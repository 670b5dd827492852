"""The traced run's reductions on a synthetic trace: busy time as the
union of kernel spans, idle time by the innermost host span, kernel names
shortened, and the readers of the per-layer metrics."""
import pytest

from perfbench import spec, trace

KERNELS = [("void (anonymous namespace)::fedavg_fold_kernel<float>(long "
            "const*, int, long)", 10.0, 40.0),
           ("Memcpy DtoD", 30.0, 50.0),
           ("void (anonymous namespace)::quantize_kernel(float const*)",
            70.0, 80.0)]
SPANS = [("window.round", 0.0, 100.0), ("session.round", 20.0, 95.0)]


def test_busy_is_the_union_of_kernel_spans():
    assert trace.busy_intervals(KERNELS) == [(10.0, 50.0), (70.0, 80.0)]
    assert trace.busy_us(KERNELS) == 50.0
    assert trace.device_us(KERNELS, r"fedavg_(fold|carry)_kernel") == 30.0


def test_idle_gaps_by_the_innermost_span():
    b = trace.breakdown(KERNELS, SPANS, 0.0, 100.0)
    idle = dict(b["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(50.0 / 1e6)
    assert idle["window.round"] == pytest.approx(10.0 / 1e6)     # 0-10
    assert idle["session.round"] == pytest.approx(40.0 / 1e6)    # 50-70, 80-100
    ops = dict(b["device_ops"])
    assert ops["fedavg_fold_kernel"] == \
        pytest.approx(30e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_readers():
    rec = {"rounds": 4, "window_s": 2e-4, "counters": {
        "repro_torch.kernels.fedavg_stream.LAUNCHES": 8},
        "work": {"fold_bound_s": 12e-6, "codec_bound_s": 4e-6,
                 "agg_bytes": 8000},
        "trace": {"kernels": KERNELS, "busy_s": 50e-6, "window_s": 100e-6,
                  "rounds": 2}}
    read = lambda name: spec.metric_reader(name)(rec)
    assert read("fold_roofline_pct") == pytest.approx(80.0)
    assert read("codec_roofline_pct") == pytest.approx(80.0)
    assert read("fold_launches_per_round") == 2.0
    assert read("device_idle_pct.agg") == pytest.approx(50.0)
    assert read("agg_GBps") == pytest.approx(4 * 8000 / 2e-4 / 1e9)
    assert read("fused_sgd_roofline_pct") is None
    rec["trace"] = None
    assert read("fold_roofline_pct") is None
