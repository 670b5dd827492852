"""The readers of the program's own spans on a synthetic trace: the
aggregation round's self time (``control_plane_ms``) and the device's idle
share inside the local steps (``step_idle_pct``)."""
import pytest

from perfbench import spans, spec

KERNELS = [("void (anonymous namespace)::fedavg_fold_kernel<float>(long "
            "const*, int, long)", 55.0, 90.0),
           ("Memcpy DtoD", 92.0, 96.0)]
BENCH_SPANS = [("window.round", 0.0, 100.0), ("session.round", 2.0, 98.0)]
# agg.plan 10-40 holds codec.encode 20-30; agg.upload 35-45 overlaps it;
# agg.fold 50-70 holds codec.decode 50-52 and fold.launch 52-60, which
# overlap each other; codec.error 80-85 lies outside every agg.* span
AGG_SPANS = [("agg.plan", 10.0, 40.0), ("codec.encode", 20.0, 30.0),
             ("agg.upload", 35.0, 45.0), ("agg.fold", 50.0, 70.0),
             ("codec.decode", 50.0, 52.0), ("fold.launch", 51.0, 60.0),
             ("codec.error", 80.0, 85.0)]
# steps 10-40 and 60-100; kernels 0-20, 30-70 and 95-120
STEP_SPANS = [("round.clients", 0.0, 100.0), ("step.forward", 10.0, 25.0),
              ("step.backward", 25.0, 40.0), ("step.optimizer", 60.0, 100.0)]
STEP_KERNELS = [("ampere_sgemm", 0.0, 20.0), ("elementwise", 30.0, 70.0),
                ("fused_sgd_kernel", 95.0, 120.0)]


def _rec(span_list, kernels, rounds=2):
    return {"trace": {"spans": span_list, "kernels": kernels,
                      "rounds": rounds, "busy_s": 0.0, "window_s": 1e-4}}


def read(name, rec):
    return spec.metric_reader(name)(rec)


def test_covered_length_of_disjoint_intervals():
    assert spans.union(AGG_SPANS, ("codec.", "fold.")) == \
        [(20.0, 30.0), (50.0, 60.0), (80.0, 85.0)]
    assert spans.covered([(0.0, 10.0), (20.0, 40.0)],
                         [(5.0, 25.0), (30.0, 31.0), (39.0, 50.0)]) == 12.0
    assert spans.covered([(0.0, 10.0)], []) == 0.0


def test_control_plane_is_agg_self_time_a_round():
    """The agg.* union 10-45 and 50-70 (55 us, the overlap counted once),
    less codec.encode 20-30 and decode + launch 50-60 inside it; the
    codec.error span outside it takes nothing away."""
    rec = _rec(BENCH_SPANS + AGG_SPANS, KERNELS, rounds=2)
    assert read("control_plane_ms", rec) == pytest.approx((55 - 20) / 2e3)


def test_step_idle_clips_kernels_to_the_step_spans():
    """Steps cover 70 us; kernels cover 10-20, 30-40, 60-70 and 95-100 of
    them (35 us): 35 of 70 idle, whatever the kernels do outside."""
    rec = _rec(STEP_SPANS, STEP_KERNELS)
    assert read("step_idle_pct", rec) == pytest.approx(50.0)


@pytest.mark.parametrize("name", ["control_plane_ms", "step_idle_pct"])
def test_none_without_the_programs_spans(name):
    """A program without spans, as before the port had them: only the
    benchmark's own spans in the trace."""
    assert read(name, _rec(BENCH_SPANS, KERNELS)) is None
    assert read(name, {"trace": None}) is None


def test_each_reader_reads_only_its_own_layer():
    assert read("step_idle_pct", _rec(BENCH_SPANS + AGG_SPANS,
                                      KERNELS)) is None
    assert read("control_plane_ms", _rec(STEP_SPANS, STEP_KERNELS)) is None
