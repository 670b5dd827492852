"""The attention kernel's two readers: ``attn_launches_per_step`` (the
program's counter over the window's local steps) and
``attn_roofline_pct`` (3 × the causal forward products of the traced
steps over the kernels' device time at the bf16 peak); both read nothing,
and raise nothing, where the program has no such counter or kernel."""
import pytest

from perfbench import cost, spec
from perfbench.tests.test_perfbench_reference import tiny_gpt2

COUNTER = "repro_torch.kernels.causal_attention.LAUNCHES"
GPT2 = {"n_layer": 36, "n_head": 20, "n_embd": 1280}
MIX = {"clients": 4, "local_steps": 2, "batch": 4, "seq": 1024}
KERNELS = [
    ("void (anonymous namespace)::causal_attention_fwd_kernel<64>("
     "(anonymous namespace)::Params)", 0.0, 100.0),
    ("void (anonymous namespace)::causal_attention_dq_kernel<64>("
     "(anonymous namespace)::Params)", 100.0, 250.0),
    ("void (anonymous namespace)::causal_attention_dkdv_kernel<64>("
     "(anonymous namespace)::Params)", 250.0, 400.0),
    ("void at::native::vectorized_elementwise_kernel<4>", 400.0, 900.0),
]


def _rec(counters=None, kernels=None, rounds=3, traced_rounds=2):
    trace = None if kernels is None else {
        "kernels": kernels, "rounds": traced_rounds, "busy_s": 1e-3,
        "window_s": 2e-3}
    return {"rounds": rounds, "counters": counters or {}, "config": GPT2,
            "traffic": MIX, "trace": trace}


def read(name, rec):
    return spec.metric_reader(name)(rec)


def test_launches_per_step_is_the_counter_over_local_steps():
    # 3 rounds × 4 clients × 2 steps, 108 launches a step
    rec = _rec({COUNTER: 3 * 4 * 2 * 108})
    assert read("attn_launches_per_step", rec) == 108.0


@pytest.mark.parametrize("counters", [{}, {COUNTER: 0}])
def test_launches_per_step_is_none_without_launches(counters):
    assert read("attn_launches_per_step", _rec(counters)) is None


def test_roofline_is_the_causal_products_over_kernel_time():
    rec = _rec(kernels=KERNELS)
    flops = 2 * 4 * 2 * 3.0 * (4 * 36 * 4.0 * 1024 * 1024 * 20 * 64 * 0.5)
    assert flops == 2 * 4 * 2 * cost.model_flops_train(
        0, 36, 20, 64, 4, 1024)
    want = 100.0 * flops / (400e-6 * cost.BF16_FLOPS)
    assert read("attn_roofline_pct", rec) == pytest.approx(want)


@pytest.mark.parametrize("kernels", [None, [], KERNELS[3:]],
                         ids=["untraced", "no_kernels", "other_kernels"])
def test_roofline_is_none_without_the_kernels(kernels):
    assert read("attn_roofline_pct", _rec(kernels=kernels)) is None


def test_readers_on_the_tiny_cell_record():
    """A CPU run of the tiny GPT-2 cell has neither a launch nor a device
    kernel: both read None."""
    config, mix = tiny_gpt2()
    rec = {"rounds": 2, "counters": {}, "config": config, "traffic": mix,
           "trace": {"kernels": [], "rounds": 1}}
    assert read("attn_launches_per_step", rec) is None
    assert read("attn_roofline_pct", rec) is None
