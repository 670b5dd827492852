"""The RoPE kernel's two readers: ``rope_launches_per_step`` (the
program's counter over the window's local steps) and ``rope_roofline_pct``
(one read and one write of every traced rotation's q and k values over the
kernels' device time at 3.35 TB/s); both read nothing, and raise nothing,
where the program has no such counter or kernel."""
import pytest

from perfbench import cost, spec
from perfbench.tests.test_perfbench_reference import tiny_gpt2

COUNTER = "repro_torch.kernels.rope.LAUNCHES"
GPT2 = {"n_layer": 36, "n_head": 20, "n_embd": 1280,
        "port": {"compute_dtype": "bfloat16"}}
MIX = {"clients": 4, "local_steps": 2, "batch": 4, "seq": 1024}
KERNELS = [
    ("void (anonymous namespace)::rope_rotate_kernel<__nv_bfloat16, 8, "
     "false>((anonymous namespace)::Params)", 0.0, 300.0),
    ("void (anonymous namespace)::rope_rotate_kernel<__nv_bfloat16, 8, "
     "true>((anonymous namespace)::Params)", 300.0, 700.0),
    ("void (anonymous namespace)::causal_attention_fwd_kernel<64>("
     "(anonymous namespace)::Params)", 700.0, 900.0),
]


def _rec(counters=None, kernels=None, config=GPT2, rounds=3,
         traced_rounds=2):
    trace = None if kernels is None else {
        "kernels": kernels, "rounds": traced_rounds, "busy_s": 1e-3,
        "window_s": 2e-3}
    return {"rounds": rounds, "counters": counters or {}, "config": config,
            "traffic": MIX, "trace": trace}


def read(name, rec):
    return spec.metric_reader(name)(rec)


def test_launches_per_step_is_the_counter_over_local_steps():
    # 3 rounds × 4 clients × 2 steps, 144 launches a step
    rec = _rec({COUNTER: 3 * 4 * 2 * 144})
    assert read("rope_launches_per_step", rec) == 144.0


@pytest.mark.parametrize("counters", [{}, {COUNTER: 0}])
def test_launches_per_step_is_none_without_launches(counters):
    assert read("rope_launches_per_step", _rec(counters)) is None


@pytest.mark.parametrize("config, values_per_token, size", [
    (GPT2, 40 * 64, 2),
    (dict(GPT2, num_key_value_heads=4,
          port={"compute_dtype": "float32"}), 24 * 64, 4),
], ids=["gpt2_bf16", "gqa_f32"])
def test_roofline_is_the_rotations_bytes_over_kernel_time(
        config, values_per_token, size):
    # 2 traced rounds × 4 clients × 2 steps × 36 layers × 2 passes, each a
    # read and a write of 4 × 1,024 tokens' q and k values
    nbytes = 2 * 4 * 2 * 36 * 2 * (4 * 1024 * values_per_token) * 2 * size
    want = 100.0 * nbytes / cost.HBM_BPS / 700e-6
    got = read("rope_roofline_pct", _rec(kernels=KERNELS, config=config))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("kernels", [None, [], KERNELS[2:]],
                         ids=["untraced", "no_kernels", "other_kernels"])
def test_roofline_is_none_without_the_kernels(kernels):
    assert read("rope_roofline_pct", _rec(kernels=kernels)) is None


def test_readers_on_the_tiny_cell_record():
    """A CPU run of the tiny GPT-2 cell has neither a launch nor a device
    kernel: both read None."""
    config, mix = tiny_gpt2()
    rec = {"rounds": 2, "counters": {}, "config": config, "traffic": mix,
           "trace": {"kernels": [], "rounds": 1}}
    assert read("rope_launches_per_step", rec) is None
    assert read("rope_roofline_pct", rec) is None
