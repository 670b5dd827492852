"""The CUDA kernels against their plain PyTorch versions: bit for bit,
except rmsnorm, whose sum runs in another order than torch.mean's (f32:
rtol 1e-5 and atol 1e-6; bf16: one ulp).

These tests need an NVIDIA GPU and the CUDA toolkit (the kernel is built
with nvcc on first use); they skip elsewhere. The file imports only the
port, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import FederatedSession  # noqa: E402
from repro_torch import smoke  # noqa: E402
from repro_torch.kernels import fedavg_stream as fs  # noqa: E402
from repro_torch.kernels import quantize as q  # noqa: E402
from repro_torch.kernels import topk_sparsify as tk  # noqa: E402
from repro_torch.kernels import fused_sgd as sgd  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

CASES = ["unweighted", "bf16", "weighted_f64", "weighted_f32", "n1",
         "misaligned", "multi_node"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _card_cases():
    g = torch.Generator(device="cuda").manual_seed(7)
    mk = lambda n, length, dtype=torch.float32: [
        torch.randn(length, generator=g, device="cuda").to(dtype)
        for _ in range(n)]
    base = mk(1, 1_000_008)[0]
    w7 = [0.5, 2.0, 1.0, 3.25, 0.125, 1.0, 7.0]
    return {
        "unweighted": ([(mk(20, 1_000_003), None)], "f64"),
        "bf16": ([(mk(7, 12_345, torch.bfloat16), None),
                  (mk(7, 12_345, torch.bfloat16), w7)], "f64"),
        "weighted_f64": ([(mk(7, 99_999), w7)], "f64"),
        "weighted_f32": ([(mk(7, 99_999), w7)], "f32"),
        "n1": ([(mk(1, 4_097), None), (mk(1, 4_097), [3.0])], "f64"),
        "misaligned": ([([base[k:k + 999_999] for k in (1, 2, 3, 5)],
                         None)], "f64"),
        "multi_node": ([(mk(3, 5), None), (mk(9, 300_000), w7 + [1.0, 2.0]),
                        (mk(2, 0), None), (mk(20, 33_333), None)], "f64"),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_bit_equal_plain_on_card(case):
    _need_card()
    nodes, acc = _card_cases()[case]
    before = fs.LAUNCHES
    got = fs.fold_nodes(nodes, acc=acc)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == before + 1
    for (inputs, weights), out in zip(nodes, got):
        want = fs.fedavg_stream_plain(inputs, weights, acc)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("topology", smoke.TOPOLOGIES)
def test_batched_round_on_card_launches_kernel(topology):
    _need_card()
    grads = smoke.smoke_grads()
    before = fs.LAUNCHES
    on_card = FederatedSession(topology=topology, engine="batched",
                               device="cuda").round(grads)
    assert fs.LAUNCHES > before
    assert on_card.avg_flat.device.type == "cuda"
    on_cpu = FederatedSession(topology=topology, engine="batched",
                              device="cpu").round(grads)
    assert smoke.avg_hash(on_card.avg_flat) == smoke.avg_hash(on_cpu.avg_flat)


CODEC_CASES = ["shard", "short", "misaligned", "zero_tiles", "half_to_even",
               "nonfinite", "few_tiles", "heavy_tail", "ties"]


def _codec_input(case):
    g = torch.Generator(device="cuda").manual_seed(11)
    rnd = lambda n: torch.randn(n, generator=g, device="cuda")
    if case == "shard":                 # a ragged last tile, as every
        return rnd(1_000_003)           # VGG-16 shard has
    if case == "short":
        return rnd(100)
    if case == "misaligned":
        return rnd(100_003)[3:]
    if case == "nonfinite":
        # tile 0: NaN, +inf and -inf; tile 1 clean; tile 2: ±inf without
        # NaN; ragged tile 3: a NaN
        x = rnd(3 * 4096 + 33)
        x[5] = x[700] = float("nan")
        x[9], x[100] = float("inf"), float("-inf")
        x[2 * 4096 + 7], x[2 * 4096 + 8] = float("inf"), float("-inf")
        x[3 * 4096 + 4] = float("nan")
        return x
    if case == "few_tiles":             # fewer tiles than SMs
        return rnd(50 * 4096 + 1234)
    if case == "heavy_tail":            # Cauchy: several block-wide steps
        u = torch.rand(300_007, generator=g, device="cuda")
        return torch.tan(torch.pi * (u - 0.5))
    if case == "ties":                  # few distinct magnitudes
        return torch.round(rnd(200_000) * 4)
    if case == "zero_tiles":
        x = rnd(4 * 4096 + 17)
        x[4096:3 * 4096] = 0.0
        x[2 * 4096:3 * 4096:64] = rnd(64)
        x[3 * 4096:3 * 4096 + 100] = -0.0
        return x
    x = torch.empty(2 * 4096, device="cuda")
    ramp = torch.arange(4096, device="cuda", dtype=torch.float32)
    x[:4096] = (ramp % 254) - 126.5
    x[0] = 127.0
    x[4096:] = 2 * ((ramp % 127) - 63) + 1
    x[4096] = 254.0
    return x


def _bits(t):
    return t if t.dtype == torch.int8 else t.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CODEC_CASES)
def test_codec_kernels_bit_equal_plain_on_card(case):
    _need_card()
    x = _codec_input(case)
    n = x.numel()
    before = (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES, tk.LAUNCHES)
    codes, scales = q.quantize(x)
    decoded = q.dequantize(codes, scales)
    part = q.dequantize(codes, scales, n // 3, n - 1)
    dense = tk.topk_sparsify(x, 128)
    torch.cuda.synchronize()
    assert (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES, tk.LAUNCHES) == \
        (before[0] + 1, before[1] + 2, before[2] + 1)
    want_codes, want_scales = q.quantize_plain(x)
    assert torch.equal(codes, want_codes)
    assert torch.equal(_bits(scales), _bits(want_scales))
    assert torch.equal(_bits(decoded),
                       _bits(q.dequantize_plain(want_codes, want_scales)))
    assert torch.equal(_bits(part), _bits(q.dequantize_plain(
        want_codes, want_scales, n // 3, n - 1)))
    assert torch.equal(_bits(dense), _bits(tk.topk_plain(x, 128)))


@pytest.mark.cuda
def test_topk_whole_vgg16_gradient_on_card():
    """The whole VGG-16 gradient, 134 M elements in 32,715 tiles, through
    the persistent grid, bit for bit."""
    _need_card()
    from repro_torch.configs.paper_workloads import VGG16
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(VGG16.params, generator=g, device="cuda")
    assert (x.numel() + 4095) // 4096 == 32_715
    before = tk.LAUNCHES
    got = tk.topk_sparsify(x, 128)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1
    assert torch.equal(_bits(got), _bits(tk.topk_plain(x, 128)))


@pytest.mark.cuda
def test_codec_kernels_skip_empty_input_on_card():
    _need_card()
    before = (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES, tk.LAUNCHES)
    codes, scales = q.quantize(torch.empty(0, device="cuda"))
    assert codes.numel() == scales.numel() == 0
    assert q.dequantize(codes, scales).numel() == 0
    assert tk.topk_sparsify(torch.empty(0, device="cuda"), 128).numel() == 0
    assert (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES, tk.LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp16", "qsgd8", "topk"])
@pytest.mark.parametrize("topology", smoke.TOPOLOGIES)
def test_codec_round_on_card_equals_cpu(topology, codec):
    _need_card()
    grads = smoke.smoke_grads()
    launches = lambda: (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES,
                        tk.LAUNCHES)
    before = launches()
    on_card = FederatedSession(topology=topology, engine="batched",
                               codec=codec, device="cuda").round(grads)
    grew = [b - a for a, b in zip(before, launches())]
    n_enc = smoke.N_CLIENTS * (4 if topology == "gradssharding" else 1)
    assert grew == {"fp16": [0, 0, 0], "qsgd8": [n_enc, n_enc, 0],
                    "topk": [0, 0, n_enc]}[codec]
    on_cpu = FederatedSession(topology=topology, engine="batched",
                              codec=codec, device="cpu").round(grads)
    assert smoke.avg_hash(on_card.avg_flat) == smoke.avg_hash(on_cpu.avg_flat)
    assert on_card.codec_error == on_cpu.codec_error


SGD_CASES = ["f32", "bf16_p", "bf16_g", "bf16_both", "ragged", "misaligned"]


def _sgd_inputs(case):
    g = torch.Generator(device="cuda").manual_seed(13)
    rnd = lambda n: torch.randn(n, generator=g, device="cuda")
    n = 1_000_003 if case == "ragged" else 65_536
    p, grad, v = rnd(n), rnd(n), rnd(n)
    if case in ("bf16_p", "bf16_both"):
        p = p.bfloat16()
    if case in ("bf16_g", "bf16_both"):
        grad = grad.bfloat16()
    if case == "misaligned":
        p, grad, v = (t[1:] for t in (rnd(n + 1), rnd(n + 1), rnd(n + 1)))
        assert p.data_ptr() % 16 != 0
    return p, grad, v


@pytest.mark.cuda
@pytest.mark.parametrize("case", SGD_CASES)
def test_fused_sgd_bit_equal_plain_on_card(case):
    _need_card()
    p, g, v = _sgd_inputs(case)
    want_p, want_v = p.clone(), v.clone()
    sgd.fused_sgd_plain(want_p, g, want_v, 0.1, 0.9)
    before = sgd.LAUNCHES
    got_p, got_v = sgd.fused_sgd(p, g, v, 0.1, 0.9)
    torch.cuda.synchronize()
    assert sgd.LAUNCHES == before + 1
    assert got_p is p and got_v is v
    bits = torch.int16 if p.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(p.view(bits), want_p.view(bits))
    assert torch.equal(v.view(torch.int32), want_v.view(torch.int32))


@pytest.mark.cuda
def test_fused_sgd_skips_empty_leaf_on_card():
    _need_card()
    before = sgd.LAUNCHES
    e = torch.empty(0, device="cuda")
    sgd.fused_sgd(e, e, e.clone(), 0.1)
    assert sgd.LAUNCHES == before


def _bf16_ulps(a, b):
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 2048, 8192])
@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("g_dtype", ["f32", "bf16"])
def test_rmsnorm_within_tolerance_of_plain_on_card(d, x_dtype, g_dtype):
    _need_card()
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn(37, d, generator=gen, device="cuda").to(types[x_dtype])
    x[3] = 0.0
    gamma = torch.randn(d, generator=gen, device="cuda").to(types[g_dtype])
    before = rn.LAUNCHES
    out, rstd = rn.rmsnorm(x, gamma)
    torch.cuda.synchronize()
    assert rn.LAUNCHES == before + 1
    want, want_rstd = rn.rmsnorm_plain(x, gamma)
    assert out.dtype == x.dtype and out.shape == x.shape
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)
    if x_dtype == "f32":
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    else:
        assert _bf16_ulps(out, want) <= 1


NORM_CASES = ["misaligned", "strided_rows", "d2047_bf16", "d8191_f32",
              "rows1", "path_shape"]


def _norm_input(case):
    gen = torch.Generator(device="cuda").manual_seed(21)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    if case == "misaligned":            # a view 2 bf16 past an aligned start
        x = rnd(513 * 2048).bfloat16()[2:2 + 512 * 2048].reshape(512, 2048)
        assert x.data_ptr() % 16 != 0
        return x, rnd(2048)
    if case == "strided_rows":          # rows 2056 apart, read in place
        return rnd(300, 2056).bfloat16()[:, :2048], rnd(2048)
    if case == "d2047_bf16":            # no 16-byte width
        return rnd(129, 2047).bfloat16(), rnd(2047)
    if case == "d8191_f32":
        return rnd(33, 8191), rnd(8191).bfloat16()
    if case == "rows1":
        return rnd(1, 2048).bfloat16(), rnd(2048)
    return rnd(512, 2048).bfloat16(), rnd(2048)


@pytest.mark.cuda
@pytest.mark.parametrize("case", NORM_CASES)
def test_rmsnorm_edge_cases_within_tolerance_on_card(case):
    _need_card()
    x, gamma = _norm_input(case)
    ptr = x.data_ptr()
    before = rn.LAUNCHES
    out, rstd = rn.rmsnorm(x, gamma)
    torch.cuda.synchronize()
    assert rn.LAUNCHES == before + 1 and x.data_ptr() == ptr
    want, want_rstd = rn.rmsnorm_plain(x, gamma)
    assert out.dtype == x.dtype and out.shape == x.shape
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)
    if x.dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    else:
        assert _bf16_ulps(out, want) <= 1


@pytest.mark.cuda
def test_rmsnorm_skips_zero_rows_on_card():
    _need_card()
    before = rn.LAUNCHES
    out, rstd = rn.rmsnorm(torch.empty(0, 2048, device="cuda"),
                           torch.ones(2048, device="cuda"))
    assert out.shape == (0, 2048) and rstd.shape == (0,)
    assert rn.LAUNCHES == before


@pytest.mark.cuda
def test_rmsnorm_raises_on_what_the_kernel_does_not_take_on_card():
    _need_card()
    x = torch.zeros(4, 16, device="cuda")
    with pytest.raises(ValueError, match="stride"):
        rn.rmsnorm(x.t().contiguous().t(), torch.ones(16, device="cuda"))
    with pytest.raises(ValueError):
        rn.rmsnorm(torch.zeros(2, 8193, device="cuda"),
                   torch.ones(8193, device="cuda"))
    with pytest.raises(ValueError):
        rn.rmsnorm(x, torch.ones(16))


@pytest.mark.cuda
def test_federated_lm_smoke_round_on_card():
    """One round of the smoke configuration through the kernels, against
    the same round on the CPU at f32 compute (losses rtol 1e-3: the card's
    matmuls sum in another order)."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch import federated_lm
    from repro_torch.models import registry as models
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").smoke,
                              compute_dtype=torch.float32)
    params = models.init_params(torch.Generator().manual_seed(0), cfg)
    kw = dict(rounds=1, clients=2, shards=2, local_steps=2, batch=2, seq=16,
              engine="batched", params=params)
    before = (fs.LAUNCHES, sgd.LAUNCHES, rn.LAUNCHES)
    on_card = federated_lm.run(cfg, device="cuda", **kw)
    grew = [b - a for a, b in zip(before, (fs.LAUNCHES, sgd.LAUNCHES,
                                           rn.LAUNCHES))]
    steps = 2 * 2
    assert grew[0] >= 1 and grew[1:] == [12 * steps, 5 * steps]
    assert all(p.device.type == "cuda" for p in on_card["params"].values())
    on_cpu = federated_lm.run(cfg, device="cpu", **kw)
    torch.testing.assert_close(
        torch.tensor(on_card["rounds"][0]["client_losses"]),
        torch.tensor(on_cpu["rounds"][0]["client_losses"]), rtol=1e-3,
        atol=0)
