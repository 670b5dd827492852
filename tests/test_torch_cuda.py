"""The CUDA kernels against their plain PyTorch versions: bit for bit,
except rmsnorm, whose sum runs in another order than torch.mean's (f32:
rtol 1e-5 and atol 1e-6; bf16: one ulp), and causal attention, whose
products sum in other orders than the einsums' (no further from an f32
attention than ``attention_dense`` is, with 10 % room).

These tests need an NVIDIA GPU and the CUDA toolkit (the kernel is built
with nvcc on first use); they skip elsewhere. The file imports only the
port, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import FederatedSession  # noqa: E402
from repro_torch.configs import arch_ids, get_arch  # noqa: E402
from repro_torch import smoke  # noqa: E402
from repro_torch.kernels import fedavg_stream as fs  # noqa: E402
from repro_torch.kernels import quantize as q  # noqa: E402
from repro_torch.kernels import topk_sparsify as tk  # noqa: E402
from repro_torch.kernels import fused_sgd as sgd  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

CASES = ["unweighted", "bf16", "weighted_f64", "weighted_f32", "n1",
         "misaligned", "multi_node", "misaligned_weighted", "subnormals",
         "multi_node_f32"]


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
    cases = {
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
    mis = [base[k:k + 999_999] for k in (1, 2, 3, 5)]
    sub = [x * 1e-39 for x in mk(6, 50_000)]
    cases.update({
        "misaligned_weighted": ([(mis, None), (mis, w7[:4])], "f64"),
        "subnormals": ([(sub, None), (sub, w7[:6])], "f64"),
        # fedavg_multi's form: several stacks, one weighted f32 table
        "multi_node_f32": ([(mk(5, n), w7[:5]) for n in (1, 1023, 70_001)],
                           "f32"),
    })
    return cases


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
               "nonfinite", "few_tiles", "heavy_tail", "ties", "subnormals",
               "near_max", "vgg16_shard", "vgg16_whole"]


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
    if case == "subnormals":
        return rnd(3 * 4096 + 5) * 1e-39
    if case == "near_max":              # |x| in [3e38, 3.4e38], f32's max
        x = (torch.rand(2 * 4096 + 9, generator=g, device="cuda") * 0.4e38
             + 3.0e38) * torch.sign(rnd(2 * 4096 + 9))
        x[5] = torch.finfo(torch.float32).max
        return x
    if case in ("vgg16_shard", "vgg16_whole"):
        # a GradsSharding client's first shard (33.5 M, a ragged last
        # tile) and the whole gradient λ-FL and LIFL encode (32,715 tiles)
        from repro_torch.configs.paper_workloads import VGG16
        from repro_torch.core.sharding import plan_uniform
        (a, b), = plan_uniform(VGG16.params, 4).segments[0]
        return rnd(b - a if case == "vgg16_shard" else VGG16.params)
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


# each group of benchmarks/expected_smoke.json that the port recomputes on a
# device (the ``roofline`` group folds on the host: see
# test_roofline_inputs_hash_on_card), and the function that recomputes it
PINNED_GROUPS = {
    "main_path": (smoke.TOPOLOGIES, smoke.main_path_invariants),
    "codec": (("codec",), smoke.codec_invariants),
    "sharded_tree": ((smoke.SHARDED_TREE, "sharded_tree_equals_lambda_fl"),
                     smoke.sharded_tree_invariants),
    "fault": (("fault",), smoke.fault_invariants),
    "robust": (("robust",), smoke.robust_invariants),
    "geo_tiered": (("geo_tiered",), smoke.geo_invariants),
    "population": (("population",), smoke.population_invariants),
}


@pytest.mark.cuda
@pytest.mark.parametrize("group", list(PINNED_GROUPS))
def test_pinned_smoke_keys_on_card(group):
    """Every pinned key of the group recomputed on the card equals
    expected_smoke.json: 168 main-path, 36 codec and 159 sharded_tree,
    fault, robust, geo_tiered and population keys."""
    _need_card()
    groups, invariants = PINNED_GROUPS[group]
    expected = smoke.expected_invariants(groups=groups)
    got = invariants("cuda")
    assert set(got) == set(expected)
    assert smoke.mismatches(got, expected) == []


@pytest.mark.cuda
@pytest.mark.parametrize("codec", smoke.CODECS)
@pytest.mark.parametrize("engine", smoke.ENGINES)
@pytest.mark.parametrize("topology", smoke.TOPOLOGIES)
def test_every_engine_at_n12_on_card_equals_cpu(topology, engine, codec):
    """N = 12, M = 8, pipelined at readahead_k 2 (divisors that are not
    powers of two, where a reciprocal multiply would show): the round on
    the card equals the CPU's, hashes included, and so does a lossy
    codec's codec_error."""
    _need_card()
    grads = smoke.readahead_grads("2")
    kw = dict(topology=topology, n_shards=smoke.N_SHARDS_2, engine=engine,
              schedule="pipelined", readahead_k=2, upload=smoke.UPLOAD,
              codec=codec)
    on_card = FederatedSession(device="cuda", **kw).round(grads)
    on_cpu = FederatedSession(device="cpu", **kw).round(grads)
    assert smoke.record(on_card) == smoke.record(on_cpu)
    if codec != "identity":
        assert on_card.codec_error == on_cpu.codec_error


SGD_CASES = ["f32", "bf16_p", "bf16_g", "bf16_both", "ragged", "misaligned",
             "mixed_offsets", "mixed_offsets_bf16_g", "bf16_p_head",
             "len1", "len3", "len5", "len5_offset", "len1_offset",
             "len3_offset"]
# (p, g, v) element offsets of the mixed cases, from a 16-byte aligned start
SGD_OFFSETS = {"mixed_offsets": (1, 2, 3), "mixed_offsets_bf16_g": (0, 1, 0),
               "bf16_p_head": (2, 2, 2), "len5_offset": (1, 1, 1),
               "len1_offset": (1, 1, 1), "len3_offset": (1, 1, 1)}


def _sgd_inputs(case):
    g = torch.Generator(device="cuda").manual_seed(13)
    rnd = lambda n: torch.randn(n, generator=g, device="cuda")
    n = {"ragged": 1_000_003, "len1": 1, "len3": 3, "len5": 5,
         "len5_offset": 5, "len1_offset": 1, "len3_offset": 3,
         "bf16_p_head": 100_005}.get(case, 65_536)
    p, grad, v = rnd(n), rnd(n), rnd(n)
    if case in ("bf16_p", "bf16_both"):
        p = p.bfloat16()
    if case in ("bf16_g", "bf16_both"):
        grad = grad.bfloat16()
    if case == "misaligned":
        p, grad, v = (t[1:] for t in (rnd(n + 1), rnd(n + 1), rnd(n + 1)))
        assert p.data_ptr() % 16 != 0
    if case in SGD_OFFSETS:
        # p, g and v start at different offsets modulo 16 bytes (or, for
        # bf16_p_head and len5_offset, at offsets one head aligns)
        op, og, ov = SGD_OFFSETS[case]
        p, grad, v = (rnd(n + k)[k:] for k in (op, og, ov))
        if case == "bf16_p_head":
            p = rnd(n + op).bfloat16()[op:]
        if case == "mixed_offsets_bf16_g":
            grad = rnd(n + og).bfloat16()[og:]
        assert {t.data_ptr() % 16 for t in (p, grad, v)} != {0}
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
              "rows1", "path_shape", "near_max"]


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
    if case == "near_max":              # sums of squares past f32's max
        x = rnd(9, 2048).sign() * 3.0e38
        x[1] = rnd(2048) * 1e17         # large, its sum of squares finite
        x[2, 7] = torch.finfo(torch.float32).max
        return x, rnd(2048)
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


# ---------------------------------------------------------------------------
# the fold kernel's carry form, population rounds and stale folds
# ---------------------------------------------------------------------------

CARRY_CASES = ["f32_chunks", "f64_chunks", "one_row_chunk", "ragged_last",
               "many_nodes", "misaligned", "weighted_f64_noninteger"]


def _carry_case(case):
    """(chunks per node, weighted) of one carry case: each node folds its
    chunks in turn, carrying the raw accumulator; every node of a case has
    the same number of chunks."""
    g = torch.Generator(device="cuda").manual_seed(13)
    rows = lambda n, length=4096: torch.randn(n, length, generator=g,
                                              device="cuda")
    if case == "f32_chunks":
        return [[rows(512), rows(512), rows(77)]], False
    if case == "f64_chunks":
        return [[rows(512), rows(512), rows(77)]], True
    if case == "one_row_chunk":
        return [[rows(1), rows(1), rows(1)], [rows(3), rows(1), rows(1)]], \
            False
    if case == "ragged_last":
        return [[rows(512, 33_333), rows(5, 33_333)]], True
    if case == "many_nodes":
        return [[rows(32, 4096 + 7 * j) for _ in range(3)]
                for j in range(40)], True
    if case == "misaligned":
        base = torch.randn(16 * 10_008 + 32, generator=g, device="cuda")
        views = [base[k + 10_008 * i:k + 10_008 * i + 9_999]
                 for i, k in enumerate((1, 2, 3, 5, 6, 7, 9, 11, 13, 14,
                                        15, 17, 18, 19, 21, 22))]
        return [[views[:7], views[7:]]], False
    return [[rows(9, 1_001)]], "weights"


def _fold_carried(chunks_per_node, weighted, fold):
    """Every node's chunks through ``fold`` (kernel or plain), one call per
    chunk step for all nodes, the last one dividing by the total."""
    n_rows = lambda x: int(x.shape[0]) if isinstance(x, torch.Tensor) \
        else len(x)
    n_steps = len(chunks_per_node[0])
    divs = [float(sum(n_rows(x) for x in chunks))
            for chunks in chunks_per_node]
    accs = [None] * len(chunks_per_node)
    raws = []
    for step in range(n_steps):
        nodes = []
        for chunks in chunks_per_node:
            x = chunks[step]
            w = None if not weighted else (
                [0.5 + 0.25 * i for i in range(n_rows(x))]
                if weighted == "weights" else [1.0] * n_rows(x))
            nodes.append((x, w))
        accs = fold(nodes, accs, step == n_steps - 1, divs)
        raws.append(accs)
    return accs, raws


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARRY_CASES)
def test_carry_form_bit_equal_plain_on_card(case):
    """The carry form: raw accumulators after each chunk (f32 or f64) and
    the final means, the kernel against its plain version bit for bit."""
    _need_card()
    chunks, weighted = _carry_case(case)

    def kernel(nodes, carry, fin, divs):
        return fs.fold_nodes(nodes, carry=carry, finalize=fin,
                             divisors=divs if fin else None)

    def plain(nodes, carry, fin, divs):
        return [fs.fedavg_stream_plain(x, w, carry=c, finalize=fin,
                                       divisor=d if fin else None)
                for (x, w), c, d in zip(nodes, carry, divs)]

    before = fs.LAUNCHES
    got, got_raw = _fold_carried(chunks, weighted, kernel)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == before + len(got_raw)
    want, want_raw = _fold_carried(chunks, weighted, plain)
    for gs, ws in zip(got_raw, want_raw):
        for a, b in zip(gs, ws):
            assert a.dtype == b.dtype
            assert torch.equal(_bits(a), _bits(b))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert torch.equal(_bits(a), _bits(b))


# the carry route: one node over the rows of one 2-D tensor, by value
CARRY_ROUTE_CASES = ["f32_chunks", "one_row_chunk", "ragged_last",
                     "weighted_chunks", "L4097", "L4100_tma", "L33333",
                     "L_below_tile_tma", "L_below_tile", "single_row",
                     "misaligned_base", "column_slice", "column_slice_tma",
                     "bf16_tma", "bf16_odd_offset", "bf16_odd_stride",
                     "nonfinite"]
CARRY_ROUTE_FORMS = ["sum_f32", "ones_f64", "weighted_f64", "weighted_f32"]


def _carry_route_case(case):
    """(the chunks of one node, each a 2-D tensor; whether the route fills
    its ring by TMA) of one carry-route case."""
    g = torch.Generator(device="cuda").manual_seed(17)
    rows = lambda n, length=4096: torch.randn(n, length, generator=g,
                                              device="cuda")
    flat = lambda n: torch.randn(n, generator=g, device="cuda")
    if case in ("f32_chunks", "weighted_chunks"):
        return [rows(512), rows(512), rows(77)], True
    if case == "one_row_chunk":
        return [rows(1), rows(1), rows(1)], True
    if case == "ragged_last":
        return [rows(512, 33_333), rows(5, 33_333)], False
    if case == "L4097":
        return [rows(512, 4_097), rows(100, 4_097)], False
    if case == "L4100_tma":
        return [rows(512, 4_100), rows(33, 4_100)], True
    if case == "L33333":
        return [rows(64, 33_333)], False
    if case == "L_below_tile_tma":
        return [rows(64, 20), rows(3, 20)], True
    if case == "L_below_tile":
        return [rows(64, 5), rows(3, 5)], False
    if case == "single_row":
        return [rows(1)], True
    if case == "misaligned_base":
        # 4 bytes off 16-byte alignment: the cp.async fill
        return [flat(600 * 4096 + 8)[k:k + 300 * 4096].view(300, 4096)
                for k in (1, 3)], False
    if case == "column_slice":
        # rows 5,000 elements apart, 28 bytes off alignment
        return [rows(300, 5_000)[:, 7:7 + 4096], rows(9, 5_000)[:, 7:7 + 4096]], \
            False
    if case == "column_slice_tma":
        return [rows(300, 5_000)[:, 8:8 + 4096], rows(9, 5_000)[:, 8:8 + 4096]], \
            True
    if case == "bf16_tma":
        return [rows(512).bfloat16(), rows(40).bfloat16()], True
    if case == "bf16_odd_offset":
        # 2 bytes off 4-byte alignment: every row at an odd offset
        return [flat(300 * 4096 + 8).bfloat16()[k:k + 300 * 4096]
                .view(300, 4096) for k in (1, 5)], False
    if case == "bf16_odd_stride":
        # rows 4,097 bf16 apart: the rows' offsets alternate
        return [rows(300, 4_097).bfloat16(), rows(7, 4_097).bfloat16()], False
    x = rows(512)
    x[3, 5] = float("nan")
    x[7, 6] = float("inf")
    x[8, 6] = float("-inf")
    x[9, 7] = float("inf")
    x[10:20, 8] = 3e38                       # overflows f32 to inf
    x[11, 9] = -0.0
    return [x, rows(30)], True


@pytest.mark.cuda
@pytest.mark.parametrize("form", CARRY_ROUTE_FORMS)
@pytest.mark.parametrize("case", CARRY_ROUTE_CASES)
def test_carry_route_bit_equal_plain_on_card(case, form):
    """The carry route, chunk by chunk with the raw accumulator carried and
    the last chunk dividing, against its plain version bit for bit: f32
    and f64 accumulators, unweighted, all-ones and weighted, TMA and
    cp.async fills, ragged and short rows, strided, misaligned and bf16
    stacks, non-finite values. One launch a chunk."""
    _need_card()
    chunks, tma = _carry_route_case(case)
    weighted = form != "sum_f32"
    acc = "f32" if form == "weighted_f32" else "f64"

    def weights(x):
        n = int(x.shape[0])
        if not weighted:
            return None
        return [1.0] * n if form == "ones_f64" else \
            [0.5 + 0.25 * (i % 7) for i in range(n)]
    total = sum(int(x.shape[0]) for x in chunks)
    div = float(total) if form in ("sum_f32", "ones_f64") else 3.5 * total
    got_c = want_c = None
    for i, x in enumerate(chunks):
        fin = i == len(chunks) - 1
        w = weights(x)
        args = fs._carry_args(x, w, got_c, div if fin else None, acc, fin,
                              x.device)[0]
        assert args[5] == int(tma)
        before = fs.LAUNCHES
        got = fs.fold_nodes([(x, w)], acc, carry=[got_c], finalize=fin,
                            divisors=[div] if fin else None)[0]
        torch.cuda.synchronize()
        assert fs.LAUNCHES == before + 1
        want = fs.fedavg_stream_plain(x, w, acc, carry=want_c, finalize=fin,
                                      divisor=div if fin else None)
        assert got.dtype == want.dtype
        assert torch.equal(_bits(got), _bits(want)), f"chunk {i}"
        got_c, want_c = got, want


@pytest.mark.cuda
def test_carry_route_raises_on_what_it_cannot_take_on_card():
    """A stack on another device than its carry, or rows that are not
    contiguous, raise; an empty row length launches nothing."""
    _need_card()
    x = torch.randn(8, 64, device="cuda")
    with pytest.raises(ValueError, match="carry"):
        fs.fold_nodes([(x, None)], carry=[torch.zeros(64)], finalize=False)
    with pytest.raises(ValueError, match="contiguous"):
        fs.fold_nodes([(x[:, ::2], None)])
    before = fs.LAUNCHES
    out = fs.fold_nodes([(torch.empty(8, 0, device="cuda"), None)])[0]
    assert out.shape == (0,) and fs.LAUNCHES == before


@pytest.mark.cuda
def test_roofline_inputs_hash_on_card():
    """The host fold sweep's six inputs folded on the card, by the table
    kernel (a list) and by the carry route (one 2-D stack), hash to the
    pinned `roofline/host_fold/avg_hash`."""
    _need_card()
    xs = [torch.from_numpy(x).cuda() for x in smoke.roofline_inputs()]
    want = smoke.expected_invariants(groups=("roofline",))[
        "roofline/host_fold/avg_hash"]
    for node in ((xs, None), (torch.stack(xs), None)):
        assert smoke.avg_hash(fs.fold_nodes([node])[0]) == want


@pytest.mark.cuda
@pytest.mark.parametrize("topology", ["gradssharding", "lambda_fl", "lifl",
                                      "geo_tiered"])
def test_population_round_on_card_equals_cpu(topology):
    """A population round over 1,300 clients (three chunks) folds through
    the kernel's carry form on the card and equals the CPU's round."""
    _need_card()
    from repro_torch.serverless.population import ClientPopulation
    pop = ClientPopulation(1_300, grad_elems=1_031, seed=5)
    kw = dict(topology=topology, schedule="pipelined", population=pop,
              upload=smoke.UPLOAD, participation_k=1_200,
              faults=smoke.FAULTS)
    before = fs.LAUNCHES
    on_card = FederatedSession(device="cuda", **kw).round()
    assert fs.LAUNCHES > before
    on_cpu = FederatedSession(device="cpu", **kw).round()
    assert on_card.avg_flat.device.type == "cuda"
    assert smoke.record(on_card) == smoke.record(on_cpu)
    assert on_card.codec_error == on_cpu.codec_error


@pytest.mark.cuda
@pytest.mark.parametrize("topology", ["gradssharding", "geo_tiered"])
def test_qsgd8_population_round_equals_eager_on_card(topology):
    """A population round of 64 clients under qsgd8 decodes through the
    codec kernels and folds through the fold kernel, and equals the eager
    round over the materialized cohort on the card: the mean bit for bit,
    codec_error and every accounting field alike."""
    _need_card()
    from repro_torch.serverless.population import ClientPopulation
    pop = ClientPopulation(64, grad_elems=4_096, seed=3)
    kw = dict(topology=topology, schedule="pipelined", codec="qsgd8",
              readahead_k=2, device="cuda")
    launches = lambda: (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES,
                        fs.LAUNCHES)
    before = launches()
    lazy = FederatedSession(population=pop, **kw).round()
    assert all(b > a for a, b in zip(before, launches()))
    eager = FederatedSession(**kw).round(pop.materialize(0, "cuda"))
    acct = lambda r: (r.puts, r.gets, r.wall_clock_s, r.phases_s,
                      sum(x.billed_gb_s for x in r.records),
                      tuple(int(i) for i in r.arrivals), r.retries,
                      r.hedges, r.hedge_wins, r.stale_folded)
    assert acct(lazy) == acct(eager)
    assert lazy.avg_flat.device.type == "cuda"
    assert torch.equal(_bits(lazy.avg_flat), _bits(eager.avg_flat))
    assert lazy.codec_error == eager.codec_error


@pytest.mark.cuda
def test_stale_weighted_round_batched_equals_streaming_on_card(monkeypatch):
    """Three rounds with stale re-entry: the batched engine folds the
    staleness-weighted nodes in the kernel (some weight ≠ 1.0) and equals
    the streaming engine on the card bit for bit."""
    _need_card()
    weights = []
    real = fs.fold_nodes

    def spy(nodes, acc="f64", **kw):
        nodes = list(nodes)
        weights.extend(w for _x, w in nodes if w is not None)
        return real(nodes, acc, **kw)

    monkeypatch.setattr(fs, "fold_nodes", spy)
    chains = {}
    for engine in ("batched", "streaming"):
        session, results = smoke.robust_session(engine, "cuda")
        chains[engine] = [r.avg_flat for r in results]
        assert any(r.stale_folded for r in results)
    assert any(w != 1.0 for ws in weights for w in ws)
    for a, b in zip(chains["batched"], chains["streaming"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# serving: the rmsnorm kernel at the decode shapes, one decode step
# ---------------------------------------------------------------------------

# (batch 4, d_model) of tinyllama, h2o-danube, gpt2-large and qwen2.5 /
# qwen3; qwen3's q and k norms at batch 4: (4·64, 128) and (4·8, 128);
# whisper, falcon-mamba / phi3.5-moe, dbrx and chameleon (MAX_D); a TP = 4
# rank's q and k norm blocks of qwen3; the trainer's rows (batch 8 × 128
# tokens of tinyllama) and falcon-mamba's at train_4k (4,096 × d_model)
DECODE_ROWS = [(4, 2048), (4, 2560), (4, 1280), (4, 5120), (256, 128),
               (32, 128), (4, 384), (4, 4096), (4, 6144), (4, 8192),
               (64, 128), (8, 128), (1024, 2048), (4096, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", DECODE_ROWS)
def test_rmsnorm_at_decode_rows_within_tolerance_on_card(rows, d):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(rows * d)
    x = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    gamma = torch.randn(d, generator=gen, device="cuda")
    before = rn.LAUNCHES
    out, rstd = rn.rmsnorm(x, gamma)
    torch.cuda.synchronize()
    assert rn.LAUNCHES == before + 1
    want, want_rstd = rn.rmsnorm_plain(x, gamma)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)
    assert _bf16_ulps(out, want) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-32b"])
def test_decode_step_equals_plain_norms_on_card(arch, monkeypatch):
    """One decode step of the smoke configuration at f32 on the card
    through the rmsnorm kernel (2·L + 1 launches, 2·L more under qk-norm)
    against the same step with the plain norm on the card: logits and
    cache at rtol 1e-5, atol 1e-5."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import registry as models
    cfg = dataclasses.replace(get_arch(arch).smoke,
                              compute_dtype=torch.float32)
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(3), cfg)
    tok = torch.randint(0, cfg.vocab, (2, 1), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(4))
    out = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(rn, "rmsnorm", rn.rmsnorm_plain)
        cache = models.init_cache(cfg, 2, 8, dtype=torch.float32,
                                  device="cuda")
        before = rn.LAUNCHES
        for _ in range(3):                   # the third step reads two slots
            logits, cache = models.decode_step(params, cfg, tok, cache)
        torch.cuda.synchronize()
        out[route] = (logits, cache, rn.LAUNCHES - before)
    norms = 2 * cfg.n_layers + 1 + (2 * cfg.n_layers if cfg.qk_norm else 0)
    assert out["kernel"][2] == 3 * norms and out["plain"][2] == 0
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=1e-5,
                               atol=1e-5)
    for key in ("k", "v"):
        torch.testing.assert_close(out["kernel"][1][key],
                                   out["plain"][1][key], rtol=1e-5,
                                   atol=1e-5)
    assert int(out["kernel"][1]["idx"]) == 3


# ---------------------------------------------------------------------------
# the model families, long context and the federated CNN (smoke width)
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["whisper-tiny", "phi3.5-moe-42b-a6.6b", "dbrx-132b",
                "falcon-mamba-7b", "chameleon-34b", "zamba2-2.7b"]
DENSE_ARCHS = ["tinyllama-1.1b", "h2o-danube-1.8b", "gpt2-large",
               "qwen2.5-14b", "qwen3-32b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS + DENSE_ARCHS)
def test_family_decode_equals_forward_on_card(arch):
    """12 teacher-forced decode steps at f32 on the card against the full
    forward (5e-3; the MoE at capacity_factor 8.0), the rmsnorm kernel's
    launches a step equal to the config's count of norms. A sliding
    window's ring of slots wraps over 14 steps. A dense model's cache
    holds as many slots as its window (or steps), and where its KV heads
    are grouped, the grouped decode equals the expanded one (2e-5) over
    10 steps."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import encdec
    from repro_torch.models import registry as models
    cfg = dataclasses.replace(get_arch(arch).smoke,
                              compute_dtype=torch.float32)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    steps = 14 if cfg.sliding_window else 12
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = models.init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab, (2, steps), generator=gen,
                         device="cuda")
    batch = {"tokens": toks}
    with torch.inference_mode():
        if models.is_encdec(cfg):
            batch["frames"] = torch.randn(
                (2, cfg.encoder_seq, cfg.frontend_dim or cfg.d_model),
                generator=gen, device="cuda")
            cache = encdec.init_cache(cfg, 2, steps, params=params,
                                      frames=batch["frames"],
                                      dtype=torch.float32, device="cuda")
        else:
            cache = models.init_cache(cfg, 2, steps, dtype=torch.float32,
                                      device="cuda")
        full = models.forward(params, cfg, batch)
        outs, per_step = [], []
        for i in range(steps):
            before = rn.LAUNCHES
            lg, cache = models.decode_step(params, cfg, toks[:, i:i + 1],
                                           cache)
            per_step.append(rn.LAUNCHES - before)
            outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=5e-3,
                               atol=5e-3)
    assert per_step == [models.norms_per_decode_step(cfg)] * steps
    if arch not in DENSE_ARCHS:
        return
    assert cache["k"].shape[2] == (cfg.sliding_window or steps)
    if cfg.n_kv_heads < cfg.n_heads:
        grouped = dataclasses.replace(cfg, decode_grouped_attn=True)
        caches = [models.init_cache(c, 2, 10, torch.float32, "cuda")
                  for c in (cfg, grouped)]
        with torch.inference_mode():
            for i in range(10):
                l1, caches[0] = models.decode_step(params, cfg,
                                                   toks[:, i:i + 1],
                                                   caches[0])
                l2, caches[1] = models.decode_step(params, grouped,
                                                   toks[:, i:i + 1],
                                                   caches[1])
                torch.testing.assert_close(l2, l1, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "h2o-danube-1.8b"])
def test_long_context_paths_equal_dense_on_card(arch, monkeypatch):
    """The chunked and 2-D causal paths against the dense forward at f32 on
    the card (S = 64, chunk 16; 1e-4); the 2-D path runs in every
    layer."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import layers
    from repro_torch.models import registry as models
    cfg = dataclasses.replace(get_arch(arch).smoke,
                              compute_dtype=torch.float32, attn_chunk=0)
    gen = torch.Generator(device="cuda").manual_seed(6)
    params = models.init_params(gen, cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, 64), generator=gen,
                                     device="cuda")}
    with torch.inference_mode():
        dense = models.forward(params, cfg, batch)
        chunked = models.forward(params, dataclasses.replace(
            cfg, attn_chunk=16), batch)
        calls = []
        tile = layers.attention_causal_2d
        monkeypatch.setattr(layers, "attention_causal_2d",
                            lambda *a, **kw: calls.append(1) or tile(*a, **kw))
        tiled = models.forward(params, dataclasses.replace(
            cfg, attn_chunk=16, attn_causal_skip=True), batch)
    assert len(calls) == cfg.n_layers
    torch.testing.assert_close(chunked, dense, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(tiled, dense, rtol=1e-4, atol=1e-4)


def _cnn_rounds(topology, rounds, device):
    """The reference's e2e loop (``tests/test_fl_e2e.py``: 4 clients, 4
    shards, 4 local steps at lr 0.05, momentum 0.9, batch 32) on
    ``device``, batched engine, from the CPU generator's seeded weights:
    the flat parameters after ``rounds`` rounds, the test accuracy after
    each, and the fused-SGD and fold launches."""
    from repro_torch.core import aggregation as agg
    from repro_torch.core.fedavg import apply_delta, local_sgd_update, \
        model_delta
    from repro_torch.core.sharding import flatten, unflatten
    from repro_torch.data import SyntheticVision
    from repro_torch.models import cnn
    from repro_torch.serverless import LambdaRuntime
    from repro_torch.store import ObjectStore
    cfg = cnn.CNNConfig(n_classes=4, channels=(8, 16), blocks_per_stage=1,
                        img_size=8)
    data = SyntheticVision(n_classes=4, img_size=8, seed=0, noise=0.4)
    params = {k: v.to(device) for k, v in cnn.init_params(
        torch.Generator().manual_seed(0), cfg).items()}
    store, rt = ObjectStore(), LambdaRuntime()
    sgd_before, fold_before = sgd.LAUNCHES, fs.LAUNCHES
    accs = []
    for rnd in range(rounds):
        flats, spec = [], None
        for c in range(4):
            local = {k: v.clone() for k, v in params.items()}
            vel = None
            for step in range(4):
                batch = data.batch(c, rnd * 10 + step, 32, device=device)
                local, vel, _ = local_sgd_update(
                    lambda p, b: cnn.loss_fn(p, cfg, b), local, batch,
                    lr=0.05, momentum=0.9, velocity=vel)
            flat, spec = flatten(model_delta(params, local))
            flats.append(flat)
        r = agg.aggregate_round(topology, flats, rnd=rnd, store=store,
                                runtime=rt, n_shards=4, codec="identity",
                                engine="batched")
        params = apply_delta(params, unflatten(r.avg_flat, spec))
        with torch.no_grad():
            _, m = cnn.loss_fn(params, cfg, data.batch(99, 999, 128,
                                                       device=device))
        accs.append(float(m["acc"]))
    if device == "cuda":
        torch.cuda.synchronize()
    return (flatten(params)[0], accs, sgd.LAUNCHES - sgd_before,
            fs.LAUNCHES - fold_before)


def _cnn_on_card(monkeypatch):
    """The convolutions in f32 with cuDNN's deterministic algorithms, so
    that runs train the same client deltas and only the aggregation
    differs, as on the CPU."""
    _need_card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)


@pytest.mark.cuda
def test_federated_cnn_rounds_on_card(monkeypatch):
    """Two rounds of the federated CNN (the reference's e2e config) on the
    card under each topology, batched engine: the same model (1e-4 /
    1e-5), fused-SGD launched once a leaf a local step (8 leaves), the
    fold kernel launched."""
    _cnn_on_card(monkeypatch)
    finals = []
    for topology in smoke.TOPOLOGIES:
        flat, _, sgd_launches, folds = _cnn_rounds(topology, 2, "cuda")
        assert sgd_launches == 8 * 4 * 4 * 2
        assert folds > 0
        finals.append(flat)
    for other in finals[1:]:
        torch.testing.assert_close(other, finals[0], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_federated_cnn_learns_and_equals_cpu_on_card(monkeypatch):
    """Six GradsSharding rounds of the federated CNN on the card end above
    0.5 test accuracy (and not below the first round's by more than
    0.05), and two rounds on the card equal the same rounds on the CPU
    (rtol 1e-4, atol 1e-5)."""
    _cnn_on_card(monkeypatch)
    _, accs, _, _ = _cnn_rounds("gradssharding", 6, "cuda")
    assert accs[-1] > 0.5 and accs[-1] >= accs[0] - 0.05, accs
    on_card = _cnn_rounds("gradssharding", 2, "cuda")[0]
    on_cpu = _cnn_rounds("gradssharding", 2, "cpu")[0]
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The single-program trainer and the host_mesh engine on one card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_one_rank_nccl_trainer_on_card():
    """One rank of an NCCL group, mesh (1, 1): the three plans from the
    same smoke parameters agree (losses within 1e-5, parameters within
    rtol 5e-4 / atol 1e-4), and the shard_map step with qsgd8 launches
    quantize, dequantize and fused-SGD once each and rmsnorm 5 times (a
    2-layer forward)."""
    import dataclasses

    from repro_torch.config import ShapeConfig, ShardingPlan
    from repro_torch.configs import get_arch
    from repro_torch.core.sharding import flatten
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry as models
    from repro_torch.optim import adamw

    _need_card()
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").smoke, remat=False,
                              compute_dtype=torch.float32)
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (8, 17),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1].cuda(), "labels": toks[:, 1:].cuda()}
    shape = ShapeConfig("t", seq_len=16, global_batch=8, kind="train")
    opt = adamw(1e-3, grad_clip_norm=1.0)
    outs = {}
    for gs in T.PLANS:
        plan = ShardingPlan(grad_sharding=gs)
        step = T.jit_train_step(cfg, shape, mesh, plan, opt, None,
                                donate=False)
        new, state, m = step(params, opt.init(params), batch)
        new, _ = T.gather_state(cfg, mesh, plan, new, state)
        outs[gs] = (flatten(new)[0], float(m["loss"]))
    for gs in ("zero1", "zero3"):
        assert abs(outs[gs][1] - outs["none"][1]) < 1e-5
        torch.testing.assert_close(outs[gs][0], outs["none"][0],
                                   rtol=5e-4, atol=1e-4)
    before = (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES, sgd.LAUNCHES,
              rn.LAUNCHES)
    step, init_v = T.make_shardmap_train_step(cfg, mesh, lr=0.05,
                                              momentum=0.9, compress="qsgd8")
    _, v, loss = step(params, init_v(params), batch)
    torch.cuda.synchronize()
    after = (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES, sgd.LAUNCHES,
             rn.LAUNCHES)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1, 5]
    assert torch.isfinite(loss) and bool(torch.any(v != 0))
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("topology", smoke.TOPOLOGIES)
def test_host_mesh_round_on_card(topology):
    """engine="host_mesh" on every visible card: the fold kernel's
    no-divide form on each column slice, then one divide, bit for bit
    the streaming engine's round."""
    from repro_torch.core.topology import run_round
    from repro_torch.serverless.runtime import LambdaRuntime
    from repro_torch.store import ObjectStore

    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    grads = [torch.randn(100_003, generator=g, device="cuda")
             for _ in range(9)]
    ref = run_round(topology, grads, rnd=0, store=ObjectStore(),
                    runtime=LambdaRuntime(), engine="streaming", n_shards=4)
    before = fs.LAUNCHES
    got = run_round(topology, grads, rnd=0, store=ObjectStore(),
                    runtime=LambdaRuntime(), engine="host_mesh", n_shards=4)
    assert fs.LAUNCHES > before
    assert _bits(got.avg_flat).equal(_bits(ref.avg_flat))


# ---------------------------------------------------------------------------
# Tensor parallelism's serving path at model = 1 on one card
# ---------------------------------------------------------------------------

def _meshed_against_meshless(cfg, params, batch, max_len, steps, dtype):
    """make_serve_step on a one-rank NCCL group's (1, 1) mesh, none plan,
    against the mesh-less step over ``steps`` decode steps, the cache in
    ``dtype`` (None: serving's bf16): the logits and every cache leaf bit
    for bit (an encoder-decoder's cross-attention cache built under the
    mesh from the same frames), the rmsnorm launches of each step equal to
    the config's count of norms on both, and no launch of the split route
    (at model = 1 the TP wrappers take no op and no row splits)."""
    from repro_torch.config import ShapeConfig, ShardingPlan
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import encdec, meshctx
    from repro_torch.models import registry as models

    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    try:
        shape = ShapeConfig("serve", seq_len=max_len, global_batch=batch,
                            kind="decode")
        family = encdec if models.is_encdec(cfg) else models
        kw = {} if dtype is None else {"dtype": dtype}
        like = family.cache_specs(cfg, batch, max_len, **kw)
        steps_fns = [serve.make_serve_step(cfg, shape, mesh, like,
                                           ShardingPlan(grad_sharding="none")),
                     serve.make_serve_step(cfg, shape, cache_like=like)]
        frames = torch.randn((batch, cfg.encoder_seq, cfg.frontend_dim
                              or cfg.d_model), device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(2))

        def cache():
            if family is encdec:
                return encdec.init_cache(cfg, batch, max_len, params=params,
                                         frames=frames, device="cuda", **kw)
            return models.init_cache(cfg, batch, max_len, device="cuda",
                                     **kw)

        with meshctx.use_mesh(mesh):
            caches = [cache()]
        caches.append(cache())
        toks = torch.randint(0, cfg.vocab, (batch, steps), device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(1))
        split_before = rn.SPLIT_LAUNCHES
        for i in range(steps):
            outs, launches = [], []
            for j, step in enumerate(steps_fns):
                before = rn.LAUNCHES
                logits, caches[j] = step(params, toks[:, i:i + 1], caches[j])
                launches.append(rn.LAUNCHES - before)
                outs.append(logits)
            assert launches[0] == launches[1] == \
                models.norms_per_decode_step(cfg)
            assert torch.equal(outs[0], outs[1]), f"step {i}"
        assert rn.SPLIT_LAUNCHES == split_before

        def leaves(tree, prefix=""):
            for k, v in sorted(tree.items()):
                if isinstance(v, dict):
                    yield from leaves(v, prefix + k + ".")
                else:
                    yield prefix + k, v

        for (ka, x), (kb, y) in zip(leaves(caches[0]), leaves(caches[1])):
            assert ka == kb and torch.equal(x, y), ka
        assert int(caches[0]["idx"]) == steps
    finally:
        torch.distributed.destroy_process_group()


def _model1_case(arch, width, dtype):
    """``arch``'s config at ``width`` (``smoke`` or ``model``), remat off,
    its compute type ``dtype`` (None: as registered), and its parameters
    from a seeded generator on the card, cast for serving when ``dtype``
    is None."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import registry as models

    over = {} if dtype is None else {"compute_dtype": dtype}
    cfg = dataclasses.replace(getattr(get_arch(arch), width), remat=False,
                              **over)
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    if dtype is None:
        params = serve.cast_for_serving(params, cfg)
    return cfg, params


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-32b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_model1_serve_step_is_the_meshless_step_on_card(arch):
    """make_serve_step on a one-rank NCCL group's (1, 1) mesh, none plan,
    at the smoke config (f32 compute, f32 cache): 12 decode steps equal
    the mesh-less step bit for bit (logits and cache), and launch rmsnorm
    as often (the TP wrappers take no op at model = 1)."""
    _need_card()
    cfg, params = _model1_case(arch, "smoke", torch.float32)
    _meshed_against_meshless(cfg, params, 2, 16, 12, torch.float32)


@pytest.mark.cuda
def test_full_width_model1_serve_step_is_the_meshless_step_on_card():
    """tinyllama-1.1b at full width (1.1 B parameters, f32 compute, f32
    cache) on the (1, 1) mesh: serving's 23 steps at batch 4 equal the
    mesh-less step bit for bit, 45 rmsnorm launches a step."""
    _need_card()
    cfg, params = _model1_case("tinyllama-1.1b", "model", torch.float32)
    _meshed_against_meshless(cfg, params, 4, 64, 23, torch.float32)


# ---------------------------------------------------------------------------
# Tensor parallelism for the SSM, hybrid and encoder-decoder families
# ---------------------------------------------------------------------------

SPLIT_ROWS = [(4, 1280, 4), (4, 2560, 2), (1024, 1280, 4), (3, 40, 5),
              (5, 2047, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,blocks", SPLIT_ROWS)
def test_rmsnorm_split_route_within_tolerance_on_card(rows, d, blocks,
                                                      dtype):
    """The split route (Mamba-2's gated norm under TP): each block's sum of
    squares against its plain version (rtol 1e-5), the blocks' scale
    launches on the summed squares against their plain version and,
    joined, against the whole-row kernel (f32: rtol 1e-5, atol 1e-6; bf16:
    one ulp); one block with its own sum bit for bit the whole-row kernel;
    two launches a block, counted in SPLIT_LAUNCHES only. Widths without
    16-byte vectors (40 f32 blocks, 2047) included."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(rows + d)
    width = d * blocks
    x = (torch.randn(rows, width, generator=g, device="cuda") * 3).to(dtype)
    gamma = torch.randn(width, generator=g, device="cuda")
    cuts = [slice(i * d, (i + 1) * d) for i in range(blocks)]
    before, split_before = rn.LAUNCHES, rn.SPLIT_LAUNCHES
    ssq = [rn.rmsnorm_sumsq(x[:, c]) for c in cuts]
    total = torch.stack(ssq).sum(0)
    outs = [rn.rmsnorm_scale(x[:, c], total, gamma[c], 1e-5, width)
            for c in cuts]
    torch.cuda.synchronize()
    assert rn.SPLIT_LAUNCHES - split_before == 2 * blocks
    assert rn.LAUNCHES == before
    for c, s in zip(cuts, ssq):
        want = rn.rmsnorm_sumsq_plain(x[:, c])
        assert bool(((s - want).abs() <= 1e-5 * want.abs()).all())

    def close(got, want):
        if dtype == torch.bfloat16:
            bits = lambda t: t.view(torch.int16).to(torch.int32)
            ordered = lambda t: torch.where(bits(t) < 0, -(bits(t) & 0x7FFF),
                                            bits(t))
            return int((ordered(got) - ordered(want)).abs().max()) <= 1
        return bool(((got - want).abs() <= 1e-6 + 1e-5 * want.abs()).all())

    for c, (out, rstd) in zip(cuts, outs):
        want, want_rstd = rn.rmsnorm_scale_plain(x[:, c], total, gamma[c],
                                                 1e-5, width)
        assert close(out, want)
        assert bool(((rstd - want_rstd).abs() <= 1e-5 * want_rstd).all())
    if width <= rn.MAX_D:
        whole, _ = rn.rmsnorm(x, gamma)
        assert close(torch.cat([o for o, _ in outs], dim=1), whole)
    one, _ = rn.rmsnorm(x[:, cuts[0]], gamma[cuts[0]])
    alone, _ = rn.rmsnorm_scale(x[:, cuts[0]], rn.rmsnorm_sumsq(
        x[:, cuts[0]]), gamma[cuts[0]], 1e-5, d)
    assert torch.equal(alone, one)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_family_model1_serve_step_is_the_meshless_step_on_card(arch):
    """The SSM, hybrid and encoder-decoder families' make_serve_step on a
    one-rank NCCL group's (1, 1) mesh, none plan, at the smoke config (f32
    compute, f32 cache; whisper's cross-attention cache built under the
    mesh from the same frames): 12 decode steps equal the mesh-less step
    bit for bit (logits and every cache leaf), with as many rmsnorm
    launches and no split-route launch (model = 1 splits nothing)."""
    _need_card()
    cfg, params = _model1_case(arch, "smoke", torch.float32)
    _meshed_against_meshless(cfg, params, 2, 16, 12, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_serving_model1_step_is_the_meshless_step_on_card(arch):
    """The same families as served: the parameters cast for serving, bf16
    compute and cache, serving's 23 steps at batch 4 on the (1, 1) mesh
    equal the mesh-less step bit for bit, every cache leaf included."""
    _need_card()
    cfg, params = _model1_case(arch, "smoke", None)
    _meshed_against_meshless(cfg, params, 4, 64, 23, None)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 7, 16, 255, 256])
def test_assoc_scan_chunk_on_card_equals_cpu(c):
    """Mamba-1's associative scan (`ssm._assoc_scan_chunk`) on the card
    equals the CPU's bit for bit on the same inputs: its `*` and `+` run as
    separate kernels on both, with no contraction; and `mamba1_ssm`'s
    gradients on the card within 1e-5 · max |want| of the CPU's (the `exp`
    and the einsum with C may round apart)."""
    from repro_torch.models import ssm

    _need_card()
    gen = torch.Generator().manual_seed(c)
    da = torch.exp(-0.2 * torch.rand((2, c, 64, 16), generator=gen))
    db = torch.randn((2, c, 64, 16), generator=gen)
    h0 = torch.randn((2, 64, 16), generator=gen)
    want = ssm._assoc_scan_chunk(da, db, h0)
    got = ssm._assoc_scan_chunk(da.cuda(), db.cuda(), h0.cuda())
    for g, w in zip(got, want):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
    s = 2 * c
    ins = [0.02 * torch.rand((2, s, 64), generator=gen),
           torch.randn((2, s, 16), generator=gen),
           torch.randn((2, s, 16), generator=gen),
           torch.randn((2, s, 64), generator=gen),
           -torch.rand((64, 16), generator=gen) - 0.5, h0]
    grads = []
    for dev in ("cpu", "cuda"):
        ts = [t.detach().to(dev).requires_grad_() for t in ins]
        y, h = ssm.mamba1_ssm(*ts, c)
        (y.sum() + h.sum()).backward()
        grads.append([t.grad.cpu() for t in ts])
    for g, w in zip(grads[1], grads[0]):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


# ---------------------------------------------------------------------------
# the causal attention kernel (csrc/causal_attention.cu)
# ---------------------------------------------------------------------------

ATTN_SHAPES = {"one_token": (1, 1, 1, 1, 64), "mqa_short": (1, 7, 2, 1, 64),
               "ragged128": (1, 65, 2, 2, 128), "gqa64": (2, 130, 4, 2, 64),
               "gpt2_large": (4, 1024, 20, 20, 64),
               "gqa128_ragged": (2, 1000, 32, 8, 128)}


def _attn_inputs(shape, seed=11):
    b, s, h, kh, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *sh: torch.randn(*sh, generator=g, device="cuda").to(
        torch.bfloat16)
    return mk(b, s, h, d), mk(b, s, kh, d), mk(b, s, kh, d), mk(b, s, h, d)


def _attn_grads(fn, q, k, v, do, dtype):
    leaves = [t.detach().clone().to(dtype).requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    out.backward(do.to(dtype))
    return [out.detach().float()] + [t.grad.float() for t in leaves]


def _attn_dense(q, k, v):
    from repro_torch.models import layers
    pos = torch.arange(q.shape[1], device=q.device)
    return layers.attention_dense(q, k, v, q_pos=pos, k_pos=pos, causal=True)


def _gap(a, b):
    n = float(b.norm())
    return float((a - b).norm()) / n if n > 0 else float((a - b).norm())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ATTN_SHAPES))
def test_causal_attention_no_further_from_f32_than_dense_on_card(name):
    """The kernels' output and three gradients are no further (relative
    norm) from an f32 attention on the same bf16 values than
    ``attention_dense`` at bf16 is, with 10 % room: the two round at the
    same points and sum in other orders. Two runs give the same bits; a
    forward is one launch and a backward two."""
    from repro_torch.kernels import causal_attention as ca

    _need_card()
    q, k, v, do = _attn_inputs(ATTN_SHAPES[name])
    exact = _attn_grads(_attn_dense, q, k, v, do, torch.float32)
    dense = _attn_grads(_attn_dense, q, k, v, do, torch.bfloat16)
    before = ca.LAUNCHES
    kernel = _attn_grads(ca.causal_attention, q, k, v, do, torch.bfloat16)
    again = _attn_grads(ca.causal_attention, q, k, v, do, torch.bfloat16)
    torch.cuda.synchronize()
    assert ca.LAUNCHES == before + 6
    for got, ref, want in zip(kernel, dense, exact):
        assert _gap(got, want) <= 1.1 * _gap(ref, want) + 1e-7
    for a, b in zip(kernel, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ragged128", "gqa64"])
def test_causal_attention_kernels_match_their_plain_versions_on_card(name):
    """Each kernel against its plain version on the same inputs: o within
    1e-3 (relative norm) and one bf16 ulp of its largest value, the row
    max and sum to f32 round-off, and the gradients from the same m and l
    within 1e-3 (relative norm): the products sum in other orders, so a
    sum that cancels near zero may round apart by more than its own
    ulp."""
    from repro_torch.kernels import causal_attention as ca

    _need_card()
    q, k, v, do = _attn_inputs(ATTN_SHAPES[name], seed=12)
    o, m, l = ca.forward(q, k, v)
    po, pm, pl = ca.forward_plain(q, k, v)
    assert _gap(o.float(), po.float()) <= 1e-3
    assert float((o.float() - po.float()).abs().max()) <= 2 ** -7 * float(
        po.float().abs().max())
    torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, pl, rtol=1e-5, atol=0)
    for got, want in zip(ca.backward(q, k, v, do, m, l),
                         ca.backward_plain(q, k, v, do, m, l)):
        assert _gap(got.float(), want.float()) <= 1e-3


@pytest.mark.cuda
def test_causal_attention_copies_strided_and_misaligned_views_on_card():
    """The kernels read contiguous, 16-byte aligned tensors only:
    ``forward`` raises on a head slice of a packed (B, S, 3, H, D) tensor,
    and ``causal_attention`` copies such slices and a view 2 bytes off
    alignment, giving the contiguous inputs' bits."""
    from repro_torch.kernels import causal_attention as ca

    _need_card()
    q, k, v, do = _attn_inputs((2, 130, 4, 4, 64), seed=13)
    want = _attn_grads(ca.causal_attention, q, k, v, do, torch.bfloat16)
    packed = torch.stack([q, k, v], dim=2)
    views = [packed[:, :, i] for i in range(3)]
    assert not views[0].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ca.forward(*views)
    leaves = [t.detach().requires_grad_() for t in views]
    out = ca.causal_attention(*leaves)
    out.backward(do)
    got = [out.float()] + [t.grad.float() for t in leaves]
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    off = flat[1:].view(q.shape)
    off.copy_(q)
    assert off.data_ptr() % 16
    out2 = ca.causal_attention(off, k, v)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(out2.float(), want[0])


@pytest.mark.cuda
def test_layers_attention_routes_bf16_causal_self_attention_on_card():
    """``layers.attention`` sends bf16 causal self-attention at head dim 64
    to the kernel (one launch), and f32, windowed and cross attention down
    the dense path (none)."""
    from repro_torch.kernels import causal_attention as ca
    from repro_torch.models import layers

    _need_card()
    q, k, v, _ = _attn_inputs((2, 64, 4, 2, 64), seed=14)
    pos = torch.arange(64, device="cuda")
    before = ca.LAUNCHES
    out = layers.attention(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                           chunk=2048)
    assert ca.LAUNCHES == before + 1
    assert _gap(out.float(), _attn_dense(q, k, v).float()) <= 1e-2
    layers.attention(q.float(), k.float(), v.float(), q_pos=pos, k_pos=pos)
    layers.attention(q, k, v, q_pos=pos, k_pos=pos, window=16)
    layers.attention(q, k[:, :32], v[:, :32], q_pos=pos,
                     k_pos=torch.arange(32, device="cuda"))
    assert ca.LAUNCHES == before + 1


# ---------------------------------------------------------------------------
# the RoPE kernel (csrc/rope.cu)
# ---------------------------------------------------------------------------

ROPE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
               "f16": torch.float16}
ROPE_INTS = {2: torch.int16, 4: torch.int32}


def _rope_same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(ROPE_INTS[a.element_size()]),
        b.view(ROPE_INTS[b.element_size()]))


def _rope_grads(fn, base, view_of, dout):
    """fn's output and the gradient autograd takes through it, for the
    view ``view_of(base)`` of a fresh leaf copy of base."""
    leaf = base.detach().clone().requires_grad_()
    out = fn(view_of(leaf))
    out.backward(dout)
    return out.detach(), view_of(leaf.grad)


def _rope_inputs(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda: (4 * torch.randn(*shape, generator=g, device="cuda")).to(
        dtype)
    return mk(), mk()


@pytest.mark.cuda
@pytest.mark.parametrize("pos", ["arange", "decode", "one_for_all"])
@pytest.mark.parametrize("hd", [64, 80, 96, 128, 72])
@pytest.mark.parametrize("dtype", list(ROPE_DTYPES))
def test_rope_kernel_bit_equal_plain_on_card(dtype, hd, pos):
    """``layers.apply_rope`` on the card (one launch forward, one
    backward) against the plain chain and autograd through it, bit for
    bit: positions arange(S), one decode position at S = 1, and one
    position for every row. 72 leaves 16-byte vectors of bf16 and f16 (36
    values a half, 72 bytes) to the scalar path."""
    from repro_torch.kernels import rope
    from repro_torch.models import layers

    _need_card()
    s = 1 if pos == "decode" else 37
    x, dout = _rope_inputs((3, s, 5, hd), ROPE_DTYPES[dtype], seed=hd)
    positions = (torch.arange(s, device="cuda") if pos == "arange"
                 else torch.tensor([4097], device="cuda"))
    before = rope.LAUNCHES
    got = _rope_grads(lambda t: layers.apply_rope(t, positions, 10000.0),
                      x, lambda t: t, dout)
    torch.cuda.synchronize()
    assert rope.LAUNCHES == before + 2
    want = _rope_grads(lambda t: rope.apply_rope_plain(t, positions,
                                                       10000.0),
                       x, lambda t: t, dout)
    for a, b in zip(got, want):
        assert _rope_same_bits(a, b)


@pytest.mark.cuda
def test_rope_kernel_plain_route_for_views_that_are_not_contiguous_on_card():
    """A head slice of a packed (B, S, 3, H, hd) tensor and a view whose
    last dim is strided take the plain chain (no launch); a contiguous
    view 2 bytes off alignment takes the kernel's scalar path. All give
    the plain chain's bits. A gradient with stride 0 (``out.sum()``'s) is
    made contiguous before the backward launch."""
    from repro_torch.kernels import rope
    from repro_torch.models import layers

    _need_card()
    x, dout = _rope_inputs((2, 40, 4, 64), torch.bfloat16, seed=3)
    positions = torch.arange(40, device="cuda")
    routed = lambda t: layers.apply_rope(t, positions, 10000.0)
    plain = lambda t: rope.apply_rope_plain(t, positions, 10000.0)
    want = _rope_grads(plain, x, lambda t: t, dout)
    flat = torch.cat([x.new_zeros(1), x.reshape(-1)])
    cases = [(torch.stack([x, x, x], dim=2), lambda t: t[:, :, 1], 0),
             (torch.stack([x, x], dim=-1), lambda t: t[..., 0], 0),
             (flat, lambda t: t[1:].view(x.shape), 2)]
    for base, view_of, launches in cases:
        before = rope.LAUNCHES
        got = _rope_grads(routed, base, view_of, dout)
        torch.cuda.synchronize()
        assert rope.LAUNCHES - before == launches
        for a, b in zip(got, want):
            assert _rope_same_bits(a, b)
    summed = [_rope_grads(fn, x, lambda t: t, torch.ones_like(x[0, 0, 0, 0]))
              for fn in (lambda t: routed(t).sum(), lambda t: plain(t).sum())]
    assert _rope_same_bits(summed[0][1], summed[1][1])


@pytest.mark.cuda
def test_rope_launches_and_tables_of_a_gpt2_shaped_step_on_card():
    """One local SGD step of a model with GPT-2 Large's 36 layers and
    64-wide heads (narrow otherwise; bf16 products, no remat): 144 RoPE
    launches (36 layers × q and k × forward and backward) and one
    table."""
    import dataclasses
    from repro_torch.configs.paper_workloads import GPT2_LARGE_MODEL
    from repro_torch.core.fedavg import local_sgd_update
    from repro_torch.kernels import rope
    from repro_torch.models import registry as models

    _need_card()
    cfg = dataclasses.replace(GPT2_LARGE_MODEL, d_model=128, n_heads=2,
                              n_kv_heads=2, d_ff=256, vocab=256, remat=False)
    gen = torch.Generator(device="cuda").manual_seed(8)
    params = models.init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    launches, builds = rope.LAUNCHES, rope.TABLE_BUILDS
    _, _, loss = local_sgd_update(lambda p, b: models.loss_fn(p, cfg, b),
                                  params, batch, lr=0.01, momentum=0.9)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert rope.LAUNCHES - launches == 144
    assert rope.TABLE_BUILDS - builds == 1


# ---------------------------------------------------------------------------
# the examples through their entry points on the card
# ---------------------------------------------------------------------------

# (example, extra arguments, (kernel module, counter) the run must launch)
EXAMPLE_RUNS = {
    "quickstart": ("quickstart", [], (fs, "LAUNCHES")),
    "quickstart_qsgd8": ("quickstart", ["--schedule", "pipelined",
                                        "--readahead-k", "4", "--codec",
                                        "qsgd8"], (q, "QUANTIZE_LAUNCHES")),
    "faulty_round": ("faulty_round", [], None),
    "faulty_round_stale_hedge": ("faulty_round", [
        "--staleness-policy", "polynomial", "--hedge", "2"], None),
    "compression_composition": ("compression_composition", [],
                                (tk, "LAUNCHES")),
}


def _same_output(got, want, path=""):
    """Two examples' returned values alike in every key: arrays of the same
    dtype, shape and bits, numbers exactly (NaN as NaN)."""
    import math

    import numpy as np
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_output(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape \
            and got.tobytes() == want.tobytes(), path
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same_output(a, b, f"{path}[{i}]")
    elif not (isinstance(want, float) and math.isnan(want)
              and math.isnan(got)):
        assert got == want, f"{path}: {got!r} != {want!r}"


@pytest.mark.cuda
@pytest.mark.parametrize("run", list(EXAMPLE_RUNS))
def test_example_on_card_equals_cpu(run):
    """quickstart (at the reference's constants, plain and pipelined
    qsgd8), faulty_round (plain and stale/hedged) and
    compression_composition through their ``main`` with ``--device
    cuda``, their self-checks live: every value they return (means, puts,
    gets, billed GB-s, peak memory, walls, costs, arrivals, drops,
    retries, codec_error) equals the CPU's, bit for bit, and the run
    reaches its kernel."""
    import importlib
    _need_card()
    name, extra, counter = EXAMPLE_RUNS[run]
    module = importlib.import_module(f"repro_torch.examples.{name}")
    before = None if counter is None else getattr(*counter)
    got = module.main(extra + ["--device", "cuda"])
    if counter is not None:
        assert getattr(*counter) > before
    _same_output(got, module.main(extra + ["--device", "cpu"]))


@pytest.mark.cuda
def test_elastic_reshard_example_on_card():
    """elastic_reshard on the card: its self-checks (the model restored bit
    for bit after resharding) hold."""
    from repro_torch.examples import elastic_reshard
    _need_card()
    out = elastic_reshard.main(["--device", "cuda"])
    assert out["resumed_shard_sizes"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", arch_ids())
def test_serve_sharded_example_on_card(arch):
    """serve_sharded for each registered arch on the card (its smoke
    config): 24 new tokens for 4 prompts, the rmsnorm kernel launched
    once a norm a decode step (and once a norm of an encoder's one run)."""
    from repro_torch.examples import serve_sharded
    from repro_torch.models import registry as models
    _need_card()
    cfg = get_arch(arch).smoke
    steps = 8 + 24 - 1                   # prompt_len + new tokens - 1
    encoder = 2 * cfg.encoder_layers + 1 if models.is_encdec(cfg) else 0
    before = rn.LAUNCHES
    got = serve_sharded.main(["--arch", arch, "--device", "cuda"])
    assert rn.LAUNCHES - before == \
        models.norms_per_decode_step(cfg) * steps + encoder
    assert got["generated"].shape == (4, 24)
