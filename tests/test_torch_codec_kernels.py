"""The port's codec kernels (`repro_torch.kernels.quantize`,
`repro_torch.kernels.topk_sparsify`) against the JAX package.

The plain PyTorch versions, which the wrappers run for CPU tensors, are
held bit for bit against the reference on the same seeded numpy inputs:

* its numpy mirrors (`repro.core.wire_codec.Qsgd8Codec.encode` /
  `decode` / `decode_range`, `TopkCodec._sparsify`);
* its Pallas kernels in interpret mode (`repro.kernels.ops.qsgd_compress`,
  `qsgd_decompress`, `topk_sparsify` with `interpret=True`).

Then the cases where rounding and tiling show: exact .5 quotients (half to
even), an all-zero tile, a tile with fewer than k nonzeros, -0.0,
subnormals, values near the f32 maximum, and tiles with NaN and ±inf. A
numpy model of the CUDA top-k kernel's narrowed search is held bit for bit
against the reference's mirror. The CUDA kernels are held against the
plain versions on a card, in `test_torch_cuda.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import wire_codec as ref_wc  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracle  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as q  # noqa: E402
from repro_torch.kernels import topk_sparsify as tk  # noqa: E402

SIZES = (0, 100, 4_096, 5_003, 12_288)
K = ref_wc.TopkCodec.k_per_block
TILE = ref_wc.TILE


def _x(size, seed=0):
    return np.random.default_rng([seed, size]).standard_normal(size) \
        .astype(np.float32)


def _special(case):
    """Inputs where rounding, zeros and the f32 range show."""
    rng = np.random.default_rng(11)
    if case == "half_to_even":
        # tile 0: amax 127, so scale 1.0 and every quotient ends in .5;
        # tile 1: amax 254, scale 2.0, odd integers halved
        x = np.empty(2 * TILE, np.float32)
        x[:TILE] = (np.arange(TILE) % 254) - 126.5
        x[0] = 127.0
        x[TILE:] = 2 * ((np.arange(TILE) % 127) - 63) + 1
        x[TILE] = 254.0
        return x
    if case == "zero_tiles":
        # an all-zero tile, a tile with 64 < k nonzeros, a run of -0.0,
        # and a ragged last tile
        x = rng.standard_normal(4 * TILE + 17).astype(np.float32)
        x[TILE:3 * TILE] = 0.0
        x[2 * TILE:3 * TILE:64] = rng.standard_normal(TILE // 64)
        x[3 * TILE:3 * TILE + 100] = -0.0
        return x
    if case == "subnormal":
        return (rng.standard_normal(3 * TILE + 5) * 1e-39).astype(np.float32)
    if case == "near_f32_max":
        x = (rng.uniform(3.0e38, 3.4e38, 2 * TILE + 9)
             * rng.choice([-1.0, 1.0], 2 * TILE + 9)).astype(np.float32)
        x[5] = np.finfo(np.float32).max
        return x
    if case == "nonfinite":
        # tile 0: NaN, +inf and -inf (amax NaN: scale 1, top-k keeps every
        # non-NaN); tile 1: clean; tile 2: ±inf without NaN (amax inf, so
        # inf / inf quotients); ragged tile 3: one NaN
        x = rng.standard_normal(3 * TILE + 33).astype(np.float32)
        x[[5, 700]] = np.nan
        x[9], x[100] = np.inf, -np.inf
        x[2 * TILE + 7], x[2 * TILE + 8] = np.inf, -np.inf
        x[3 * TILE + 4] = np.nan
        return x
    raise ValueError(case)


SPECIAL = ("half_to_even", "zero_tiles", "subnormal", "near_f32_max",
           "nonfinite")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _inputs(case):
    return _special(case) if isinstance(case, str) else _x(case)


CASES = SIZES + SPECIAL


# ---------------------------------------------------------------------------
# Plain versions == the reference's numpy mirrors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_quantize_plain_bit_equal_numpy_mirror(case):
    x = _inputs(case)
    with np.errstate(over="ignore"):
        want = ref_wc.get_codec("qsgd8").encode(x)
    codes, scales = q.quantize_plain(torch.from_numpy(x))
    _assert_bits(codes.numpy(), want.parts["codes"])
    _assert_bits(scales.numpy(), want.parts["scales"])


@pytest.mark.parametrize("case", CASES)
def test_dequantize_plain_bit_equal_numpy_mirror(case):
    x = _inputs(case)
    codec = ref_wc.get_codec("qsgd8")
    payload = codec.encode(x)
    codes = torch.from_numpy(payload.parts["codes"])
    scales = torch.from_numpy(payload.parts["scales"])
    with np.errstate(over="ignore"):
        _assert_bits(q.dequantize_plain(codes, scales).numpy(),
                     codec.decode(payload))
        n = x.size
        for a, b in ((0, n), (n // 3, n), (1, max(1, n - 7)),
                     (TILE - 1, min(n, 2 * TILE + 1))):
            if a <= b:
                _assert_bits(q.dequantize_plain(codes, scales, a, b).numpy(),
                             codec.decode_range(payload, a, b))


@pytest.mark.parametrize("case", CASES)
def test_topk_plain_bit_equal_numpy_mirror(case):
    x = _inputs(case)
    with np.errstate(over="ignore"):
        want = ref_wc.get_codec("topk")._sparsify(x)
    _assert_bits(tk.topk_plain(torch.from_numpy(x), K).numpy(), want)


# ---------------------------------------------------------------------------
# The CUDA top-k kernel's narrowed search == the reference's bisection
# ---------------------------------------------------------------------------

def _narrowed_topk(x, k, cap=256):
    """The search of `csrc/topk_sparsify.cu`, tile by tile in numpy: the
    reference's bisection, but once at most ``cap`` positive |x| lie in
    [lo, hi) the remaining steps count ``c(hi) + count(list >= mid)`` over
    those alone. While hi has not moved the list is every positive |x| >=
    lo and c(hi) is 0; a moved hi above 1e38 (lo + hi could overflow)
    keeps the steps tile-wide. amax is the largest bit pattern of |x| (NaN
    above inf). Returns the dense output and the tile-wide steps of each
    tile."""
    tiles = ref_wc._pad_tiles(x)
    out = np.empty_like(tiles)
    steps = []
    half, zero = np.float32(0.5), np.float32(0.0)
    least = np.array(1, np.int32).view(np.float32)[()]    # least subnormal
    for r, tile in enumerate(tiles):
        a = np.abs(tile)
        amax = np.array((tile.view(np.uint32) & np.uint32(0x7fffffff)).max()
                        ).view(np.float32)[()]
        lo, hi = zero, amax + np.float32(1e-12)
        c_lo, c_hi, moved, it = int((a > 0).sum()), 0, False, 0
        if np.isnan(amax):
            lo, it = (amax if k <= 0 else zero), ref_wc.BISECT_ITERS
        while it < ref_wc.BISECT_ITERS and (c_lo - c_hi > cap
                                            or (moved and hi > 1e38)):
            mid = half * (lo + hi)
            count = int((a >= mid).sum())
            if count >= k:
                lo, c_lo = mid, count
            else:
                hi, c_hi, moved = mid, count, True
            it += 1
        steps.append(it)
        if it < ref_wc.BISECT_ITERS:
            bound = hi if moved else np.float32(np.nan)
            cand = a[(a >= max(lo, least)) & ~(a >= bound)]
            assert cand.size <= cap
            for _ in range(it, ref_wc.BISECT_ITERS):
                mid = half * (lo + hi)
                if c_hi + int((cand >= mid).sum()) >= k:
                    lo = mid
                else:
                    hi = mid
        out[r] = np.where(a >= lo, tile, zero)
    return out.reshape(-1)[:x.size], steps


def _narrowing_input(case):
    rng = np.random.default_rng(17)
    if case == "heavy_tail":          # amax far above the threshold
        return rng.standard_cauchy(3 * TILE + 5).astype(np.float32)
    if case == "ties":                # few distinct magnitudes
        return np.round(rng.standard_normal(2 * TILE) * 4).astype(np.float32)
    return _inputs(case)


@pytest.mark.parametrize("k", [K, 1, 4_096, 0])
@pytest.mark.parametrize("case", CASES + ("heavy_tail", "ties"))
def test_narrowed_topk_bit_equal_bisection(case, k):
    """Bit for bit against the mirror at its k, and against the plain
    version (itself held to the mirror above) at the other k."""
    x = _narrowing_input(case)
    with np.errstate(over="ignore", invalid="ignore"):
        got, steps = _narrowed_topk(x, k)
        if k == K:
            want = ref_wc.get_codec("topk")._sparsify(x)
        else:
            want = tk.topk_plain(torch.from_numpy(x), k).numpy()
    _assert_bits(got, want)
    if case in (5_003, 12_288) and k == K:
        # whole Gaussian tiles narrow after a few block-wide steps
        assert max(steps[:x.size // TILE]) <= 4


# ---------------------------------------------------------------------------
# Plain versions == the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

PALLAS_CASES = tuple(s for s in SIZES if s) + SPECIAL


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_qsgd_plain_vs_pallas_interpret(case):
    """Codes, scales and the decode equal the Pallas kernels' bit for bit,
    except in tiles where XLA's CPU arithmetic (interpret mode) leaves
    IEEE: it rewrites the kernel's ``amax / 127`` as ``amax * (1/127)``,
    1 ulp off the quotient on some tiles, and it flushes subnormals to
    zero, so a tile of subnormals gets scale 1.0. The reference's numpy
    mirror, which the pinned hashes come from, and the port compute the
    IEEE quotient. Tiles that differ must be exactly XLA's form; the
    decode of the kernel's own payload stays bit-equal everywhere."""
    x = _inputs(case)
    codes, scales, n = ref_ops.qsgd_compress(x, interpret=True)
    p_codes = np.asarray(codes).reshape(-1)[:n]
    p_scales = np.asarray(scales).reshape(-1)
    got_codes, got_scales = (t.numpy() for t in
                             q.quantize_plain(torch.from_numpy(x)))
    same = got_scales.view(np.int32) == p_scales.view(np.int32)
    amax = np.abs(ref_wc._pad_tiles(x)).max(axis=1)
    xla = np.where(amax >= np.finfo(np.float32).tiny,
                   amax * (np.float32(1.0) / np.float32(127.0)),
                   np.float32(1.0))
    _assert_bits(p_scales[~same], xla[~same])
    if case != "subnormal":
        assert np.abs(got_scales.view(np.int32).astype(np.int64)
                      - p_scales.view(np.int32)).max() <= 1
    in_same = np.repeat(same, TILE)[:n]
    _assert_bits(got_codes[in_same], p_codes[in_same])
    _assert_bits(q.dequantize_plain(torch.from_numpy(p_codes.copy()),
                                    torch.from_numpy(p_scales.copy())).numpy(),
                 ref_ops.qsgd_decompress(codes, scales, n, interpret=True))


@pytest.mark.parametrize("size", [4_096, 5_003])
def test_qsgd_plain_bit_equal_pallas_where_the_reference_pins_it(size):
    """The inputs of the JAX package's own mirror-vs-kernel test
    (`tests/test_wire_codec.py`), where every scale is the IEEE quotient:
    codes, scales and decode all bit-equal."""
    x = np.random.default_rng(7).standard_normal(size).astype(np.float32)
    codes, scales, n = ref_ops.qsgd_compress(x, interpret=True)
    got_codes, got_scales = q.quantize_plain(torch.from_numpy(x))
    _assert_bits(got_codes.numpy(), np.asarray(codes).reshape(-1)[:n])
    _assert_bits(got_scales.numpy(), np.asarray(scales).reshape(-1))
    _assert_bits(q.dequantize_plain(got_codes, got_scales).numpy(),
                 ref_ops.qsgd_decompress(codes, scales, n, interpret=True))


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_topk_plain_bit_equal_pallas_interpret(case):
    x = _inputs(case)
    _assert_bits(tk.topk_plain(torch.from_numpy(x), K).numpy(),
                 ref_ops.topk_sparsify(x, K, interpret=True))


# ---------------------------------------------------------------------------
# The reference's kernel tests (`tests/test_kernels.py`), on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [4_096, 10_000, 131_072])
def test_qsgd_roundtrip_error_bound(length):
    x = torch.from_numpy(_x(length, seed=12))
    codes, scales, n = ops.qsgd_compress(x)
    back = ops.qsgd_decompress(codes, scales)
    assert codes.dtype == torch.int8 and n == length
    err = float((x - back).abs().max())
    assert err <= float(scales.max()) / 2 + 1e-7


def test_qsgd_matches_ref_oracle():
    """`ref.quantize_ref` / `dequantize_ref` with the reference's own
    tolerances (its divide by 127 is XLA's, see above)."""
    x = _x(8_192, seed=13)
    codes, scales = q.quantize_plain(torch.from_numpy(x))
    rc, rs = ref_oracle.quantize_ref(x.reshape(-1, 128))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rc).reshape(-1))
    np.testing.assert_allclose(scales.numpy(), np.asarray(rs).reshape(-1),
                               rtol=1e-6)
    np.testing.assert_allclose(
        q.dequantize_plain(codes, scales).numpy(),
        np.asarray(ref_oracle.dequantize_ref(rc, rs)).reshape(-1),
        rtol=1e-6)


def test_qsgd_zero_block_safe():
    codes, scales, _ = ops.qsgd_compress(torch.zeros(8_192))
    assert scales.tolist() == [1.0, 1.0]
    assert not ops.qsgd_decompress(codes, scales).any()


@pytest.mark.parametrize("k", [1, 10, 100, 1000])
def test_topk_keeps_k_per_block(k):
    x = _x(4_096, seed=14)
    out = ops.topk_sparsify(torch.from_numpy(x), k).numpy()
    nnz = int(np.count_nonzero(out))
    assert k <= nnz <= k + 8                  # bisection tie slack
    kept = np.abs(x)[out != 0].min()
    dropped = np.abs(x)[out == 0]
    if dropped.size:
        assert kept >= dropped.max() - 1e-6


def test_topk_matches_ref_oracle():
    """The sort-based oracle `ref.topk_sparsify_ref` (exact k-th largest
    threshold), bit for bit, as the reference's own test holds it."""
    x = _x(8_192, seed=15)
    _assert_bits(tk.topk_plain(torch.from_numpy(x), 64).numpy(),
                 np.asarray(ref_oracle.topk_sparsify_ref(
                     x.reshape(-1, 128), 64)).reshape(-1))


# ---------------------------------------------------------------------------
# What the cases are there to show
# ---------------------------------------------------------------------------

def test_half_quotients_round_to_even():
    codes, scales = q.quantize_plain(torch.from_numpy(_special(
        "half_to_even")))
    assert scales.tolist() == [1.0, 2.0]
    # 2.5 -> 2, 3.5 -> 4, -2.5 -> -2: half to even, not away from zero
    x = _special("half_to_even")
    for value, code in ((2.5, 2), (3.5, 4), (-2.5, -2), (-3.5, -4)):
        i = int(np.flatnonzero(x[:TILE] == value)[0])
        assert int(codes[i]) == code


def test_zero_tile_and_sparse_tile():
    x = _special("zero_tiles")
    codes, scales = q.quantize_plain(torch.from_numpy(x))
    assert float(scales[1]) == 1.0 and not codes[TILE:2 * TILE].any()
    dense = tk.topk_plain(torch.from_numpy(x), K).numpy()
    # an all-zero tile keeps nothing; a tile of 64 < k nonzeros keeps all
    assert not dense[TILE:2 * TILE].any()
    np.testing.assert_array_equal(dense[2 * TILE:3 * TILE],
                                  x[2 * TILE:3 * TILE])
    # a full tile keeps about k
    assert K <= np.count_nonzero(dense[:TILE]) <= K + 2


def test_ragged_tile_keeps_its_own_scale():
    """The ragged last tile is padded with zeros, which never raise its
    amax: its scale comes from its own elements."""
    x = _x(5_003)
    codes, scales = q.quantize_plain(torch.from_numpy(x))
    assert scales.shape == (2,) and codes.shape == (5_003,)
    assert float(scales[1]) == float(np.float32(np.abs(x[TILE:]).max())
                                     / np.float32(127.0))


# ---------------------------------------------------------------------------
# The wrappers: CPU tensors take the plain versions, no launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
def test_wrappers_route_cpu_tensors_to_plain(size):
    x = torch.from_numpy(_x(size, seed=4))
    launches = (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES, tk.LAUNCHES)
    codes, scales, n = ops.qsgd_compress(x)
    want_codes, want_scales = q.quantize_plain(x)
    assert n == size
    assert torch.equal(codes, want_codes)
    assert torch.equal(scales.view(torch.int32), want_scales.view(torch.int32))
    assert torch.equal(ops.qsgd_decompress(codes, scales),
                       q.dequantize_plain(codes, scales))
    assert torch.equal(ops.topk_sparsify(x, K), tk.topk_plain(x, K))
    assert (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES, tk.LAUNCHES) == \
        launches


def test_wrappers_take_a_misaligned_view():
    base = torch.from_numpy(_x(10_003, seed=5))
    view = base[3:]
    codes, scales, _ = ops.qsgd_compress(view)
    want = q.quantize_plain(view.clone())
    assert torch.equal(codes, want[0]) and torch.equal(scales, want[1])
    assert torch.equal(ops.topk_sparsify(view, K),
                       tk.topk_plain(view.clone(), K))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(8_192)
    with pytest.raises(TypeError, match="float32"):
        ops.qsgd_compress(x.double())
    with pytest.raises(ValueError, match="1-D"):
        ops.topk_sparsify(x.reshape(2, -1), K)
    with pytest.raises(ValueError, match="contiguous"):
        ops.qsgd_compress(x[::2])
    codes, scales, _ = ops.qsgd_compress(x)
    with pytest.raises(ValueError, match="range"):
        ops.qsgd_decompress(codes, scales, 10, 8_193)
    with pytest.raises(ValueError, match="scales"):
        ops.qsgd_decompress(codes, scales[:1])
    with pytest.raises(ValueError, match="device"):
        ops.qsgd_compress(torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="device"):
        ops.topk_sparsify(torch.zeros(8, device="meta"), K)
