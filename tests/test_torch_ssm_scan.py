"""Mamba-1's associative scan in the port (`repro_torch.models.ssm`:
`associative_scan`, `_assoc_scan_chunk`, `mamba1_ssm`) against the JAX
package's, on the same seeded numpy inputs.

Tolerances:

* `associative_scan` with the reference's combine against
  `jax.lax.associative_scan`, and `_assoc_scan_chunk` against the
  reference's: bit for bit (the same products and sums in the same order),
  at chunk lengths of both parities; a -0.0 the reference's interleave
  makes +0.0 stays -0.0 (equal values);
* `mamba1_ssm`: y and the last state within 1e-5 · max |want| (the `exp`
  and the einsum with C round apart; the scan itself is exact), every
  input's gradient within 1e-4 · max |want|, as
  `tests/test_torch_families.py` holds gradients;
* the bytes a chunk's forward and backward move (the dry run's
  `OpCounter`, views left out) grow with the chunk by less than 1.5× a
  token from C = 64 to C = 256: the scan's levels, not a tensor of the
  whole chunk a step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.launch.dryrun import OpCounter  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

CHUNKS = (1, 2, 3, 7, 16, 255, 256)


def _comb(l, r):
    return (r[0] * l[0], r[0] * l[1] + r[1])


def _chunk_inputs(c, seed, di=8, ds=4, b=2):
    """da in (exp(-0.2), 1], db normal, h0 normal: f32."""
    rng = np.random.default_rng(seed)
    da = np.exp(-rng.uniform(0.0, 0.2, (b, c, di, ds))).astype(np.float32)
    db = rng.standard_normal((b, c, di, ds)).astype(np.float32)
    h0 = rng.standard_normal((b, di, ds)).astype(np.float32)
    return da, db, h0


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.int32)


@pytest.mark.parametrize("c", CHUNKS)
def test_associative_scan_equals_lax_bit_for_bit(c):
    da, db, _ = _chunk_inputs(c, seed=c)
    want = jax.lax.associative_scan(_comb, (jnp.asarray(da),
                                            jnp.asarray(db)), axis=1)
    got = ssm.associative_scan(_comb, (torch.from_numpy(da),
                                       torch.from_numpy(db)), axis=1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("axis", [0, 2, -1])
def test_associative_scan_on_other_axes(axis):
    """A sum scanned along another axis (the reference's example 1 of
    `lax.associative_scan`, generalised): bit for bit with lax."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((9, 3, 6)).astype(np.float32)
    want = jax.lax.associative_scan(lambda l, r: (l[0] + r[0],),
                                    (jnp.asarray(x),), axis=axis)[0]
    got = ssm.associative_scan(lambda l, r: (l[0] + r[0],),
                               (torch.from_numpy(x),), axis=axis)[0]
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_associative_scan_signed_zero():
    """The one difference in bits: the reference interleaves by padding
    with zeros and adding, which turns -0.0 into +0.0; the port's
    interleave keeps the sign. The values are equal."""
    a = np.ones((1, 5), np.float32)
    b = np.full((1, 5), -0.0, np.float32)
    want = jax.lax.associative_scan(_comb, (jnp.asarray(a), jnp.asarray(b)),
                                    axis=1)[1]
    got = ssm.associative_scan(_comb, (torch.from_numpy(a),
                                       torch.from_numpy(b)), axis=1)[1]
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.signbit(got.numpy()).all()
    assert not np.signbit(np.asarray(want)).any()


@pytest.mark.parametrize("c", CHUNKS)
def test_assoc_scan_chunk_equals_reference_bit_for_bit(c):
    da, db, h0 = _chunk_inputs(c, seed=100 + c)
    h, last = ssm._assoc_scan_chunk(torch.from_numpy(da),
                                    torch.from_numpy(db),
                                    torch.from_numpy(h0))
    want_h, want_last = ref_ssm._assoc_scan_chunk(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(h0))
    assert h.shape == (2, c, 8, 4) and last.shape == (2, 8, 4)
    assert np.array_equal(_bits(h.numpy()), _bits(want_h))
    assert np.array_equal(_bits(last.numpy()), _bits(want_last))


def _ssm_inputs(s, di=16, ds=16, b=2, seed=7):
    """dt as softplus(-4.6 + noise) (the block's scale), the rest normal,
    a = -exp(log(1..ds)) as the block's initialisation."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(-4.6 + rng.standard_normal((b, s, di)))
                  ).astype(np.float32)
    bm = rng.standard_normal((b, s, ds)).astype(np.float32)
    cm = rng.standard_normal((b, s, ds)).astype(np.float32)
    xc = rng.standard_normal((b, s, di)).astype(np.float32)
    a = -np.tile(np.arange(1, ds + 1, dtype=np.float32), (di, 1))
    h0 = rng.standard_normal((b, di, ds)).astype(np.float32)
    wy = rng.standard_normal((b, s, di)).astype(np.float32)
    wh = rng.standard_normal((b, di, ds)).astype(np.float32)
    return (dt, bm, cm, xc, a, h0), (wy, wh)


def _close_to_max(got, want, tol, label):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, label
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (label, err)


@pytest.mark.parametrize("s, chunk", [(512, 256), (7, 256), (48, 16)])
def test_mamba1_ssm_matches_reference_with_gradients(s, chunk):
    """S = 512 at the registered chunk of 256 (two chunks), a 7-token
    prompt (one chunk of odd length) and three chunks of 16."""
    inputs, (wy, wh) = _ssm_inputs(s)

    def ref_loss(*args):
        y, h = ref_ssm.mamba1_ssm(*args, chunk)
        return jnp.sum(y * wy) + jnp.sum(h * wh), (y, h)

    (_, (want_y, want_h)), want_g = jax.value_and_grad(
        ref_loss, argnums=tuple(range(6)), has_aux=True)(
        *map(jnp.asarray, inputs))
    ts = [torch.from_numpy(x).requires_grad_() for x in inputs]
    y, h = ssm.mamba1_ssm(*ts, chunk)
    (y * torch.from_numpy(wy)).sum().add((h * torch.from_numpy(wh)).sum()
                                         ).backward()
    _close_to_max(y, want_y, 1e-5, "y")
    _close_to_max(h, want_h, 1e-5, "h_last")
    for name, t, g in zip(("dt", "bmat", "cmat", "xc", "a", "h0"), ts,
                          want_g):
        _close_to_max(t.grad, g, 1e-4, f"d{name}")


def test_mamba1_ssm_keeps_its_chunk_check():
    inputs, _ = _ssm_inputs(12)
    with pytest.raises(ValueError, match="not divisible"):
        ssm.mamba1_ssm(*map(torch.from_numpy, inputs), 8)


def _chunk_bytes_per_token(c: int) -> float:
    """Operand and result bytes of ``mamba1_ssm`` over one chunk of C
    tokens, forward and backward, at d_inner 64 and d_state 16, f32, on
    the meta device, a token."""
    def leaf(*shape):
        return torch.empty(shape, device="meta", requires_grad=True)

    inputs = (leaf(1, c, 64), leaf(1, c, 16), leaf(1, c, 16),
              leaf(1, c, 64), leaf(64, 16), leaf(1, 64, 16))
    with OpCounter() as counter:
        y, h = ssm.mamba1_ssm(*inputs, c)
        (y.sum() + h.sum()).backward()
    return counter.bytes / c


def test_chunk_bytes_grow_flat_in_the_chunk():
    """The per-step loop that stood here moved 3.8× the bytes a token at
    C = 256 than at C = 64 (each step's slice wrote a zero tensor of the
    whole chunk in its backward); the scan's levels keep it near flat."""
    small, large = _chunk_bytes_per_token(64), _chunk_bytes_per_token(256)
    assert large < 1.5 * small, (small, large)
