"""The port's long-context attention (`repro_torch.models.layers`:
`attention_chunked`, `attention_causal_2d` and the `attention` dispatch)
against the reference functions, on the same seeded numpy q, k and v, f32,
rtol = atol = 1e-5.

Cases: sequences that are and are not a multiple of the chunk (the
padded last chunk), windows smaller and larger than the chunk, GQA (fewer
K/V heads than query heads), causal and not causal.

Where the keys are padded and there is no window, the reference's
`attention_chunked` lets the padded keys into the softmax (their position
`-(10**9)` is masked only by a window), so it differs from its own
`attention_dense`; the port masks them. Those cases hold the port against
the reference's `attention_dense`, the function the chunked path computes
in blocks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = 1e-5


def _qkv(b, s, t, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d))]


def _both(fn_name, arrays, **kw):
    """The port's and the reference's ``fn_name`` on the same arrays."""
    ref_kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()}
    t_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    want = getattr(ref_layers, fn_name)(*map(jnp.asarray, arrays), **ref_kw)
    got = getattr(layers, fn_name)(*map(torch.from_numpy, arrays), **t_kw)
    return got.numpy(), np.asarray(want)


# (s, t, chunk, heads, kv heads, window, causal)
CHUNKED = {
    "multiple_causal": (64, 64, 16, 4, 4, 0, True),
    "multiple_gqa": (64, 64, 16, 8, 2, 0, True),
    "window_below_chunk": (64, 64, 16, 4, 2, 5, True),
    "window_above_chunk": (64, 64, 16, 4, 2, 40, True),
    "padded_window_below": (50, 50, 16, 4, 2, 7, True),
    "padded_window_above": (50, 50, 16, 4, 4, 23, True),
    "cross_not_causal": (12, 64, 16, 4, 2, 0, False),
}
PADDED_NO_WINDOW = {
    "padded_causal": (50, 50, 16, 4, 4, 0, True),
    "padded_gqa": (70, 70, 32, 8, 2, 0, True),
    "padded_cross": (9, 40, 16, 4, 2, 0, False),
}


@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_matches_reference_chunked(case):
    s, t, chunk, h, kh, window, causal = CHUNKED[case]
    arrays = _qkv(2, s, t, h, kh, 16, seed=len(case))
    got, want = _both("attention_chunked", arrays,
                      q_pos=np.arange(s), k_pos=np.arange(t), causal=causal,
                      window=window, chunk=chunk)
    assert got.shape == (2, s, h, 16)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # and the reference's dense attention, which the chunks compute
    _, dense = _both("attention_dense", arrays, q_pos=np.arange(s),
                     k_pos=np.arange(t), causal=causal, window=window)
    np.testing.assert_allclose(got, dense, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", sorted(PADDED_NO_WINDOW))
def test_chunked_padding_is_masked_as_dense(case):
    s, t, chunk, h, kh, window, causal = PADDED_NO_WINDOW[case]
    assert t % chunk
    arrays = _qkv(1, s, t, h, kh, 8, seed=len(case))
    got, _ = _both("attention_chunked", arrays, q_pos=np.arange(s),
                   k_pos=np.arange(t), causal=causal, window=window,
                   chunk=chunk)
    _, dense = _both("attention_dense", arrays, q_pos=np.arange(s),
                     k_pos=np.arange(t), causal=causal, window=window)
    np.testing.assert_allclose(got, dense, rtol=TOL, atol=TOL)


# (s, chunk, heads, kv heads, window)
CAUSAL_2D = {
    "no_window": (64, 16, 4, 4, 0),
    "gqa": (64, 16, 8, 2, 0),
    "window_below_chunk": (64, 16, 4, 2, 6),
    "window_of_chunk": (64, 16, 4, 4, 16),
    "window_above_chunk": (96, 16, 4, 2, 37),
}


@pytest.mark.parametrize("case", sorted(CAUSAL_2D))
def test_causal_2d_matches_reference(case, monkeypatch):
    """Against the reference's 2-D tiling and its dense attention; the keys
    each query block reads: from the first block its window reaches to
    the diagonal, the blocks above it and older than the window skipped."""
    s, chunk, h, kh, window = CAUSAL_2D[case]
    arrays = _qkv(2, s, s, h, kh, 16, seed=7 + len(case))
    read = []
    for name in ("attention_dense", "attention_chunked"):
        fn = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda q, k, v, _fn=fn, **kw:
                            read.append(k.shape[1]) or _fn(q, k, v, **kw))
    got, want = _both("attention_causal_2d", arrays, positions=np.arange(s),
                      window=window, chunk=chunk)
    monkeypatch.undo()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    nq = s // chunk
    first = [max(0, (i * chunk - window + 1) // chunk) if window else 0
             for i in range(nq)]
    assert read == [(i + 1 - j) * chunk for i, j in enumerate(first)]
    _, dense = _both("attention_dense", arrays, q_pos=np.arange(s),
                     k_pos=np.arange(s), causal=True, window=window)
    np.testing.assert_allclose(got, dense, rtol=TOL, atol=TOL)


# (s, t, chunk, causal_skip, causal): the path the dispatch takes
DISPATCH = {
    "dense_short": (16, 16, 16, True, True),
    "chunked_long": (48, 48, 16, False, True),
    "causal_2d": (48, 48, 16, True, True),
    "chunked_not_multiple": (40, 40, 16, True, True),
    "chunked_cross": (8, 48, 16, True, False),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_attention_dispatch_matches_reference(case, monkeypatch):
    s, t, chunk, skip, causal = DISPATCH[case]
    arrays = _qkv(1, s, t, 4, 2, 16, seed=3 + len(case))
    taken = []
    for name in ("attention_dense", "attention_chunked",
                 "attention_causal_2d"):
        fn = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _fn=fn, _n=name, **kw:
                            taken.append(_n) or _fn(*a, **kw))
    got, want = _both("attention", arrays, q_pos=np.arange(s),
                      k_pos=np.arange(t), causal=causal, window=0,
                      chunk=chunk, causal_skip=skip)
    monkeypatch.undo()
    if t % chunk and t > chunk:
        # the reference's padded keys take part in its softmax: hold the
        # port against the dense path instead
        _, want = _both("attention_dense", arrays, q_pos=np.arange(s),
                        k_pos=np.arange(t), causal=causal)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    path = {"dense_short": "attention_dense",
            "causal_2d": "attention_causal_2d"}.get(case, "attention_chunked")
    assert taken[0] == path
