"""The causal attention kernel's plain versions, its route and its checks
on the CPU (``repro_torch.kernels.causal_attention``).

The plain forward is ``attention_dense``'s causal arithmetic bit for bit;
the plain backward (the kernels' recipe: p from the forward's row max and
sum, dp rounded to bf16, the row term, ds split into hi + lo bf16 parts)
matches autograd through ``attention_dense`` within a stated tolerance.
``layers.attention`` sends the card's bf16 causal self-attention at head
dim 64 or 128 to the kernel and everything else down its old paths; meta
tensors stand in for the card where the route is tested. The kernels
themselves run on the card: ``tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import causal_attention as ca
from repro_torch.models import layers

SHAPES = {"mha64": (2, 37, 4, 4, 64), "gqa128": (2, 50, 8, 2, 128),
          "mqa64": (1, 70, 4, 1, 64), "one_token": (1, 1, 2, 2, 64)}


def _qkv(shape, dtype=torch.bfloat16, seed=0):
    b, s, h, kh, d = shape
    g = torch.Generator().manual_seed(seed)
    mk = lambda *sh: torch.randn(*sh, generator=g).to(dtype)
    return mk(b, s, h, d), mk(b, s, kh, d), mk(b, s, kh, d), mk(b, s, h, d)


def _dense(q, k, v):
    pos = torch.arange(q.shape[1])
    return layers.attention_dense(q, k, v, q_pos=pos, k_pos=pos, causal=True)


def _autograd(fn, q, k, v, do, dtype):
    leaves = [t.detach().clone().to(dtype).requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    out.backward(do.to(dtype))
    return [out.detach()] + [t.grad for t in leaves]


def _rel(a, b):
    a, b = a.float(), b.float()
    n = b.norm()
    return float((a - b).norm() / n) if n > 0 else float((a - b).norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_plain_equals_attention_dense_bit_for_bit(shape, dtype):
    """The plain forward masks by index (-inf after the query), as the
    kernels do; ``attention_dense`` adds a bias built from the positions.
    At positions arange(S) the two give the same bits."""
    q, k, v, _ = _qkv(shape, dtype)
    o, m, l = ca.forward_plain(q, k, v)
    assert torch.equal(o, _dense(q, k, v))
    assert m.shape == l.shape == (shape[0], shape[2], shape[1])
    assert m.dtype == l.dtype == torch.float32


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_forward_stats_give_the_softmax(shape):
    """exp(s − m)/l from the saved row max and sum is the dense path's
    softmax to f32 round-off."""
    q, k, v, _ = _qkv(shape)
    _, m, l = ca.forward_plain(q, k, v)
    s, _ = ca._scores(q, k)
    p = torch.exp(s - m[..., None]) / l[..., None]
    want = torch.softmax(s, dim=-1)
    torch.testing.assert_close(p, want, rtol=1e-6, atol=1e-7)


# The recipe against autograd through attention_dense at bf16: with one kv
# head a q head the two round at the same points, and differ by the order
# of summation and the hi + lo split (a relative norm under 5e-4); with
# grouped kv heads the dense path also rounds each q head's dk and dv to
# bf16 before summing the group, which the kernel sums in f32 and rounds
# once (under 5e-3). Against an f32 attention on the same bf16 values the
# recipe is never further than attention_dense (within 1 %).
RECIPE_TOL = {"mha64": 5e-4, "gqa128": 5e-3, "mqa64": 5e-3,
              "one_token": 5e-4}


@pytest.mark.parametrize("name", list(SHAPES))
def test_backward_recipe_matches_autograd(name):
    q, k, v, do = _qkv(SHAPES[name], seed=1)
    dense = _autograd(_dense, q, k, v, do, torch.bfloat16)
    f32 = _autograd(_dense, q, k, v, do, torch.float32)
    _, m, l = ca.forward_plain(q, k, v)
    recipe = ca.backward_plain(q, k, v, do, m, l)
    for got, want, exact in zip(recipe, dense[1:], f32[1:]):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _rel(got, want) <= RECIPE_TOL[name]
        assert _rel(got, exact) <= 1.01 * _rel(want, exact) + 1e-7


@pytest.mark.parametrize("name", ["mha64", "gqa128"])
def test_function_on_cpu_is_the_plain_pair(name):
    """The autograd Function on CPU tensors: the plain forward, the
    recipe's gradients, no kernel launch."""
    q, k, v, do = _qkv(SHAPES[name], seed=2)
    before = ca.LAUNCHES
    got = _autograd(ca.causal_attention, q, k, v, do, torch.bfloat16)
    o, m, l = ca.forward_plain(q, k, v)
    assert torch.equal(got[0], o)
    for a, b in zip(got[1:], ca.backward_plain(q, k, v, do, m, l)):
        assert torch.equal(a, b)
    assert ca.LAUNCHES == before


# ---------------------------------------------------------------------------
# the route in layers.attention (meta tensors stand in for the card)
# ---------------------------------------------------------------------------

def _meta(b, s, h, kh, d, dtype=torch.bfloat16, t=None):
    mk = lambda *sh: torch.empty(*sh, dtype=dtype, device="meta")
    t = s if t is None else t
    return mk(b, s, h, d), mk(b, t, kh, d), mk(b, t, kh, d)


@pytest.fixture
def routed(monkeypatch):
    """Calls that reached the kernel, with meta tensors taken as the
    card's."""
    calls = []
    monkeypatch.setattr(ca, "takes",
                        lambda q, k, v: q.device.type == "meta"
                        and ca._reason(q, k, v) is None)
    monkeypatch.setattr(ca, "causal_attention",
                        lambda q, k, v: calls.append(q.shape) or
                        torch.empty_like(q))
    return calls


ROUTE = {"gpt2_large": (4, 1024, 20, 20, 64),
         "gqa128": (2, 1000, 32, 8, 128)}


@pytest.mark.parametrize("shape", list(ROUTE.values()), ids=list(ROUTE))
def test_route_takes_the_kernel(shape, routed):
    q, k, v = _meta(*shape)
    pos = torch.arange(shape[1], device="meta")
    out = layers.attention(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                           chunk=2048)
    assert routed == [q.shape] and out.shape == q.shape
    layers.attention(q, k, v, q_pos=pos, k_pos=pos, causal=True, chunk=0)
    assert len(routed) == 2


REFUSED = {
    "window": dict(window=256),
    "k_valid": dict(k_valid=True),
    "non_causal": dict(causal=False),
    "cross": dict(t=700),
    "head_dim_96": dict(d=96),
    "f32": dict(dtype=torch.float32),
    "longer_than_chunk": dict(chunk=512),
    "other_positions": dict(k_pos=True),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_route_refuses(case, routed):
    kw = dict(REFUSED[case])
    b, s, h, kh, d = 2, 1000, 32, 8, kw.pop("d", 128)
    q, k, v = _meta(b, s, h, kh, d, kw.pop("dtype", torch.bfloat16),
                    kw.pop("t", None))
    t = k.shape[1]
    pos = torch.arange(s, device="meta")
    k_pos = torch.arange(t, device="meta") if kw.pop("k_pos", t != s) \
        else pos
    if kw.pop("k_valid", False):
        kw["k_valid"] = torch.ones(t, dtype=torch.bool, device="meta")
    kw.setdefault("chunk", 2048)
    out = layers.attention(q, k, v, q_pos=pos, k_pos=k_pos, **kw)
    assert out.shape == q.shape
    assert routed == []


def test_route_refuses_cpu_tensors():
    q, k, v, _ = _qkv((1, 16, 2, 2, 64))
    assert not ca.takes(q, k, v)
    before = ca.LAUNCHES
    pos = torch.arange(16)
    got = layers.attention(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                           chunk=2048)
    assert torch.equal(got, _dense(q, k, v)) and ca.LAUNCHES == before


# ---------------------------------------------------------------------------
# the wrapper's checks
# ---------------------------------------------------------------------------

BAD = {
    "f32": ((1, 64, 2, 2, 64), dict(dtype=torch.float32), TypeError),
    "head_dim_96": ((1, 64, 2, 2, 96), {}, ValueError),
    "kv_heads_not_dividing": ((1, 64, 6, 4, 64), {}, ValueError),
    "cross": ((1, 64, 2, 2, 64), dict(t=32), ValueError),
}


@pytest.mark.parametrize("case", list(BAD))
@pytest.mark.parametrize("entry", ["forward", "causal_attention"])
def test_wrapper_raises_on_what_it_does_not_take(case, entry):
    shape, kw, err = BAD[case]
    q, k, v = _meta(*shape, **kw)
    with pytest.raises(err, match="causal_attention"):
        getattr(ca, entry)(q, k, v)


def test_wrapper_raises_on_mixed_types_and_ranks():
    q, k, v = _meta(1, 64, 2, 2, 64)
    with pytest.raises(TypeError):
        ca.forward(q, k.float(), v)
    with pytest.raises(ValueError):
        ca.forward(q[0], k[0], v[0])
    with pytest.raises(ValueError):
        ca.forward(q, k, v[:, :, :1])


def test_backward_checks_do_and_stats():
    q, k, v = _meta(2, 64, 4, 2, 64)
    o, m, l = ca.forward(q, k, v)
    assert o.shape == q.shape and m.shape == l.shape == (2, 4, 64)
    dq, dk, dv = ca.backward(q, k, v, o, m, l)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    with pytest.raises(ValueError, match="do"):
        ca.backward(q, k, v, o.float(), m, l)
    with pytest.raises(ValueError, match="m, l"):
        ca.backward(q, k, v, o, m[:, :2], l)
    with pytest.raises(ValueError, match="m, l"):
        ca.backward(q, k, v, o, m, l.to(torch.bfloat16))

