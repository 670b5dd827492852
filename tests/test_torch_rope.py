"""The RoPE kernel's plain versions, its table memo and its route on the
CPU (``repro_torch.kernels.rope``).

The plain rotation over a given table, and the backward formula the
kernel computes, equal ``layers.apply_rope`` and the gradient autograd
takes through it, bit for bit; the memo's table is the plain chain's;
``layers.apply_rope`` keeps the plain chain for CPU and meta tensors. The
kernel itself runs on the card: ``tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import rope
from repro_torch.models import layers

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
HEAD_DIMS = (64, 80, 72, 96, 128)
THETA = 10000.0
INTS = {2: torch.int16, 4: torch.int32}


def _bits(t):
    return t.view(INTS[t.element_size()])


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        _bits(a), _bits(b))


def _inputs(hd, dtype, s=7, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (4 * torch.randn(2, s, 3, hd, generator=g)).to(dtype)
    dout = torch.randn(2, s, 3, hd, generator=g).to(dtype)
    return x, dout


def _positions(kind, s):
    return torch.arange(s) if kind == "arange" else torch.tensor([1234])


def _autograd(fn, x, dout):
    leaf = x.detach().clone().requires_grad_()
    out = fn(leaf)
    out.backward(dout)
    return out.detach(), leaf.grad


@pytest.mark.parametrize("pos", ["arange", "decode"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_plain_rotation_and_backward_equal_apply_rope(dtype, hd, pos):
    """Over the table of ``table_plain``, ``rotate`` forward and backward
    on CPU tensors (the kernel's formulas in plain ops) give
    ``apply_rope``'s output and autograd's gradient through it, and so
    does the autograd Function the route takes on the card."""
    x, dout = _inputs(hd, DTYPES[dtype])
    positions = _positions(pos, x.shape[1])
    want_out, want_dx = _autograd(
        lambda t: layers.apply_rope(t, positions, THETA), x, dout)
    cos, sin = rope.table_plain(positions, hd, THETA)
    assert _same_bits(rope.rotate(x, cos, sin), want_out)
    assert _same_bits(rope.rotate(dout, cos, sin, backward=True), want_dx)
    before = rope.LAUNCHES
    out, dx = _autograd(lambda t: rope.rope(t, positions, THETA), x, dout)
    assert _same_bits(out, want_out) and _same_bits(dx, want_dx)
    assert rope.LAUNCHES == before


def test_table_is_the_plain_chains_bit_for_bit():
    positions = torch.arange(33)
    cos, sin = rope.table(positions, 80, 500000.0)
    angles = positions[..., None].to(torch.float32) * rope.rope_freqs(
        80, 500000.0)
    assert _same_bits(cos, torch.cos(angles))
    assert _same_bits(sin, torch.sin(angles))
    assert cos.shape == (33, 40)


@pytest.mark.parametrize("change", ["in_place", "head_dim", "theta",
                                    "new_tensor"])
def test_table_memo_hits_the_same_positions_and_misses_a_change(change):
    positions = torch.arange(9)
    first = rope.table(positions, 64, THETA)
    builds = rope.TABLE_BUILDS
    again = rope.table(positions, 64, THETA)
    assert rope.TABLE_BUILDS == builds
    assert again[0] is first[0] and again[1] is first[1]
    args = {"in_place": (positions, 64, THETA),
            "head_dim": (positions, 128, THETA),
            "theta": (positions, 64, 500000.0),
            "new_tensor": (torch.arange(9), 64, THETA)}[change]
    if change == "in_place":
        positions.add_(3)
    cos, sin = rope.table(*args)
    assert rope.TABLE_BUILDS == builds + 1
    want = rope.table_plain(*args)
    assert _same_bits(cos, want[0]) and _same_bits(sin, want[1])


def test_table_of_inference_positions_is_built_every_call():
    """Under inference mode (decode, prefill) the positions carry no
    version counter: the table is built anew each call and not kept, and
    the rotation runs."""
    with torch.inference_mode():
        positions = torch.arange(6)
        builds = rope.TABLE_BUILDS
        first = rope.table(positions, 64, THETA)
        again = rope.table(positions, 64, THETA)
        assert rope.TABLE_BUILDS == builds + 2
        want = rope.table_plain(positions, 64, THETA)
        for got in (first, again):
            assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
        x, _ = _inputs(64, torch.bfloat16, s=6)
        assert _same_bits(rope.rope(x, positions, THETA),
                          layers.apply_rope(x, positions, THETA))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_route_keeps_the_plain_chain_off_the_card(device):
    """``takes`` holds only for CUDA tensors: ``apply_rope`` on CPU and
    meta tensors runs the plain chain, with no launch and no memo."""
    x = torch.randn(2, 5, 3, 64).to(device).requires_grad_()
    positions = torch.arange(5, device=device)
    assert not rope.takes(x, positions)
    before = (rope.LAUNCHES, rope.TABLE_BUILDS)
    out = layers.apply_rope(x, positions, THETA)
    assert (rope.LAUNCHES, rope.TABLE_BUILDS) == before
    assert "Rope" not in type(out.grad_fn).__name__
    assert out.shape == x.shape and out.device.type == device


@pytest.mark.parametrize("x_shape, table_shape", [
    ((2, 5, 3, 7), (5, 3)),        # odd head dim
    ((5, 3, 64), (5, 32)),         # not (B, S, H, hd)
    ((2, 5, 3, 64), (4, 32)),      # neither S nor 1 rows
    ((2, 5, 3, 64), (5, 16)),      # not hd / 2 wide
], ids=["odd_hd", "three_dims", "rows", "width"])
def test_rotate_raises_on_what_it_does_not_take(x_shape, table_shape):
    x = torch.randn(*x_shape)
    cos = torch.randn(*table_shape)
    with pytest.raises(ValueError):
        rope.rotate(x, cos, cos)
    with pytest.raises(TypeError):
        rope.rotate(x.double(), cos, cos)
