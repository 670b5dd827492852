"""The CUDA kernels against their plain PyTorch versions, bit for bit.

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


CODEC_CASES = ["shard", "short", "misaligned", "zero_tiles", "half_to_even"]


def _codec_input(case):
    g = torch.Generator(device="cuda").manual_seed(11)
    rnd = lambda n: torch.randn(n, generator=g, device="cuda")
    if case == "shard":                 # a ragged last tile, as every
        return rnd(1_000_003)           # VGG-16 shard has
    if case == "short":
        return rnd(100)
    if case == "misaligned":
        return rnd(100_003)[3:]
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
