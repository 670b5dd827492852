"""The CUDA fold kernel against its plain PyTorch version, bit for bit.

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
