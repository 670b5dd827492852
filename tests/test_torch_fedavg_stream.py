"""The port's FedAvg fold (`repro_torch.kernels.fedavg_stream`).

The plain PyTorch version is held against the JAX package on the same
seeded numpy inputs:

* a numpy f32 left fold plus one divide — bit-equal (f32 inputs, and bf16
  inputs widened to f32);
* the Pallas kernel in interpret mode and its `ref.py` oracle — within
  1 ulp, since XLA may turn the divide into a reciprocal multiply;
* the Pallas kernel's f32 weighted form — rtol 1e-6 (its weight sum is
  XLA's, the port's is a numpy f32 sum);
* the reference engine's f64 weighted fold (`StreamingBackend`) —
  bit-equal.

The multi-node table the CUDA kernel reads is decoded here in numpy and
must encode exactly the per-node folds. The kernel itself is held against
the plain version on a card, in `test_torch_cuda.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.agg_engine import StreamingBackend  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import fedavg_stream as fs  # noqa: E402

NS = (1, 2, 7, 20)
LS = (128, 5000, 12_345)
DTYPES = ("f32", "bf16")


def _stack(n, length, seed=0):
    rng = np.random.default_rng([seed, n, length])
    return rng.standard_normal((n, length)).astype(np.float32)


def _port_inputs(x, dtype):
    """(port tensor stack, the numpy f32 values the port folds)."""
    t = torch.from_numpy(x)
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
    return t, t.to(torch.float32).numpy()


def _numpy_left_fold(x, divide=True):
    acc = x[0].copy()
    for row in x[1:]:
        acc += row
    return acc / np.float32(len(x)) if divide else acc


def _weights(n, seed=0):
    rng = np.random.default_rng([seed, n])
    w = rng.choice([0.5, 1.0, 1.0, 2.0, 3.25, 7.0], size=n)
    return [float(v) for v in w]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("length", LS)
@pytest.mark.parametrize("n", NS)
def test_plain_bit_equal_numpy_left_fold(n, length, dtype):
    t, vals = _port_inputs(_stack(n, length), dtype)
    got = fs.fedavg_stream_plain(t).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32),
                                  _numpy_left_fold(vals).view(np.int32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("length", LS)
@pytest.mark.parametrize("n", NS)
def test_plain_within_one_ulp_of_pallas_interpret(n, length, dtype):
    x = _stack(n, length, seed=1)
    t, _ = _port_inputs(x, dtype)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    pallas = np.asarray(ops.fedavg_shards(jx, interpret=True))
    np.testing.assert_array_max_ulp(fs.fedavg_shards(t).numpy(), pallas,
                                    maxulp=1)


@pytest.mark.parametrize("length", LS)
@pytest.mark.parametrize("n", NS)
def test_plain_within_one_ulp_of_pallas_oracle(n, length):
    x = _stack(n, length, seed=2)
    pad = (-length) % 128
    tiles = np.pad(x, ((0, 0), (0, pad))).reshape(n, -1, 128)
    oracle = np.asarray(ref.fedavg_stream_ref(jnp.asarray(tiles)))
    oracle = oracle.reshape(-1)[:length]
    got = fs.fedavg_stream_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_max_ulp(got, oracle, maxulp=1)


@pytest.mark.parametrize("length", LS)
@pytest.mark.parametrize("n", NS)
def test_weighted_f32_matches_pallas(n, length):
    x = _stack(n, length, seed=3)
    w = _weights(n, seed=3)
    got = fs.fedavg_shards(torch.from_numpy(x), w).numpy()
    pallas = np.asarray(ops.fedavg_shards(
        jnp.asarray(x), jnp.asarray(w, jnp.float32), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=0)


@pytest.mark.parametrize("length", LS)
@pytest.mark.parametrize("n", NS)
def test_weighted_f64_bit_equal_streaming_backend(n, length):
    x = _stack(n, length, seed=4)
    w = _weights(n, seed=4)
    be = StreamingBackend()
    acc = be.init_acc(x[0], w)
    for i in range(1, n):
        acc = be.accumulate(acc, x[i], i, w)
    want = be.finalize(acc, w, n)
    got = fs.fedavg_stream_plain(torch.from_numpy(x), w).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _mixed_nodes():
    rng = np.random.default_rng(5)
    mk = lambda n, length: [torch.from_numpy(
        rng.standard_normal(length).astype(np.float32)) for _ in range(n)]
    base = mk(1, 40_000)[0]
    return [
        (mk(3, 5), None),
        (mk(9, 3_001), _weights(9)),
        (mk(2, 0), None),
        (mk(1, 1), [4.0]),
        ([base[k:k + 30_000] for k in (1, 2, 3, 5)], None),   # offset views
        (mk(20, 4_097), None),
    ]


def _decode_table(table, n_nodes, tensors):
    """Evaluate a kernel node table in numpy, as the kernel reads it."""
    cols = fs._META
    meta = table[:n_nodes * cols].reshape(n_nodes, cols)
    div = table[n_nodes * cols:n_nodes * (cols + 1)].view(np.float64)
    n_slots = (len(table) - n_nodes * (cols + 1)) // 2
    ptr = table[n_nodes * (cols + 1):n_nodes * (cols + 1) + n_slots]
    wts = table[n_nodes * (cols + 1) + n_slots:].view(np.float64)
    by_ptr = {t.data_ptr(): t.numpy() for t in tensors}
    outs = []
    for length, _out, slot, nc, mode, carry, fin in meta:
        xs = [by_ptr[int(p)][:length] for p in ptr[slot:slot + nc]]
        ws = wts[slot:slot + nc]
        d = div[len(outs)]
        if carry:
            xs = [by_ptr[int(carry)][:length]] + xs
            ws = np.concatenate([[1.0], ws])
        if mode == 0:
            acc = _numpy_left_fold(np.stack(xs), divide=False) if length \
                else np.empty(0, np.float32)
            outs.append(acc / np.float32(d) if fin else acc)
            assert carry or d == nc
        elif mode == 1:
            acc = xs[0].astype(np.float64) * ws[0]
            for xi, wi in zip(xs[1:], ws[1:]):
                acc += xi.astype(np.float64) * wi
            outs.append((acc / d).astype(np.float32) if fin else acc)
        else:
            acc = xs[0] * np.float32(ws[0])
            for xi, wi in zip(xs[1:], ws[1:]):
                acc += xi * np.float32(wi)
            outs.append(acc / np.float32(d) if fin else acc)
    return outs, meta


@pytest.mark.parametrize("acc", ["f64", "f32"])
def test_node_table_encodes_each_node(acc):
    nodes = _mixed_nodes()
    table, outs, max_len = fs._table(nodes, [None] * len(nodes), None, acc,
                                     True, torch.device("cpu"))
    assert max_len == 30_000
    decoded, meta = _decode_table(
        table, len(nodes), [x for inputs, _ in nodes for x in inputs])
    for (inputs, weights), out, got, row in zip(nodes, outs, decoded, meta):
        assert row[0] == len(out) == inputs[0].shape[0]
        assert row[1] == out.data_ptr()
        assert row[4] == (0 if weights is None else fs._MODES[acc])
        assert (row[5], row[6]) == (0, 1)          # no carry, finalize
        want = fs.fedavg_stream_plain(inputs, weights, acc).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fold_nodes_equals_per_node_calls():
    nodes = _mixed_nodes()
    before = fs.LAUNCHES
    outs = fs.fold_nodes(nodes)
    assert fs.LAUNCHES == before          # CPU tensors never launch
    for (inputs, weights), out in zip(nodes, outs):
        want = fs.fold_nodes([(inputs, weights)])[0]
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_fedavg_multi_equals_fedavg_shards():
    stacks = [torch.from_numpy(_stack(5, n, seed=6)) for n in (1, 777, 4096)]
    w = _weights(5, seed=6)
    for weights in (None, w):
        outs = fs.fedavg_multi(stacks, weights)
        for s, out in zip(stacks, outs):
            want = fs.fedavg_shards(s, weights)
            assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match="same N"):
        fs.fedavg_multi([stacks[0], stacks[0][:3]])


def test_fold_nodes_rejects_foreign_devices():
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no fold kernel"):
        fs.fold_nodes([([x], None)])
    with pytest.raises(ValueError, match="acc"):
        fs.fold_nodes([([torch.zeros(4)], None)], acc="f16")
