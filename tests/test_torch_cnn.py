"""The port's federated CNN (`repro_torch.models.cnn`) against the JAX
package, and the reference's end-to-end federated tests
(`tests/test_fl_e2e.py`) on the port's substrate.

The model: forward logits, loss and every gradient leaf on the
reference's weights (carried over by `convert.params_from_jax`) and the
same seeded numpy images, at the federated tests' config and at the
default `CNNConfig()`, on even and odd image sides, which pin XLA's
asymmetric "SAME" padding of the stride-2 convs. Tolerances: logits and
loss rtol 1e-5, atol 1e-5; each gradient leaf max |got - want| <= 1e-4 *
max |want| (the convolutions sum in another order).

The federated runs: the reference test's loop (4 clients, 4 shards, 4
local steps at lr 0.05, momentum 0.9 through the port's fused-SGD entry
point, 32 images a step) with the port's SyntheticVision, sessions and
topologies, on the CPU. Its trajectory against the reference's: rtol
1e-4, atol 1e-5 on the parameters after two GradsSharding rounds, the
same test accuracies.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_fl_e2e as ref_e2e  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core.fedavg import (  # noqa: E402
    apply_delta, local_sgd_update, model_delta)
from repro_torch.core.sharding import flatten, unflatten  # noqa: E402
from repro_torch.data import SyntheticVision, dirichlet_partition  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.serverless import LambdaRuntime  # noqa: E402
from repro_torch.store import ObjectStore  # noqa: E402

CFG = cnn.CNNConfig(n_classes=4, channels=(8, 16), blocks_per_stage=1,
                    img_size=8)
DATA = SyntheticVision(n_classes=4, img_size=8, seed=0, noise=0.4)
CONFIGS = {"test": CFG, "default": cnn.CNNConfig()}


def _np(x):
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,want", [(8, (0, 1)), (7, (1, 1)),
                                       (32, (0, 1)), (1, (1, 1))])
def test_same_pad_is_xla_rule_for_stride_2(size, want):
    assert cnn.same_pad(size, 3, 2) == want
    assert cnn.same_pad(size, 3, 1) == (1, 1)
    assert cnn.same_pad(size, 1, 2) == (0, 0)


@pytest.mark.parametrize("side", ["even", "odd"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_forward_loss_and_gradients_match_reference(config, side):
    cfg = CONFIGS[config]
    ref_cfg = ref_cnn.CNNConfig(**dataclasses.asdict(cfg))
    size = cfg.img_size - (side == "odd")
    rng = np.random.default_rng([size, len(cfg.channels)])
    images = rng.standard_normal((4, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, 4)
    ref_params = ref_cnn.init_params(jax.random.PRNGKey(3), ref_cfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, ref_params))
    assert sorted(params) == sorted(cnn.param_shapes(cfg)) == \
        sorted(ref_cnn.param_specs(ref_cfg))
    for name, shape in cnn.param_shapes(cfg).items():
        assert params[name].shape == shape, name

    jb = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    tb = {"images": torch.from_numpy(images),
          "labels": torch.from_numpy(labels)}
    want_logits = ref_cnn.forward(ref_params, ref_cfg, jb["images"])
    (want_loss, want_m), want_grads = jax.value_and_grad(
        ref_cnn.loss_fn, has_aux=True)(ref_params, ref_cfg, jb)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    logits = cnn.forward(leaves, cfg, tb["images"])
    loss, m = cnn.loss_fn(leaves, cfg, tb)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))

    np.testing.assert_allclose(logits.detach().numpy(), _np(want_logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5, atol=1e-5)
    assert float(m["acc"]) == float(want_m["acc"])
    for name, g in grads.items():
        want = _np(want_grads[name])
        scale = float(np.abs(want).max())
        assert float(np.abs(g.numpy() - want).max()) <= 1e-4 * scale, name


def test_seeded_init_scales_and_shapes():
    params = cnn.init_params(torch.Generator().manual_seed(0),
                             cnn.CNNConfig())
    assert params["s1b0_proj"].shape == (1, 1, 16, 32)
    assert torch.equal(params["head_b"], torch.zeros(10))
    assert abs(float(params["s2b1_c2"].std()) - (9 * 64) ** -0.5) < 5e-3


# ---------------------------------------------------------------------------
# tests/test_fl_e2e.py on the port
# ---------------------------------------------------------------------------

def _loss_fn(params, batch):
    return cnn.loss_fn(params, CFG, batch)


def run_federated(topology: str, rounds: int = 3, n_clients: int = 4,
                  n_shards: int = 4, local_steps: int = 4,
                  codec: str | None = None, params: dict | None = None):
    """The reference test's loop on the port: each client trains a copy of
    the global parameters, uploads its flat delta, and the round's mean
    delta updates the global parameters."""
    if params is None:
        params = cnn.init_params(torch.Generator().manual_seed(0), CFG)
    store, rt = ObjectStore(), LambdaRuntime()
    accs = []
    for rnd in range(rounds):
        flats, spec = [], None
        for c in range(n_clients):
            local = {k: v.clone() for k, v in params.items()}
            vel = None
            for step in range(local_steps):
                batch = DATA.batch(c, rnd * 10 + step, 32)
                local, vel, _ = local_sgd_update(_loss_fn, local, batch,
                                                 lr=0.05, momentum=0.9,
                                                 velocity=vel)
            flat, spec = flatten(model_delta(params, local))
            flats.append(flat)
        r = agg.aggregate_round(topology, flats, rnd=rnd, store=store,
                                runtime=rt, n_shards=n_shards, codec=codec)
        params = apply_delta(params, unflatten(r.avg_flat, spec))
        with torch.no_grad():
            _, m = cnn.loss_fn(params, CFG, DATA.batch(99, 999, 128))
        accs.append(float(m["acc"]))
    return params, accs


def test_federated_training_improves():
    _, accs = run_federated("gradssharding", rounds=6)
    assert accs[-1] > 0.5, accs               # 4-class: chance = 0.25
    assert accs[-1] >= accs[0] - 0.05


def test_topologies_produce_same_model():
    flats = [flatten(run_federated(topo, rounds=2, codec="identity")[0])[0]
             for topo in ("gradssharding", "lambda_fl", "lifl")]
    for other in flats[1:]:
        np.testing.assert_allclose(other.numpy(), flats[0].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_noniid_dirichlet_still_learns():
    labels = np.random.default_rng(0).integers(0, 4, 2000)
    parts = dirichlet_partition(labels, 4, alpha=0.5, seed=1)
    params = cnn.init_params(torch.Generator().manual_seed(0), CFG)
    store, rt = ObjectStore(), LambdaRuntime()
    for rnd in range(8):
        flats, spec = [], None
        for c in range(4):
            client_labels = labels[parts[c][:32]]
            local = {k: v.clone() for k, v in params.items()}
            vel = None
            for step in range(2):
                batch = DATA.batch(c, rnd * 2 + step, 32,
                                   labels=client_labels)
                local, vel, _ = local_sgd_update(_loss_fn, local, batch,
                                                 lr=0.05, momentum=0.9,
                                                 velocity=vel)
            flat, spec = flatten(model_delta(params, local))
            flats.append(flat)
        r = agg.aggregate_round("gradssharding", flats, rnd=rnd, store=store,
                                runtime=rt, n_shards=2)
        params = apply_delta(params, unflatten(r.avg_flat, spec))
    with torch.no_grad():
        _, m = cnn.loss_fn(params, CFG, DATA.batch(99, 999, 128))
    assert float(m["acc"]) > 0.4


def test_gradssharding_trajectory_matches_reference():
    """Two GradsSharding rounds from the reference's initial weights: the
    reference test's own loop against the port's."""
    want_params, want_accs = ref_e2e.run_federated("gradssharding", rounds=2,
                                                   codec="identity")
    init = convert.params_from_jax(jax.tree.map(
        np.asarray, ref_cnn.init_params(jax.random.PRNGKey(0),
                                        ref_e2e.CFG)))
    params, accs = run_federated("gradssharding", rounds=2, codec="identity",
                                 params=init)
    assert accs == want_accs
    want = convert.params_from_jax(jax.tree.map(np.asarray, want_params))
    np.testing.assert_allclose(flatten(params)[0].numpy(),
                               flatten(want)[0].numpy(), rtol=1e-4,
                               atol=1e-5)
