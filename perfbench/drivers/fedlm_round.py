"""Federated training rounds of a transformer LM through the port.

The window drives this copy of the round body of
``repro_torch.launch.federated_lm.run``, calling the port's layers: per
client a clone of the global parameters, ``local_steps`` calls of
``core.fedavg.local_sgd_update`` (the rmsnorm kernel in every forward, the
fused-SGD kernel on every leaf), ``model_delta`` and
``core.sharding.flatten``, each client's loss read to the host and a
device synchronisation; then ``FederatedSession.round`` of the N flat
deltas (the fold kernel) and ``apply_delta`` of the unflattened mean.
``run`` itself makes its own parameters and data and has no window, so
the benchmark makes both from the seed (``inputs.py``): f32 parameters on
the device, and Zipf token batches over the whole vocabulary with a
permutation a client.

Set-up builds the parameters, the data and the session, and drives the
first ``check_rounds`` rounds through the window's own call, recording
every local step's loss, the first gradient's per-leaf norms (the
optimizer's velocity after its first step, which starts from zero, is
that gradient) and, after the rounds, the per-leaf norms of the
parameters' change; the window continues from that state. Once it has
closed and the program's state is freed, ``reference/gpt2.py`` follows the
same rounds in f32, and the check compares the three, by the worst step or
the worst leaf.
"""
from __future__ import annotations

import torch

from perfbench import cost, inputs
from perfbench.reference import gpt2 as ref

#: a leaf whose first reference gradient is under this share of the median
#: leaf's moves by round-off alone, and is not compared for its change
MOVED_SHARE = 1e-3


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of the configuration file."""
    from repro_torch.config import ModelConfig
    port = cfg["port"]
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    return ModelConfig(
        name=cfg["name"], family="dense", n_layers=cfg["n_layer"],
        d_model=cfg["n_embd"], n_heads=cfg["n_head"],
        n_kv_heads=cfg["n_head"], d_ff=inputs.d_ff(cfg),
        vocab=cfg["vocab_size"], gated_mlp=False,
        rope_theta=port["rope_theta"], norm_eps=cfg["layer_norm_epsilon"],
        param_dtype=dtypes[port["param_dtype"]],
        compute_dtype=dtypes[port["compute_dtype"]],
        tie_embeddings=cfg["tie_word_embeddings"], remat=port["remat"],
        attn_chunk=port["attn_chunk"])


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device: str,
                 limits: dict | None = None):
        from repro_torch.api import FederatedSession, SessionConfig
        from repro_torch.core import fedavg, sharding
        from repro_torch.models import registry
        self.fedavg, self.sharding = fedavg, sharding
        self.config, self.mix, self.seed = config, mix, seed
        self.device, self.limits = device, limits or {}
        self.cfg = model_config(config)
        self.loss_fn = lambda p, b: registry.loss_fn(p, self.cfg, b)
        self.params = inputs.gpt2_params(config, seed, device)
        self.data = inputs.ZipfTokens(config, mix, seed, device)
        self.session = FederatedSession(SessionConfig(
            topology=mix["topology"], n_shards=mix["n_shards"],
            engine="batched", codec=mix["codec"], schedule=mix["schedule"],
            keep_records=False, device=device))
        self.losses: list = []
        self.grad_norms: dict | None = None
        self.first_round = mix["check_rounds"]
        for r in range(self.first_round):
            self.round(r, record=True)
        init = inputs.gpt2_params(config, seed, device)
        with torch.no_grad():
            self.change_norms = ref.leaf_norms(
                {k: self.params[k] - init[k] for k in init})
        del init

    def _sync(self) -> None:
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def round(self, r: int, record: bool = False) -> None:
        fedavg, mix = self.fedavg, self.mix
        flats, spec, round_losses = [], None, []
        with torch.profiler.record_function("round.clients"):
            for c in range(mix["clients"]):
                local = {k: v.detach().clone()
                         for k, v in self.params.items()}
                vel = loss = None
                steps = []
                for s in range(mix["local_steps"]):
                    local, vel, loss = fedavg.local_sgd_update(
                        self.loss_fn, local, self.data.batch_of(r, c, s),
                        lr=mix["lr"], momentum=mix["momentum"],
                        velocity=vel)
                    if record:
                        steps.append(float(loss))
                        if self.grad_norms is None:
                            self.grad_norms = ref.leaf_norms(vel)
                float(loss)
                flat, spec = self.sharding.flatten(
                    fedavg.model_delta(self.params, local))
                del local, vel
                flats.append(flat)
                round_losses.append(steps)
                self._sync()
        with torch.profiler.record_function("round.aggregate"):
            res = self.session.round(flats, rnd=r)
            self._sync()
        del flats
        with torch.profiler.record_function("round.apply"):
            self.params = fedavg.apply_delta(
                self.params, self.sharding.unflatten(res.avg_flat, spec))
            self._sync()
        if record:
            self.losses.append(round_losses)

    def work(self) -> dict:
        """A round's work and least times (``cost.py``)."""
        c, mix = self.config, self.mix
        steps = mix["clients"] * mix["local_steps"]
        n = inputs.param_count(c)
        flops = cost.model_flops_train(
            n, c["n_layer"], c["n_head"], c["n_embd"] // c["n_head"],
            mix["batch"], mix["seq"])
        return {"tokens": steps * mix["batch"] * mix["seq"],
                "model_flops": steps * flops,
                "fused_sgd_bound_s": steps * cost.fused_sgd_bound_s(n)}

    def release(self) -> None:
        self.params = self.session = self.data = None
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def check(self) -> dict:
        want = ref.follow(self.config, self.mix, self.seed, self.device,
                          self.first_round)
        return compare(self.losses, self.grad_norms, self.change_norms,
                       want, self.limits)


def compare(losses, grad_norms, change_norms, want: dict,
            limits: dict) -> dict:
    """The three numbers compared, each with its limit: the largest gap
    of a local step's loss (nats); the worst leaf's gap of the first
    gradient's norm; the worst moved leaf's gap of the change's norm."""
    loss_gap = max(abs(a - b) for got_r, want_r in zip(losses, want["losses"])
                   for got_c, want_c in zip(got_r, want_r)
                   for a, b in zip(got_c, want_c))
    g_want = want["grad_norms"]
    median = sorted(g_want.values())[len(g_want) // 2]
    moved = {k for k, v in g_want.items() if v >= MOVED_SHARE * median}
    return {"loss_gap": (loss_gap, limits["loss_gap"]),
            "grad_norm_gap": (ref.gaps(grad_norms, g_want),
                              limits["grad_norm_gap"]),
            "change_norm_gap": (ref.gaps(change_norms, want["change_norms"],
                                         keep=moved),
                                limits["change_norm_gap"])}
