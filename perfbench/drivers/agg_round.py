"""Aggregation rounds: ``FederatedSession.round`` of N client gradients.

Set-up draws the N gradients on the device from the seed (one call),
builds one session (the batched engine, ``keep_records=False``) and runs
the mix's warm-up rounds through the window's own call. Each round hands
the gradients over in an order drawn from the seed and the round's
number, so every round computes a new mean, and ends in a device
synchronisation; rounds run back to back (a closed loop: FedAvg rounds
are sequential).

The check: the mix's ``check_rounds`` rounds of the window, drawn from the
seed below ``sample_below`` (with the window's first round), keep their
mean; once the window has closed each is compared bit for bit with the
plain reference (``reference/fold.py``) over the same gradients in the
same order. The number compared is the most elements that differ in any
checked round; the limit is 0.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import cost, inputs
from perfbench.reference import fold


class Driver:
    SPAN = "session.round"

    def __init__(self, config: dict, mix: dict, seed: int, device: str,
                 limits: dict | None = None):
        from repro_torch.api import FederatedSession, SessionConfig
        self.seed, self.device = seed, device
        self.config, self.mix = config, mix
        self.limit = (limits or {}).get("mismatched_elements", 0)
        self.n, self.length = mix["n_clients"], config["params"]
        self.grads = inputs.client_grads(seed, self.n, self.length,
                                         mix["grad_scale"], device)
        self.session = FederatedSession(SessionConfig(
            topology=mix["topology"], n_shards=mix["n_shards"],
            engine="batched", codec=mix["codec"], schedule=mix["schedule"],
            keep_records=False, device=device))
        self.first_round = mix["warmup_rounds"]
        rng = np.random.default_rng(inputs.sub_seed(seed, 6))
        picks = rng.choice(np.arange(1, mix["sample_below"]),
                           size=mix["check_rounds"] - 1, replace=False)
        self.check_at = {self.first_round + int(i)
                         for i in [0, *picks.tolist()]}
        self.held: dict[int, torch.Tensor] = {}
        for r in range(self.first_round):
            self.round(r)

    def round(self, r: int) -> None:
        order = inputs.client_order(self.seed, r, self.n)
        with torch.profiler.record_function(self.SPAN):
            res = self.session.round([self.grads[i] for i in order], rnd=r)
            if self.device.startswith("cuda"):
                torch.cuda.synchronize()
        if r in self.check_at:
            self.held[r] = res.avg_flat

    def work(self) -> dict:
        """A round's work and least times (``cost.py``)."""
        n, length, mix = self.n, self.length, self.mix
        if mix["topology"] == "gradssharding":
            cuts = fold.uniform_cuts(length, mix["n_shards"])
            waves = [[(n, hi - lo, False) for lo, hi in cuts]]
        elif mix["topology"] == "lambda_fl":
            k = max(2, int(np.ceil(np.sqrt(n))))
            sizes = [min(k, n - g) for g in range(0, n, k)]
            waves = [[(s, length, False) for s in sizes],
                     [(len(sizes), length, True)]]
        else:
            raise ValueError(f"no cost for topology {mix['topology']!r}")
        fold_s = sum(cost.wave_cost(w)[2] for w in waves)
        codec_s = cost.codec_bound_s(n * length) \
            if mix["codec"] == "qsgd8" else 0.0
        return {"agg_bytes": 4 * n * length, "fold_bound_s": fold_s,
                "codec_bound_s": codec_s}

    def release(self) -> None:
        self.session = None
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def check(self) -> dict:
        worst = self.length if not self.held else 0
        mix = self.mix
        for r, got in sorted(self.held.items()):
            order = inputs.client_order(self.seed, r, self.n)
            want = fold.round_mean([self.grads[i] for i in order],
                                   mix["topology"], mix["codec"],
                                   mix["n_shards"])
            worst = max(worst, fold.mismatches(got, want))
            del want
        return {"mismatched_elements": (worst, self.limit)}
