"""Deterministic synthetic language-model data.

``SyntheticLM`` is the reference's order-1 Markov token stream with a
client-dependent transition bias (non-IID across federated clients), so a
trained model beats the uniform-entropy floor. Sampling is stateless:
(seed, client, step) -> batch, on the reference's numpy PCG64 streams, so
every batch holds the reference's tokens byte for byte; they arrive as
int64 tensors. ``SyntheticVision`` waits for the CNN family (ROADMAP
queue 1, item 11).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    seed: int = 0
    markov_concentration: float = 0.5   # lower = more predictable

    def _transition_logits(self, client: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 7919, client))
        return rng.gumbel(size=(min(self.vocab, 256),
                                min(self.vocab, 256))) \
            / self.markov_concentration

    def batch(self, client: int, step: int, batch_size: int,
              device: str | torch.device = "cpu") -> dict:
        """Markov chain over an effective sub-vocab (<=256 for tractable
        transition tables); labels are next tokens. (B, S) int64 tensors
        on ``device``."""
        v = min(self.vocab, 256)
        logits = self._transition_logits(client)
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        rng = np.random.default_rng((self.seed, client, step))
        toks = np.zeros((batch_size, self.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, v, batch_size)
        # vectorized markov sampling via inverse-CDF per step
        cdf = np.cumsum(probs, axis=1)
        for t in range(self.seq_len):
            u = rng.random(batch_size)
            toks[:, t + 1] = (u[:, None] < cdf[toks[:, t]]).argmax(axis=1)
        toks = torch.from_numpy(toks)
        return {"tokens": toks[:, :-1].contiguous().to(device),
                "labels": toks[:, 1:].contiguous().to(device)}
