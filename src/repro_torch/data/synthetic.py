"""Deterministic synthetic data pipelines.

* ``SyntheticLM`` — the reference's order-1 Markov token stream with a
  client-dependent transition bias (non-IID across federated clients), so
  a trained model beats the uniform-entropy floor. Tokens arrive as int64
  tensors.
* ``SyntheticVision`` — class-conditional Gaussian blobs over image space;
  linearly separable. Images arrive as (B, H, W, C) f32 tensors, labels
  as int64 tensors.

Sampling is stateless: (seed, client, step) -> batch, on the reference's
numpy PCG64 streams, so every batch holds the reference's values byte for
byte. ``lm_batch_specs`` gives a token batch's stand-ins on the ``meta``
device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def lm_batch_specs(batch: int, seq: int) -> dict:
    """The reference's token batch (int32) as tensors on the meta device."""
    spec = lambda: torch.empty((batch, seq), dtype=torch.int32, device="meta")
    return {"tokens": spec(), "labels": spec()}


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


@dataclass(frozen=True)
class SyntheticVision:
    n_classes: int = 10
    img_size: int = 32
    channels: int = 3
    seed: int = 0
    noise: float = 0.6

    def _prototypes(self) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 104729))
        return rng.standard_normal(
            (self.n_classes, self.img_size, self.img_size, self.channels)
        ).astype(np.float32)

    def batch(self, client: int, step: int, batch_size: int,
              labels: np.ndarray | None = None,
              device: str | torch.device = "cpu") -> dict:
        """Images (B, H, W, C) f32 and labels (B,) int64, tensors on
        ``device``; ``labels`` picks the classes, else they are drawn."""
        rng = np.random.default_rng((self.seed, client, step))
        if labels is None:
            labels = rng.integers(0, self.n_classes, batch_size)
        protos = self._prototypes()
        imgs = protos[labels] + self.noise * rng.standard_normal(
            (batch_size, self.img_size, self.img_size, self.channels)
        ).astype(np.float32)
        return {"images": torch.from_numpy(imgs).to(device),
                "labels": torch.from_numpy(np.asarray(labels, np.int64))
                .to(device)}
