"""The benchmark's inputs, made on the run's device from the seed: client
gradients, a GPT-2 parameter dict and Zipf-distributed token batches.
Program and reference are handed the same; the same seed gives the same
inputs. Nothing here imports the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one purpose, derived from the run's seed and the
    purpose's tags (any whole numbers, of any size)."""
    a, b = np.random.SeedSequence([int(seed), *map(int, tags)]) \
        .generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def generator(device: str, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


# ---------------------------------------------------------------------------
# Aggregation: N flat f32 client gradients
# ---------------------------------------------------------------------------

def client_grads(seed: int, n: int, length: int, scale: float,
                 device: str) -> torch.Tensor:
    """(n, length) f32, normal with standard deviation ``scale``, drawn in
    one call; row i is client i's gradient."""
    g = torch.randn((n, length), generator=generator(device, seed, 1),
                    device=device, dtype=torch.float32)
    return g.mul_(scale)


def client_order(seed: int, rnd: int, n: int) -> list[int]:
    """The order in which round ``rnd`` hands the clients over."""
    rng = np.random.default_rng(sub_seed(seed, 2, rnd))
    return [int(i) for i in rng.permutation(n)]


# ---------------------------------------------------------------------------
# GPT-2: parameters and token batches
# ---------------------------------------------------------------------------

def d_ff(cfg: dict) -> int:
    """The MLP's width: ``n_inner``, or GPT-2's 4 × ``n_embd`` where the
    published configuration leaves it null."""
    return cfg["n_inner"] or 4 * cfg["n_embd"]


def gpt2_leaves(cfg: dict) -> list[tuple[str, tuple, float | None]]:
    """Each parameter's name (the port's dotted names, stacked layers),
    shape and initial standard deviation (None: ones, a norm's gain). A
    tied head is the embedding's transpose and no leaf of its own."""
    d, n_l, h = cfg["n_embd"], cfg["n_layer"], cfg["n_head"]
    hd, ff, v = d // h, d_ff(cfg), cfg["vocab_size"]
    head = [] if cfg["tie_word_embeddings"] else [("lm_head", (d, v), 0.02)]
    return [("embed", (v, d), 0.02),
            ("final_norm", (d,), None),
            ("layers.attn.wk", (n_l, d, h, hd), 1 / math.sqrt(d)),
            ("layers.attn.wo", (n_l, h, hd, d), 1 / math.sqrt(h * hd)),
            ("layers.attn.wq", (n_l, d, h, hd), 1 / math.sqrt(d)),
            ("layers.attn.wv", (n_l, d, h, hd), 1 / math.sqrt(d)),
            ("layers.ln1", (n_l, d), None),
            ("layers.ln2", (n_l, d), None),
            ("layers.mlp.w1", (n_l, d, ff), 1 / math.sqrt(d)),
            ("layers.mlp.w2", (n_l, ff, d), 1 / math.sqrt(ff)), *head]


def param_count(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in gpt2_leaves(cfg))


def gpt2_params(cfg: dict, seed: int, device: str) -> dict:
    """f32 parameters: every drawn leaf a slice of one normal draw, scaled
    in place; the norms' gains ones."""
    leaves = gpt2_leaves(cfg)
    drawn = sum(math.prod(s) for _, s, std in leaves if std is not None)
    flat = torch.randn(drawn, generator=generator(device, seed, 3),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, std in leaves:
        if std is None:
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        size = math.prod(shape)
        out[name] = flat[off:off + size].view(shape).mul_(std)
        off += size
    return out


class ZipfTokens:
    """Token batches: ranks drawn from Zipf(s) over the whole vocabulary,
    mapped through a per-client permutation of the vocabulary, so each
    client's data has its own frequent tokens (non-IID)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.seed, self.device = seed, device
        self.vocab = cfg["vocab_size"]
        self.batch, self.seq = mix["batch"], mix["seq"]
        ranks = torch.arange(1, self.vocab + 1, dtype=torch.float64,
                             device=device)
        self.probs = ranks.pow(-float(mix["zipf_s"])).to(torch.float32)
        self.perms = [torch.randperm(self.vocab,
                                     generator=generator(device, seed, 4, c),
                                     device=device)
                      for c in range(mix["clients"])]

    def batch_of(self, rnd: int, client: int, step: int) -> dict:
        """The batch of one local step: ``tokens`` and the next-token
        ``labels``, (batch, seq) int64."""
        g = generator(self.device, self.seed, 5, rnd, client, step)
        ranks = torch.multinomial(self.probs, self.batch * (self.seq + 1),
                                  replacement=True, generator=g)
        toks = self.perms[client][ranks].view(self.batch, self.seq + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
