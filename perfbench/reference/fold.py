"""Plain reference of an aggregation round's mean, in whole-tensor torch
ops: what a GradsSharding or λ-FL round of N flat f32 gradients, as
given, in the order given, must return, bit for bit.

* GradsSharding, ``identity``: per element, an f32 left fold over the
  clients in order and one IEEE f32 divide by N (the shards are disjoint
  element ranges, so the cut does not enter the arithmetic).
* GradsSharding, ``qsgd8``: each client's shard (the uniform cut into M
  contiguous ranges, the first ``L mod M`` one element longer) is coded
  per 4096-element tile of the shard: ``scale = amax / 127`` (1.0 where
  ``amax`` is 0), ``code = clip(round_half_even(x / scale), ±127)``, and
  decoded ``f32(code) · scale``; the decoded values are folded as above.
* λ-FL: leaves of ``k = max(2, ceil(sqrt(N)))`` consecutive clients, each
  the unweighted f32 mean of its clients; the root an f64 fold of each
  leaf's mean times its client count (the multiply skipped for a weight
  of exactly 1), one f64 divide by the summed counts, rounded to f32.

Every divide takes a 0-d tensor on the values' device: a divide by a
Python number may multiply by the reciprocal. ``lower=True`` is the
control: every stage one precision below the configured one (bf16 for
f32, f32 for f64). Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

QMAX = 127.0
TILE = 4096


def _scalar(value: float, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def mean_f32(xs, lower: bool = False) -> torch.Tensor:
    """The unweighted mean, an f32 (bf16) left fold and one divide."""
    dt = torch.bfloat16 if lower else torch.float32
    acc = xs[0].to(dt, copy=True)
    for x in xs[1:]:
        acc.add_(x.to(dt))
    return acc.div_(_scalar(float(len(xs)), dt, acc.device)) \
        .to(torch.float32)


def mean_weighted_f64(xs, weights, lower: bool = False) -> torch.Tensor:
    """The weighted mean: an f64 (f32) fold of x·w, one divide by the
    weights' sum, rounded to f32."""
    dt = torch.float32 if lower else torch.float64
    acc = None
    for x, w in zip(xs, weights):
        term = x.to(dt, copy=True)
        if w != 1.0:
            term.mul_(w)
        acc = term if acc is None else acc.add_(term)
    return acc.div_(_scalar(float(sum(weights)), dt, acc.device)) \
        .to(torch.float32)


def uniform_cuts(length: int, m: int) -> list[tuple[int, int]]:
    """M contiguous ranges; the first ``length mod M`` one longer."""
    base, rem = divmod(length, m)
    cuts, lo = [], 0
    for j in range(m):
        hi = lo + base + (1 if j < rem else 0)
        cuts.append((lo, hi))
        lo = hi
    return cuts


def qsgd8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Code and decode one flat f32 vector, tile by tile from its start."""
    n = int(x.shape[0])
    tiles = -(-n // TILE)
    t = torch.zeros(tiles * TILE, dtype=torch.float32, device=x.device)
    t[:n] = x
    t = t.view(tiles, TILE)
    amax = t.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / _scalar(QMAX, torch.float32,
                                                 x.device),
                        _scalar(1.0, torch.float32, x.device))
    codes = torch.clamp(torch.round(t / scale[:, None]), -QMAX, QMAX)
    codes = torch.nan_to_num(codes, nan=0.0).to(torch.int8)
    return (codes.to(torch.float32) * scale[:, None]).reshape(-1)[:n]


def round_mean(xs, topology: str, codec: str, n_shards: int,
               lower: bool = False) -> torch.Tensor:
    """The mean a round of the client gradients ``xs`` (in fold order)
    returns."""
    if codec == "qsgd8":
        if topology != "gradssharding":
            raise ValueError(f"no qsgd8 reference for {topology!r}")
        length = int(xs[0].shape[0])
        out = torch.empty(length, dtype=torch.float32, device=xs[0].device)
        for lo, hi in uniform_cuts(length, n_shards):
            out[lo:hi] = mean_f32([qsgd8_roundtrip(x[lo:hi]) for x in xs],
                                  lower)
        return out
    if codec != "identity":
        raise ValueError(f"no reference for codec {codec!r}")
    if topology == "gradssharding":
        return mean_f32(xs, lower)
    if topology == "lambda_fl":
        n = len(xs)
        k = max(2, math.ceil(math.sqrt(n)))
        groups = [list(range(g, min(g + k, n))) for g in range(0, n, k)]
        leaves = [mean_f32([xs[i] for i in g], lower) for g in groups]
        return mean_weighted_f64(leaves, [float(len(g)) for g in groups],
                                 lower)
    raise ValueError(f"no reference for topology {topology!r}")


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements whose bits differ (every element when the shapes or types
    differ)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return int(want.numel())
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())
