"""Lazy sub-stream sampling for seeded per-cohort random draws.

The determinism contract of :class:`~repro_torch.core.cost_model.UploadModel`
and :class:`~repro_torch.serverless.faults.FaultModel` keys every per-client
draw by *cohort index* inside one ``default_rng([seed, round, stream])``
stream: client ``i``'s jitter is element ``i`` of a length-N vectorized
draw, so membership changes never perturb anyone else's schedule. The
eager implementation materializes all N draws even when only K << N
clients participate — at million-client scale that is an O(N) host pass
per stream per round.

:func:`gather_stream` recovers exactly the requested elements in
O(K + runs) work instead: PCG64's ``advance`` jumps the bit-generator
over the gaps between contiguous index runs, and each run is drawn with
the *same* vectorized call the eager path uses. numpy's float64
``random``/``uniform`` paths consume exactly one 64-bit state step per
element, so the gathered slice is bit-identical to slicing the full
draw — the property the population engine's eager-equivalence tests
pin down.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

#: draw(rng, size) -> float64 array consuming exactly ``size`` state steps
DrawFn = Callable[[np.random.Generator, int], np.ndarray]


def gather_stream(key: Sequence[int], idx, draw: DrawFn, *,
                  skip: int = 0) -> np.ndarray:
    """Elements ``idx`` of the virtual array ``draw(default_rng(key), N)``.

    ``skip`` positions the stream past draws consumed earlier from the
    same generator (``UploadModel.plan`` draws starts, then mults, from
    one stream). ``idx`` may be in any order but must be unique; the
    result is returned in ``idx`` order. Bit-identical to
    ``draw(rng, N)[idx]`` for one-step-per-element float64 draws
    (``Generator.random`` / ``Generator.uniform``).
    """
    idx = np.asarray(idx, dtype=np.int64)
    out = np.empty(len(idx))
    if len(idx) == 0:
        return out
    order = None
    if np.any(np.diff(idx) <= 0):          # unsorted (quorum fold order)
        order = np.argsort(idx, kind="stable")
        idx = idx[order]
        if np.any(np.diff(idx) <= 0):
            raise ValueError("gather_stream: idx must be unique")
    if idx[0] < 0:
        raise ValueError("gather_stream: idx must be non-negative")
    rng = np.random.default_rng(key)
    advance = rng.bit_generator.advance
    if skip:
        advance(int(skip))
    # contiguous runs of idx: one vectorized draw per run, one state jump
    # per gap — full participation is a single run, a sparse cohort is
    # O(runs) python steps
    cuts = np.flatnonzero(np.diff(idx) != 1) + 1
    run_starts = np.concatenate(([0], cuts))
    run_ends = np.concatenate((cuts, [len(idx)]))
    gathered = out if order is None else np.empty(len(idx))
    pos = 0
    for s, e in zip(run_starts, run_ends):
        lo = int(idx[s])
        if lo > pos:
            advance(lo - pos)
        gathered[s:e] = draw(rng, int(e - s))
        pos = int(idx[e - 1]) + 1
    if order is not None:
        out[order] = gathered
    return out
