"""Serverless federated training loop (the paper's setting).

The port's share of the reference's ``launch/train.py``: the multi-round
``federated_train_loop``. The single-program trainer (``train_loop``,
GSPMD and shard_map paths, checkpoints) is not ported yet (ROADMAP queue
1, item 4).
"""
from __future__ import annotations


def federated_train_loop(client_grad_fn, *, rounds: int,
                         topology: str = "gradssharding", n_shards: int = 4,
                         partition: str = "uniform", tensor_sizes=None,
                         engine=None, schedule: str | None = None,
                         upload=None, store=None, runtime=None,
                         on_round=None, device: str = "cuda") -> dict:
    """Multi-round serverless aggregation loop.

    ``client_grad_fn(rnd)`` returns the round's client gradients (flat f32
    vectors, numpy arrays or tensors — typically local-SGD deltas). Rounds
    run through a :class:`repro_torch.api.FederatedSession` on ``device``
    (the card unless the caller asks for ``"cpu"``), which threads
    per-client timing internally so pipelined sessions overlap rounds.
    ``on_round(rnd, result)`` is called after each round (apply the
    update, log). Returns the results plus session timing:
    ``session_wall_s`` (makespan) and ``sum_round_walls_s`` (what a fully
    barriered session would report).
    """
    from repro_torch.api import FederatedSession, SessionConfig

    session = FederatedSession(
        SessionConfig(topology=topology, n_shards=n_shards,
                      partition=partition, tensor_sizes=tensor_sizes,
                      engine=engine, schedule=schedule, upload=upload,
                      device=device),
        store=store, runtime=runtime)
    results = []
    for rnd, res in enumerate(session.run(client_grad_fn, rounds)):
        results.append(res)
        if on_round is not None:
            on_round(rnd, res)
    return {
        "results": results,
        "session_wall_s": session.session_wall_s,
        "sum_round_walls_s": session.sum_round_walls_s,
        "lambda_cost": session.runtime.total_cost(),
        "store": session.store,
        "runtime": session.runtime,
    }
