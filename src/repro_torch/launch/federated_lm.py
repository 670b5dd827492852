"""Federated training of a transformer LM through the serverless
GradsSharding aggregation substrate, on the card.

The counterpart of the reference's ``examples/train_federated_lm.py``:
N clients each hold a non-IID synthetic Markov token stream
(:class:`repro_torch.data.SyntheticLM`); every round each client starts
from a copy of the global parameters, takes ``local_steps`` SGD-with-
momentum steps (``local_sgd_update``: the rmsnorm kernel in every
forward, the fused-SGD kernel on every leaf), and uploads its model delta
flattened to one f32 vector on the device. The session averages the N
deltas (the fold kernel, under the batched engine) and every client
applies the mean. Swapping ``topology``, ``schedule`` or ``engine`` changes
cost and modeled latency, never the trajectory.

Run (the smoke configuration, on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.federated_lm --smoke \\
        --device cpu --rounds 3 --clients 3 --shards 2 --local_steps 2 \\
        --batch 4 --seq 32

Without ``--smoke`` it trains the registered configuration at full width
(``tinyllama-1.1b``, 1.1 B parameters), which needs the card. The
reference's example overrides the vocabulary to 256; this trainer keeps
the configuration's own, and ``SyntheticLM`` still draws from a 256-token
sub-vocabulary.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.api import FederatedSession, SessionConfig, resolve_device
from repro_torch.config import ModelConfig
from repro_torch.configs import get_arch
from repro_torch.core.cost_model import UploadModel
from repro_torch.core.fedavg import apply_delta, local_sgd_update, model_delta
from repro_torch.core.sharding import flatten, leaf_order, unflatten
from repro_torch.data import SyntheticLM
from repro_torch.models import registry as models


MOMENTUM = 0.9      # the paper's client optimizer: SGD with momentum 0.9
SEED = 0            # parameters, when the caller gives none


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: ModelConfig, *, rounds: int = 10, clients: int = 4,
        shards: int = 4, local_steps: int = 4, batch: int = 8, seq: int = 64,
        lr: float = 0.1, topology: str = "gradssharding",
        partition: str = "uniform", schedule: str | None = None, engine: str | None = None,
        readahead_k: int | None = None, codec: str | None = None,
        upload: UploadModel | None = None, device: str = "cuda",
        params: dict | None = None, on_round=None) -> dict:
    """Train ``cfg`` for ``rounds`` federated rounds; returns the final
    ``params``, per-round records (``rounds``: client losses, their mean,
    host walls, op counts) and the ``session``.

    ``params`` (a parameter dict, e.g. ``convert.params_from_jax``) is the
    starting point; without it the parameters come from a
    ``torch.Generator`` on the device seeded with ``SEED``. Host walls are
    taken around work that ends in a device synchronisation:
    ``client_walls_s`` per client's local training and upload flatten,
    ``agg_wall_s`` per aggregation round. ``on_round(rnd, result, flats)``
    sees each round's result and its client flats before the mean is
    applied.

    Each round's store objects are dropped after the round
    (``keep_records=False``): at 1.1 B parameters a round's shards and
    outputs hold 22 GB, and op counts and billing survive compaction.
    """
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = models.init_params(gen, cfg)
    else:
        params = {k: v.detach().to(dev) for k, v in params.items()}
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=0,
                       markov_concentration=0.4)

    def loss_fn(p, b):
        return models.loss_fn(p, cfg, b)

    tensor_sizes = None
    if partition != "uniform":
        tensor_sizes = [params[k].numel() for k in leaf_order(params)]

    session = FederatedSession(SessionConfig(
        topology=topology, n_shards=shards, partition=partition,
        tensor_sizes=tensor_sizes, engine=engine, schedule=schedule,
        readahead_k=readahead_k, codec=codec, upload=upload,
        keep_records=False, device=str(dev)))
    print(f"federated {cfg.name} ({models.param_count(cfg):,} params), "
          f"N={clients} clients, topology={topology} M={shards}, "
          f"schedule={schedule or 'barrier'}, device={dev}")
    t_start = time.perf_counter()
    records = []
    for rnd in range(rounds):
        flats, losses, client_walls = [], [], []
        spec = None
        for c in range(clients):
            t0 = time.perf_counter()
            local = {k: v.detach().clone() for k, v in params.items()}
            vel, loss = None, None
            for s in range(local_steps):
                b = data.batch(c, rnd * local_steps + s, batch, device=dev)
                local, vel, loss = local_sgd_update(
                    loss_fn, local, b, lr=lr, momentum=MOMENTUM,
                    velocity=vel)
            losses.append(float(loss))
            flat, spec = flatten(model_delta(params, local))
            del local, vel
            flats.append(flat)
            _sync(dev)
            client_walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        res = session.round(flats, rnd=rnd)
        _sync(dev)
        agg_wall = time.perf_counter() - t0
        if on_round is not None:
            on_round(rnd, res, flats)
        del flats
        params = apply_delta(params, unflatten(res.avg_flat, spec))
        records.append({"client_losses": losses,
                        "mean_loss": float(np.mean(losses)),
                        "client_walls_s": client_walls,
                        "agg_wall_s": agg_wall,
                        "modeled_wall_s": res.wall_clock_s,
                        "puts": res.puts, "gets": res.gets,
                        "codec_error": res.codec_error})
        codec_note = "" if res.codec == "identity" \
            else f" {res.codec} err={res.codec_error:.1e}"
        print(f"round {rnd:3d}  client-loss {np.mean(losses):.4f}  "
              f"agg-wall {res.wall_clock_s:.2f}s  "
              f"ops {res.puts}P/{res.gets}G  "
              f"peak-mem {res.peak_memory_mb:.0f}MB  "
              f"[{res.schedule}{codec_note}]")
        del res
    print(f"session wall (modeled): {session.session_wall_s:.2f}s  "
          f"vs sum-of-round-walls {session.sum_round_walls_s:.2f}s")
    print(f"total lambda cost: ${session.lambda_cost():.6f}  "
          f"({time.perf_counter() - t_start:.1f}s real)")
    return {"params": params, "rounds": records, "session": session}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="train the arch's reduced smoke configuration")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--local_steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--topology", default="gradssharding",
                    choices=["gradssharding", "lambda_fl", "lifl"])
    ap.add_argument("--partition", default="uniform",
                    choices=["uniform", "balanced", "layer_contiguous"])
    ap.add_argument("--schedule", default=None,
                    choices=["barrier", "pipelined"],
                    help="round schedule (default: REPRO_AGG_SCHEDULE / "
                         "barrier)")
    ap.add_argument("--engine", default=None,
                    choices=["streaming", "batched", "incremental"])
    ap.add_argument("--readahead-k", type=int, default=None,
                    help="pipelined read-ahead window (default: "
                         "REPRO_AGG_READAHEAD / 1)")
    ap.add_argument("--codec", default=None,
                    choices=["identity", "fp16", "qsgd8", "topk"],
                    help="wire codec for client uploads (default: "
                         "REPRO_AGG_CODEC / identity)")
    ap.add_argument("--upload-mbps", type=float, default=None,
                    help="per-client uplink MB/s (None = instantaneous)")
    ap.add_argument("--download-mbps", type=float, default=None)
    ap.add_argument("--jitter-s", type=float, default=0.0,
                    help="max per-client upload start jitter (seconds)")
    ap.add_argument("--rate-jitter", type=float, default=0.0)
    ap.add_argument("--local-compute-s", type=float, default=0.0,
                    help="modeled per-client local training time per round")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    cfg = dataclasses.replace(spec.smoke if args.smoke else spec.model,
                              remat=False)
    upload = None
    if args.upload_mbps or args.download_mbps or args.jitter_s \
            or args.rate_jitter or args.local_compute_s:
        upload = UploadModel(mbps=args.upload_mbps,
                             download_mbps=args.download_mbps,
                             jitter_s=args.jitter_s,
                             rate_jitter=args.rate_jitter,
                             compute_s=args.local_compute_s)
    return run(cfg, rounds=args.rounds, clients=args.clients,
               shards=args.shards, local_steps=args.local_steps,
               batch=args.batch, seq=args.seq, lr=args.lr,
               topology=args.topology, partition=args.partition,
               schedule=args.schedule, engine=args.engine,
               readahead_k=args.readahead_k, codec=args.codec,
               upload=upload, device=args.device)


if __name__ == "__main__":
    main()
