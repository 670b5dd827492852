"""Quickstart: the session API in ~15 lines.

One ``SessionConfig`` declares the whole substrate (topology, shard count,
engine, schedule, upload model, device); ``session.round(grads)`` runs a
simulated serverless aggregation round. Swapping the topology — including
the ``sharded_tree`` plugin registered via ``@register_topology`` —
changes cost and latency, never the learning result: GradsSharding is
bit-identical to full-vector FedAvg, and sharded_tree is bit-identical to
λ-FL.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart \
          [--schedule pipelined --readahead-k 4 --workers 4] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import FederatedSession, SessionConfig
from repro_torch.core.cost_model import UploadModel

N_CLIENTS, M, GRAD_SIZE = 20, 4, 100_000
TOPOLOGIES = ("gradssharding", "lambda_fl", "lifl", "sharded_tree")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--schedule", default=None,
                    choices=["barrier", "pipelined"])
    ap.add_argument("--readahead-k", type=int, default=None,
                    help="pipelined out-of-order prefetch window (GET up "
                         "to k contributions ahead of the fold frontier; "
                         "fold order, and thus the result bits, never "
                         "change)")
    ap.add_argument("--upload-mbps", type=float, default=None)
    ap.add_argument("--jitter-s", type=float, default=0.0)
    ap.add_argument("--codec", default=None,
                    choices=["identity", "fp16", "qsgd8", "topk"],
                    help="on-the-wire contribution format (default: "
                         "REPRO_AGG_CODEC / identity); lossy codecs are "
                         "deterministic and report codec_error")
    ap.add_argument("--workers", default=None,
                    help="host fold-pool width: an int or 'auto' "
                         "(default: REPRO_AGG_WORKERS / all host cores). "
                         "Folds shard across cores by element span, so "
                         "the result bits never depend on this")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    upload = None
    if args.upload_mbps or args.jitter_s:
        upload = UploadModel(mbps=args.upload_mbps, jitter_s=args.jitter_s)

    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(GRAD_SIZE).astype(np.float32)
             for _ in range(N_CLIENTS)]
    reference = np.mean(grads, axis=0, dtype=np.float32)

    out = {"topologies": {}}
    for topology in TOPOLOGIES:
        session = FederatedSession(SessionConfig(
            topology=topology, n_shards=M, schedule=args.schedule,
            readahead_k=args.readahead_k, upload=upload, codec=args.codec,
            workers=args.workers, device=args.device))
        r = session.round(grads)
        row = out["topologies"][topology] = {
            "avg_flat": r.avg_flat.cpu().numpy(),
            "wall_clock_s": r.wall_clock_s, "phases": len(r.phases_s),
            "puts": r.puts, "gets": r.gets,
            "peak_memory_mb": r.peak_memory_mb,
            "billed_gb_s": [rec.billed_gb_s for rec in r.records],
            "cost": session.total_cost(), "codec": r.codec,
            "codec_error": r.codec_error}
        print(f"{topology:14s}: wall {r.wall_clock_s:6.2f}s "
              f"({len(r.phases_s)} phase(s)), ops {r.puts}P+{r.gets}G, "
              f"peak-mem {r.peak_memory_mb:5.0f} MB, "
              f"cost ${session.total_cost():.8f}/round"
              + (f", codec_error {r.codec_error:.2e}"
                 if r.codec != "identity" else ""))

    rows = out["topologies"]
    if rows["gradssharding"]["codec"] == "identity":
        # the paper's equivalence claims, extended to the plugin topology
        # (exact bit-identity is the *identity* codec's contract; lossy
        # codecs guarantee determinism and a reported codec_error instead)
        if not np.array_equal(rows["gradssharding"]["avg_flat"],
                              _streaming_mean(grads)):
            raise AssertionError("gradssharding != the streaming mean")
        if not np.array_equal(rows["sharded_tree"]["avg_flat"],
                              rows["lambda_fl"]["avg_flat"]):
            raise AssertionError("sharded_tree != lambda_fl")
        for topology, row in rows.items():
            if not np.allclose(row["avg_flat"], reference, rtol=1e-5,
                               atol=1e-6):
                raise AssertionError(f"{topology}: mean off the reference")
        print("gradssharding bit-identical to full FedAvg: True")
        print("sharded_tree bit-identical to lambda_fl:    True")
        out["bit_identical"] = True
    return out


def _streaming_mean(grads):
    acc = grads[0].copy()
    for g in grads[1:]:
        acc += g
    return acc / len(grads)


if __name__ == "__main__":
    main()
