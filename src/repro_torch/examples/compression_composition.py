"""Per-shard gradient compression composed with GradsSharding (paper §VI:
"compression ... can be composed by compressing each shard before upload").

The wire format is a first-class session knob: ``SessionConfig(codec=...)``
makes clients PUT codec-encoded shards, the store/op-log/billing see wire
bytes, and aggregators decode-before-fold — on the card through the
quantize, dequantize and top-k kernels. For each registered codec the
example reports bytes-on-the-wire, modeled round wall-clock, billed GB-s,
and the per-round ``codec_error`` the session surfaces (max-abs vs the
uncompressed reference).

Run:  PYTHONPATH=src python -m repro_torch.examples.compression_composition \
          [--topology gradssharding --clients 8 --shards 4 --size 200000]
          [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import FederatedSession, SessionConfig
from repro_torch.core.cost_model import UploadModel
from repro_torch.core.wire_codec import available_codecs, get_codec

MB = 1e6
CODECS = ("identity", "fp16", "qsgd8", "topk")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--topology", default="gradssharding",
                    choices=["gradssharding", "lambda_fl", "lifl",
                             "sharded_tree"])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--size", type=int, default=200_000)
    ap.add_argument("--upload-mbps", type=float, default=16.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(args.size).astype(np.float32)
             for _ in range(args.clients)]
    upload = UploadModel(mbps=args.upload_mbps)
    raw_upload_bytes = args.clients * args.size * 4

    print(f"{args.topology}, N={args.clients}, M={args.shards}, "
          f"|g|={args.size * 4 / MB:.2f} MB/client, "
          f"codecs: {', '.join(available_codecs())}\n")
    out = {"raw_upload_mb": raw_upload_bytes / MB, "codecs": {}}
    base_wall = None
    for codec in CODECS:
        session = FederatedSession(SessionConfig(
            topology=args.topology, n_shards=args.shards,
            schedule="pipelined", upload=upload, codec=codec,
            device=args.device))
        r = session.round(grads)
        # client-upload wire volume: every PUT of the round minus the
        # aggregator outputs (which stay raw f32)
        out_bytes = sum(nb for key, nb in session.store.stats.put_log
                        if "/avg/" in key or "/partial/" in key)
        wire = session.store.stats.bytes_written - out_bytes
        billed = sum(rec.billed_gb_s for rec in r.records)
        if base_wall is None:
            base_wall = r.wall_clock_s
        out["codecs"][codec] = {
            "avg_flat": r.avg_flat.cpu().numpy(), "wire_mb": wire / MB,
            "wall_clock_s": r.wall_clock_s, "billed_gb_s": billed,
            "codec_error": r.codec_error, "codec": r.codec}
        print(f"{codec:9s}: wire {wire / MB:7.2f} MB "
              f"(vs {raw_upload_bytes / MB:.2f} MB raw, "
              f"{raw_upload_bytes / wire:4.1f}x smaller)  "
              f"wall {r.wall_clock_s:6.2f}s "
              f"({base_wall / r.wall_clock_s:.2f}x)  "
              f"billed {billed:.3f} GB-s  "
              f"codec_error {r.codec_error:.2e}")
        if r.codec != get_codec(codec).name:
            raise AssertionError(f"the round ran codec {r.codec!r}, "
                                 f"not {codec!r}")

    print("\nS3-transfer implication (paper: I/O is >90% of time & the "
          "dominant cost): 4x fewer bytes ≈ 4x faster aggregation reads "
          "and proportionally lower Lambda GB-s on the transfer-bound "
          "path — and codec_error makes the accuracy cost observable "
          "instead of silent.")
    return out


if __name__ == "__main__":
    main()
