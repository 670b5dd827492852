"""Elastic shard-count restart: checkpoint at M=4, resume at M=8.

The paper's "adaptive shard counts" future work: a training run saves its
state sharded by logical shard index; after a (simulated) failure the
deployment re-tunes M — e.g. the model grew past the per-function memory
budget — and the restart re-partitions without losing a step. Also shows
`min_shards_for` picking M automatically from the Lambda memory limit.

Run:  PYTHONPATH=src python -m repro_torch.examples.elastic_reshard \
          [--device cpu]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import load_resharded, save_sharded
from repro_torch.core import cost_model as cm
from repro_torch.core.sharding import make_plan, reconstruct, resolve_device

MB = 1024 * 1024


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    theta = torch.from_numpy(
        rng.standard_normal(1_000_003).astype(np.float32)).to(device)

    out = {}
    with tempfile.TemporaryDirectory() as d:
        plan4 = make_plan("uniform", theta.numel(), 4)
        save_sharded(d, theta, plan4, step=100,
                     extra={"note": "round 100, M=4"})
        out["saved_shard_sizes"] = plan4.shard_sizes()
        print(f"saved step 100 at M=4: shard sizes {plan4.shard_sizes()}")

        # --- simulated operator decision: resume at M=8 -------------------
        shards, plan8, meta = load_resharded(d, 100, new_m=8)
        out["resumed_shard_sizes"] = plan8.shard_sizes()
        out["meta_extra"] = meta["extra"]
        print(f"resumed at M=8: shard sizes {plan8.shard_sizes()} "
              f"(meta: {meta['extra']})")
        restored = reconstruct([s.to(device) for s in shards], plan8)
        if not torch.equal(restored, theta):
            raise AssertionError("the restored state differs from the "
                                 "saved one")
        out["restored"] = restored.cpu().numpy()
        print("state after reshard: bit-identical  ✓")

        # --- automatic M from the platform memory limit --------------------
        out["min_shards"] = {}
        for grad_mb in (512, 2953, 5120, 10_240, 102_400):
            m = cm.min_shards_for(grad_mb * MB)
            mem = cm.lambda_memory_mb("gradssharding", grad_mb * MB, m)
            out["min_shards"][grad_mb] = (m, mem)
            print(f"gradient {grad_mb:>7d} MB -> min M = {m:>3d} "
                  f"({mem:.0f} MB/function, limit 10,240)")
    return out


if __name__ == "__main__":
    main()
