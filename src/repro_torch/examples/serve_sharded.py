"""Batched serving with a KV-cache decode step.

Greedy-decodes a batch of prompts with any ``--arch`` (reduced config),
exercising the same `make_serve_step` the dry run counts. Works for
dense, SWA, MoE, SSM, hybrid and enc-dec families; on the card every
RMSNorm of a decode step is one launch of the rmsnorm kernel.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_sharded \
          --arch zamba2-2.7b [--device cpu]
"""
import argparse

from repro_torch.configs import arch_ids, get_arch
from repro_torch.launch.serve import serve_loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=arch_ids() + ["gpt2-large"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=8)
    ap.add_argument("--new_tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).smoke
    out = serve_loop(cfg, batch=args.batch, prompt_len=args.prompt_len,
                     max_new_tokens=args.new_tokens,
                     max_len=args.prompt_len + args.new_tokens + 8,
                     device=args.device)
    print(f"arch={args.arch} ({cfg.family}) "
          f"generated={out['generated'].shape} "
          f"throughput={out['tokens_per_s']:.1f} tok/s "
          f"wall={out['wall_s']:.2f}s")
    print("sample token ids:", out["generated"][0][:16].tolist())
    return {"arch": args.arch, "family": cfg.family, **out}


if __name__ == "__main__":
    main()
