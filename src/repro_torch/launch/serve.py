"""Batched serving: greedy cache decode of an LM of any family, on one
device or a mesh.

The counterpart of the reference's ``launch/serve.py``. ``make_serve_step``
gives one decode step, ``(params, tokens, cache) -> (logits, cache)``;
``serve_loop`` greedy-decodes a batch of seeded prompts: it prefills by
repeated decode steps against the cache, then generates. An
encoder-decoder model's cache is built once from seeded frame embeddings
(the encoder's one run). On the card every norm of a step runs the
rmsnorm kernel (2·L + 1 launches a step for an attention stack, 2·L more
under ``qk_norm``; ``models.norms_per_decode_step`` counts every family).

Under a mesh the step follows the reference's partition specs: each rank
holds its ``model``-axis block of every weight (``param_pspecs``), its
rows of the batch and its block of the cache (``cache_pspecs``: kv heads
over ``model``, or the ring's length where the kv heads do not divide),
the step runs tensor-parallel, every family alike, and the logits are
all-gathered to the whole (B, 1, V) on every rank. An encoder-decoder's
cross-attention cache splits as the self-attention ring does (its kv
heads, or its 1,500 encoder positions over ``model``); a Mamba cache holds
this rank's channels and heads.

Run (the smoke configuration, on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

As in the reference, ``--smoke`` is on by default and cannot be turned
off from the command line, so ``main`` always serves the smoke
configuration; a full-width configuration is served by calling
``serve_loop`` with it.
"""
from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from repro_torch.config import ModelConfig, ShapeConfig, ShardingPlan
from repro_torch.core import device_agg
from repro_torch.core.sharding import resolve_device
from repro_torch.launch import partitioning as parts
from repro_torch.launch.hostenv import host_timer, maybe_preload_tcmalloc
from repro_torch.models import encdec, meshctx
from repro_torch.models import registry as models
from repro_torch.models.transformer import map_tree

#: the norms' γ, which keep ``param_dtype`` when the weights are cast for
#: serving: the reference's rmsnorm casts γ to f32, so a bf16 γ would
#: change bits
NORM_LEAVES = ("ln", "ln1", "ln2", "lnx", "final_norm", "enc_norm", "qnorm",
               "knorm", "norm_g")


def cast_for_serving(params: dict, cfg: ModelConfig) -> dict:
    """Every weight cast to ``cfg.compute_dtype`` once; the norms' γ and the
    f32 leaves (``models.F32_LEAVES``: the MoE router, the SSM's
    ``dt_bias``, ``a_log`` and ``d_skip``, which the reference reads in
    f32) left as they are. The model casts each weight to the compute
    type before its product; after this the cast is a no-op instead of a
    pass over every weight each step, and the bits are the same."""
    keep = NORM_LEAVES + models.F32_LEAVES
    cd = cfg.compute_dtype
    return {name: t if name.rsplit(".", 1)[-1] in keep else t.to(cd)
            for name, t in params.items()}


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                    cache_like=None, plan=None, donate: bool = True):
    """One decode step, ``(params, tokens, cache) -> (logits, cache)``,
    under ``torch.inference_mode``. ``donate=True`` writes the cache in
    place and returns it; ``donate=False`` leaves the caller's cache,
    nested dicts included, as it was and returns a new one.

    With a ``mesh`` (called in every rank with the same global tokens),
    the reference's specs for ``shape``, ``cache_like`` (the whole cache,
    or its specs on the meta device) and ``plan`` (default ``none``) place
    each input: a whole weight or cache leaf is cut to this rank's block
    on the way in (a block passes through), the tokens to its rows. The
    cache comes back as this rank's block and the logits whole. With
    neither a mesh nor a plan it is the one-device step."""
    if mesh is None and plan is None:
        @torch.inference_mode()
        def serve_step(params, tokens, cache):
            if not donate:
                cache = map_tree(torch.clone, cache)
            return models.decode_step(params, cfg, tokens, cache)

        return serve_step
    if mesh is None:
        raise ValueError("a sharding plan needs a mesh")
    plan = plan or ShardingPlan(grad_sharding="none")
    c_specs = parts.cache_pspecs(cfg, shape, mesh, cache_like)
    t_spec = parts.decode_token_pspec(shape, mesh)
    length_axes = parts.kv_length_axes(c_specs)
    cross_axes = parts.kv_length_axes(c_specs, "xk")
    tp = parts.axis_sizes(mesh).get("model", 1)
    p_local = parts.local_param_shapes(cfg, mesh, plan)
    rows = device_agg.replica_size(mesh) > 1 and t_spec[0] is not None
    ctx = (lambda: meshctx.use_mesh(mesh)) if tp > 1 else \
        contextlib.nullcontext

    def place(spec, leaf, whole):
        if isinstance(leaf, dict):
            return {k: place(spec[k], v, whole[k]) for k, v in leaf.items()}
        if tuple(leaf.shape) == parts.local_shape(spec, whole.shape, mesh,
                                                  False):
            return leaf
        return leaf[parts.rank_block(spec, leaf.shape, mesh)].clone()

    @torch.inference_mode()
    def serve_step(params, tokens, cache):
        if any(tuple(t.shape) != p_local[k] for k, t in params.items()):
            params = parts.shard_params(params, cfg, mesh, plan)
        if not donate:
            cache = map_tree(torch.clone, cache)
        cache = place(c_specs, cache, cache_like)
        tokens = tokens[parts.rank_block(t_spec, tokens.shape, mesh)]
        with ctx():
            logits, cache = models.decode_step(
                params, cfg, tokens, cache, length_axes=length_axes,
                cross_length_axes=cross_axes)
        if logits.shape[-1] != cfg.vocab:
            logits = device_agg.all_gather_model(mesh, logits, -1)
        if rows:
            logits = device_agg.GatherRows.apply(
                logits, mesh, device_agg.replica_index(mesh))
        return logits, cache

    return serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_loop(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 8,
               max_new_tokens: int = 16, max_len: int = 64, seed: int = 0,
               greedy: bool = True, device: str = "cuda",
               params: dict | None = None, mesh=None) -> dict:
    """Greedy decode: prefill via repeated decode steps, then generate.

    Returns ``generated`` ((batch, max_new_tokens) int32 numpy),
    ``tokens_per_s`` and ``wall_s``, the host wall of the decode loop,
    which ends in a device synchronisation. Prompts are the reference's
    seeded numpy draws. ``params`` (a parameter dict, e.g.
    ``convert.params_from_jax``) are the weights; without them the
    weights come from a ``torch.Generator`` on the device seeded with
    ``seed``. Non-greedy decoding samples from a generator seeded with
    ``seed`` (the reference draws from ``jax.random``: other tokens).

    With a ``mesh`` (every rank calls it alike) each rank holds its blocks
    of the weights (drawn by ``partitioning.init_local_params``, or cut
    from ``params``) and of the cache (``cache_pspecs``), and every rank
    generates the same tokens.
    """
    dev = resolve_device(device)
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=batch,
                        kind="decode")
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = models.init_params(gen, cfg) if mesh is None else \
            parts.init_local_params(gen, cfg, mesh)
    elif mesh is not None:
        params = parts.shard_params(params, cfg, mesh)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    sampler = None if greedy else torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        params = cast_for_serving({k: v.to(dev) for k, v in params.items()},
                                  cfg)
        if models.is_encdec(cfg):
            # the stub frontend's frame embeddings, drawn on the device
            # (the reference draws them from jax.random: other frames)
            fd = cfg.frontend_dim or cfg.d_model
            frames = torch.randn(
                (batch, cfg.encoder_seq, fd), device=dev,
                generator=torch.Generator(device=dev).manual_seed(seed + 1))
            cache_like = encdec.cache_specs(cfg, batch, max_len)
            with meshctx.use_mesh(mesh):
                cache = encdec.init_cache(cfg, batch, max_len, params=params,
                                          frames=frames, device=dev)
        else:
            cache_like = models.cache_specs(cfg, batch, max_len)
            with meshctx.use_mesh(mesh):
                cache = models.init_cache(cfg, batch, max_len, device=dev)
        step_fn = make_serve_step(cfg, shape, mesh, cache_like=cache_like)
        prompt_t = torch.from_numpy(prompt).to(dev)
        generated = []
        tok = prompt_t[:, :1]
        _sync(dev)
        t0 = host_timer()
        for t in range(prompt_len + max_new_tokens - 1):
            logits, cache = step_fn(params, tok, cache)
            if t + 1 < prompt_len:
                tok = prompt_t[:, t + 1:t + 2]
            else:
                last = logits[:, -1]
                nxt = torch.argmax(last, dim=-1) if greedy else \
                    torch.multinomial(torch.softmax(last.float(), dim=-1), 1,
                                      generator=sampler)[:, 0]
                tok = nxt[:, None].to(torch.int32)
                generated.append(tok)
        gen = torch.cat(generated, dim=1).cpu().numpy() if generated \
            else np.zeros((batch, 0), np.int32)
        _sync(dev)
        dt = host_timer() - t0
    total_tokens = batch * (prompt_len + max_new_tokens - 1)
    return {"generated": gen, "tokens_per_s": total_tokens / dt,
            "wall_s": dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="batched serving")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new_tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.model
    out = serve_loop(cfg, batch=args.batch, max_new_tokens=args.new_tokens,
                     device=args.device)
    print(f"[serve] {args.arch}: {out['tokens_per_s']:.1f} tok/s, "
          f"generated shape {out['generated'].shape}")
    return out


if __name__ == "__main__":
    maybe_preload_tcmalloc()
    main()
