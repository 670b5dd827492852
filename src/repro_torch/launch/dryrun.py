"""Multi-pod dry run on the meta device: build every (architecture × input
shape × mesh) cell's step for one rank and read its roofline terms.

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell with XLA. Here one process plays rank 0 of the mesh:
a ``fake`` process group of prod(mesh) ranks
(``torch.testing._internal.distributed.fake_pg``, whose collectives do
nothing) stands under a ``DeviceMesh`` of the production shape, and the
cell's step runs eagerly on ``meta`` tensors, which have shapes and types
and no storage, so a 132 B-parameter model costs nothing to hold. It
builds what the reference builds (``_build_target``):

* train: ``jit_train_step`` with AdamW under the plan;
* prefill: the forward at bf16 parameters;
* decode: the sharded ``make_serve_step`` at bf16 parameters.

Per cell, for that rank:

* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode`` over
  the step, forward and backward; it counts matrix products only
  (matmuls, einsums, convolutions, attention), as the key
  ``flops_counts`` says;
* ``bytes_per_device``: the operand and result bytes of every op the rank
  runs (a ``TorchDispatchMode``; views move nothing and are left out):
  what eager PyTorch moves through device memory, op by op;
* ``collectives``: payload bytes and counts by kind (all-reduce,
  all-gather, reduce-scatter), each op's result, as the reference reads
  its HLO;
* ``memory``: the argument bytes worked out exactly from the placed
  shapes (parameters, optimizer state, batch, cache), and the peak of the
  tensors the step creates (``torch.distributed._tools.mem_tracker``);
* the roofline terms against ``config.H100_SXM``: compute at the bf16
  tensor-core peak, memory at the HBM rate, collectives at one direction
  of NVLink 4. A 256- or 512-card mesh spans many 8-card NVLink domains,
  so the collective term is a floor.

Depth: ``--mode scan2`` builds the cell at the base depth and at twice it
(``_depth_knobs``: one layer; the hybrid family's ``attn_every`` layers;
an encoder-decoder's two stacks one at a time) and extrapolates linearly
to full depth; ``--mode unroll`` builds full depth.

Run (every cell on both production meshes, the zero1 plan)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \\
        --plan zero1

It writes one JSON per cell and a summary under ``--out``
(``dryrun_results_torch/``).
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.config import (H100_SXM, MULTI_POD_MESH, SINGLE_POD_MESH,
                                MeshConfig, ShapeConfig, ShardingPlan)
from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.launch import partitioning as parts
from repro_torch.launch import serve as S
from repro_torch.launch import train as T
from repro_torch.models import encdec, meshctx
from repro_torch.models import registry as models
from repro_torch.models.transformer import map_tree
from repro_torch.optim import adamw

KINDS = ("all-reduce", "all-gather", "reduce-scatter")
#: the c10d ops the port's collectives reach, by kind; the payload is the
#: op's result (an all-reduce's tensors, a gather's or scatter's output)
_C10D = {"c10d::allreduce_": "all-reduce",
         "c10d::_allgather_base_": "all-gather",
         "c10d::allgather_into_tensor_coalesced_": "all-gather",
         "c10d::_reduce_scatter_base_": "reduce-scatter",
         "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter"}
#: ops that allocate without writing
_NO_BYTES = ("aten::empty", "aten::empty_strided", "aten::empty_like")

MESHES = {"single": [("single_pod_16x16", SINGLE_POD_MESH)],
          "multi": [("multi_pod_2x16x16", MULTI_POD_MESH)],
          "tiny": [("tiny_2x2x2", MeshConfig((2, 2, 2),
                                             ("pod", "data", "model")))]}
MESHES["both"] = MESHES["single"] + MESHES["multi"]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Per-op bytes (operands and results, views excluded) and the
    collectives' payload bytes and counts by kind."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.coll = {k: 0 for k in KINDS}
        self.counts = {k: 0 for k in KINDS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        kind = _C10D.get(name)
        if kind is not None:
            self.coll[kind] += _nbytes(args[0])
            self.counts[kind] += 1
        elif name.startswith("c10d::"):
            raise NotImplementedError(f"the dry run does not count {name}")
        elif not func.is_view and name not in _NO_BYTES:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


# ---------------------------------------------------------------------------
# The fake mesh
# ---------------------------------------------------------------------------

def fake_mesh(mc: MeshConfig):
    """Rank 0 of a ``DeviceMesh`` of ``mc``'s shape and axis names over a
    fake process group of ``mc.n_devices`` ranks (started anew)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mc.n_devices)
    return init_device_mesh("cpu", tuple(mc.shape),
                            mesh_dim_names=tuple(mc.axes))


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _depth_knobs(cfg) -> dict[str, tuple[int, int]]:
    """knob -> (base depth, full depth); an increment is one base unit."""
    if cfg.is_encdec:
        return {"n_layers": (1, cfg.n_layers),
                "encoder_layers": (1, cfg.encoder_layers)}
    if cfg.family == "hybrid":
        return {"n_layers": (cfg.attn_every, cfg.n_layers)}
    return {"n_layers": (1, cfg.n_layers)}


def _meta_params(cfg, mesh, plan: ShardingPlan) -> dict:
    """This rank's ``model``-axis blocks of every weight, on the meta
    device."""
    shapes = parts.local_param_shapes(cfg, mesh, plan)
    return {k: torch.empty(shapes[k], dtype=t.dtype, device="meta")
            for k, t in models.param_specs(cfg).items()}


def _build_target(cfg, shape: ShapeConfig, mesh, plan: ShardingPlan):
    """(run, arguments): ``run()`` is the cell's step on this rank's placed
    meta inputs; ``arguments`` those inputs, by part."""
    tp = parts.axis_sizes(mesh).get("model", 1)
    inputs = models.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = adamw(1e-4)
        params = _meta_params(cfg, mesh, plan)
        params, state = T.place_state(cfg, mesh, plan, params,
                                      opt.init(params))
        step = T.jit_train_step(cfg, shape, mesh, plan, opt)
        return (lambda: step(params, state, inputs),
                {"params": params, "opt_state": state,
                 "batch": T._local_batch(inputs, parts.batch_pspecs(
                     cfg, shape, mesh), mesh)})
    serve_cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    params = _meta_params(serve_cfg, mesh, plan)
    if shape.kind == "prefill":
        batch = T._local_batch(inputs, parts.batch_pspecs(serve_cfg, shape,
                                                          mesh), mesh)

        def forward():
            with torch.no_grad(), meshctx.use_mesh(mesh if tp > 1 else None):
                return models.forward(params, serve_cfg, batch)

        return forward, {"params": params, "batch": batch}
    b, max_len = shape.global_batch, shape.seq_len
    family = encdec if models.is_encdec(serve_cfg) else models
    whole = family.cache_specs(serve_cfg, b, max_len)
    with meshctx.use_mesh(mesh):
        cache = map_tree(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                               device="meta"),
                         family.cache_specs(serve_cfg, b, max_len))
    step = S.make_serve_step(serve_cfg, shape, mesh, whole, plan)
    return (lambda: step(params, inputs["tokens"], cache),
            {"params": params, "cache": cache,
             "batch": {"tokens": inputs["tokens"][parts.rank_block(
                 parts.decode_token_pspec(shape, mesh),
                 inputs["tokens"].shape, mesh)]}})


def measure(cfg, shape: ShapeConfig, mesh, plan: ShardingPlan) -> dict:
    """One build of the cell at ``cfg``'s depth: FLOPs, bytes,
    collectives, argument bytes and the peak of the tensors the step
    creates."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    run, arguments = _build_target(cfg, shape, mesh, plan)
    flops, counter, tracker = FlopCounterMode(display=False), OpCounter(), \
        MemTracker()
    with flops, tracker, counter:
        run()
    peaks = tracker.get_tracker_snapshot("peak")
    return {"flops": float(flops.get_total_flops()), "bytes": counter.bytes,
            "coll": counter.coll, "counts": counter.counts,
            "arguments": {k: _nbytes(v) for k, v in arguments.items()},
            "temp": int(sum(v["Total"] for v in peaks.values()))}


def _extrapolate(base: dict, double: dict, reps: int, out: dict) -> None:
    """``out`` += reps × (double − base), key by key (numbers and the
    collectives' dicts)."""
    for key in ("flops", "bytes", "temp"):
        out[key] += reps * (double[key] - base[key])
    for key in ("coll", "counts"):
        for kind in KINDS:
            out[key][kind] += reps * (double[key][kind] - base[key][kind])


def analyze_cell(arch_id: str, shape: ShapeConfig, mesh, mesh_name: str,
                 plan: ShardingPlan, mode: str = "scan2") -> dict:
    """Build and measure one (arch, shape, mesh) cell for rank 0 of
    ``mesh`` (a ``DeviceMesh`` over a fake group: :func:`fake_mesh`)."""
    cfg = get_arch(arch_id).model
    t0 = time.perf_counter()
    full = measure(cfg, shape, mesh, plan) if mode == "unroll" else None
    if mode == "scan2":
        knobs = _depth_knobs(cfg)
        base_over = {k: b for k, (b, _) in knobs.items()}
        base = measure(dataclasses.replace(cfg, **base_over), shape, mesh,
                       plan)
        full = copy.deepcopy(base)
        for k, (b, depth) in knobs.items():
            reps = (depth - b) // b
            if reps <= 0:
                continue
            double = measure(dataclasses.replace(
                cfg, **{**base_over, k: 2 * b}), shape, mesh, plan)
            _extrapolate(base, double, reps, full)
        # the arguments at full depth, exactly, from the shapes
        _, arguments = _build_target(cfg, shape, mesh, plan)
        full["arguments"] = {k: _nbytes(v) for k, v in arguments.items()}
    elif mode != "unroll":
        raise ValueError(f"mode must be 'scan2' or 'unroll', got {mode!r}")

    hw = H100_SXM
    n_chips = math.prod(parts.axis_sizes(mesh).values())
    coll_total = int(sum(full["coll"].values()))
    compute_s = full["flops"] / hw.peak_flops_bf16
    memory_s = full["bytes"] / hw.hbm_bw
    collective_s = coll_total / (hw.nvlink_bw / 2)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    mf = models.model_flops(cfg, shape)
    arg_bytes = int(sum(full["arguments"].values()))
    return {
        "arch": arch_id, "shape": shape.name, "mesh": mesh_name,
        "mesh_shape": list(parts.axis_sizes(mesh).values()),
        "n_chips": n_chips, "plan": dataclasses.asdict(plan), "mode": mode,
        "kind": shape.kind, "build_s": time.perf_counter() - t0,
        "flops_per_device": full["flops"],
        "flops_counts": "matrix products only (torch.utils.flop_counter: "
                        "mm, bmm, einsum, conv, attention), forward and "
                        "backward",
        "bytes_per_device": full["bytes"],
        "bytes_counts": "operand and result bytes of every op this rank "
                        "runs eagerly, views left out",
        "collectives": {"bytes": full["coll"], "counts": full["counts"],
                        "total_bytes": coll_total},
        "memory": {"argument_bytes": full["arguments"],
                   "argument_total_bytes": arg_bytes,
                   "temp_peak_bytes": full["temp"],
                   "temp_note": "peak of the tensors the step creates "
                                "(torch.distributed._tools.mem_tracker)"
                                + (", extrapolated like the FLOPs"
                                   if mode == "scan2" else "")},
        "hbm_per_device_gb": (arg_bytes + full["temp"]) / 1e9,
        "terms_s": terms,
        "dominant": max(terms, key=terms.get),
        "hardware": {"name": hw.name, "peak_flops_bf16": hw.peak_flops_bf16,
                     "hbm_bw": hw.hbm_bw, "nvlink_bw": hw.nvlink_bw,
                     "note": "data-sheet peaks; the collective term takes "
                             "one direction of NVLink 4 (nvlink_bw / 2); a "
                             "mesh of more than 8 cards spans many NVLink "
                             "domains, so the term is a floor"},
        "model_flops_total": mf,
        "useful_flops_ratio": (mf / n_chips) / full["flops"]
        if full["flops"] else 0.0,
    }


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def iter_cells(arch_ids=None):
    for spec in ASSIGNED:
        if arch_ids and spec.arch_id not in arch_ids:
            continue
        for shape, ok, why in spec.cells():
            yield spec.arch_id, shape, ok, why


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry run on the "
                                             "meta device")
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--mesh", default="both", choices=sorted(MESHES))
    ap.add_argument("--plan", default="zero1",
                    choices=["none", "zero1", "zero3"])
    ap.add_argument("--mode", default="scan2", choices=["scan2", "unroll"])
    ap.add_argument("--out", default="dryrun_results_torch")
    args = ap.parse_args(argv)

    plan = ShardingPlan(grad_sharding=args.plan)
    os.makedirs(args.out, exist_ok=True)
    summary, n_ok, n_skip, n_fail = [], 0, 0, 0
    t0 = time.perf_counter()
    try:
        for mesh_name, mc in MESHES[args.mesh]:
            mesh = fake_mesh(mc)
            for arch_id, shape, ok, why in iter_cells(args.arch):
                if args.shape and shape.name not in args.shape:
                    continue
                cell = f"{arch_id} x {shape.name} x {mesh_name}"
                if not ok:
                    print(f"[SKIP] {cell}: {why}")
                    summary.append({"arch": arch_id, "shape": shape.name,
                                    "mesh": mesh_name, "status": "skip",
                                    "reason": why})
                    n_skip += 1
                    continue
                print(f"[CELL] {cell} (plan={args.plan}, mode={args.mode})",
                      flush=True)
                try:
                    r = analyze_cell(arch_id, shape, mesh, mesh_name, plan,
                                     args.mode)
                except Exception as e:      # the cell fails, the sweep goes on
                    n_fail += 1
                    print(f"[FAIL] {cell}: {type(e).__name__}: {e}")
                    traceback.print_exc()
                    summary.append({"arch": arch_id, "shape": shape.name,
                                    "mesh": mesh_name, "status": "fail",
                                    "error": f"{type(e).__name__}: {e}"})
                    continue
                r["status"] = "ok"
                t = r["terms_s"]
                print(f"    terms: compute={t['compute'] * 1e3:.3f}ms "
                      f"memory={t['memory'] * 1e3:.3f}ms "
                      f"collective={t['collective'] * 1e3:.3f}ms "
                      f"dominant={r['dominant']} "
                      f"useful={r['useful_flops_ratio']:.2f} "
                      f"hbm={r['hbm_per_device_gb']:.2f}GB "
                      f"({r['build_s']:.1f}s)", flush=True)
                fn = os.path.join(args.out, f"{mesh_name}__{arch_id}__"
                                            f"{shape.name}__{args.plan}.json")
                with open(fn, "w") as f:
                    json.dump(r, f, indent=1)
                summary.append(r)
                n_ok += 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(args.out, f"summary_{args.mesh}_{args.plan}.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\n[dryrun] ok={n_ok} skip={n_skip} fail={n_fail} "
          f"({time.perf_counter() - t0:.1f}s)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
