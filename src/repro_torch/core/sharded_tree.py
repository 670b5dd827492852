"""``sharded_tree``: a hybrid topology registered via the public API only.

GradsSharding × λ-FL: the gradient is split into M shards (paper Step 1),
and each shard is aggregated through its own two-level ⌈√N⌉ tree instead
of a single fan-in-N aggregator — N·M client PUTs, then M·⌈N/√N⌉ leaf
aggregators (phase 1) and M shard roots (phase 2). The per-aggregator
fan-in drops from N to ~√N *and* the per-object size from |θ| to |θ|/M,
trading one extra phase for both — the regime where a single shard
aggregator's N sequential GETs dominate the round.

This module is the registry's proof of extensibility: it builds its round
program and cost entries exclusively from the public topology API
(:func:`~repro_torch.core.topology.register_topology`, :class:`InvocationSpec`,
:func:`tree_groups`, :func:`resolve_partition_plan`, the ``k_*`` keyspace
helpers) — no edits to the shared round driver or the builtin cost model.

Arithmetic: each element of shard j sees exactly the λ-FL op sequence
(unweighted f32 leaf fold over the same client groups, f64 group-weighted
root fold), so ``avg_flat`` is **bit-identical to λ-FL** for every
engine/schedule and device. Client shards and partials are torch tensors
on the gradients' device; the cumulative wire-byte schedule of the
pipelined cost entry is host arithmetic and stays numpy.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core.topology import (InvocationSpec, RoundProgram, Topology,
                                 k_avg_shard, k_client_shard,
                                 register_topology, resolve_partition_plan,
                                 sharded_client_uploads, tree_groups)
from repro_torch.core.sharding import reconstruct
from repro_torch.core.wire_codec import get_codec


def k_shard_partial(rnd: int, j: int, leaf: int) -> str:
    """Keyspace extension: leaf partial of shard ``j``'s tree."""
    return f"round{rnd:05d}/partial/shard{j:04d}/l1/g{leaf:04d}"


@register_topology("sharded_tree")
class ShardedTreeTopology(Topology):
    """Shard the gradient into M pieces; aggregate each through a ⌈√N⌉
    two-level tree."""

    def program(self, client_grads, spec, backend):
        rnd, n = spec.rnd, spec.n
        plan = resolve_partition_plan(spec, int(client_grads[0].numel()))
        m = plan.n_shards

        # Step 1+2 — identical client-side keyspace to GradsSharding
        puts, uploads, shard_bytes, wire_bytes = sharded_client_uploads(
            client_grads, rnd, plan, backend, codec=spec.codec)

        # Phase 1 — per-shard leaf trees (λ-FL grouping, per shard);
        # leaves read encoded client shards, roots read raw partials
        groups = tree_groups(n, cm.lambda_fl_branching(n))
        w = spec.weights
        leaves = tuple(
            InvocationSpec(
                fn_name=f"r{rnd}-s{j}leaf{leaf}",
                in_keys=tuple(k_client_shard(rnd, i, j) for i in members),
                out_key=k_shard_partial(rnd, j, leaf),
                alloc_bytes=shard_bytes[j],
                weights=None if w is None
                else tuple(w[i] for i in members),
                wire_in_bytes=wire_bytes[j])
            for j in range(m)
            for leaf, members in enumerate(groups))

        # Phase 2 — per-shard roots (group-size-weighted, like λ-FL's
        # root; staleness weights replace the plain group sizes)
        roots = tuple(
            InvocationSpec(
                fn_name=f"r{rnd}-s{j}root",
                in_keys=tuple(k_shard_partial(rnd, j, leaf)
                              for leaf in range(len(groups))),
                out_key=k_avg_shard(rnd, j),
                alloc_bytes=shard_bytes[j],
                weights=tuple(float(len(members)) if w is None
                              else float(sum(w[i] for i in members))
                              for members in groups))
            for j in range(m))

        readback = tuple((k_avg_shard(rnd, j), shard_bytes[j])
                         for j in range(m))
        return RoundProgram(
            topology="sharded_tree", client_puts=tuple(puts),
            uploads=tuple(uploads), phases=(leaves, roots),
            readback=readback,
            collect=lambda shards: reconstruct(shards, plan))

    # -- analytical cost entries (consulted by cost_model's registry
    #    fallback for s3_ops / n_aggregators / n_phases / memory /
    #    round_cost) ---------------------------------------------------------
    def _leaves(self, n: int) -> int:
        return math.ceil(n / cm.lambda_fl_branching(n))

    def cost_s3_ops(self, n, m=1):
        leaves = self._leaves(n)
        return cm.S3Ops(puts=n * m + leaves * m + m,
                        gets_agg=n * m + leaves * m,
                        gets_clients=n * m)

    def cost_n_aggregators(self, n, m=1):
        return m * (self._leaves(n) + 1)

    def cost_n_phases(self):
        return 2

    def cost_input_bytes(self, grad_bytes, m=1):
        return math.ceil(grad_bytes / m)

    def cost_collect_fanin(self, n, m=1):
        # λ-FL's widest aggregator, per shard: the ⌈√N⌉-way leaf fold
        # (leaf fan-in >= root fan-in == leaf count)
        return cm.lambda_fl_branching(n)

    def cost_phase_plan(self, grad_bytes, n, m, limits, *, codec):
        cdc = get_codec(codec)
        shard_b = self.cost_input_bytes(grad_bytes, m)
        k = cm.lambda_fl_branching(n)
        leaves = self._leaves(n)
        # leaf folds read codec-encoded client shards; roots read raw
        # f32 leaf partials
        return [(cm.aggregator_timing(shard_b, k, shard_b, limits,
                                      wire_in_bytes=cdc.wire_bytes(shard_b),
                                      decode_s=cdc.decode_cost_s(shard_b)),
                 m * leaves),
                (cm.aggregator_timing(shard_b, leaves, shard_b, limits), m)]

    def cost_client_upload_bytes(self, grad_bytes, m=1, codec=None,
                                 shard_bytes=None):
        return cm.sharded_wire_upload_bytes(grad_bytes, m, codec,
                                            shard_bytes)

    def cost_pipelined_plan(self, grad_bytes, n, m, limits, *, upload,
                            starts, mults, run_fold, shard_bytes=None,
                            codec):
        """Pipelined entry, mirroring :meth:`program`: clients upload their
        M shards sequentially (availability = start + cumulative-PUT prefix
        time, over *wire* sizes), each shard's leaf folds launch/stream off
        the encoded shard keyspace, and each shard root chains on its leaf
        finishes (raw partials)."""
        cdc = get_codec(codec)
        sb = list(shard_bytes) if shard_bytes is not None \
            else cm.uniform_shard_bytes(grad_bytes, m)
        wsb = [cdc.wire_bytes(b) for b in sb]
        cum = np.cumsum(wsb)
        groups = cm.tree_groups(n, cm.lambda_fl_branching(n))
        for j in range(m):
            avail = [starts[i] + upload.upload_s(int(cum[j]), mults[i])
                     for i in range(n)]
            leaf_ends = [
                run_fold([avail[i] for i in members],
                         [sb[j]] * len(members), sb[j],
                         wire_b=[wsb[j]] * len(members),
                         decode_s=cdc.decode_cost_s(sb[j]))
                for members in groups]
            run_fold(leaf_ends, [sb[j]] * len(leaf_ends), sb[j])
