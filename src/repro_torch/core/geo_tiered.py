"""``geo_tiered``: hierarchical edge → region → global aggregation.

The million-client regime (LIFL, IBM Adaptive Aggregation) aggregates
locality-first: clients upload over a constrained edge link to a nearby
edge aggregator, edge partials merge per region, and regions meet at one
global root over the backbone. Three phases like LIFL, but the shape is
set by *deployment* fan-ins (``edge_fanin``/``region_fanin``) rather than
the cohort-derived ⌈∛N⌉, and each tier's transfers run at that tier's
link bandwidth (``edge_mbps``/``region_mbps``/``backbone_mbps``; ``None``
keeps the platform S3 stream rates).

Like :mod:`repro_torch.core.sharded_tree`, this registers purely through the
public topology API — per-tier bandwidths ride on
:class:`InvocationSpec.read_mbps`/``write_mbps`` (tier *t*'s write link
is tier *t+1*'s read link) and the analytical hooks price the same tiers
via :func:`repro_torch.core.topology.tier_limits`, so the event sim and the
cost model match to float epsilon for no-fault rounds.

Arithmetic: every tier is weight-carrying (group sizes — or staleness
weights — merge up the tree, LIFL-style f64 group-weighted folds), so the
result is the exact cohort mean up to f32 rounding; the fold *grouping*
follows the deployment fan-ins, so bits agree across engines/schedules
for this topology but differ from λ-FL/LIFL's cohort-derived trees.

The five knobs may be overridden per-session via ``topology_options``
(the sim honors ``spec.opt``), but the ``cost_*`` hooks read the
registered instance's attributes — analytical parity therefore requires
registering a configured instance::

    register_topology("geo_eu", replace=True)(
        GeoTieredTopology(edge_fanin=64, edge_mbps=16.0))
"""
from __future__ import annotations

from repro_torch.core import cost_model as cm
from repro_torch.core.topology import (InvocationSpec, RoundProgram, Topology,
                                 full_grad_uploads, k_client_grad, k_global,
                                 register_topology, tier_limits, tree_groups)
from repro_torch.core.wire_codec import get_codec


def k_edge_partial(rnd: int, g: int) -> str:
    """Keyspace extension: edge tier partial ``g``."""
    return f"round{rnd:05d}/partial/edge/g{g:04d}"


def k_region_partial(rnd: int, g: int) -> str:
    """Keyspace extension: region tier partial ``g``."""
    return f"round{rnd:05d}/partial/region/g{g:04d}"


@register_topology("geo_tiered")
class GeoTieredTopology(Topology):
    """Edge → region → global tree with per-tier fan-in and link rates."""

    options_used = frozenset({"edge_fanin", "region_fanin", "edge_mbps",
                              "region_mbps", "backbone_mbps"})

    def __init__(self, edge_fanin: int = 32, region_fanin: int = 16,
                 edge_mbps: float | None = None,
                 region_mbps: float | None = None,
                 backbone_mbps: float | None = None):
        if edge_fanin < 2 or region_fanin < 2:
            raise ValueError("tier fan-ins must be >= 2")
        self.edge_fanin = int(edge_fanin)
        self.region_fanin = int(region_fanin)
        self.edge_mbps = edge_mbps
        self.region_mbps = region_mbps
        self.backbone_mbps = backbone_mbps

    # -- simulator side -------------------------------------------------------
    def program(self, client_grads, spec, backend):
        rnd, n = spec.rnd, spec.n
        edge_fanin = int(spec.opt("edge_fanin", self.edge_fanin))
        region_fanin = int(spec.opt("region_fanin", self.region_fanin))
        edge_mbps = spec.opt("edge_mbps", self.edge_mbps)
        region_mbps = spec.opt("region_mbps", self.region_mbps)
        backbone_mbps = spec.opt("backbone_mbps", self.backbone_mbps)

        puts, uploads, grad_bytes, wire_grad = full_grad_uploads(
            client_grads, rnd, codec=spec.codec)

        # every tier carries weights (group sizes merge up the tree), so
        # staleness weights simply seed the edge tier instead of all-ones
        w = [float(x) for x in spec.weights] if spec.weights is not None \
            else [1.0] * n

        edge_groups = tree_groups(n, edge_fanin)
        edges = tuple(
            InvocationSpec(
                fn_name=f"r{rnd}-edge{g}",
                in_keys=tuple(k_client_grad(rnd, i) for i in members),
                out_key=k_edge_partial(rnd, g),
                alloc_bytes=grad_bytes,
                weights=tuple(w[i] for i in members),
                # only the edge tier reads encoded client uploads
                wire_in_bytes=wire_grad,
                read_mbps=edge_mbps, write_mbps=region_mbps)
            for g, members in enumerate(edge_groups))
        edge_w = [float(sum(w[i] for i in members))
                  for members in edge_groups]

        region_groups = tree_groups(len(edge_groups), region_fanin)
        regions = tuple(
            InvocationSpec(
                fn_name=f"r{rnd}-region{g}",
                in_keys=tuple(k_edge_partial(rnd, e) for e in members),
                out_key=k_region_partial(rnd, g),
                alloc_bytes=grad_bytes,
                weights=tuple(edge_w[e] for e in members),
                read_mbps=region_mbps, write_mbps=backbone_mbps)
            for g, members in enumerate(region_groups))
        region_w = tuple(float(sum(edge_w[e] for e in members))
                         for members in region_groups)

        root = InvocationSpec(
            fn_name=f"r{rnd}-georoot",
            in_keys=tuple(k_region_partial(rnd, g)
                          for g in range(len(region_groups))),
            out_key=k_global(rnd),
            alloc_bytes=grad_bytes,
            weights=region_w,
            global_out=True,
            read_mbps=backbone_mbps, write_mbps=backbone_mbps)

        return RoundProgram(
            topology="geo_tiered", client_puts=puts, uploads=uploads,
            phases=(edges, regions, (root,)),
            readback=((k_global(rnd), grad_bytes),),
            collect=lambda values: values[0])

    # -- analytical side (reads the registered instance's tier spec) ---------
    def _tiers(self, n: int) -> tuple[list, list]:
        edge_groups = tree_groups(n, self.edge_fanin)
        region_groups = tree_groups(len(edge_groups), self.region_fanin)
        return edge_groups, region_groups

    def _tier_limits(self, limits) -> tuple:
        return (tier_limits(limits, self.edge_mbps, self.region_mbps),
                tier_limits(limits, self.region_mbps, self.backbone_mbps),
                tier_limits(limits, self.backbone_mbps, self.backbone_mbps))

    def cost_s3_ops(self, n, m=1):
        e, r = (len(t) for t in self._tiers(n))
        return cm.S3Ops(puts=n + e + r + 1, gets_agg=n + e + r,
                        gets_clients=n)

    def cost_n_aggregators(self, n, m=1):
        e, r = (len(t) for t in self._tiers(n))
        return e + r + 1

    def cost_n_phases(self):
        return 3

    def cost_collect_fanin(self, n, m=1):
        edge_groups, region_groups = self._tiers(n)
        return max(max(len(g) for g in edge_groups),
                   max(len(g) for g in region_groups),
                   len(region_groups))

    def cost_wire_weighted(self):
        # the edge tier folds encoded client gradients with weights, so
        # the compressed-wire memory bound budgets the f64 accumulator
        return True

    def cost_phase_plan(self, grad_bytes, n, m, limits, *, codec):
        cdc = get_codec(codec)
        edge_groups, region_groups = self._tiers(n)
        lim_e, lim_r, lim_g = self._tier_limits(limits)
        k_e = max(len(g) for g in edge_groups)
        k_r = max(len(g) for g in region_groups)
        return [
            (cm.aggregator_timing(grad_bytes, k_e, grad_bytes, lim_e,
                                  wire_in_bytes=cdc.wire_bytes(grad_bytes),
                                  decode_s=cdc.decode_cost_s(grad_bytes)),
             len(edge_groups)),
            (cm.aggregator_timing(grad_bytes, k_r, grad_bytes, lim_r),
             len(region_groups)),
            (cm.aggregator_timing(grad_bytes, len(region_groups),
                                  grad_bytes, lim_g), 1)]

    def cost_pipelined_plan(self, grad_bytes, n, m, limits, *, upload,
                            starts, mults, run_fold, shard_bytes=None,
                            codec):
        """Pipelined entry mirroring :meth:`program`: whole-gradient
        client uploads feed the edge folds, edge finishes chain into the
        region folds, regions into the root — each fold priced at its
        tier's link rates (``limits_override``) and billed weighted
        (every tier carries an f64 accumulator)."""
        cdc = get_codec(codec)
        wire_g = cdc.wire_bytes(grad_bytes)
        lim_e, lim_r, lim_g = self._tier_limits(limits)

        def override(lim):
            return None if lim is limits else lim

        avail = [starts[i] + upload.upload_s(wire_g, mults[i])
                 for i in range(n)]
        edge_ends = [
            run_fold([avail[i] for i in members],
                     [grad_bytes] * len(members), grad_bytes,
                     wire_b=[wire_g] * len(members),
                     decode_s=cdc.decode_cost_s(grad_bytes),
                     weighted=True, limits_override=override(lim_e))
            for members in tree_groups(n, self.edge_fanin)]
        region_ends = [
            run_fold([edge_ends[e] for e in members],
                     [grad_bytes] * len(members), grad_bytes,
                     weighted=True, limits_override=override(lim_r))
            for members in tree_groups(len(edge_ends), self.region_fanin)]
        run_fold(region_ends, [grad_bytes] * len(region_ends), grad_bytes,
                 weighted=True, limits_override=override(lim_g))
