"""Million-client rounds on one host: the lazy population engine.

A :class:`~repro_torch.serverless.population.ClientPopulation` replaces
the eager list of N gradient arrays: schedules, faults and participation
are drawn lazily per cohort-index range (same seeded streams as the eager
path — results are bit-identical), and only the O(active aggregators)
slice of client state is ever materialized. Hand it to ``SessionConfig
.population`` and ``session.round()`` takes no gradients at all —
N = 10⁶ rounds fit in well under a GB of host memory. On the card each
512-row chunk of a fold is one launch of the fold kernel's carry form.

The walkthrough runs one round per architecture at growing cohort sizes
and prints the cost-crossover table: single-tier λ-FL is cheapest while
one function can swallow the fan-in; the hierarchical ``geo_tiered``
topology catches up as edge aggregation amortizes the long-haul bytes;
GradsSharding pays M-way shard traffic for its O(|θ|/M) memory ceiling,
which client count alone never threatens.

Run:  PYTHONPATH=src python -m repro_torch.examples.million_clients \
          [--million] [--device cpu]
"""
import argparse
import dataclasses
import resource

from repro_torch.api import FederatedSession, SessionConfig
from repro_torch.core.cost_model import UploadModel
from repro_torch.launch.hostenv import host_timer
from repro_torch.serverless.population import ClientPopulation
from repro_torch.serverless.runtime import DEFAULT_LIMITS

TOPOLOGIES = ("lambda_fl", "geo_tiered", "gradssharding")
COHORTS = (1_000, 10_000, 100_000)
MILLION = 1_000_000
GRAD_ELEMS = 4_096
UPLOAD = UploadModel(mbps=16.0, jitter_s=3.0, rate_jitter=0.5,
                     compute_s=2.0, compute_jitter=1.0, seed=11)


def one_round(topology: str, n: int, device: str):
    session = FederatedSession(SessionConfig(
        topology=topology,
        population=ClientPopulation(n, grad_elems=GRAD_ELEMS, seed=1),
        upload=UPLOAD,
        schedule="pipelined", readahead_k=4,
        # bounded-memory hygiene at cohort scale: skip the per-op store
        # log and per-round record retention...
        log_ops=False, keep_records=False,
        # ...and price (rather than refuse) fan-ins that overrun the
        # Lambda timeout — feasibility walls are a separate study
        limits=dataclasses.replace(DEFAULT_LIMITS,
                                   max_timeout_s=10_000_000),
        track_codec_error=False, device=device))
    t0 = host_timer()
    r = session.round()
    r.avg_flat.cpu()                     # the round ends on the device
    return r, session.total_cost(), host_timer() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--million", action="store_true",
                    help="include the N=10^6 cells (~2 min host time)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    ns = COHORTS + ((MILLION,) if args.million else ())

    cells = {}
    for n in ns:
        for topology in TOPOLOGIES:
            r, cost, host_s = one_round(topology, n, args.device)
            rss_mb = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024
            cells[n, topology] = {"wall_clock_s": r.wall_clock_s,
                                  "cost": cost, "host_s": host_s,
                                  "rss_mb": rss_mb}
            print(f"N={n:>9,} {topology:14s}: wall {r.wall_clock_s:8.1f}s"
                  f"  ${cost:.4f}/round  ({cost / n * 1e6:6.2f} µ$/client)"
                  f"  [host {host_s:5.1f}s, rss {rss_mb:4.0f} MB]")

    print("\ncheapest architecture by cohort size:")
    cheapest = {}
    for n in ns:
        best = cheapest[n] = min(TOPOLOGIES, key=lambda t: cells[n, t]["cost"])
        cell = cells[n, best]
        print(f"  N={n:>9,}: {best:14s} ${cell['cost']:.4f}/round, "
              f"wall {cell['wall_clock_s']:.1f}s")
    if not args.million:
        print("\n(re-run with --million for the N=10^6 cells)")
    return {"cells": cells, "cheapest": cheapest}


if __name__ == "__main__":
    main()
