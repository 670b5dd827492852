"""A round that survives faults: dropout, a stalled upload, a retried
aggregator — and still delivers the exact mean over the survivors.

The seeded :class:`~repro_torch.serverless.faults.FaultModel` drives every
disturbance: ~10% of the sampled participants drop out before uploading,
some uploads stall, and aggregator invocations die at launch with the
configured probability (the runtime retries with exponential backoff and
idempotent first-write-wins PUTs, so a retried round is still correct).
The result reports the degradation honestly: ``delivered_fraction``,
``dropped``/``late``, ``retries`` — and ``avg_flat`` equals the plain
mean over the arrivals' gradients, on every engine and device.

Robustness knobs layered on top:

* ``--staleness-policy`` keeps a cut straggler's upload in the session's
  :class:`~repro_torch.serverless.faults.StaleBuffer` and folds it into a
  later round with a staleness weight (``--staleness-alpha`` tunes the
  polynomial 1/(1+s)^alpha decay; the demo shows a round-r casualty's
  gradient landing, weighted, in round r+2). When stale gradients fold,
  the reported average is the *weighted* survivor mean.
* ``--hedge`` races a speculative replica against any aggregator whose
  retry chain overruns ``hedge_factor`` x its fault-free expected finish
  — first finisher wins, the loser stays billed.

Run:  PYTHONPATH=src python -m repro_torch.examples.faulty_round \
          [--seed 9 --schedule pipelined --deadline-s 8 --quorum 12]
          [--staleness-policy polynomial --staleness-alpha 0.5 --hedge 1.2]
          [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import FederatedSession, SessionConfig
from repro_torch.core import cost_model as cm
from repro_torch.core.cost_model import UploadModel
from repro_torch.serverless.faults import FaultModel, StalenessPolicy

N_CLIENTS, M, GRAD_SIZE = 20, 4, 50_000


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=9,
                    help="FaultModel seed (every disturbance stream is "
                         "deterministic given the seed and round)")
    ap.add_argument("--schedule", default="pipelined",
                    choices=["barrier", "pipelined", "quorum"])
    ap.add_argument("--participation-k", type=int, default=16,
                    help="sample K of the 20-client cohort per round")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="aggregate whatever landed by T (cuts stragglers)")
    ap.add_argument("--quorum", type=int, default=None,
                    help="with --schedule quorum: fold fires on the q-th "
                         "arrival, in arrival order (semi-async FedBuff)")
    ap.add_argument("--staleness-policy", default=None,
                    choices=["constant", "polynomial", "cutoff"],
                    help="fold cut stragglers' buffered uploads into later "
                         "rounds with this staleness weighting")
    ap.add_argument("--staleness-alpha", type=float, default=0.5,
                    help="polynomial decay exponent: weight 1/(1+s)^alpha")
    ap.add_argument("--reentry-delay-s", type=float, default=None,
                    help="extra delay before a dropped client's buffered "
                         "upload re-enters (defaults: long enough to "
                         "demonstrate a round-r upload landing in r+2)")
    ap.add_argument("--hedge", type=float, default=None, metavar="FACTOR",
                    help="speculative hedging: replica races any "
                         "aggregator lagging FACTOR x its expected finish "
                         "(> 1.0; needs a non-barrier schedule)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.schedule == "quorum" and args.quorum is None:
        args.quorum = 12

    policy = None
    if args.staleness_policy is not None:
        if args.reentry_delay_s is None:
            # push a dropped client's re-entry past round r+1's cut so
            # the demo shows staleness s=2: upload from round r folds in
            # round r+2 (late clients re-enter at their probed completion
            # and typically land in r+1 with s=1)
            args.reentry_delay_s = 14.0
        policy = StalenessPolicy(
            kind=args.staleness_policy, alpha=args.staleness_alpha,
            max_staleness=4 if args.staleness_policy == "cutoff" else None,
            reentry_delay_s=args.reentry_delay_s)
        if args.deadline_s is None and args.schedule != "quorum":
            args.deadline_s = 8.0   # a cut is what creates stragglers

    faults = FaultModel(dropout_rate=0.10, stall_rate=0.15, stall_s=6.0,
                        failure_rate=0.30, retry_backoff_s=0.5,
                        seed=args.seed)
    session = FederatedSession(SessionConfig(
        topology="gradssharding", n_shards=M, schedule=args.schedule,
        upload=UploadModel(mbps=16.0, jitter_s=3.0, rate_jitter=0.5,
                           seed=11),
        faults=faults, participation_k=args.participation_k,
        deadline_s=args.deadline_s, quorum=args.quorum,
        staleness_policy=policy, hedge_factor=args.hedge,
        device=args.device))

    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(GRAD_SIZE).astype(np.float32)
             for _ in range(N_CLIENTS)]

    print(f"cohort N={N_CLIENTS}, K={args.participation_k} sampled/round, "
          f"schedule={args.schedule}, fault seed={args.seed}")
    e_deliver = cm.expected_deliveries(N_CLIENTS, args.participation_k,
                                       faults.dropout_rate)
    e_attempts = cm.expected_attempts(faults.failure_rate)
    print(f"expected deliveries/round: {e_deliver:.1f}, "
          f"expected attempts/invocation: {e_attempts:.3f}\n")
    out = {"expected_deliveries": e_deliver,
           "expected_attempts": e_attempts, "rounds": []}

    for r in session.run(lambda rnd: grads, rounds=args.rounds):
        fresh = [grads[i] for i in r.arrivals]
        if r.stale_folded and policy is not None:
            # stale entries fold with their policy weight; fresh ones
            # weigh 1.0 — the exactness contract becomes the weighted
            # survivor mean
            w = [1.0] * len(fresh) \
                + [policy.weight(s) for _c, s in r.stale_folded]
            g = fresh + [grads[c] for c, _s in r.stale_folded]
            ref = np.average(np.stack(g), axis=0, weights=w) \
                .astype(np.float32)
        else:
            ref = np.mean(np.stack(fresh), axis=0).astype(np.float32)
        avg = r.avg_flat.cpu().numpy()
        exact = np.allclose(avg, ref, rtol=1e-5, atol=1e-6)
        rnd = session.rounds_run - 1
        stale = "".join(f", stale client {c} (s={s})"
                        for c, s in r.stale_folded)
        hedge = f", hedges={r.hedges}/{r.hedge_wins} won" \
            if args.hedge else ""
        print(f"round {rnd}: delivered {len(r.arrivals)}/"
              f"{len(r.participants)} "
              f"({r.delivered_fraction:.0%}), dropped={list(r.dropped)}, "
              f"late={list(r.late)}, retries={r.retries}{stale}{hedge}, "
              f"wall={r.wall_clock_s:.2f}s, survivor-mean exact: {exact}")
        out["rounds"].append({
            "avg_flat": avg, "participants": tuple(r.participants),
            "arrivals": tuple(r.arrivals), "dropped": tuple(r.dropped),
            "late": tuple(r.late), "retries": r.retries,
            "delivered_fraction": r.delivered_fraction,
            "stale_folded": tuple(r.stale_folded),
            "hedges": (r.hedges, r.hedge_wins),
            "wall_clock_s": r.wall_clock_s, "exact": exact})
        if not exact:
            raise AssertionError(f"round {rnd}: the mean is not the "
                                 f"survivor mean")

    totals = session.fault_totals
    out.update(session_wall_s=session.session_wall_s,
               total_cost=session.total_cost(),
               lambda_cost=session.lambda_cost(), s3_cost=session.s3_cost(),
               totals=dict(totals))
    print(f"\nsession: wall={session.session_wall_s:.2f}s, "
          f"total cost=${session.total_cost():.6f} "
          f"(lambda ${session.lambda_cost():.6f} + "
          f"s3 ${session.s3_cost():.6f})")
    if policy is not None or args.hedge:
        print(f"totals: {totals['stale_folded']} stale fold(s), "
              f"{totals['hedges']} hedge(s) ({totals['hedge_wins']} won), "
              f"{totals['retries']} retried attempt(s)")
    print("every failed attempt was retried and billed; the averages "
          "above are bit-exact over each round's survivors.")
    return out


if __name__ == "__main__":
    main()
