"""Fault-tolerant rounds on the port, held against the JAX package.

The contract cases of `tests/test_faults.py` and `tests/test_robustness.py`
(participation, dropout, stalls, retries with backoff, deadlines, quorum,
stale re-entry under each `StalenessPolicy` kind, hedging) run through
`repro_torch.FederatedSession` on the CPU and through
`repro.api.FederatedSession`, live, from the same knobs and seeded numpy
gradients. Every observable must agree exactly: `avg_flat` bits, walls,
phase times, op counts, every invocation record (billed GB-s, retries,
cold starts), membership, read-back times, `fault_totals` and the
session summary. Then the 27 `smoke/fault/*` and 18 `smoke/robust/*` keys
of `benchmarks/expected_smoke.json`, on the engines' CPU path and on the
batched engine's kernel-wave path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_compare as cmp  # noqa: E402
from repro.core import cost_model as ref_cm  # noqa: E402
from repro_torch import smoke  # noqa: E402
from repro_torch.core import agg_engine  # noqa: E402
from repro_torch.core import cost_model as port_cm  # noqa: E402
from repro_torch.core.topology import validate_fault_knobs  # noqa: E402
from repro_torch.kernels import fedavg_stream  # noqa: E402
from repro_torch.serverless.faults import FaultModel, StaleBuffer, \
    StalenessPolicy  # noqa: E402

ENGINES = ("streaming", "batched", "incremental")
TOPOLOGIES = ("gradssharding", "lambda_fl", "lifl", "sharded_tree",
              "geo_tiered")
FAULTS = dict(dropout_rate=0.2, stall_rate=0.2, stall_s=4.0,
              failure_rate=0.3, retry_backoff_s=0.5, seed=9)
MEMBER_FAULTS = dict(dropout_rate=0.2, stall_rate=0.2, stall_s=4.0, seed=9)
FAIL_FAULTS = dict(failure_rate=0.4, retry_backoff_s=0.5, seed=9)
PINNED = smoke.expected_invariants(groups=("fault", "robust"))


def _m(topology):
    return 4 if topology in ("gradssharding", "sharded_tree") else 1


# ---------------------------------------------------------------------------
# single faulty rounds
# ---------------------------------------------------------------------------

ROUND_CASES = {
    "empty_model_barrier": dict(schedule="barrier", faults=dict(seed=99)),
    "empty_model_pipelined": dict(faults=dict(seed=99)),
    "full_participation": dict(participation_k=8),
    "loose_deadline": dict(deadline_s=1e6),
    "full_quorum_no_jitter": dict(upload=None, schedule="quorum", quorum=8),
    "participation_k6": dict(faults=FAULTS, participation_k=6),
    "retries_only": dict(faults=dict(FAULTS, dropout_rate=0.0,
                                     stall_rate=0.0)),
    "deadline_pipelined": dict(faults=FAULTS, deadline_s=4.0),
    "deadline_barrier": dict(schedule="barrier", faults=FAULTS,
                             deadline_s=4.0),
    "quorum": dict(schedule="quorum", quorum=5),
    "quorum_faults": dict(schedule="quorum", quorum=3, faults=FAULTS,
                          participation_k=6),
    "quorum_within_deadline": dict(schedule="quorum", quorum=3,
                                   deadline_s=6.0, faults=MEMBER_FAULTS),
    "straggler_threshold": dict(faults=FAULTS,
                                straggler_threshold_s=0.05),
    "readahead4_faults": dict(faults=FAULTS, readahead_k=4,
                              participation_k=7),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_faulty_round_matches_reference(case, engine):
    cmp.assert_same(cmp.run_both(engine=engine, **ROUND_CASES[case]))


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_faulty_topologies_match_reference(topology):
    for knobs in (dict(faults=FAULTS, participation_k=6),
                  dict(schedule="quorum", quorum=4, faults=MEMBER_FAULTS),
                  dict(deadline_s=5.0, faults=MEMBER_FAULTS)):
        cmp.assert_same(cmp.run_both(topology=topology,
                                     n_shards=_m(topology), **knobs))


@pytest.mark.parametrize("seed", range(4))
def test_seeded_dropout_survivor_mean_matches_reference(seed):
    """Random seeds, cohort sizes and dropout rates: the port's survivor
    means equal the reference's bit for bit."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 14))
    knobs = dict(faults=dict(dropout_rate=float(rng.uniform(0.0, 0.6)),
                             seed=seed), engine=ENGINES[seed % 3])
    out = cmp.run_both(grad_list=cmp.grads(n=n, seed=seed), **knobs)
    cmp.assert_same(out)


def test_refusals_match_reference():
    """The same knob combinations raise the same exception types in both
    packages, at construction or in the round."""
    bad = [dict(faults=dict(dropout_rate=1.0, seed=1)),
           dict(deadline_s=1e-9),
           dict(schedule="quorum", quorum=9),
           dict(schedule="quorum", quorum=7, deadline_s=1.0,
                faults=MEMBER_FAULTS),
           dict(schedule="barrier", quorum=3),
           dict(deadline_s=-1.0),
           dict(hedge_factor=0.9),
           dict(schedule="barrier", hedge_factor=1.5)]
    for knobs in bad:
        kinds = []
        for pkg in cmp.PACKAGES:
            try:
                cmp.session(pkg, **knobs).round(cmp.grads())
                kinds.append(None)
            except Exception as exc:   # noqa: BLE001 - compared below
                kinds.append(type(exc).__name__)
        assert kinds[0] is not None and kinds[0] == kinds[1], knobs


def test_validate_fault_knobs_matches_reference():
    from repro.core.topology import validate_fault_knobs as ref_validate
    cases = [("pipelined", dict(deadline_s=0.0)),
             ("pipelined", dict(quorum=3)),
             ("quorum", dict(quorum=9, n_clients=8)),
             ("quorum", dict(quorum=5, participation_k=4)),
             ("pipelined", dict(hedge_factor=1.0)),
             ("barrier", dict(hedge_factor=1.5)),
             ("quorum", dict(quorum=4, hedge_factor=1.5)),
             ("pipelined", dict(participation_k=0))]
    for sched, kw in cases:
        got = []
        for fn in (ref_validate, validate_fault_knobs):
            try:
                fn(sched, **kw)
                got.append(None)
            except Exception as exc:   # noqa: BLE001 - compared below
                got.append((type(exc).__name__, str(exc)))
        assert got[0] == got[1], (sched, kw)


# ---------------------------------------------------------------------------
# multi-round robustness: stale re-entry and hedging
# ---------------------------------------------------------------------------

POLICIES = {
    "constant": dict(kind="constant"),
    "polynomial": dict(kind="polynomial", alpha=0.5),
    "polynomial_delay": dict(kind="polynomial", alpha=0.5,
                             reentry_delay_s=2.0),
    "cutoff": dict(kind="cutoff", max_staleness=1, reentry_delay_s=50.0),
    "polynomial_max2": dict(kind="polynomial", alpha=1.0, max_staleness=2),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_stale_reentry_matches_reference(policy, engine):
    out = cmp.run_both(rounds=4, grad_list=cmp.grads(n=12), engine=engine,
                       deadline_s=6.0, faults=MEMBER_FAULTS,
                       staleness_policy=POLICIES[policy])
    cmp.assert_same(out)
    assert any(r["stale"][0] for r in out["port"][0]) \
        or policy == "cutoff"


def test_stale_reentry_quorum_and_topologies_match_reference():
    for topology in TOPOLOGIES:
        cmp.assert_same(cmp.run_both(
            rounds=3, grad_list=cmp.grads(n=12), topology=topology,
            n_shards=_m(topology), schedule="quorum", quorum=5,
            faults=MEMBER_FAULTS, staleness_policy=POLICIES["polynomial"]))


def test_stale_weights_reach_the_fold_as_python_floats(monkeypatch):
    """The batched engine hands the fold its staleness weights as Python
    floats equal to the policy's, fresh members at exactly 1.0, and the
    divisor is their float sum; the stale buffer keeps the session
    device's tensor, never a host copy."""
    seen = []
    real = fedavg_stream.fold_nodes

    def spy(nodes, acc="f64", **kw):
        nodes = [(list(i), w) for i, w in nodes]
        seen.extend(w for _i, w in nodes if w is not None)
        return real(nodes, acc, **kw)

    monkeypatch.setattr(fedavg_stream, "fold_nodes", spy)
    monkeypatch.setattr(agg_engine, "_evaluate_nodes",
                        lambda pending, pool=None: agg_engine._evaluate_kernel(
                            pending, torch.device("cpu")))
    policy = StalenessPolicy(kind="polynomial", alpha=0.5)
    s = cmp.session("port", engine="batched", deadline_s=6.0,
                    faults=MEMBER_FAULTS,
                    staleness_policy=POLICIES["polynomial"])
    g = cmp.grads(n=12)
    results = [s.round(g) for _ in range(4)]
    stale = [w for ws in seen for w in ws if w != 1.0]
    assert stale, "no stale weight other than 1.0 reached the fold"
    assert all(type(w) is float for ws in seen for w in ws)
    want = {policy.weight(sn) for r in results for _c, sn in r.stale_folded}
    assert set(stale) <= want
    for e in s.stale_buffer.entries:
        assert isinstance(e.grad, torch.Tensor)
        assert e.grad.device == s.device


@pytest.mark.parametrize("sched", ("pipelined", "quorum"))
def test_hedging_matches_reference(sched):
    knobs = dict(faults=FAIL_FAULTS, schedule=sched, hedge_factor=1.2)
    if sched == "quorum":
        knobs["quorum"] = 8
    out = cmp.run_both(rounds=4, grad_list=cmp.grads(n=12), **knobs)
    cmp.assert_same(out)
    assert sum(r["hedges"][0] for r in out["port"][0]) > 0
    unhedged = cmp.run_both(rounds=4, grad_list=cmp.grads(n=12),
                            **dict(knobs, hedge_factor=None))
    cmp.assert_same(unhedged)
    for rh, rp in zip(out["port"][0], unhedged["port"][0]):
        assert rh["avg"] == rp["avg"]          # hedges move time, not bits


def test_fault_totals_survive_compaction_like_reference():
    knobs = dict(faults=FAULTS, participation_k=6, keep_records=False,
                 staleness_policy=POLICIES["polynomial"], deadline_s=6.0)
    cmp.assert_same(cmp.run_both(rounds=3, **knobs))


# ---------------------------------------------------------------------------
# the analytical quorum / deadline / hedge entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topology", TOPOLOGIES[:4])
def test_scheduled_round_costs_match_reference_and_sim(topology):
    gb, n, m = 512 * 4, 12, _m(topology)
    up = (ref_cm.UploadModel(**cmp.UPLOAD), port_cm.UploadModel(**cmp.UPLOAD))
    fm = (cmp.build_knobs("ref", dict(faults=MEMBER_FAULTS))["faults"],
          FaultModel(**MEMBER_FAULTS))
    for codec in ("identity", "fp16"):
        for k in (1, 4):
            q = [cm_.quorum_round_cost(topology, gb, n, m, upload=u,
                                       codec=codec, readahead_k=k, quorum=7,
                                       faults=f)
                 for cm_, u, f in zip((ref_cm, port_cm), up, fm)]
            d = [cm_.deadline_round_cost(topology, gb, n, m, upload=u,
                                         codec=codec, readahead_k=k,
                                         deadline_s=6.0, faults=f)
                 for cm_, u, f in zip((ref_cm, port_cm), up, fm)]
            assert q[0].wall_clock_s == q[1].wall_clock_s
            assert q[0].lambda_gb_s == q[1].lambda_gb_s
            assert d[0].wall_clock_s == d[1].wall_clock_s
            r = cmp.session("port", topology=topology, n_shards=m,
                            schedule="quorum", quorum=7, codec=codec,
                            readahead_k=k, faults=MEMBER_FAULTS).round(
                cmp.grads(n=n))
            assert r.wall_clock_s == pytest.approx(q[1].wall_clock_s,
                                                   rel=1e-9)


def test_expected_cost_entries_match_reference():
    lim = (ref_cm.LambdaLimits(), port_cm.LambdaLimits())
    for args in ((1024, 2.0, 0.0), (1024, 2.0, 0.2), (2048, 2.0, 0.4)):
        assert ref_cm.expected_hedge_cost(*args, lim[0], n_aggregators=4) \
            == port_cm.expected_hedge_cost(*args, lim[1], n_aggregators=4)
    names = [n for n in dir(ref_cm) if n.startswith("expected_")]
    assert names and all(hasattr(port_cm, n) for n in names)


def test_stale_buffer_units_match_reference():
    from repro.serverless.faults import StaleBuffer as RefBuffer
    from repro.serverless.faults import StalenessPolicy as RefPolicy
    for kw in POLICIES.values():
        bufs = (RefBuffer(), StaleBuffer())
        pols = (RefPolicy(**kw), StalenessPolicy(**kw))
        for b in bufs:
            for c, (o, t) in enumerate([(0, 1.0), (1, 5.0), (0, 9.0),
                                        (2, 0.5)]):
                b.add(c, o, t, None)
        for rnd, cut in ((1, 2.0), (2, 6.0), (3, 100.0), (5, 100.0)):
            got = [[(e.client, e.origin_rnd, w) for e, w in
                    b.take_ready(cut, rnd, p)] for b, p in zip(bufs, pols)]
            assert got[0] == got[1]
            assert len(bufs[0]) == len(bufs[1])


# ---------------------------------------------------------------------------
# the pinned keys
# ---------------------------------------------------------------------------

def test_pinned_fault_keys_on_cpu():
    got = smoke.fault_invariants("cpu")
    expected = {k: v for k, v in PINNED.items() if k.startswith(
        "smoke/fault/")}
    assert len(expected) == 27 and len(got) == 27
    assert smoke.mismatches(got, expected) == []


def test_pinned_robust_keys_on_cpu():
    got = smoke.robust_invariants("cpu")
    expected = {k: v for k, v in PINNED.items() if k.startswith(
        "smoke/robust/")}
    assert len(expected) == 18 and len(got) == 18
    assert smoke.mismatches(got, expected) == []


def test_pinned_fault_and_robust_keys_through_kernel_waves(monkeypatch):
    """The batched engine's CUDA path (dependency waves through
    `fold_nodes`, staleness-weighted nodes included) run on CPU tensors,
    where `fold_nodes` takes the plain fold: every key must still hold."""
    waves = []

    def via_waves(pending, pool=None):
        waves.append(len(pending))
        agg_engine._evaluate_kernel(pending, torch.device("cpu"))

    monkeypatch.setattr(agg_engine, "_evaluate_nodes", via_waves)
    got = smoke.fault_invariants("cpu")
    got.update(smoke.robust_invariants("cpu"))
    assert waves
    assert smoke.mismatches(got, PINNED) == []
