"""Shared helpers of the port's cross-package tests: build the same session
in the JAX package (`repro`) and in the port (`repro_torch`, on the CPU)
from one neutral knob dict, run the same rounds, and reduce each result to
the observables both packages must agree on exactly."""
import dataclasses

import numpy as np

import repro.api as ref_api
import repro.core.cost_model as ref_cm
import repro.serverless.faults as ref_faults
import repro_torch.api as port_api
import repro_torch.core.cost_model as port_cm
import repro_torch.serverless.faults as port_faults

PACKAGES = {
    "ref": (ref_api, ref_cm, ref_faults),
    "port": (port_api, port_cm, port_faults),
}

# neutral spellings of the knob objects: plain dicts of constructor args
UPLOAD = dict(mbps=16.0, jitter_s=3.0, rate_jitter=0.5, seed=11)


def grads(n=8, elems=512, seed=1234):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(elems).astype(np.float32) for _ in range(n)]


def build_knobs(pkg: str, knobs: dict) -> dict:
    """``knobs`` with ``upload``/``faults``/``staleness_policy`` dicts turned
    into the package's own objects."""
    _api, cm, faults = PACKAGES[pkg]
    out = dict(knobs)
    if out.get("upload") is not None:
        out["upload"] = cm.UploadModel(**out["upload"])
    if out.get("faults") is not None:
        out["faults"] = faults.FaultModel(**out["faults"])
    if out.get("staleness_policy") is not None:
        out["staleness_policy"] = faults.StalenessPolicy(
            **out["staleness_policy"])
    if pkg == "port":
        out["device"] = "cpu"
    return out


def session(pkg: str, **knobs):
    cfg = dict(topology="gradssharding", n_shards=4, schedule="pipelined",
               upload=UPLOAD, readahead_k=1, codec="identity")
    cfg.update(knobs)
    return PACKAGES[pkg][0].FederatedSession(**build_knobs(pkg, cfg))


def avg_bytes(avg) -> bytes:
    if hasattr(avg, "detach"):
        avg = avg.detach().cpu().numpy()
    return np.ascontiguousarray(avg, np.float32).tobytes()


def _ints(xs) -> tuple:
    return tuple(int(i) for i in xs)


def observe(r) -> dict:
    """Every observable of one round's result, in a package-neutral form."""
    return {
        "avg": avg_bytes(r.avg_flat), "topology": r.topology,
        "wall": r.wall_clock_s, "phases": tuple(r.phases_s),
        "puts": r.puts, "gets": r.gets,
        "records": [dataclasses.astuple(x) for x in r.records],
        "memory": (r.memory_mb, r.peak_memory_mb),
        "knobs": (r.engine, r.schedule, r.readahead_k, r.codec),
        "codec_error": repr(float(r.codec_error)),
        "times": (r.round_start_s, r.round_end_s,
                  np.asarray(r.client_done_s, np.float64).tobytes()),
        "participants": _ints(r.participants), "arrivals": _ints(r.arrivals),
        "dropped": _ints(r.dropped), "late": _ints(r.late),
        "delivered_fraction": r.delivered_fraction, "retries": r.retries,
        "hedges": (r.hedges, r.hedge_wins),
        "stale": (tuple(r.stale_folded), tuple(r.staleness_histogram)),
    }


def observe_session(s) -> dict:
    return {"fault_totals": s.fault_totals, "summary": s.summary(),
            "gb_s": s.runtime.total_gb_s()}


def run_both(rounds: int = 1, grad_list=None, **knobs):
    """The same ``rounds`` rounds in both packages: per package the list of
    round observables and the session's totals."""
    g = grads() if grad_list is None else grad_list
    out = {}
    for pkg in PACKAGES:
        s = session(pkg, **knobs)
        obs = [observe(s.round(g)) for _ in range(rounds)]
        out[pkg] = (obs, observe_session(s))
    return out


def assert_same(out):
    ref, port = out["ref"], out["port"]
    for rnd, (a, b) in enumerate(zip(ref[0], port[0])):
        for key in a:
            assert a[key] == b[key], f"round {rnd}: {key} differs"
    assert len(ref[0]) == len(port[0])
    assert ref[1] == port[1]
