"""The port's Lambda runtime and object store (`repro_torch.serverless`,
`repro_torch.store`): memory cap, billing, cold starts, timeouts, retries,
first-write-wins PUTs and op accounting. The reference's
`tests/test_serverless_runtime.py`, case for case, on the port; stored
objects are tensors."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serverless import (  # noqa: E402
    FaultPlan,
    LambdaOOM,
    LambdaRuntime,
    LambdaTimeout,
)
from repro_torch.store import ObjectStore  # noqa: E402

MB = 1024 * 1024


def test_oom_when_buffers_exceed_allocation():
    rt = LambdaRuntime()

    def body(ctx):
        ctx.alloc(600 * MB)

    with pytest.raises(LambdaOOM):
        rt.invoke(body, fn_name="f", memory_mb=1000)   # 450 overhead + 600


def test_fits_with_enough_memory():
    rt = LambdaRuntime()

    def body(ctx):
        ctx.alloc(500 * MB)
        ctx.free(500 * MB)
        return "ok"

    out, rec = rt.invoke(body, fn_name="f", memory_mb=1000)
    assert out == "ok"
    assert rec.peak_memory_mb == pytest.approx(950, rel=0.01)


def test_platform_max_rejected():
    rt = LambdaRuntime()
    with pytest.raises(LambdaOOM, match="platform max"):
        rt.invoke(lambda ctx: None, fn_name="f", memory_mb=20_000)


def test_timeout_enforced():
    rt = LambdaRuntime()
    store = ObjectStore()
    store.put("big", torch.zeros(200 * MB // 4))

    def body(ctx):
        for _ in range(300):
            ctx.get(store, "big")

    with pytest.raises(LambdaTimeout):
        rt.invoke(body, fn_name="f", memory_mb=2000, timeout_s=300)


def test_billing_memory_times_duration():
    rt = LambdaRuntime()
    store = ObjectStore()
    store.put("x", torch.zeros(52 * MB // 4))  # 52 MB -> 1 s read

    def body(ctx):
        ctx.get(store, "x")

    _, rec = rt.invoke(body, fn_name="f", memory_mb=1024)
    # cold start (3 s) + ~1 s read
    assert rec.duration_s == pytest.approx(4.0, rel=0.05)
    assert rec.billed_gb_s == pytest.approx(rec.duration_s * 1.0, rel=0.01)
    assert rec.cold_start


def test_warm_invocations_skip_cold_start():
    rt = LambdaRuntime()
    _, r1 = rt.invoke(lambda ctx: None, fn_name="f", memory_mb=512)
    _, r2 = rt.invoke(lambda ctx: None, fn_name="f", memory_mb=512)
    assert r1.cold_start and not r2.cold_start
    assert r2.duration_s < r1.duration_s


def test_injected_fault_recorded_not_raised():
    rt = LambdaRuntime(faults=FaultPlan(fail={("f", 0)}))
    out, rec = rt.invoke(lambda ctx: "ok", fn_name="f", memory_mb=512)
    assert out is None and rec.failed


def test_invoke_reliable_retries():
    rt = LambdaRuntime(faults=FaultPlan(fail={("f", 0)}))
    out, rec = rt.invoke_reliable(lambda ctx: "ok", fn_name="f",
                                  memory_mb=512)
    assert out == "ok" and rec.attempt == 1
    assert rt.total_cost() > 0                  # failed attempt still billed


def test_store_first_write_wins():
    store = ObjectStore()
    assert store.put("k", torch.ones(4), if_none_match=True)
    assert not store.put("k", torch.zeros(4), if_none_match=True)
    assert torch.equal(store.get("k"), torch.ones(4))
    assert store.put("k", torch.zeros(4))       # unconditional overwrites


def test_store_accounting():
    store = ObjectStore()
    arr = torch.zeros(1024)
    store.put("a", arr)
    store.get("a")
    store.get("a")
    assert store.stats.puts == 1 and store.stats.gets == 2
    assert store.stats.bytes_written == arr.nbytes
    assert store.stats.bytes_read == 2 * arr.nbytes
    assert store.list("a") == ["a"]
    store.delete("a")
    assert not store.exists("a")


def test_raised_body_still_billed_and_recorded():
    # a body that raises mid-phase is a crashed container, not an
    # accounting hole: the record lands with its accrued billed duration
    rt = LambdaRuntime()

    def bad(ctx):
        ctx.compute(8 * MB)
        raise RuntimeError("bug in body")

    with pytest.raises(RuntimeError, match="bug in body"):
        rt.invoke(bad, fn_name="f", memory_mb=512)
    assert len(rt.records) == 1
    rec = rt.records[0]
    assert rec.failed and rec.billed_gb_s > 0.0
    assert rec.duration_s > rt.limits.cold_start_s   # cold start + compute
    assert rt.total_cost() > 0.0


def test_raised_body_releases_warm_slot():
    rt = LambdaRuntime()
    rt.invoke(lambda ctx: None, fn_name="f", memory_mb=512)   # warm "f"

    def bad(ctx):
        raise RuntimeError("crash")

    with pytest.raises(RuntimeError, match="crash"):
        rt.invoke(bad, fn_name="f", memory_mb=512)
    # the container died with the body: the next invocation cold-starts
    _, rec = rt.invoke(lambda ctx: None, fn_name="f", memory_mb=512)
    assert rec.cold_start


def test_injected_failure_evicts_warm_slot_for_retry():
    rt = LambdaRuntime(faults=FaultPlan(fail={("f", 1)}))
    _, r0 = rt.invoke(lambda ctx: "ok", fn_name="f", memory_mb=512)
    _, r1 = rt.invoke(lambda ctx: "ok", fn_name="f", memory_mb=512,
                      attempt=1)
    _, r2 = rt.invoke(lambda ctx: "ok", fn_name="f", memory_mb=512,
                      attempt=2)
    assert r0.cold_start and not r0.failed
    assert r1.failed and not r1.cold_start     # died in r0's warm container
    assert r2.cold_start            # the crash evicted the warm container


def test_retry_backoff_delays_relaunch():
    rt = LambdaRuntime(faults=FaultPlan(fail={("f", 0), ("f", 1)},
                                        retry_backoff_s=2.0))
    out, rec = rt.invoke_reliable(lambda ctx: "ok", fn_name="f",
                                  memory_mb=512, start_s=0.0)
    assert out == "ok" and rec.attempt == 2
    a0, a1, a2 = rt.records
    assert a1.start_s == pytest.approx(a0.end_s + 2.0)        # backoff * 2^0
    assert a2.start_s == pytest.approx(a1.end_s + 4.0)        # backoff * 2^1
    assert rec is a2


def test_zero_backoff_is_legacy_immediate_relaunch():
    rt = LambdaRuntime(faults=FaultPlan(fail={("f", 0)}))
    rt.invoke_reliable(lambda ctx: "ok", fn_name="f", memory_mb=512,
                       start_s=0.0)
    a0, a1 = rt.records
    assert a1.start_s == a0.end_s
