"""The port's discrete-event core (`repro_torch.serverless.event_sim`):
heap ordering, deterministic tie-breaking, per-entity timelines,
availability publication. The reference's `tests/test_event_sim.py`, case
for case, on the port."""
import pytest

pytest.importorskip("torch")

from repro_torch.serverless.event_sim import (  # noqa: E402
    AvailabilityMap,
    EventSim,
    Timeline,
)


def test_events_fire_in_time_order():
    sim = EventSim()
    log = []
    sim.at(3.0, log.append, "c")
    sim.at(1.0, log.append, "a")
    sim.at(2.0, log.append, "b")
    sim.run()
    assert log == ["a", "b", "c"]
    assert sim.now == 3.0
    assert sim.fired == 3


def test_tie_break_is_schedule_order_then_priority():
    sim = EventSim()
    log = []
    sim.at(1.0, log.append, "first")
    sim.at(1.0, log.append, "second")
    sim.at(1.0, log.append, "prio", priority=-1)   # lower priority fires first
    sim.run()
    assert log == ["prio", "first", "second"]


def test_run_until_leaves_later_events_pending():
    sim = EventSim()
    log = []
    sim.at(1.0, log.append, 1)
    sim.at(5.0, log.append, 5)
    sim.run(until=2.0)
    assert log == [1] and len(sim) == 1
    sim.run()
    assert log == [1, 5]


def test_drain_fires_everything_without_moving_cursor():
    sim = EventSim()
    sim.advance_to(2.0)
    log = []
    sim.at(10.0, log.append, "late")
    sim.at(0.5, log.append, "early")               # may predate the cursor
    n = sim.drain()
    assert n == 2 and log == ["early", "late"]
    assert sim.now == 2.0                           # cursor untouched
    assert len(sim) == 0


def test_after_and_advance_to_monotone():
    sim = EventSim()
    sim.advance_to(4.0)
    sim.advance_to(1.0)                             # no-op backwards
    assert sim.now == 4.0
    ev = sim.after(2.5)
    assert ev.time == 6.5


def test_timeline_advance_and_stall():
    tl = Timeline(10.0)
    assert tl.advance(2.0) == 12.0
    assert tl.wait_until(11.0) == 0.0               # already past
    assert tl.t == 12.0
    assert tl.wait_until(15.0) == pytest.approx(3.0)
    assert tl.t == 15.0


def test_availability_first_write_wins():
    av = AvailabilityMap()
    assert not av.known("k")
    assert av.time_of("k") == 0.0                   # default: always available
    assert av.time_of("k", default=7.0) == 7.0
    av.publish("k", 5.0)
    av.publish("k", 9.0)                            # later publish ignored
    assert av.time_of("k") == 5.0
    av.publish("k", 3.0)                            # earlier one wins
    assert av.time_of("k") == 3.0


def test_sim_reset():
    sim = EventSim()
    sim.at(1.0, lambda: None)
    sim.run()
    sim.reset()
    assert sim.now == 0.0 and len(sim) == 0 and sim.fired == 0
