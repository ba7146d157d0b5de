"""The port's fault monitors (``repro_torch/fault/monitor.py``) against the
JAX package's on the CPU: ``SlotClock``, ``FleetMonitor`` (live, and
``replay`` against the same events fed live, on a synthetic stream and on
a real churn run's push log) and ``ElasticCohort``. The module is plain
Python in both packages, so every eviction list, membership set and EWMA
must be equal."""
import pytest

torch = pytest.importorskip("torch")

import repro.fault.monitor as jm  # noqa: E402
import repro_torch.fault as tf  # noqa: E402
import repro_torch.fault.monitor as tm  # noqa: E402


def test_exports_match_jax():
    import repro.fault as jf
    assert set(tf.__all__) == set(jf.__all__)


def test_slot_clock_matches_jax():
    out = []
    for mod in (tm, jm):
        clk = mod.SlotClock(t_d=1.6)
        seen = [clk()]
        clk.advance(3)
        seen.append(clk())
        clk.advance()
        clk.seek(10)
        clk.seek(10)             # same slot is fine (in-slot events)
        seen += [clk.slot, clk()]
        with pytest.raises(ValueError, match="rewind"):
            clk.seek(9)
        with pytest.raises(ValueError, match="t_d"):
            mod.SlotClock(t_d=0.0)
        hb = mod.HeartbeatMonitor(timeout=10.0, clock=mod.SlotClock(2.0))
        hb.beat("u")
        hb.clock.seek(5)
        seen.append(sorted(hb.dead()))
        hb.clock.seek(6)
        seen.append(sorted(hb.dead()))
        out.append(seen)
    assert out[0] == out[1]
    assert out[0][-2:] == [[], ["u"]]


def _live(mod, events, horizon, timeout, sweep_every=1):
    mon = mod.FleetMonitor(timeout_slots=timeout)
    k = 0
    for slot in range(horizon):
        while k < len(events) and events[k][0] == slot:
            mon.observe_push(slot, events[k][1])
            k += 1
        if slot % sweep_every == 0:
            mon.sweep(slot)
    return mon


def _state(mon):
    return (mon.evictions, sorted(mon.active),
            {u: (w.updates, w.ewma_interval)
             for u, w in mon.straggler.workers.items()},
            sorted(mon.straggler.stragglers()))


@pytest.mark.parametrize("sweep_every", (1, 3))
def test_fleet_monitor_replay_matches_live_and_jax(sweep_every):
    events = [(0, 1), (0, 2), (3, 1), (7, 1), (12, 1), (12, 3), (13, 3),
              (20, 2)]
    log = [{"t": t, "user": u} for t, u in events]
    states = []
    for mod in (tm, jm):
        replayed = mod.FleetMonitor(timeout_slots=4)
        evictions = replayed.replay(log, 25, sweep_every=sweep_every)
        live = _live(mod, events, 25, 4, sweep_every)
        assert evictions == live.evictions
        assert _state(replayed) == _state(live)
        states.append(_state(live))
    assert states[0] == states[1]
    assert [u for _, u in states[0][0]].count(2) >= 1


def test_fleet_monitor_on_a_churn_run_matches_jax():
    """The monitor over a real push log: the port's numpy engine under
    Markov churn (the JAX package's "churn" fault scenario, cut short)."""
    from repro_torch.core import Scenario
    from repro_torch.core.dynamics import MarkovChurnDynamics
    res = Scenario(policy="immediate", n_users=12, horizon_s=1800,
                   dynamics=MarkovChurnDynamics(p_off=0.01, p_on=0.05,
                                                resume_penalty_s=20.0),
                   seed=0).run()
    horizon = int(res.push_log[-1]["t"]) + 50 if res.push_log else 50
    out = []
    for mod in (tm, jm):
        mon = mod.FleetMonitor(timeout_slots=40)
        mon.replay(res.push_log, horizon)
        out.append(_state(mon))
    assert out[0] == out[1]
    assert out[0][0], "the churn run evicted no user"


def test_fleet_monitor_rules_match_jax():
    for mod in (tm, jm):
        with pytest.raises(ValueError, match="timeout_slots"):
            mod.FleetMonitor(timeout_slots=0)
        mon = mod.FleetMonitor(timeout_slots=3)
        mon.observe_push(0, 7)
        assert mon.sweep(10) == {7} and mon.active == set()
        mon.observe_push(10, 7)          # eviction is not final
        assert mon.active == {7} and mon.sweep(11) == set()
        mon.observe_heartbeat(12, 8)     # liveness only: no cadence sample
        assert 8 in mon.active and 8 not in mon.straggler.workers
        with pytest.raises(ValueError, match="rewind"):
            mon.observe_push(3, 1)


def test_elastic_cohort_matches_jax():
    out = []
    for mod in (tm, jm):
        c = mod.ElasticCohort(shards=[0, 1, 2])
        seen = [c.join("a"), c.join("b"), sorted(c.active), c.evict(["a"]),
                c.join("c"), sorted(c.active), c.leave("zz"), c.join("d")]
        with pytest.raises(RuntimeError, match="free shards"):
            c.join("e")
        out.append(seen)
    assert out[0] == out[1]
