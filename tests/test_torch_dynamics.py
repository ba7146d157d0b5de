"""The port's device dynamics (``core/dynamics.py``: ``MarkovChurnDynamics``
on the threefry twin) against the JAX package's, live.

``_transition`` must equal the reference's on the same numpy inputs, field
for field; under every fault scenario of ``tests/test_dynamics_faults.py``
and both dropout rules the port's loop and numpy engines must give the
push-log digest (t, user, lag, gap, corun) of the reference's loop and
numpy engines, the same ``drops`` and update count, and energy at rel
1e-9. The reference's jax engine is not the oracle here: on this tree it
fails its own churn burst, and the host engines are what the port has."""
import hashlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import MarkovChurnDynamics as JaxMarkov  # noqa: E402
from repro.core import Scenario as JaxScenario  # noqa: E402
from repro.core.dynamics import _dyn_draw as jax_dyn_draw  # noqa: E402
from repro_torch.core import (FederatedSim, MarkovChurnDynamics,  # noqa: E402
                              Scenario, SimConfig)
from repro_torch.core.dynamics import (DeviceDynamics, _dyn_draw,  # noqa: E402
                                       dynamics_support, resolve_dynamics)

BASE = dict(n_users=16, horizon_s=1200, seed=7, app_arrival_p=0.01,
            policy="immediate")
SCENARIOS = {
    "churn": dict(p_off=0.01, p_on=0.05),
    "mass_dropout": dict(p_off=0.2, p_on=0.05),
    "battery_blackout": dict(p_off=0.0, p_on=1.0, battery_init=0.35,
                             drain_train=5e-3, drain_corun=8e-3,
                             charge_rate=2e-4, battery_min=0.2),
    "flapping": dict(p_off=0.3, p_on=0.5),
    "net_degraded": dict(p_off=0.02, p_on=0.1, p_net_bad=0.1,
                         p_net_recover=0.05, net_delay_slots=40),
}


def _digest(log) -> str:
    h = hashlib.sha256()
    for e in log:
        h.update(f'{e["t"]},{e["user"]},{e["lag"]},{e["gap"]!r},'
                 f'{int(e["corun"])};'.encode())
    return h.hexdigest()


def _knobs(scenario, dropout):
    return dict(dropout=dropout, resume_penalty_s=20.0,
                **SCENARIOS[scenario])


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_transition_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 40
    knobs = dict(battery_capacity=1.5, battery_min=0.3, p_net_bad=0.2,
                 p_net_recover=0.3, net_delay_slots=7, drain_train=0.05,
                 drain_corun=0.08, charge_rate=0.02, resume_penalty_s=3.0)
    a = JaxMarkov(p_off=0.3, p_on=0.4, **knobs)
    b = MarkovChurnDynamics(p_off=0.3, p_on=0.4, **knobs)
    dyn_a, dyn_b = a.init_state(n), b.init_state(n)
    for k in dyn_a:
        np.testing.assert_array_equal(dyn_b[k], dyn_a[k])
    for _ in range(25):
        dyn = {"on": rng.random(n) < 0.6, "up": rng.random(n) < 0.6,
               "battery": rng.uniform(0.0, 1.5, n),
               "net_bad": rng.random(n) < 0.4,
               "drops": rng.integers(0, 5, n),
               "p_off": rng.uniform(0, 1, n), "p_on": rng.uniform(0, 1, n)}
        mode = rng.integers(0, 4, n).astype(np.int8)
        corun = rng.random(n) < 0.5
        u = rng.random((2, n)).astype(np.float32)
        args = (u[0], u[1], mode, corun, 0.7, 1.5, 0.05, 0.08, 0.02, 0.3,
                0.2, 0.3, 7, 3.0)
        ra = a._transition(np, dict(dyn), *args)
        rb = b._transition(np, dict(dyn), *args)
        for k in ra[0]:
            np.testing.assert_array_equal(rb[0][k], ra[0][k], err_msg=k)
            assert rb[0][k].dtype == ra[0][k].dtype, k
        for f in ("up", "went_down", "went_up", "net_extra",
                  "resume_penalty"):
            np.testing.assert_array_equal(getattr(rb[1], f),
                                          getattr(ra[1], f), err_msg=f)


def test_host_draw_matches_reference():
    key = np.array([0, 7], np.uint32)
    key_j = key.copy()
    for n in (1, 16, 25):
        for _ in range(5):
            key_j, ua = jax_dyn_draw(key_j, n)
            key, ub = _dyn_draw(key, n)
            np.testing.assert_array_equal(key, key_j)
            np.testing.assert_array_equal(ub, ua)


@pytest.mark.parametrize("dropout", ("lose", "resume"))
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engines_match_reference_engines(scenario, dropout):
    ref = {e: JaxScenario(engine=e, dynamics=JaxMarkov(
        **_knobs(scenario, dropout)), **BASE).run()
        for e in ("loop", "vectorized")}
    out = {e: Scenario(engine=e, dynamics=MarkovChurnDynamics(
        **_knobs(scenario, dropout)), **BASE).run()
        for e in ("loop", "vectorized")}
    d = _digest(ref["loop"].push_log)
    assert _digest(ref["vectorized"].push_log) == d
    for e, r in out.items():
        assert _digest(r.push_log) == d, e
        assert r.updates == ref["loop"].updates, e
        assert r.drops == ref["loop"].drops, e
        assert r.energy_j == pytest.approx(ref["loop"].energy_j, rel=1e-9)
        assert r.mean_Q == pytest.approx(ref["loop"].mean_Q, rel=1e-9,
                                         abs=1e-12)
    if scenario not in ("battery_blackout",):
        assert ref["loop"].drops > 0


@pytest.mark.parametrize("policy", ("online", "offline", "sync", "greedy",
                                    "eps_greedy"))
def test_other_policies_under_churn_match_reference(policy):
    """eps_greedy and markov share ``EngineState.rng_key``: the dynamics
    draw precedes the policy draw every slot, on every engine."""
    kw = dict(BASE, policy=policy, seed=11 if policy == "eps_greedy" else 7)
    a = JaxScenario(engine="loop", dynamics=JaxMarkov(**_knobs(
        "churn", "lose")), **kw).run()
    for engine in ("loop", "vectorized"):
        b = Scenario(engine=engine, dynamics=MarkovChurnDynamics(
            **_knobs("churn", "lose")), **kw).run()
        assert _digest(b.push_log) == _digest(a.push_log), engine
        assert b.drops == a.drops, engine


def test_registry_and_string_resolution():
    dyn = resolve_dynamics("markov")
    assert isinstance(dyn, MarkovChurnDynamics) and dyn.active
    assert resolve_dynamics("markov") is dyn
    assert not resolve_dynamics("none").active
    r = Scenario(engine="loop", dynamics="markov", **BASE).run()
    assert r.updates > 0
    assert Scenario(engine="loop", **BASE).run().drops == 0


@pytest.mark.parametrize("kwargs,match", (
    (dict(p_off=1.5), "p_off"),
    (dict(p_on=-0.1), "p_on"),
    (dict(p_off=[]), "p_off"),
    (dict(p_net_bad=2.0), "p_net_bad"),
    (dict(p_net_recover=-1.0), "p_net_recover"),
    (dict(battery_capacity=0.0), "battery_capacity"),
    (dict(battery_init=1.5), "battery_init"),
    (dict(battery_min=1.0), "battery_min"),
    (dict(drain_train=-1e-3), "drain"),
    (dict(net_delay_slots=-1), "net_delay_slots"),
    (dict(dropout="pause"), "dropout"),
    (dict(resume_penalty_s=-1.0), "resume_penalty_s"),
))
def test_validation_errors_match_reference(kwargs, match):
    with pytest.raises(ValueError, match=match) as ref:
        JaxMarkov(**kwargs)
    with pytest.raises(ValueError, match=match) as out:
        MarkovChurnDynamics(**kwargs)
    assert str(out.value) == str(ref.value)


def test_per_device_class_knobs_need_a_matching_fleet():
    p_off = np.linspace(0.0, 0.05, 4)     # the Table II catalog's 4 rows
    sim = FederatedSim(SimConfig(engine="loop", dynamics=MarkovChurnDynamics(
        p_off=p_off), **BASE))
    np.testing.assert_array_equal(
        sim.state.dyn["p_off"], p_off[sim.fleet_spec.device_ids])
    ref = JaxScenario(engine="loop", dynamics=JaxMarkov(p_off=p_off),
                      **BASE).run()
    assert _digest(sim.run().push_log) == _digest(ref.push_log)
    with pytest.raises(ValueError, match="per-device-class"):
        FederatedSim(SimConfig(dynamics=MarkovChurnDynamics(
            p_off=[0.1, 0.2]), **BASE))


def test_sim_config_refuses_hookless_or_unknown_dropout_dynamics():
    class NoHost(DeviceDynamics):
        name = "no_host_for_test"

    assert not dynamics_support(NoHost())["host"]
    with pytest.raises(ValueError, match="host_step"):
        SimConfig(dynamics=NoHost())
    bad = MarkovChurnDynamics()
    bad.dropout = "pause"
    with pytest.raises(ValueError, match="dropout rule"):
        SimConfig(dynamics=bad)
