"""The port's offline schedule (Alg. 1: ``core/offline.py``,
``plan_window`` and ``OfflinePolicy``) against the JAX package's, live.

Lemma 1's lag bounds, the knapsack DP and the full ``offline_schedule``
must equal the reference on seeded numpy inputs; every plan the numpy
engine makes over a run must equal the reference engine's, plan by plan;
in real mode (the sizes of ``tests/test_real_mode.py``, the JAX initial
parameters and permutations carried over) the schedule must equal the
JAX backend's while H == 0 and accuracy agree within 0.03."""
import hashlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import Scenario as JaxScenario  # noqa: E402
from repro.core import offline as j_off  # noqa: E402
from repro.core import policies as j_pol  # noqa: E402
from repro.core.realml import LeNetBackend as JaxLeNetBackend  # noqa: E402
from repro_torch.core import Scenario  # noqa: E402
from repro_torch.core import offline as t_off  # noqa: E402
from repro_torch.core import policies as t_pol  # noqa: E402
from repro_torch.models.lenet import params_from_jax  # noqa: E402

SEEDS = (0, 3, 11)
TRACE_KW = (dict(n_users=12, horizon_s=2000, seed=2, app_arrival_p=0.01,
                 V=5.0),
            dict(n_users=30, horizon_s=3000, seed=5, L_b=2.0, V=50.0),
            dict(n_users=20, horizon_s=2500, seed=7, L_b=0.05,
                 offline_window=300.0, offline_resolution=0.001,
                 app_arrival_p=0.02))
SIM_KW = dict(n_users=4, horizon_s=900, app_arrival_p=0.004, seed=0, V=5.0)
ML_KW = dict(n_train=256, n_test=128, eval_every=300)


def _windows(rng, n):
    t = rng.integers(0, 50, n).astype(float)
    return t, t + rng.integers(0, 40, n), rng.uniform(5.0, 60.0, n)


@pytest.mark.parametrize("seed", SEEDS)
def test_lemma1_bounds_match_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 7, 40):
        t, ta, d = _windows(rng, n)
        ref = j_off.lemma1_lag_bounds(t, ta, d)
        np.testing.assert_array_equal(t_off.lemma1_lag_bounds(t, ta, d), ref)
        np.testing.assert_array_equal(
            t_off.lemma1_lag_bounds(t, ta, d, block=3), ref)
        np.testing.assert_array_equal(t_off.lemma1_lag_bounds_loop(t, ta, d),
                                      j_off.lemma1_lag_bounds_loop(t, ta, d))


@pytest.mark.parametrize("seed", SEEDS)
def test_knapsack_and_offline_schedule_match_jax(seed):
    rng = np.random.default_rng(seed)
    for n, L_b, res in ((6, 3.0, 1.0), (25, 10.0, 0.5), (30, 0.2, 0.01)):
        s = rng.uniform(-1.0, 5.0, n)
        g = rng.uniform(0.0, 2.0, n)
        g[rng.integers(0, n)] = 0.0          # a free item
        x, tot = t_off.knapsack_schedule(s, g, L_b, resolution=res)
        xr, totr = j_off.knapsack_schedule(s, g, L_b, resolution=res)
        np.testing.assert_array_equal(x, xr)
        assert tot == totr
        assert np.sum(np.ceil(g[x] / res)) <= np.floor(L_b / res)
        t, ta, d = _windows(rng, n)
        for vn in (0.0, 1.7):
            a = t_off.offline_schedule(t, ta, d, s, L_b, 0.01, 0.9, vn,
                                       resolution=res)
            b = j_off.offline_schedule(t, ta, d, s, L_b, 0.01, 0.9, vn,
                                       resolution=res)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
    with pytest.raises(ValueError):
        t_off.knapsack_schedule([1.0], [1.0], -1.0)


def _record_plans(monkeypatch, module):
    plans = []
    real = module.plan_window

    def recording(plan, t, widx, *a, **k):
        out = real(plan, t, widx, *a, **k)
        plans.append((t, [int(i) for i in widx], out.tolist()))
        return out

    monkeypatch.setattr(module, "plan_window", recording)
    return plans


@pytest.mark.parametrize("case", range(len(TRACE_KW)))
def test_plans_match_jax_plan_by_plan(monkeypatch, case):
    kw = TRACE_KW[case]
    ref_plans = _record_plans(monkeypatch, j_pol)
    port_plans = _record_plans(monkeypatch, t_pol)
    a = JaxScenario(policy="offline", engine="vectorized", **kw).run()
    b = Scenario(policy="offline", **kw).run()
    assert len(ref_plans) > 1
    assert port_plans == ref_plans
    assert any(t_pol.PLAN_CORUN in p for _, _, p in port_plans)
    assert b.updates == a.updates > 0
    assert list(b.push_log) == list(a.push_log)
    assert b.energy_j == pytest.approx(a.energy_j, rel=1e-9)


def test_plan_host_callback_matches_jax():
    """``_offline_plan_host`` (the scan engine's host callback) on a
    look-ahead slice equals the reference's, and equals ``plan_window`` on
    the full horizon."""
    from repro_torch.core.energy import APPS
    from repro_torch.core.fleet import resolve_fleet
    rng = np.random.default_rng(4)
    n, T, W = 16, 120, 40
    spec = resolve_fleet("paper").build(np.random.default_rng(0), n)
    tab, dev = spec.tables, spec.device_ids
    T_COR, SRATE = tab.t_corun[dev], tab.saving_rate[dev]
    sched = rng.random((T, n)) < 0.03
    choice = rng.integers(0, len(APPS), (T, n))
    app = np.where(rng.random(n) < 0.3, rng.integers(0, len(APPS), n), -1)
    waiting = rng.random(n) < 0.7
    plan = rng.integers(0, 3, n).astype(np.int8)
    for t in (0, 50, T - 10):
        row0 = min(t, T - W)
        args = (t, waiting, plan, app, 17, sched[row0:row0 + W],
                choice[row0:row0 + W], row0, T_COR, SRATE, float(W), 1.5,
                0.01, 0.01, 0.9, 1.0)
        out = t_pol._offline_plan_host(*args)
        np.testing.assert_array_equal(out, j_pol._offline_plan_host(*args))
        full = t_pol.plan_window(plan.copy(), t, np.nonzero(waiting)[0], app,
                                 sched, choice, T_COR, SRATE, float(W),
                                 1.0 / np.sqrt(1.0 + 0.05 * 17), 1.5, 0.01,
                                 0.01, 0.9)
        np.testing.assert_array_equal(out, full)
        assert out.dtype == plan.dtype


def _digest(push_log) -> str:
    return hashlib.sha256(json.dumps(
        [(e["t"], e["user"], e["lag"], e["corun"]) for e in push_log])
        .encode()).hexdigest()


def test_real_mode_matches_jax_backend():
    a = JaxScenario(policy="offline", ml="lenet", ml_kwargs=ML_KW,
                    **SIM_KW).run()
    sim = Scenario(policy="offline", ml="lenet",
                   ml_kwargs=dict(ML_KW, device="cpu"), **SIM_KW).build()
    backend = sim.ml_backend
    source = JaxLeNetBackend(SIM_KW["n_users"], seed=SIM_KW["seed"],
                             **ML_KW)
    backend.server.params = params_from_jax(
        jax.tree.map(np.asarray, source.server.params))
    backend._next_perm = source._next_perm
    b = sim.run()
    assert a.mean_H == b.mean_H == 0.0
    assert b.updates == a.updates > 0
    assert _digest(b.push_log) == _digest(a.push_log)
    assert b.corun_fraction == a.corun_fraction
    assert b.energy_j == pytest.approx(a.energy_j, rel=1e-9)
    np.testing.assert_allclose([e["gap"] for e in b.push_log],
                               [e["gap"] for e in a.push_log],
                               rtol=2e-5, atol=1e-6)
    assert [t for t, _ in b.accuracy] == [t for t, _ in a.accuracy]
    np.testing.assert_allclose([x for _, x in b.accuracy],
                               [x for _, x in a.accuracy], atol=0.03)


def test_offline_knobs_validated():
    from repro_torch.core import SimConfig
    for bad in (dict(offline_window=0.0), dict(offline_resolution=-1.0)):
        with pytest.raises(ValueError, match="offline_window"):
            SimConfig(policy="offline", **bad)
