"""The port's per-user loop oracle (``FederatedSim._run_loop`` with
``Policy.decide_loop``) against the JAX package's, live, and against the
port's own numpy engine.

Trace mode, every ported policy x every aggregation rule on
``tests/test_engine_matrix.py``'s setup: the push log's (t, user, lag,
corun) must equal the JAX loop engine's and the port's numpy engine's
exactly, and energy, the queue and energy traces, gaps and weights agree
at rel 1e-9.

Real mode, the setup of ``tests/test_real_mode.py``: the port's loop with
``make_ml_hooks`` LeNet hooks (one ``Client`` epoch and one K1 push a
finisher) against the JAX loop with its ``make_ml_hooks``, the JAX initial
parameters and the JAX clients' permutations carried over; and the port's
loop against its own batched engine on one backend setup. The schedule
must be equal (H == 0, so it is norm-free), gaps at rtol 1e-6 / atol 1e-9
and accuracy within 0.03 at every sample (the reference's bounds,
``tests/test_real_mode.py::test_engine_parity``)."""
import numpy as np
import pytest

pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import Scenario as JaxScenario  # noqa: E402
from repro.core.realml import LeNetBackend as JaxLeNetBackend  # noqa: E402
from repro.core.realml import make_ml_hooks as jax_make_ml_hooks  # noqa: E402
from repro_torch.core import FederatedSim, Scenario, SimConfig  # noqa: E402
from repro_torch.core import make_ml_hooks  # noqa: E402
from repro_torch.core.policies import Policy, resolve_policy  # noqa: E402
from repro_torch.models.lenet import params_from_jax  # noqa: E402

POLICIES = ("online", "immediate", "offline", "sync", "greedy", "eps_greedy")
RULES = ("replace", "fedasync_poly", "gap_aware", "hetero_aware")
KW = dict(n_users=10, horizon_s=1500, app_arrival_p=0.01, seed=11,
          V=2000.0, L_b=2.0)
SIM_KW = dict(n_users=4, horizon_s=900, app_arrival_p=0.004, seed=0, V=5.0)
ML_KW = dict(n_train=256, n_test=128, seed=0)
REAL_POLICIES = ("online", "immediate", "sync", "greedy", "eps_greedy")


def _schedule(log):
    return [(e["t"], e["user"], e["lag"], e["corun"]) for e in log]


def _field(log, name):
    return np.array([e[name] for e in log], dtype=float)


def _assert_trace_equal(b, a):
    assert _schedule(b.push_log) == _schedule(a.push_log)
    assert b.updates == a.updates
    assert b.energy_j == pytest.approx(a.energy_j, rel=1e-9)
    assert b.mean_Q == pytest.approx(a.mean_Q, rel=1e-9, abs=1e-12)
    assert b.mean_H == pytest.approx(a.mean_H, rel=1e-9, abs=1e-12)
    assert b.corun_fraction == a.corun_fraction
    np.testing.assert_array_equal(b.trace_t, a.trace_t)
    np.testing.assert_allclose(b.trace_energy, a.trace_energy, rtol=1e-9)
    np.testing.assert_allclose(b.trace_Q, a.trace_Q, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(b.trace_H, a.trace_H, rtol=1e-9, atol=1e-12)
    for name in ("gap", "weight"):
        np.testing.assert_allclose(_field(b.push_log, name),
                                   _field(a.push_log, name), rtol=1e-9)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("policy", POLICIES)
def test_trace_loop_matches_jax_loop_and_numpy_engine(policy, rule):
    a = JaxScenario(policy=policy, engine="loop", aggregation=rule,
                    **KW).run()
    b = Scenario(policy=policy, engine="loop", aggregation=rule, **KW).run()
    c = Scenario(policy=policy, engine="vectorized", aggregation=rule,
                 **KW).run()
    assert a.updates > 0
    _assert_trace_equal(b, a)
    _assert_trace_equal(c, b)


def _assert_real_equal(b, a):
    assert a.mean_H == b.mean_H == 0.0
    assert b.updates == a.updates > 0
    assert _schedule(b.push_log) == _schedule(a.push_log)
    assert b.energy_j == pytest.approx(a.energy_j, rel=1e-9)
    np.testing.assert_allclose(_field(b.push_log, "gap"),
                               _field(a.push_log, "gap"),
                               rtol=1e-6, atol=1e-9)
    assert [t for t, _ in b.accuracy] == [t for t, _ in a.accuracy]
    np.testing.assert_allclose([x for _, x in b.accuracy],
                               [x for _, x in a.accuracy], atol=0.03)


@pytest.mark.parametrize("policy", REAL_POLICIES)
def test_real_loop_matches_jax_loop(policy):
    sync = resolve_policy(policy).sync_rounds
    jax_hooks, _ = jax_make_ml_hooks(SIM_KW["n_users"], sync=sync, **ML_KW)
    a = JaxScenario(policy=policy, engine="loop", ml_mode="real",
                    **SIM_KW).run(ml_hooks=jax_hooks)
    source = JaxLeNetBackend(SIM_KW["n_users"], sync=sync, **ML_KW)
    hooks, state = make_ml_hooks(SIM_KW["n_users"], sync=sync, device="cpu",
                                 **ML_KW)
    backend = state["backend"]
    backend.server.params = params_from_jax(
        jax.tree.map(np.asarray, source.server.params))
    backend._next_perm = source._next_perm
    b = Scenario(policy=policy, engine="loop", ml_mode="real",
                 **SIM_KW).run(ml_hooks=hooks)
    _assert_real_equal(b, a)
    assert [e["weight"] for e in b.push_log] == \
        [e["weight"] for e in a.push_log]
    assert state["accuracy"](state["server"].params) == b.accuracy[-1][1]


@pytest.mark.parametrize("policy", ("online", "immediate", "sync"))
def test_real_loop_matches_the_ports_batched_engine(policy):
    runs = [Scenario(policy=policy, engine=engine, ml="lenet",
                     ml_kwargs=dict(ML_KW, eval_every=300, device="cpu"),
                     **SIM_KW).run() for engine in ("loop", "vectorized")]
    _assert_real_equal(runs[1], runs[0])


@pytest.mark.parametrize("ml", ("lenet", "mlp"))
def test_loop_equals_the_one_lane_batched_run_bitwise(ml, monkeypatch):
    """A client's epoch is the batched engine's program for a one-lane
    chunk: with chunks of one lane the two engines give the same push log
    (gaps included), accuracy and final model bit for bit. LeNet takes
    the card's convolution route (im2col), as on the card; ``F.conv2d``
    on the CPU sums a one-lane grouped convolution in another order."""
    import torch
    from repro_torch.models import lenet
    monkeypatch.setattr(lenet, "_conv", lenet.conv_im2col)
    runs = []
    for engine in ("loop", "vectorized"):
        sim = Scenario(policy="online", engine=engine, ml=ml,
                       ml_kwargs=dict(ML_KW, eval_every=300, device="cpu"),
                       **SIM_KW).build()
        sim.ml_backend.COHORT_CHUNK = 1
        runs.append((sim.run(), sim.ml_backend.server.params))
    (a, pa), (b, pb) = runs
    assert a.updates > 0
    assert list(a.push_log) == list(b.push_log)
    assert a.accuracy == b.accuracy
    assert torch.equal(pa, pb)


def test_loop_pushes_are_one_k1_call_each(monkeypatch):
    """Every loop push goes through ``AsyncParameterServer.push``, one
    one-push K1 call a push (the plain K1 here, on the CPU)."""
    from repro_torch.kernels.fused_update import ops
    calls = []
    real = ops.fused_apply_cohort

    def counted(cur, v, trained, *a, **k):
        calls.append(trained.shape[0])
        return real(cur, v, trained, *a, **k)

    monkeypatch.setattr(ops, "fused_apply_cohort", counted)
    hooks, state = make_ml_hooks(SIM_KW["n_users"], device="cpu", **ML_KW)
    r = Scenario(policy="immediate", engine="loop", ml_mode="real",
                 **SIM_KW).run(ml_hooks=hooks)
    assert calls == [1] * r.updates and r.updates > 0
    assert state["server"].lag_tracker.version == r.updates


@pytest.mark.parametrize("with_hooks", (False, True))
@pytest.mark.parametrize("engine", ("auto", "loop", "vectorized", "jax"))
def test_engine_resolution(engine, with_hooks):
    """auto -> vectorized for hook-free trace runs, loop with per-user
    hooks; vectorized refuses hooks; jax is still to port."""
    hooks = make_ml_hooks(2, device="cpu", n_train=64, n_test=32)[0] \
        if with_hooks else None
    cfg = SimConfig(policy="online", engine=engine, n_users=2,
                    horizon_s=30, ml_mode="real" if with_hooks else "trace")
    sim = FederatedSim(cfg, ml_hooks=hooks)
    if engine == "jax":
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            sim.resolve_engine()
    elif engine == "vectorized" and with_hooks:
        with pytest.raises(ValueError, match="per-user ML hooks"):
            sim.resolve_engine()
    else:
        want = "loop" if engine == "loop" or with_hooks else "vectorized"
        assert sim.resolve_engine() == want
        sim.run()


def test_loop_only_policy_runs_on_auto_and_refuses_vectorized():
    class EveryOther(Policy):
        name = "every_other_loop_only"

        def decide_loop(self, sim, t, waiting, carry):
            go = waiting[::2]
            for u in go:
                sim.begin_training(u, t, corun=u.app is not None)
            return len(go), 0.0

    sim = FederatedSim(SimConfig(policy=EveryOther(), **KW))
    assert sim.resolve_engine() == "loop"
    assert sim.run().updates > 0
    with pytest.raises(ValueError, match="decide_vectorized"):
        SimConfig(policy=EveryOther(), engine="vectorized")

    class Lying(EveryOther):
        supports_vectorized = True

    with pytest.raises(ValueError, match="supports_vectorized"):
        SimConfig(policy=Lying())


def test_rerun_starts_fresh():
    sim = FederatedSim(SimConfig(policy="greedy", engine="loop", **KW))
    a, b = sim.run(), sim.run()
    assert _schedule(a.push_log) == _schedule(b.push_log)
    assert a.energy_j == b.energy_j


def test_ml_hooks_and_backend_are_exclusive():
    from repro_torch.core import LeNetBackend
    hooks = make_ml_hooks(2, device="cpu", n_train=64, n_test=32)[0]
    backend = LeNetBackend(2, device="cpu", n_train=64, n_test=32)
    cfg = SimConfig(n_users=2, horizon_s=30, ml_mode="real")
    with pytest.raises(ValueError, match="not both"):
        FederatedSim(cfg, ml_hooks=hooks, ml_backend=backend)
    with pytest.raises(ValueError, match="ml_hooks only"):
        Scenario(ml="lenet", n_users=2, horizon_s=30,
                 ml_kwargs=dict(device="cpu", n_train=64,
                                n_test=32)).build(ml_hooks=hooks)
