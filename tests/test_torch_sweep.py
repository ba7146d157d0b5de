"""The port's batched sweeps (``run_sweep``, ``Scenario.sweep``,
``run_jax_sweep``, ``sweep_bucket_key``) on the CPU: points that share a
bucket run as one stacked scan, and each row must equal its own per-point
scan run (the schedule and the integer columns bit for bit, energies,
gaps and weights within rel 1e-9), and the JAX package's batched sweep
under x64 (never without it: the reference's sweep runs in f32 then,
tests/test_sweep.py:26-33). Buckets group a mixed grid as the
reference's do; offline is never batched; mixed keys and non-Scenarios
are refused; without CUDA the default device raises."""
import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import vector_engine as jve  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import vector_engine as pve  # noqa: E402
from repro_torch.core.engine_state import EVENT_FIELDS  # noqa: E402


@pytest.fixture(autouse=True)
def _x64_and_threefry():
    prev_x64 = jax.config.jax_enable_x64
    prev_mode = prng.PARTITIONABLE
    jax.config.update("jax_enable_x64", True)
    prng.set_partitionable(bool(jax.config.jax_threefry_partitionable))
    yield
    prng.set_partitionable(prev_mode)
    jax.config.update("jax_enable_x64", prev_x64)


@pytest.fixture(autouse=True, scope="module")
def _jax_chunk_cache():
    """The JAX package's jitted-chunk cache (contents and LRU order), its
    counters and its cap put back as this file found them: reference
    tests that later share the worker count its hits and misses exactly.
    Inside the file the JAX runs share their executables."""
    cache = list(jve._JAX_FN_CACHE.items())
    stats = dict(jve._JAX_CACHE_STATS)
    cap = jve._JAX_FN_CACHE_MAX
    yield
    jve._JAX_FN_CACHE.clear()
    jve._JAX_FN_CACHE.update(cache)
    jve._JAX_CACHE_STATS.clear()
    jve._JAX_CACHE_STATS.update(stats)
    jve._JAX_FN_CACHE_MAX = cap


def digest(log) -> str:
    return hashlib.sha256(";".join(
        f'{e["t"]},{e["user"]},{e["lag"]},{int(e["corun"])}'
        for e in log).encode()).hexdigest()


def per_point(sc):
    return P.Scenario(config=dataclasses.replace(sc.config, engine="jax"),
                      arrivals=sc._arrivals_arg, fleet=sc.fleet
                      ).run(device="cpu")


def assert_row(r, pp, rtol=1e-9):
    assert r.updates == pp.updates and r.drops == pp.drops
    np.testing.assert_array_equal(r.trace_t, pp.trace_t)
    np.testing.assert_array_equal(r.trace_Q, pp.trace_Q)
    np.testing.assert_allclose(r.trace_H, pp.trace_H, rtol=rtol)
    np.testing.assert_allclose(r.energy_j, pp.energy_j, rtol=rtol)
    np.testing.assert_allclose(r.trace_energy, pp.trace_energy, rtol=rtol)
    assert r.mean_Q == pytest.approx(pp.mean_Q, rel=rtol, abs=1e-12)
    np.testing.assert_allclose(r.mean_H, pp.mean_H, rtol=rtol)
    assert r.corun_fraction == pp.corun_fraction
    a, b = r.push_log.arrays(), pp.push_log.arrays()
    for j, name in enumerate(EVENT_FIELDS):
        if name in ("t", "user", "lag", "corun"):
            np.testing.assert_array_equal(a[j], b[j], err_msg=name)
        else:
            np.testing.assert_allclose(a[j], b[j], rtol=rtol, atol=1e-15,
                                       err_msg=name)


def _grid_kw(policy, aggregation, dynamics):
    kw = dict(policy=policy, n_users=10, horizon_s=600, seed=5,
              app_arrival_p=0.02, aggregation=aggregation, V=60.0,
              L_b=2.0, jax_chunk=256)
    if dynamics != "none":
        kw["dynamics"] = dynamics
    return kw


@pytest.mark.parametrize("policy,aggregation,dynamics", (
    ("online", "replace", "none"), ("online", "fedasync_poly", "markov"),
    ("eps_greedy", "hetero_aware", "none"), ("greedy", "gap_aware", "none"),
    ("sync", "replace", "none")))
def test_batched_rows_equal_per_point_runs(policy, aggregation, dynamics):
    grid = P.Scenario(**_grid_kw(policy, aggregation, dynamics)).grid(
        V=[5.0, 60.0, 200.0])
    sims = [sc.build(device="cpu") for sc in grid]
    assert len({pve.sweep_bucket_key(s) for s in sims}) == 1
    results = P.run_sweep(grid, device="cpu")
    assert sum(r.updates for r in results) > 0
    for sc, r in zip(grid, results):
        assert_row(r, per_point(sc))


@pytest.mark.parametrize("policy,dynamics", (("online", "none"),
                                             ("eps_greedy", "markov")))
def test_batched_rows_equal_the_jax_sweep_under_x64(policy, dynamics):
    kw = _grid_kw(policy, "fedasync_poly", dynamics)
    ours = P.Scenario(**kw).sweep(V=[5.0, 60.0], L_b=[2.0, 50.0],
                                  device="cpu")
    theirs = J.Scenario(**kw).sweep(V=[5.0, 60.0], L_b=[2.0, 50.0])
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert digest(a.push_log) == digest(b.push_log)
        assert a.updates == b.updates and a.drops == b.drops
        assert a.energy_j == pytest.approx(b.energy_j, rel=1e-9)
        assert a.mean_Q == pytest.approx(b.mean_Q, rel=1e-9, abs=1e-12)
        assert a.mean_H == pytest.approx(b.mean_H, rel=1e-6, abs=1e-9)
        for col in ("gap", "weight"):
            np.testing.assert_allclose(a.push_log.field(col),
                                       b.push_log.field(col), rtol=1e-9,
                                       atol=1e-15)


def _mixed(pkg):
    return (pkg.Scenario(policy="online", n_users=10, horizon_s=300,
                         seed=2).grid(V=[20.0, 50.0])
            + pkg.Scenario(policy="online", n_users=14, horizon_s=300,
                           seed=2).grid(V=[20.0, 50.0])
            + [pkg.Scenario(policy="offline", n_users=10, horizon_s=300,
                            seed=2),
               pkg.Scenario(policy="online", n_users=10, horizon_s=300,
                            seed=2, engine="loop"),
               pkg.Scenario(policy="online", n_users=10, horizon_s=300,
                            seed=2, jax_chunk=0),
               pkg.Scenario(policy="greedy", n_users=10, horizon_s=300,
                            seed=3),
               pkg.Scenario(policy="online", n_users=10, horizon_s=300,
                            seed=4, jax_chunk=64),
               pkg.Scenario(policy="online", n_users=10, horizon_s=300,
                            seed=4, push_log_capacity=5000),
               pkg.Scenario(policy="online", n_users=10, horizon_s=300,
                            seed=9, collect_push_log=False),
               pkg.Scenario(policy="online", n_users=10, horizon_s=300,
                            seed=9, aggregation="gap_aware"),
               pkg.Scenario(policy="online", n_users=10, horizon_s=300,
                            seed=7, dynamics="markov")])


def _partition(keys):
    groups = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return sorted(sorted(g) for k, g in groups.items() if k is not None), \
        sorted(i for i, k in enumerate(keys) if k is None)


def test_bucket_keys_group_a_mixed_grid_as_jax():
    ours = [pve.sweep_bucket_key(sc.build(device="cpu"))
            for sc in _mixed(P)]
    theirs = [jve.sweep_bucket_key(sc.build()) for sc in _mixed(J)]
    assert _partition(ours) == _partition(theirs)
    batched, alone = _partition(ours)
    assert [0, 1] in batched and [2, 3] in batched
    assert 4 in alone and 5 in alone and 6 in alone   # offline, loop, tuned


@pytest.mark.parametrize("what", ("policy", "aggregation", "dynamics"))
def test_a_component_without_vmap_runs_alone_as_in_jax(what):
    """A policy, rule or dynamics that clears ``supports_vmap`` keeps its
    points out of every bucket, as in the reference; the sweep then runs
    each point on its own."""
    grids = []
    for pkg in (J, P):
        if what == "policy":
            class NoVmap(pkg.OnlinePolicy):
                name = "no_vmap_test"
                supports_vmap = False
        elif what == "aggregation":
            class NoVmap(pkg.ReplaceRule):
                name = "no_vmap_rule_test"
                supports_vmap = False
        else:
            class NoVmap(pkg.MarkovChurnDynamics):
                supports_vmap = False
        kw = dict(policy="online", n_users=6, horizon_s=120, seed=2)
        kw[what] = NoVmap()
        grids.append(pkg.Scenario(**kw).grid(V=[20.0, 50.0]))
    assert [jve.sweep_bucket_key(sc.build()) for sc in grids[0]] == \
        [None, None]
    assert [pve.sweep_bucket_key(sc.build(device="cpu"))
            for sc in grids[1]] == [None, None]
    for sc, r in zip(grids[1], P.run_sweep(grids[1], device="cpu")):
        ref = sc.run(device="cpu")
        assert digest(r.push_log) == digest(ref.push_log)
        assert r.energy_j == ref.energy_j


def test_rows_keep_their_own_trace_every():
    """Points that differ only in ``trace_every`` share a bucket; each row
    samples its trace at its own interval, as its per-point run and the
    JAX package's sweep do."""
    kw = _grid_kw("online", "replace", "none")
    every = [7, 30, 1]
    grid = P.Scenario(**kw).grid(trace_every=every)
    assert len({pve.sweep_bucket_key(sc.build(device="cpu"))
                for sc in grid}) == 1
    ours = P.run_sweep(grid, device="cpu")
    theirs = J.run_sweep(J.Scenario(**kw).grid(trace_every=every))
    for sc, e, r, t in zip(grid, every, ours, theirs):
        assert_row(r, per_point(sc))
        np.testing.assert_array_equal(r.trace_t, np.arange(0, 600, e))
        np.testing.assert_array_equal(r.trace_t, t.trace_t)
        np.testing.assert_allclose(r.trace_Q, t.trace_Q, rtol=1e-9)
        np.testing.assert_allclose(r.trace_H, t.trace_H, rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(r.trace_energy, t.trace_energy,
                                   rtol=1e-9)


def test_a_real_ml_point_is_built_just_before_its_run(monkeypatch):
    """A real-ML point never batches: the sweep builds its backend only
    when it runs, so a sweep holds one point's model at a time."""
    events = []
    build, run = P.Scenario.build, P.FederatedSim.run

    def spy_build(self, *a, **k):
        events.append(("build", self.ml is not None))
        return build(self, *a, **k)

    def spy_run(self):
        events.append(("run", self.ml_backend is not None))
        return run(self)

    monkeypatch.setattr(P.Scenario, "build", spy_build)
    monkeypatch.setattr(P.FederatedSim, "run", spy_run)
    ml = P.Scenario(policy="online", ml="mlp", n_users=2, horizon_s=30,
                    ml_kwargs=dict(device="cpu", n_train=64, n_test=32,
                                   eval_every=300))
    trace = P.Scenario(policy="online", n_users=4, horizon_s=60, seed=1)
    results = P.run_sweep([ml, trace], device="cpu")
    assert events == [("build", False), ("build", True), ("run", True),
                      ("run", False)]
    monkeypatch.undo()
    alone = ml.run(device="cpu")
    assert results[0].accuracy == alone.accuracy != []
    assert results[0].energy_j == alone.energy_j
    assert digest(results[1].push_log) == digest(trace.run().push_log)


def test_mixed_grid_returns_results_in_input_order():
    scs = _mixed(P)[:5]
    results = P.run_sweep(scs, device="cpu")
    for sc, r in zip(scs, results):
        if sc.policy.name == "offline":
            ref = P.Scenario(config=sc.config).run()
            assert digest(r.push_log) == digest(ref.push_log)
        else:
            assert_row(r, per_point(sc))


def test_offline_is_never_batched():
    grid = P.Scenario(policy="offline", n_users=10, horizon_s=300,
                      seed=2).grid(L_b=[5.0, 1000.0])
    assert all(pve.sweep_bucket_key(sc.build(device="cpu")) is None
               for sc in grid)
    with pytest.raises(ValueError, match="sweep_bucket_key"):
        pve.run_jax_sweep([sc.build(device="cpu") for sc in grid])


def test_run_jax_sweep_rejects_mixed_keys():
    scs = _mixed(P)
    sims = [scs[0].build(device="cpu"), scs[2].build(device="cpu")]
    with pytest.raises(ValueError, match="sweep_bucket_key"):
        pve.run_jax_sweep(sims)
    assert pve.run_jax_sweep([]) == []


def test_sweep_rejects_non_scenarios():
    with pytest.raises(TypeError, match="Scenario"):
        P.run_sweep([P.SimConfig(policy="online")], device="cpu")


def test_batch_overflow_retry_keeps_every_row_exact():
    grid = P.Scenario(policy="immediate", n_users=8, horizon_s=600, seed=1,
                      app_arrival_p=0.02, push_log_capacity=2).grid(
        seed=[1, 2, 3])
    sims = [sc.build(device="cpu") for sc in grid]
    results = pve.run_jax_sweep(sims)
    assert sims[0].scan_info.retries > 0 and sims[0].scan_info.batch == 3
    for sc, r in zip(grid, results):
        ref = P.Scenario(config=dataclasses.replace(
            sc.config, engine="vectorized")).run()
        assert len(r.push_log) == r.updates == ref.updates > 2
        assert digest(r.push_log) == digest(ref.push_log)


def test_sweep_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.Scenario(policy="online", n_users=4, horizon_s=30).sweep(
            V=[1.0, 2.0])
