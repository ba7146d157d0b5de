"""The scan engine's padded user axis (``SimConfig.n_devices``, ROADMAP
Queue 1 item 9) on the CPU: ``pad_to_devices``, ``pad_state_per_user``
and ``unpad_state_per_user`` against the JAX package's own functions on
the same state, ``SimConfig``'s construction errors where JAX's raise,
``resolve_engine``'s routing, the auto-tuner's arithmetic at n_devices 1,
2 and 4 against JAX's, ``make_sim_mesh``; and, on the port alone, runs
padded past n (``_Scan``'s ``n_arr``) equal to the unpadded run bit for
bit (push log, Q/H/energy traces, every live user's state, drops) for
online, immediate, greedy and eps_greedy without dynamics and under
Markov churn, the pad rows inert (never waiting, training, pushing or
drawing energy). No JAX engine runs here; the fixture leaves the JAX
package's jitted-chunk cache and its flags as it found them all the
same."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import autotune as j_autotune  # noqa: E402
from repro.core import engine_state as j_es  # noqa: E402
from repro.core import vector_engine as j_ve  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import autotune, prng  # noqa: E402
from repro_torch.core import engine_state as p_es  # noqa: E402
from repro_torch.core import vector_engine as p_ve  # noqa: E402
from repro_torch.launch.mesh import make_sim_mesh  # noqa: E402

PER_USER = ("mode", "cooldown", "app", "app_rem", "train_rem", "corun",
            "idle_gap", "pulled_at", "energy", "updates", "plan")
CHURN = dict(p_off=0.005, p_on=0.05, resume_penalty_s=20.0)


@pytest.fixture(autouse=True)
def _flags():
    """The x64 and threefry flags as this test found them; the port's
    threefry mode follows jax's."""
    prev_x64 = jax.config.jax_enable_x64
    prev_tf = jax.config.jax_threefry_partitionable
    prev_mode = prng.PARTITIONABLE
    prng.set_partitionable(bool(prev_tf))
    yield
    prng.set_partitionable(prev_mode)
    jax.config.update("jax_threefry_partitionable", prev_tf)
    jax.config.update("jax_enable_x64", prev_x64)


@pytest.fixture(autouse=True, scope="module")
def _jax_chunk_cache():
    """The JAX package's jitted-chunk cache (contents and LRU order), its
    counters and its cap put back as this file found them."""
    cache = list(j_ve._JAX_FN_CACHE.items())
    stats = dict(j_ve._JAX_CACHE_STATS)
    cap = j_ve._JAX_FN_CACHE_MAX
    yield
    j_ve._JAX_FN_CACHE.clear()
    j_ve._JAX_FN_CACHE.update(cache)
    j_ve._JAX_CACHE_STATS.clear()
    j_ve._JAX_CACHE_STATS.update(stats)
    j_ve._JAX_FN_CACHE_MAX = cap


def _dyn(name):
    return P.MarkovChurnDynamics(**CHURN) if name == "markov" else "none"


def _jdyn(name):
    return J.MarkovChurnDynamics(**CHURN) if name == "markov" else "none"


def test_pad_to_devices_equals_jax():
    for n in (0, 1, 7, 8, 9, 100_000, 100_003):
        for d in (0, 1, 2, 3, 4, 8):
            assert p_es.pad_to_devices(n, d) == j_es.pad_to_devices(n, d)


@pytest.mark.parametrize("policy", ("online", "greedy"))
@pytest.mark.parametrize("dyn", ("none", "markov"))
def test_pad_then_unpad_equals_jax_and_is_the_identity(policy, dyn):
    """The same initial state padded by both packages from 10 to 16 users
    (greedy's wait counters ride in the carry; Markov churn brings its
    ``pad_state`` rows), then cut back."""
    kw = dict(n_users=10, horizon_s=60, policy=policy, seed=3)
    psim = P.FederatedSim(P.SimConfig(**kw, dynamics=_dyn(dyn)),
                          device="cpu")
    jsim = J.FederatedSim(J.SimConfig(**kw, dynamics=_jdyn(dyn)))
    rows = (psim.dynamics.pad_state(6), jsim.dynamics.pad_state(6)) \
        if dyn == "markov" else (None, None)
    ours = p_es.pad_state_per_user(psim.state, 16, dyn_rows=rows[0])
    theirs = j_es.pad_state_per_user(jsim.state, 16, dyn_rows=rows[1])
    for f in PER_USER:
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.shape == (16,) and a.dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    for f in ("carry", "dyn"):
        a, b = p_es._leaves(getattr(ours, f)), \
            j_es._map_tree(np.asarray, getattr(theirs, f))
        b = p_es._leaves(b)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y)
    back = p_es.unpad_state_per_user(ours, 10)
    for f in PER_USER + ("carry", "dyn"):
        for x, y in zip(p_es._leaves(getattr(back, f)),
                        p_es._leaves(getattr(psim.state, f))):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert p_es.pad_state_per_user(psim.state, 10) is psim.state
    with pytest.raises(ValueError, match="below the live n"):
        p_es.pad_state_per_user(psim.state, 9)
    if dyn == "markov":
        with pytest.raises(ValueError, match="pad_state"):
            p_es.pad_state_per_user(psim.state, 16)


def _rule_without_hook(pkg):
    class NoScanRule(pkg.ReplaceRule):
        name = "no_scan_test"
        supports_jax = False
    return NoScanRule()


def _dyn_not_shardable(pkg):
    class Pinned(pkg.MarkovChurnDynamics):
        name = "markov_unshardable_test"
        supports_shard = False
    return Pinned(**CHURN)


def _policy_without_hook(pkg):
    class HostOnly(pkg.ImmediatePolicy):
        name = "host_only_test"
        supports_jax = False
    return HostOnly()


CASES = {
    "negative": lambda pkg: dict(n_devices=-1),
    "loop": lambda pkg: dict(n_devices=2, engine="loop"),
    "vectorized": lambda pkg: dict(n_devices=1, engine="vectorized"),
    "offline": lambda pkg: dict(n_devices=1, policy="offline"),
    "policy_without_scan_step": lambda pkg: dict(
        n_devices=1, policy=_policy_without_hook(pkg)),
    "dynamics_not_shardable": lambda pkg: dict(
        n_devices=1, dynamics=_dyn_not_shardable(pkg)),
    "rule_without_scan_weight": lambda pkg: dict(
        n_devices=1, aggregation=_rule_without_hook(pkg)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_construction_errors_raise_where_jax_raises(case):
    with pytest.raises(ValueError) as theirs:
        J.SimConfig(n_users=5, **CASES[case](J))
    with pytest.raises(ValueError) as ours:
        P.SimConfig(n_users=5, **CASES[case](P))
    assert str(ours.value) == str(theirs.value)


def test_routing_never_degrades():
    """n_devices sends every eligible run to the scan engine (auto too),
    the push log off lets a rule without the hook through, and per-user
    hooks raise at run time, as in JAX."""
    for kw in (dict(engine="auto"), dict(engine="jax"),
               dict(collect_push_log=False,
                    aggregation=_rule_without_hook(P))):
        cfg = P.SimConfig(n_users=5, n_devices=1, **kw)
        assert P.FederatedSim(cfg, device="cpu").resolve_engine() == "jax"
    jkw = dict(collect_push_log=False, aggregation=_rule_without_hook(J))
    assert J.FederatedSim(J.SimConfig(n_users=5, n_devices=1, **jkw)
                          ).resolve_engine() == "jax"
    hooks = {"v_norm": lambda: 1.0}
    for pkg, kw in ((P, dict(device="cpu")), (J, {})):
        sim = pkg.FederatedSim(pkg.SimConfig(n_users=5, n_devices=1),
                               ml_hooks=hooks, **kw)
        with pytest.raises(ValueError, match="n_devices=1 shards"):
            sim.resolve_engine()
    assert p_ve.sweep_bucket_key(P.FederatedSim(
        P.SimConfig(n_users=5, n_devices=1), device="cpu")) is None
    assert j_ve.sweep_bucket_key(J.FederatedSim(
        J.SimConfig(n_users=5, n_devices=1))) is None


@pytest.fixture(scope="module")
def built():
    """The autotune cases' sims, built once a configuration for the three
    device counts and dropped with the module."""
    cache = {}
    yield cache
    cache.clear()


@pytest.mark.parametrize("D", (1, 2, 4))
@pytest.mark.parametrize("n,horizon,dyn,collect", (
    (25, 600, "none", True), (5001, 3000, "markov", True),
    (100_003, 20, "none", False)))
def test_autotune_at_n_devices_equals_jax(built, D, n, horizon, dyn,
                                          collect):
    key = (n, horizon, dyn, collect)
    if key not in built:
        kw = dict(n_users=n, horizon_s=horizon, collect_push_log=collect)
        built[key] = (
            P.FederatedSim(P.SimConfig(**kw, dynamics=_dyn(dyn)),
                           device="cpu"),
            J.FederatedSim(J.SimConfig(**kw, dynamics=_jdyn(dyn))))
    sim, jsim = built[key]
    for mem in (1 << 20, 64 << 20, 16 << 30):
        a = autotune.autotune_scan_params(sim, n_devices=D, mem_bytes=mem)
        b = j_autotune.autotune_scan_params(jsim, n_devices=D,
                                            mem_bytes=mem)
        assert vars(a) == vars(b)
    args = (n, n // 10, 64, 1024, D)
    for dyn_active in (False, True):
        assert autotune.estimate_device_bytes(
            *args, dyn_active=dyn_active, collect=collect) == \
            j_autotune.estimate_device_bytes(
                *args, dyn_active=dyn_active, collect=collect)
    assert autotune.device_memory_budget(D, device="cpu") == \
        j_autotune.device_memory_budget(D)


def test_make_sim_mesh():
    for n in (0, 1, 4):
        mesh = make_sim_mesh(n, device="cpu")
        assert mesh.size == 1 and mesh.axis_names == ("users",)
        assert mesh.devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="n_devices must be >= 0"):
        make_sim_mesh(-1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_sim_mesh(1)


def _scan(n_arr=0, keep=None, **kw):
    """One scan-engine run on the CPU; ``keep`` receives the padded final
    host state before its pad rows are cut."""
    cfg = P.SimConfig(**dict(dict(n_users=10, horizon_s=300,
                                  app_arrival_p=0.02, seed=11, V=2000.0,
                                  L_b=2.0, engine="jax"), **kw))
    sim = P.FederatedSim(cfg, device="cpu")
    if keep is not None:
        cut = p_ve.unpad_state_per_user

        def unpad(state, n):
            keep.append(state)
            return cut(state, n)
        p_ve.unpad_state_per_user = unpad
    try:
        res = p_ve._Scan([sim], torch.device("cpu"), n_arr=n_arr).run()[0]
    finally:
        if keep is not None:
            p_ve.unpad_state_per_user = cut
    return res, sim


@pytest.mark.parametrize("policy", ("online", "immediate", "greedy",
                                    "eps_greedy"))
@pytest.mark.parametrize("dyn", ("none", "markov"))
def test_padded_run_equals_unpadded_bitwise(policy, dyn):
    # greedy waits at most 60 slots, so that it trains within 300 s
    kw = dict(policy=P.GreedyThresholdPolicy(patience=60)
              if policy == "greedy" else policy, dynamics=_dyn(dyn))
    ref, rsim = _scan(**kw)
    kept = []
    pad, psim = _scan(n_arr=13, keep=kept, **kw)
    assert psim.scan_info.n_arr == 13 and rsim.scan_info.n_arr == 10
    assert ref.updates > 0 and (dyn == "none" or ref.drops > 0)
    assert list(pad.push_log) == list(ref.push_log)
    for f in ("energy_j", "updates", "mean_Q", "mean_H", "drops",
              "corun_fraction"):
        assert getattr(pad, f) == getattr(ref, f), f
    for f in ("trace_t", "trace_Q", "trace_H", "trace_energy"):
        np.testing.assert_array_equal(getattr(pad, f), getattr(ref, f))
    for f in PER_USER:
        np.testing.assert_array_equal(getattr(psim.state, f),
                                      getattr(rsim.state, f), err_msg=f)
    for f in ("carry", "dyn"):
        for x, y in zip(p_es._leaves(getattr(psim.state, f)),
                        p_es._leaves(getattr(rsim.state, f))):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(psim.state.rng_key, rsim.state.rng_key)
    # the pad rows never left MODE_OFF: no wait (Q equal above), no
    # training, no push, no energy, no churn
    full = kept[0]
    assert (full.mode[10:] == p_es.MODE_OFF).all()
    assert not full.updates[10:].any() and not full.energy[10:].any()
    assert not full.corun[10:].any() and (full.app[10:] == -1).all()
    if dyn == "markov":
        assert full.dyn["up"][10:].all() and not full.dyn["drops"][10:].any()
    if policy == "greedy":
        assert not full.carry["waited"][10:].any()


@pytest.mark.parametrize("policy", ("online",))
def test_n_devices_run_equals_the_unpadded_run(policy):
    """``n_devices=1`` (one device: no padding) through ``engine="auto"``
    takes the scan engine and equals the plain scan run bit for bit."""
    ref, rsim = _scan(policy=policy)
    sim = P.FederatedSim(dataclasses.replace(
        rsim.cfg, engine="auto", n_devices=1), device="cpu")
    res = sim.run()
    assert sim.scan_info.n_arr == 10
    assert list(res.push_log) == list(ref.push_log)
    assert (res.energy_j, res.mean_H) == (ref.energy_j, ref.mean_H)
    np.testing.assert_array_equal(res.trace_Q, ref.trace_Q)
