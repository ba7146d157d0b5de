"""The port's device scan engine (``engine="jax"``, core/vector_engine.py)
on the CPU, against the JAX package's jax engine under x64 and against
the port's numpy engine, live, to the reference's engine-parity contract
(tests/test_engine_matrix.py): the schedule (t, user, lag, corun) equal,
energy and mean_Q within rel 1e-9, mean_H within rel 1e-6, gap and weight
within rtol 1e-9 / atol 1e-15. Also: chunk invariance, the push buffer's
overflow retry, the auto-tuner's arithmetic, the threefry device twin,
online's replay (plain version) against the numpy engine's
``decide_batch``, the degrade rule of ``resolve_engine``, the device rule,
and item 11's API (``predict_weights``, ``true_gap``, ``POLICIES``, the
data exports). The replay's CUDA kernel is held to its plain version on
the card (tests/test_torch_cuda.py)."""
import dataclasses
import functools
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import autotune as j_autotune  # noqa: E402
from repro.core import staleness as j_staleness  # noqa: E402
from repro.core import vector_engine as jve  # noqa: E402
from repro.core.lyapunov import OnlineScheduler as JSched  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import autotune, prng, staleness  # noqa: E402
from repro_torch.core.lyapunov import OnlineScheduler  # noqa: E402
from repro_torch.core.policies import (Policy,  # noqa: E402
                                       registered_policies)
from repro_torch.kernels.online_replay import online_replay  # noqa: E402

KW = dict(n_users=10, horizon_s=1500, app_arrival_p=0.01, seed=11,
          V=2000.0, L_b=2.0)
RULES = ("replace", "fedasync_poly", "gap_aware", "hetero_aware")
CHURN = dict(p_off=0.01, p_on=0.05, resume_penalty_s=20.0)


@pytest.fixture(autouse=True)
def _x64_and_threefry():
    """x64 for the reference's f64 scan; the port's threefry mode follows
    jax's flag. Both restored."""
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


def assert_contract(res, ref):
    assert res.updates == ref.updates
    assert digest(res.push_log) == digest(ref.push_log)
    assert res.drops == ref.drops
    assert res.energy_j == pytest.approx(ref.energy_j, rel=1e-9)
    assert res.mean_Q == pytest.approx(ref.mean_Q, rel=1e-9, abs=1e-12)
    assert res.mean_H == pytest.approx(ref.mean_H, rel=1e-6, abs=1e-9)
    for col in ("gap", "weight"):
        np.testing.assert_allclose(res.push_log.field(col),
                                   ref.push_log.field(col), rtol=1e-9,
                                   atol=1e-15, err_msg=col)
    np.testing.assert_array_equal(res.trace_t, ref.trace_t)
    np.testing.assert_allclose(res.trace_energy, ref.trace_energy,
                               rtol=1e-9)
    np.testing.assert_allclose(res.trace_Q, ref.trace_Q, rtol=1e-9,
                               atol=1e-12)


@functools.lru_cache(maxsize=None)
def port_run(policy, engine, rule="replace", chunk=1024, dropout=None):
    kw = dict(KW, policy=policy, aggregation=rule, engine=engine)
    if engine == "jax":
        kw["jax_chunk"] = chunk
    if dropout:
        kw["dynamics"] = P.MarkovChurnDynamics(dropout=dropout, **CHURN)
    return P.Scenario(**kw).run(device="cpu")


def jax_run(policy, engine, rule="replace", dropout=None):
    kw = dict(KW, policy=policy, aggregation=rule, engine=engine)
    if dropout:
        kw["dynamics"] = J.MarkovChurnDynamics(dropout=dropout, **CHURN)
    return J.Scenario(**kw).run()


# ---------------------------------------------------------------------------
# the engine matrix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", registered_policies())
def test_every_policy_equals_jax_scan_and_numpy_engine(policy):
    res = port_run(policy, "jax")
    assert res.updates > 0
    assert_contract(res, jax_run(policy, "jax"))
    assert_contract(res, port_run(policy, "vectorized"))


@pytest.mark.parametrize("rule", RULES[1:])
@pytest.mark.parametrize("policy", ("online", "eps_greedy"))
def test_rule_weights_equal_jax_scan_and_numpy_engine(policy, rule):
    res = port_run(policy, "jax", rule)
    weights = res.push_log.field("weight")
    assert len(weights) and np.all((weights > 0) & (weights <= 1))
    assert_contract(res, jax_run(policy, "jax", rule))
    assert_contract(res, port_run(policy, "vectorized", rule))


@pytest.mark.parametrize("dropout", ("lose", "resume"))
def test_markov_churn_equals_jax_numpy_engine(dropout):
    """Under churn the reference's numpy engine is the oracle (its jax
    engine fails its own churn burst on this tree)."""
    res = port_run("online", "jax", dropout=dropout, chunk=333)
    assert res.drops > 0
    assert_contract(res, jax_run("online", "vectorized", dropout=dropout))


def test_final_state_reads_like_the_numpy_engines():
    sims = {e: P.Scenario(engine=e, jax_chunk=64, **KW).build(device="cpu")
            for e in ("jax", "vectorized")}
    for sim in sims.values():
        sim.run()
    a, b = sims["jax"].state, sims["vectorized"].state
    for f in ("mode", "cooldown", "app", "corun", "pulled_at", "updates",
              "plan"):
        np.testing.assert_array_equal(a.__dict__[f], b.__dict__[f],
                                      err_msg=f)
    for f in ("app_rem", "train_rem", "idle_gap", "energy"):
        np.testing.assert_allclose(a.__dict__[f], b.__dict__[f], rtol=1e-12)
    assert (a.version, a.in_flight, a.round_open, a.corun_updates) == \
        (b.version, b.in_flight, b.round_open, b.corun_updates)
    assert a.Q == b.Q and a.H == pytest.approx(b.H, rel=1e-9)
    assert a.rng_key.dtype == np.uint32
    np.testing.assert_array_equal(a.rng_key, b.rng_key)


# ---------------------------------------------------------------------------
# chunks and the push buffer
# ---------------------------------------------------------------------------
def test_chunk_size_does_not_change_the_run():
    """1500 slots in chunks of 7, 64 and 1024 (uneven tails): the same
    run, bit for bit."""
    runs = [port_run("online", "jax", chunk=c) for c in (7, 64, 1024)]
    for r in runs[1:]:
        for a, b in zip(r.push_log.arrays(), runs[0].push_log.arrays()):
            np.testing.assert_array_equal(a, b)
        assert r.energy_j == runs[0].energy_j
        assert r.mean_H == runs[0].mean_H
        np.testing.assert_array_equal(r.trace_H, runs[0].trace_H)


def test_push_buffer_overflow_is_lossless():
    kw = dict(policy="immediate", n_users=8, horizon_s=1200, seed=1,
              app_arrival_p=0.02)
    sim = P.Scenario(engine="jax", push_log_capacity=1, jax_chunk=300,
                     **kw).build(device="cpu")
    res = sim.run()
    ref = P.Scenario(engine="vectorized", **kw).run()
    assert sim.scan_info.retries > 0 and sim.scan_info.capacity > 1
    assert len(res.push_log) == res.updates == ref.updates > 4
    for a, b in zip(res.push_log.arrays(), ref.push_log.arrays()):
        np.testing.assert_allclose(a, b, rtol=1e-12)


@pytest.mark.parametrize("chunk", (0, 128))
def test_no_push_log_and_auto_tuned_chunk(chunk):
    kw = dict(KW, horizon_s=400, policy="online", collect_push_log=False)
    sim = P.Scenario(engine="jax", jax_chunk=chunk, **kw).build(device="cpu")
    res = sim.run()
    ref = P.Scenario(engine="vectorized", **kw).run()
    assert len(res.push_log) == 0 and res.updates == ref.updates
    assert res.energy_j == pytest.approx(ref.energy_j, rel=1e-9)
    want = 128 if chunk else sim.scan_info.tune.jax_chunk
    assert sim.scan_info.chunk == want and sim.scan_info.capacity == 0


EDGES = {"overhead": dict(include_scheduler_overhead=True),
         "half_slot": dict(t_d=0.5),
         "uneven_slots": dict(t_d=1.6, horizon_s=48),
         "no_slot": dict(horizon_s=0.4),
         "one_user": dict(n_users=1, policy="greedy"),
         "rate_vector": dict(app_arrival_p=tuple(0.01 * (i + 1)
                                                 for i in range(10))),
         "sync_no_delay": dict(policy="sync", t_d=2.0, ready_delay=0)}


@pytest.mark.parametrize("case", list(EDGES))
def test_edge_configs_equal_numpy_engine(case):
    """Scheduler overhead power, slots other than 1 s (an uneven 48 s /
    1.6 s horizon, a horizon of no slot), one user, per-user arrival
    rates, sync rounds without a cooldown."""
    kw = dict(policy="online", n_users=10, horizon_s=600, seed=3, V=200.0,
              L_b=2.0, app_arrival_p=0.02)
    kw.update(EDGES[case])
    res = P.Scenario(engine="jax", jax_chunk=64, **kw).run(device="cpu")
    assert_contract(res, P.Scenario(engine="vectorized", **kw).run())


# ---------------------------------------------------------------------------
# the auto-tuner: the reference's arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mem", (1 << 20, 64 << 20, 16 << 30))
@pytest.mark.parametrize("n,horizon,dyn", ((25, 600, "none"),
                                           (5000, 3000, "markov"),
                                           (100_000, 20, "none")))
@pytest.mark.parametrize("collect", (True, False))
def test_autotune_equals_jax(mem, n, horizon, dyn, collect):
    """One device (the reference's n_devices = 1; the sharded scan is
    ROADMAP Queue 1 item 9), with and without the push log."""
    kw = dict(n_users=n, horizon_s=horizon, dynamics=dyn,
              collect_push_log=collect)
    a = autotune.autotune_scan_params(
        P.FederatedSim(P.SimConfig(**kw), device="cpu"), mem_bytes=mem)
    b = j_autotune.autotune_scan_params(J.FederatedSim(J.SimConfig(**kw)),
                                        mem_bytes=mem)
    assert vars(a) == vars(b)


def test_estimate_device_bytes_equals_jax():
    for args in ((25, 600, 64, 1024), (10 ** 6, 300, 300, 1 << 20),
                 (7, 3, 3, 0)):
        for dyn in (False, True):
            for collect in (False, True):
                kw = dict(dyn_active=dyn, collect=collect)
                assert autotune.estimate_device_bytes(*args, **kw) == \
                    j_autotune.estimate_device_bytes(*args, **kw)


def test_cpu_budget_is_a_quarter_of_system_ram():
    assert autotune.device_memory_budget(device="cpu") == \
        j_autotune.device_memory_budget(1)


# ---------------------------------------------------------------------------
# the threefry device twin
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", (True, False))
def test_device_threefry_equals_host_twin_and_jax(mode):
    prng.set_partitionable(mode)
    rng = np.random.default_rng(3)
    keys = [np.array([0, s], np.uint32) for s in (0, 11, 2 ** 32 - 1)]
    keys += [rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
             for _ in range(5)]
    batch = torch.as_tensor(np.stack(keys).astype(np.int64))
    with jax.threefry_partitionable(mode):
        for num in (2, 3):
            out = prng.split_t(batch, num).numpy().astype(np.uint32)
            for b, key in enumerate(keys):
                ref = np.asarray(jax.random.split(jnp.asarray(key), num))
                np.testing.assert_array_equal(out[b], ref)
                np.testing.assert_array_equal(out[b], prng.split(key, num))
        for n in (1, 10, 25, 1001):
            out = prng.uniform_t(batch, n).numpy()
            assert out.dtype == np.float32
            for b, key in enumerate(keys):
                ref = np.asarray(jax.random.uniform(jnp.asarray(key), (n,),
                                                    jnp.float32))
                np.testing.assert_array_equal(out[b].view(np.uint32),
                                              ref.view(np.uint32))
        # the dynamics' (2, n) draw is the (2 n,) one reshaped
        two = np.asarray(jax.random.uniform(jnp.asarray(keys[1]), (2, 25),
                                            jnp.float32))
        np.testing.assert_array_equal(
            prng.uniform_t(batch[1], 50).reshape(2, 25).numpy(), two)


# ---------------------------------------------------------------------------
# online's in-slot replay: the plain version against the numpy engine's
# ---------------------------------------------------------------------------
def _replay_case(rng, n, H):
    powers = np.array([0.3, 0.55, 1.2, 2.4])
    # Q = 0 half the time, so that equal powers tie on the gap terms alone
    V, eta, beta, eps = 4000.0, 0.01, 0.9, 0.05
    Q = float(rng.integers(1, 40)) if rng.random() < 0.5 else 0.0
    waiting = rng.random(n) < 0.7
    p_s, p_i = rng.choice(powers, n), rng.choice(powers, n)
    lag0 = int(rng.integers(0, 20))
    vn = float(1.0 / np.sqrt(1.0 + 0.05 * rng.integers(0, 500)))
    sched = OnlineScheduler(V, 1000.0, eta, beta, eps, 1.0)
    sched.Q, sched.H = Q, H
    gap_vec = staleness.gradient_gap(vn, lag0 + np.arange(n + 1), eta, beta)
    # ties on purpose: equal powers, an idle gap on the gap table
    tie = rng.random(n) < 0.4
    p_s = np.where(tie, p_i, p_s)
    ig = np.where(tie, gap_vec[rng.integers(0, n + 1, n)] - eps,
                  rng.choice([0.0, 0.05, 0.25], n))
    base = V * p_s * 1.0 - Q
    rhs = V * p_i * 1.0
    return sched, waiting, base, rhs, ig, gap_vec, lag0, vn, p_s, p_i


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("H", (0.0, 0.7, 3000.0))
def test_replay_plain_equals_decide_batch(seed, H):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    sched, waiting, base, rhs, ig, gap_vec, lag0, vn, p_s, p_i = \
        _replay_case(rng, n, H)
    gap_idle = ig + sched.epsilon
    t = lambda a: torch.as_tensor(np.asarray(a))[None]
    start, gsum = online_replay(
        t(waiting), t(base).double(), t(rhs).double(), t(gap_idle).double(),
        t(gap_vec).double(), torch.tensor([H], dtype=torch.float64),
        kernel="reference")
    w = np.nonzero(waiting)[0]
    k = len(w)
    seq = sched._decide_batch_sequential(
        base[w], rhs[w], gap_idle[w], gap_vec[:k + 1], k)
    np.testing.assert_array_equal(start[0].numpy()[w], seq.schedule)
    assert not start[0].numpy()[~waiting].any()
    # the replay sums the waiting users' gaps in numpy's order: exactly
    # np.sum of the same operands, and so the numpy engine's gap_sum
    assert float(gsum[0]) == float(np.sum(seq.gaps)) == seq.gap_sum
    batch = sched.decide_batch(p_s[w], p_i[w], ig[w], lag0, vn)
    np.testing.assert_array_equal(start[0].numpy()[w], batch.schedule)
    assert float(gsum[0]) == batch.gap_sum
    jb = JSched(sched.V, 1000.0, 0.01, 0.9, 0.05, 1.0)
    jb.Q, jb.H = sched.Q, H
    ref = jb.decide_batch(p_s[w], p_i[w], ig[w], lag0, vn)
    np.testing.assert_array_equal(batch.schedule, ref.schedule)


def test_replay_rejects_bad_shapes_and_cuda_mode_on_cpu():
    ok = (torch.zeros((1, 3), dtype=torch.bool),
          *[torch.zeros((1, 3), dtype=torch.float64)] * 3,
          torch.zeros((1, 4), dtype=torch.float64),
          torch.zeros(1, dtype=torch.float64))
    start, gsum = online_replay(*ok)
    assert start.shape == (1, 3) and float(gsum[0]) == 0.0
    with pytest.raises(ValueError, match="gap_vec"):
        online_replay(*ok[:4], torch.zeros((1, 3), dtype=torch.float64),
                      ok[5])
    with pytest.raises(ValueError, match="CUDA"):
        online_replay(*ok, kernel="cuda")


def _plain(w, b, r, gi, gv, H):
    """The plain replay of one row (numpy in, numpy out)."""
    t = lambda a: torch.as_tensor(np.asarray(a))[None]
    start, gsum = online_replay(t(w), t(b), t(r), t(gi), t(gv),
                                torch.tensor([float(H)], dtype=torch.float64),
                                kernel="reference")
    return start[0].numpy(), float(gsum[0])


def _walk_operands(w, b, r, gi, gv, H):
    """The literal walk's operands of the waiting users, in user order."""
    j, ops = 0, []
    for i in np.nonzero(w)[0].tolist():
        if b[i] + H * gv[j] <= r[i] + H * gi[i]:
            ops.append(gv[j])
            j += 1
        else:
            ops.append(gi[i])
    return np.array(ops, dtype=float)


@pytest.mark.parametrize("waiting", (0, 1, 7, 8, 127, 128, 129, 8191, 8192,
                                     8193, 16385, 20000))
def test_replay_gap_sum_is_numpy_sum_order(waiting):
    """The plain gap_sum equals np.sum of the waiting users' operands bit
    for bit at numpy's leaf (8, 128) and buffer (8,192) edges; operands
    of mixed magnitudes, so that the order of the additions shows."""
    from repro_torch.kernels.online_replay import np_sum_order
    rng = np.random.default_rng(waiting)
    n = waiting + waiting // 3
    w = np.zeros(n, bool)
    w[rng.permutation(n)[:waiting]] = True
    gi = rng.random(n) * 10.0 ** rng.integers(-6, 3, n)
    gv = np.sort(rng.random(n + 1) * 10.0 ** rng.integers(-6, 3, n + 1))
    r = 4000.0 * rng.choice([0.3, 1.2, 2.4], n)
    b = 4000.0 * rng.choice([0.3, 1.2, 2.4], n) - 7.0
    start, gsum = _plain(w, b, r, gi, gv, 0.5)
    ops = _walk_operands(w, b, r, gi, gv, 0.5)
    assert len(ops) == waiting
    assert waiting < 128 or 0 < start.sum() < waiting   # both kinds
    assert np.float64(gsum).view(np.int64) == np.sum(ops).view(np.int64)
    assert np_sum_order(ops.tolist()) == float(np.sum(ops))
    if waiting >= 8193:   # a serial sum lands elsewhere: the order shows
        serial = 0.0
        for x in ops.tolist():
            serial += x
        assert serial != gsum


def _threshold_model(w, b, r, gi, gv, H):
    """Phases (a)-(e) of ``csrc/online_replay.cu`` for one row, in numpy,
    as the kernel forms them: the row's check; w_i; K_i by bisection in
    [-1, w_i] (w_i and 0 probed first); the classes; A_i and u_i; the
    integer walk over the undecided users with T_i = K_i - A_i; the
    decisions and operands. None where the check sends the row to the
    literal walk. Held here to the plain version; not used by the
    package."""
    n, W = len(b), int(w.sum())
    with np.errstate(invalid="ignore", over="ignore"):
        ok = (np.isfinite(H) and H >= 0.0
              and (W <= 1 or bool(np.all(gv[:W - 1] <= gv[1:W])))
              and (W == 0 or (np.isfinite(H * gv[0])
                              and np.isfinite(H * gv[W - 1]))))
    if not ok:
        return None
    wi = np.cumsum(w) - w                                     # (a)
    c = r + H * gi
    holds = lambda j: b + H * gv[j] <= c                      # (b)
    top, bot = holds(wi), holds(np.zeros(n, np.int64))
    always, und = w & top, w & ~top & bot
    lo, hi = np.zeros(n, np.int64), np.where(und, wi, 0)
    while np.any(hi - lo > 1):
        go = hi - lo > 1
        mid = (lo + hi) >> 1
        h = holds(np.where(go, mid, 0))
        lo, hi = np.where(go & h, mid, lo), np.where(go & ~h, mid, hi)
    K = np.where(always, wi, np.where(und, lo, -1))
    A, u = np.cumsum(always) - always, np.cumsum(und) - und   # (c)
    T = (K - A)[und]
    M, m = np.zeros(len(T) + 1, np.int64), 0                  # (d)
    for k, t in enumerate(T.tolist()):
        M[k] = m
        m += m <= t
    M[len(T)] = m
    d = always | (und & (M[np.minimum(u + 1, len(T))] > M[u]))  # (e)
    j = np.where(d, A + M[u], 0)
    ops = np.where(d, gv[j], gi)[w]
    return d, ops, int(always.sum()), int(und.sum()), K, A


def _model_case(rng, n, H, kind):
    """One row: random operands with ties and one-ulp neighbours (as
    ``_replay_case``), or every waiting user undecided."""
    if kind == "undecided":
        # base == rhs and g_i = gap_vec[k] for k < w_i on a strictly
        # increasing gap_vec: the comparison holds for j <= k only
        w = np.ones(n, bool)
        r = np.full(n, 4000.0)
        gv = 1e-3 * (3.0 + np.arange(n + 1))
        wi = np.arange(n)
        k = rng.integers(0, np.maximum(wi, 1))
        return w, r.copy(), r, gv[k], gv, H
    sched, w, b, r, ig, gv, *_ = _replay_case(rng, n, H)
    ulp = rng.random(n) < 0.1
    b = np.where(ulp, np.nextafter(r, rng.choice([-np.inf, np.inf], n)), b)
    gi = ig + sched.epsilon
    if kind == "unsorted":
        gv = gv[::-1].copy()
    elif kind == "nan_b":
        b[rng.integers(0, n)] = np.nan
    return w, b, r, gi, gv, H


@pytest.mark.parametrize("kind,H", (("random", 0.7), ("random", 3000.0),
                                    ("random", 0.0), ("unsorted", 3000.0),
                                    ("nan_b", 3000.0), ("undecided", 1.0),
                                    ("random", float("nan"))))
@pytest.mark.parametrize("seed", range(4))
def test_replay_threshold_model_equals_plain_walk(kind, H, seed):
    """The numpy model of the kernel's phases (a)-(e) gives the plain
    walk's decisions and operands (so np.sum of them is the plain
    gap_sum), with the classes that probing w_i and 0 gives; an unsorted
    gap_vec or a NaN H fails the check (the literal walk)."""
    rng = np.random.default_rng(100 * seed + len(kind))
    n = int(rng.integers(200, 700))
    w, b, r, gi, gv, H = _model_case(rng, n, H, kind)
    start, gsum = _plain(w, b, r, gi, gv, H)
    got = _threshold_model(w, b, r, gi, gv, H)
    if kind == "unsorted" or np.isnan(H):
        assert got is None
        return
    d, ops, n_always, n_und, K, A = got
    np.testing.assert_array_equal(d, start)
    np.testing.assert_array_equal(ops, _walk_operands(w, b, r, gi, gv, H))
    assert float(np.sum(ops)) == gsum
    wi = np.cumsum(w) - w
    c = r + H * gi
    assert n_always == int((w & (b + H * gv[wi] <= c)).sum())
    assert n_und == int((w & ~(b + H * gv[wi] <= c)
                         & (b + H * gv[0] <= c)).sum())
    if H == 0.0:
        assert n_und == 0        # the gap terms add 0: no order
    if kind == "undecided":
        assert n_und == int(w.sum()) - 1   # all but the first waiting user
    if kind in ("random", "undecided") and H > 0:
        assert n_und > 0 and n_always > 0 or kind == "undecided"
        # T_i = K_i - A_i: the walk compares m with the lag K_i less the
        # always-users before i, and the cap at w_i: K_i < w_i for every
        # undecided user
        assert np.all(K[w & (K >= 0) & (K < wi)] < wi[w & (K >= 0) & (K < wi)])
        assert np.any((A > 0) & (K >= 0) & (K < wi) & w)


# ---------------------------------------------------------------------------
# the degrade rule and the construction-time checks
# ---------------------------------------------------------------------------
def _custom(pkg, kind):
    """One custom component per package: a policy with the numpy hook
    only, a loop-only policy, a rule without scan_weight, a dynamics
    without scan_step."""
    if kind == "vec_policy":
        class VecOnly(pkg.ImmediatePolicy):
            name = "vec_only_test"
            supports_jax = False
        return dict(policy=VecOnly())
    if kind == "loop_policy":
        class LoopOnly(pkg.Policy):
            name = "loop_only_test"

            def decide_loop(self, sim, t, waiting, carry):
                return 0, 0.0
        return dict(policy=LoopOnly())
    if kind in ("host_rule", "host_rule_no_log"):
        class HostRule(pkg.ReplaceRule):
            name = "host_rule_test"
            supports_jax = False
        return dict(aggregation=HostRule(),
                    collect_push_log=kind == "host_rule")
    if kind == "host_dyn":
        class HostDyn(pkg.MarkovChurnDynamics):
            supports_jax = False
        return dict(dynamics=HostDyn())
    return {}


@pytest.mark.parametrize("kind", ("none", "vec_policy", "loop_policy",
                                  "host_rule", "host_rule_no_log",
                                  "host_dyn", "v_norm_hook", "hooks"))
@pytest.mark.parametrize("engine", ("auto", "jax", "vectorized", "loop"))
def test_resolve_engine_equals_jax(kind, engine):
    out = []
    for pkg in (J, P):
        kw = dict(n_users=4, horizon_s=60, engine=engine,
                  **_custom(pkg, kind))
        hooks = None
        if kind == "v_norm_hook":
            hooks = {"v_norm": lambda: 1.0}
        elif kind == "hooks":
            hooks = {"pull": lambda uid: None}
            kw["ml_mode"] = "real"
        try:
            cfg = pkg.SimConfig(**kw)
            out.append(pkg.FederatedSim(cfg, ml_hooks=hooks)
                       .resolve_engine())
        except ValueError:
            out.append("ValueError")
    assert out[0] == out[1], out


def test_real_backend_degrades_jax_to_numpy_engine():
    ml = dict(n_train=64, n_test=32, seed=0, eval_every=300)
    a = J.Scenario(policy="online", engine="jax", ml="lenet", n_users=2,
                   horizon_s=30, ml_kwargs=ml).build()
    b = P.Scenario(policy="online", engine="jax", ml="lenet", n_users=2,
                   horizon_s=30, ml_kwargs=dict(ml, device="cpu")).build()
    assert a.resolve_engine() == b.resolve_engine() == "vectorized"


@pytest.mark.parametrize("what", ("policy", "aggregation", "dynamics"))
def test_flag_without_hook_raises_at_construction(what):
    for pkg in (J, P):
        if what == "policy":
            class Liar(pkg.ImmediatePolicy):
                name = "liar_test"
                scan_step = pkg.Policy.scan_step
            obj = Liar()
        elif what == "aggregation":
            class Liar(pkg.ReplaceRule):
                name = "liar_rule_test"
                scan_weight = pkg.AggregationRule.scan_weight
            obj = Liar()
        else:
            class Liar(pkg.MarkovChurnDynamics):
                scan_step = pkg.DeviceDynamics.scan_step
            obj = Liar()
        with pytest.raises(ValueError, match="supports_jax"):
            pkg.SimConfig(**{what: obj})


@pytest.mark.parametrize("k", (0, 1, 5))
def test_pad_state_equals_jax(k):
    """The inert rows a user axis padded past n would take (the
    reference's recipe, kept for the sharded scan): the same keys, dtypes
    and values; the base dynamics has no recipe."""
    kw = dict(p_off=0.01, p_on=0.05, battery_capacity=2.5)
    ours = P.MarkovChurnDynamics(**kw).pad_state(k)
    theirs = J.MarkovChurnDynamics(**kw).pad_state(k)
    assert ours.keys() == theirs.keys()
    for key in ours:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert a.dtype == b.dtype and a.shape == (k,), key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert P.DeviceDynamics().pad_state(k) is None
    assert J.DeviceDynamics().pad_state(k) is None


@pytest.mark.parametrize("field,value", (("jax_chunk", -1),
                                         ("push_log_capacity", -2)))
def test_negative_scan_knobs_raise(field, value):
    for pkg in (J, P):
        with pytest.raises(ValueError, match=field):
            pkg.SimConfig(**{field: value})


def test_jax_engine_without_cuda_and_without_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    sim = P.Scenario(policy="online", engine="jax", n_users=3,
                     horizon_s=20).build()
    assert sim.resolve_engine() == "jax"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.run()
    # the numpy engine needs no device
    assert P.Scenario(policy="online", n_users=3, horizon_s=20).run() \
        .energy_j > 0


# ---------------------------------------------------------------------------
# item 11: staleness, POLICIES, the data exports
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lag", (0, 1, 7, 40))
def test_predict_weights_and_true_gap_equal_jax(lag):
    rng = np.random.default_rng(lag)
    theta = {"w": rng.standard_normal((4, 3)), "b": rng.standard_normal(5)}
    v = {"w": rng.standard_normal((4, 3)), "b": rng.standard_normal(5)}
    ref = j_staleness.predict_weights(
        jax.tree.map(jnp.asarray, theta), jax.tree.map(jnp.asarray, v), lag,
        0.01, 0.9)
    for tree in (lambda t: t, lambda t: {k: torch.from_numpy(x)
                                         for k, x in t.items()}):
        out = staleness.predict_weights(tree(theta), tree(v), lag, 0.01, 0.9)
        for k in theta:
            np.testing.assert_allclose(np.asarray(out[k]),
                                       np.asarray(ref[k]), rtol=1e-12)
        gap = staleness.true_gap(tree(theta), out)
        assert gap == pytest.approx(j_staleness.true_gap(
            jax.tree.map(jnp.asarray, theta), ref), rel=1e-6)
    # Eq. 3's step is Eq. 4's gap: ||theta - theta'|| = scale * ||v||
    vn = float(np.sqrt(sum(np.sum(x ** 2) for x in v.values())))
    assert staleness.true_gap(theta, staleness.predict_weights(
        theta, v, lag, 0.01, 0.9)) == pytest.approx(
        staleness.gradient_gap(vn, lag, 0.01, 0.9), rel=1e-5, abs=1e-7)


def test_policies_and_exports_match_jax():
    assert P.POLICIES == J.POLICIES
    assert P.PushBuffer._fields == J.PushBuffer._fields
    for name in ("predict_weights", "true_gap", "POLICIES", "PushBuffer",
                 "run_jax_sweep", "sweep_bucket_key",
                 "autotune_scan_params"):
        assert hasattr(P, name), name
    import repro.data as jd
    import repro_torch.data as td
    for name in ("synthetic_tokens", "token_batches"):
        a = getattr(jd, name)
        b = getattr(td, name)
        assert name in td.__all__
        if name == "synthetic_tokens":
            np.testing.assert_array_equal(b(500, 97, seed=3),
                                          a(500, 97, seed=3))
