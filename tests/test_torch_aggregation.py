"""The port's aggregation rules (``fedasync_poly``, ``gap_aware``,
``hetero_aware`` beside ``replace``) against the JAX package's, live.

- Trace mode: every ported policy x every rule gives the reference numpy
  engine's push log (every field, digest equal), energy and queue trace.
- The host ``weight`` equals the reference's bit for bit (scalar and array
  paths); the tensor twin ``scan_weight`` equals it at f32 rounding.
- The LeNet finish: under ``gap_aware`` (one one-push K1 a push, the
  weight computed on the device from the previous push's norm) it equals
  the reference's Pallas finish scan (``_build_finish_chunk_pallas``, in
  interpret mode as the JAX tests run it) at rtol 1e-6 on parameters,
  momentum (beside the repo's atol for its cancelling step), gaps and
  weights; under ``fedasync_poly``/``hetero_aware`` (the weights through
  the cohort K1's weight tensor) it equals a per-push chain of
  ``fused_apply_flat_ref`` bit for bit.
- Real mode (the sizes of ``tests/test_real_mode.py``): the schedule equals
  the JAX backend's while H == 0, weights and gaps at rtol 2e-5, accuracy
  within 0.03.
"""
import hashlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import Scenario as JaxScenario  # noqa: E402
from repro.core import aggregation as j_agg  # noqa: E402
from repro.core import fleet as j_fleet  # noqa: E402
from repro.core.realml import LeNetBackend as JaxLeNetBackend  # noqa: E402
from repro.core.realml import _build_finish_chunk_pallas  # noqa: E402
from repro.core.server import AsyncParameterServer as JaxServer  # noqa: E402
from repro.models.lenet import init_lenet as jax_init_lenet  # noqa: E402
from repro_torch.core import Scenario  # noqa: E402
from repro_torch.core import aggregation as t_agg  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core.realml import (LeNetBackend, _masked_epoch,  # noqa: E402
                                     gap_aware_pushes)
from repro_torch.core.server import AsyncParameterServer  # noqa: E402
from repro_torch.core.staleness import gradient_gap  # noqa: E402
from repro_torch.kernels.fused_update import fused_apply_flat_ref  # noqa: E402
from repro_torch.models.lenet import params_from_jax  # noqa: E402

POLICIES = ("online", "immediate", "offline", "sync")
RULES = ("replace", "fedasync_poly", "hetero_aware", "gap_aware")
NEW_RULES = RULES[1:]
TRACE_KW = (dict(n_users=12, horizon_s=2000, seed=2, app_arrival_p=0.01,
                 V=5.0),
            dict(n_users=30, horizon_s=3000, seed=5, L_b=2.0, V=50.0))
SIM_KW = dict(n_users=4, horizon_s=900, app_arrival_p=0.004, seed=0, V=5.0)
ML_KW = dict(n_train=256, n_test=128, eval_every=300)
ETA, BETA = 0.01, 0.9


def _digest(rows) -> str:
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def _schedule(push_log):
    return [(e["t"], e["user"], e["lag"], e["corun"]) for e in push_log]


@pytest.mark.parametrize("case", range(len(TRACE_KW)))
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("policy", POLICIES)
def test_trace_push_log_matches_jax_engine(policy, rule, case):
    kw = dict(TRACE_KW[case], aggregation=rule)
    a = JaxScenario(policy=policy, engine="vectorized", **kw).run()
    b = Scenario(policy=policy, **kw).run()
    assert b.updates == a.updates > 0
    assert _digest(list(b.push_log)) == _digest(list(a.push_log))
    assert b.energy_j == pytest.approx(a.energy_j, rel=1e-9)
    assert (b.mean_Q, b.mean_H, b.corun_fraction) == \
        (a.mean_Q, a.mean_H, a.corun_fraction)
    np.testing.assert_array_equal(b.trace_Q, a.trace_Q)
    np.testing.assert_array_equal(b.trace_H, a.trace_H)
    if rule != "replace" and policy != "sync":
        assert min(e["weight"] for e in b.push_log) < 1.0


def _rule_pairs():
    return [(j_agg.resolve_aggregation(r), t_agg.resolve_aggregation(r))
            for r in RULES] + [
        (j_agg.FedAsyncPolyRule(0.9, 1.5), t_agg.FedAsyncPolyRule(0.9, 1.5)),
        (j_agg.GapAwareRule(0.05), t_agg.GapAwareRule(0.05)),
        (j_agg.HeteroAwareRule(2.0), t_agg.HeteroAwareRule(2.0))]


@pytest.mark.parametrize("fleet", ("paper", "synthetic"))
def test_host_weights_match_jax_bit_for_bit(fleet):
    n = 37
    fj = j_fleet.resolve_fleet(fleet).build(np.random.default_rng(3), n)
    ft = t_fleet.resolve_fleet(fleet).build(np.random.default_rng(3), n)
    rng = np.random.default_rng(8)
    lags = rng.integers(0, 40, n)
    vns = rng.uniform(0.0, 3.0, n)
    gaps = gradient_gap(vns, lags, ETA, BETA)
    users = rng.permutation(n)
    for rj, rt in _rule_pairs():
        assert (rt.name, rt.needs_gap) == (rj.name, rj.needs_gap)
        wj = rj.weight(lags, gaps, vns, fleet=fj, users=users)
        wt = rt.weight(lags, gaps, vns, fleet=ft, users=users)
        np.testing.assert_array_equal(np.broadcast_to(wt, lags.shape),
                                      np.broadcast_to(wj, lags.shape))
        assert np.all((0.0 <= wt) & (wt <= 1.0))
        for i in range(4):      # the scalar (server) path: the same bits
            s = rt.weight(int(lags[i]), float(gaps[i]), float(vns[i]),
                          fleet=ft, users=int(users[i]))
            assert float(s) == float(np.broadcast_to(wt, lags.shape)[i])
        cj, ct = rj.init_carry(n, None, fj), rt.init_carry(n, None, ft)
        assert (cj is None) == (ct is None)
        if ct is not None:
            np.testing.assert_array_equal(ct["scale"], cj["scale"])
    np.testing.assert_array_equal(t_agg.hetero_scales(ft),
                                  j_agg.hetero_scales(fj))


def test_tensor_twin_matches_host_weight():
    """``scan_weight`` (torch f32) against ``weight`` (numpy f64) and the
    JAX package's traced twin (jnp f32) on the same pushes."""
    from types import SimpleNamespace
    ft = t_fleet.resolve_fleet("paper").build(np.random.default_rng(1), 25)
    fj = j_fleet.resolve_fleet("paper").build(np.random.default_rng(1), 25)
    rng = np.random.default_rng(9)
    lags = rng.integers(0, 30, 25)
    vns = rng.uniform(0.0, 2.0, 25).astype(np.float32)
    gaps = np.asarray(gradient_gap(vns.astype(np.float64), lags, ETA, BETA),
                      np.float32)
    users = np.arange(25)[::-1].copy()
    for rj, rt in _rule_pairs():
        host = np.broadcast_to(rt.weight(lags, gaps.astype(np.float64), vns,
                                         fleet=ft, users=users), lags.shape)
        pv = SimpleNamespace(lag=torch.from_numpy(lags),
                             gap=torch.from_numpy(gaps),
                             v_norm=torch.from_numpy(vns),
                             users=torch.from_numpy(users),
                             consts=rt.scan_operands(),
                             float_dtype=torch.float32)
        carry = rt.init_carry(25, None, ft)
        carry2, w = rt.scan_weight(carry, pv)
        assert carry2 is carry and w.dtype == torch.float32
        np.testing.assert_allclose(np.broadcast_to(w.numpy(), lags.shape),
                                   host, rtol=1e-6)
        jc = rj.init_carry(25, None, fj)
        jpv = SimpleNamespace(jnp=jnp, lag=jnp.asarray(lags),
                              gap=jnp.asarray(gaps), v_norm=jnp.asarray(vns),
                              users=jnp.asarray(users),
                              consts=tuple(jnp.asarray(c, jnp.float32) for c
                                           in rj.scan_operands(None)),
                              float_dtype=jnp.float32)
        _, wj = rj.scan_weight(None if jc is None else jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float32), jc), jpv)
        np.testing.assert_allclose(np.broadcast_to(w.numpy(), lags.shape),
                                   np.broadcast_to(np.asarray(wj),
                                                   lags.shape), rtol=1e-6)


def test_configure_and_validate_like_jax():
    for kw in (dict(), dict(fedasync_alpha=0.3), dict(fedasync_a=2.0),
               dict(gap_ref=0.5)):
        for name in RULES:
            rj = j_agg.configure_aggregation(name, **kw)
            rt = t_agg.configure_aggregation(name, **kw)
            assert type(rt).__name__ == type(rj).__name__
            assert vars(rt) == vars(rj)
    inst = t_agg.GapAwareRule(0.25)
    assert t_agg.configure_aggregation(inst, gap_ref=9.0) is inst
    for bad in (lambda m: m.FedAsyncPolyRule(alpha=1.5),
                lambda m: m.FedAsyncPolyRule(a=-1.0),
                lambda m: m.GapAwareRule(0.0),
                lambda m: m.HeteroAwareRule(-0.5)):
        with pytest.raises(ValueError):
            bad(j_agg)
        with pytest.raises(ValueError):
            bad(t_agg)
    with pytest.raises(ValueError, match="FleetSpec"):
        t_agg.resolve_aggregation("hetero_aware").weight(1, 0.0, 0.0)
    with pytest.raises(ValueError, match="FleetSpec"):
        t_agg.resolve_aggregation("hetero_aware").init_carry(4)
    server = AsyncParameterServer(torch.zeros(3), eta=ETA, beta=BETA,
                                  aggregation="fedasync_poly",
                                  fedasync_alpha=0.8, device="cpu")
    assert (server.rule.alpha, server.rule.a) == (0.8, 0.5)


@pytest.mark.parametrize("rule", NEW_RULES)
def test_server_push_stream_matches_jax(rule):
    """``AsyncParameterServer.push`` under each rule: the host weight from
    the server's momentum norm, one K1 push (the plain version here)."""
    fj = j_fleet.resolve_fleet("paper").build(np.random.default_rng(0), 4)
    ft = t_fleet.resolve_fleet("paper").build(np.random.default_rng(0), 4)
    params = jax.tree.map(np.asarray, jax_init_lenet(jax.random.PRNGKey(0)))
    ref = JaxServer(jax.tree.map(jnp.asarray, params), eta=ETA, beta=BETA,
                    aggregation=rule, fleet=fj)
    port = AsyncParameterServer(params_from_jax(params), eta=ETA, beta=BETA,
                                aggregation=rule, fleet=ft, device="cpu")
    rng = np.random.default_rng(5)
    for c in range(4):
        port.pull(c), ref.pull(c)
    weights = []
    for c in (0, 2, 1, 3, 0, 2):
        noise = jax.tree.map(lambda a: (0.02 * rng.standard_normal(a.shape))
                             .astype(np.float32), params)
        new_ref = jax.tree.map(lambda p, d: p + d, ref.params, noise)
        a = port.push(c, params_from_jax(jax.tree.map(np.asarray, new_ref)))
        b = ref.push(c, new_ref)
        assert (a.lag, a.version) == (b.lag, b.version)
        assert a.applied_weight == pytest.approx(b.applied_weight, rel=1e-6)
        assert a.gap_estimate == pytest.approx(b.gap_estimate, rel=1e-6)
        weights.append(a.applied_weight)
        ref_p = np.concatenate([np.asarray(l).reshape(-1)
                                for l in jax.tree.leaves(ref.params)])
        np.testing.assert_allclose(port.params.numpy(), ref_p, rtol=1e-6,
                                   atol=1e-6)
        assert port.v_norm == pytest.approx(ref.v_norm, rel=1e-5)
        port.pull(c), ref.pull(c)
    assert min(weights) < 1.0


def _lenet_tree_like(flat_np, template):
    out, off = {}, 0
    for layer in sorted(template):
        out[layer] = {}
        for kind in sorted(template[layer]):
            shape = template[layer][kind].shape
            size = int(np.prod(shape))
            out[layer][kind] = jnp.asarray(flat_np[off:off + size]
                                           .reshape(shape))
            off += size
    return out


def test_gap_aware_pushes_match_jax_pallas_finish():
    """The push side of the gap_aware finish: ``gap_aware_pushes`` (one
    one-push K1 launch a push, plain version on the CPU) against the
    reference's Pallas finish scan, its training masked off so the lanes
    are the given models."""
    rng = np.random.default_rng(21)
    template = jax.tree.map(np.asarray, jax_init_lenet(jax.random.PRNGKey(2)))
    p0 = params_from_jax(template).numpy()
    n, C = p0.size, 5
    v0 = (0.3 * rng.standard_normal(n)).astype(np.float32)
    lanes = (p0[None] + 0.05 * rng.standard_normal((C, n))).astype(np.float32)
    lags = np.array([0, 1, 3, 2, 6], np.int64)
    uids = np.array([3, 0, 4, 1, 2], np.int64)
    rule_j, rule_t = j_agg.GapAwareRule(0.05), t_agg.GapAwareRule(0.05)
    finish = _build_finish_chunk_pallas(
        rule_j, ETA, BETA, False, True, JaxLeNetBackend.model_loss, False,
        ETA)
    pj, vj, vn_j, w_j, final_j = finish(
        tuple(_lenet_tree_like(l, template) for l in lanes),
        jnp.zeros((C, 1, 2), jnp.int32), jnp.zeros((C, 1), bool),
        jnp.ones(C, bool), jnp.asarray(lags), jnp.asarray(uids), None,
        tuple(jnp.asarray(x) for x in rule_j.scan_operands(None)),
        _lenet_tree_like(p0, template), _lenet_tree_like(v0, template),
        jnp.zeros((4, 32, 32, 3), jnp.float32), jnp.zeros(4, jnp.int32))
    v0_t = torch.from_numpy(v0)
    pt, vt, pre, w_t, final_t = gap_aware_pushes(
        torch.from_numpy(p0), v0_t, torch.from_numpy(lanes), lags,
        torch.sqrt(torch.sum(v0_t * v0_t)).reshape(1), rule_t, None, uids,
        ETA, BETA, 1.0 / ETA, "reference")
    assert pre.shape == w_t.shape == (C,) and final_t.shape == (1,)
    p_ref = params_from_jax(jax.tree.map(np.asarray, pj)).numpy()
    v_ref = params_from_jax(jax.tree.map(np.asarray, vj)).numpy()
    np.testing.assert_allclose(pt.numpy(), p_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        vt.numpy(), v_ref, rtol=1e-6,
        atol=1e-6 * (float(np.max(np.abs(v_ref))) + 1.0))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6)
    assert float(np.min(np.asarray(w_j))) < 0.9
    np.testing.assert_allclose(
        gradient_gap(pre.numpy().astype(np.float64), lags, ETA, BETA),
        gradient_gap(np.asarray(vn_j, np.float64), lags, ETA, BETA),
        rtol=1e-6)
    assert float(final_t[0]) == pytest.approx(float(final_j), rel=1e-6)


@pytest.mark.parametrize("n_finish", (3, 20))
@pytest.mark.parametrize("rule", ("fedasync_poly", "hetero_aware"))
def test_cohort_weights_match_per_push_chain(rule, n_finish):
    """Lag- and user-only weights go through one K1 call a chunk as its
    weight tensor: bit for bit what a chain of one-push
    ``fused_apply_flat_ref`` calls at the same f32 weights gives."""
    kw = dict(n_train=2000, n_test=64, seed=0, aggregation=rule,
              device="cpu")
    a, b = LeNetBackend(20, **kw), LeNetBackend(20, **kw)
    fleet = t_fleet.resolve_fleet("paper").build(np.random.default_rng(0), 20)
    for be in (a, b):
        be.bind_fleet(fleet)
    uids = np.arange(n_finish)[::-1].copy()
    lags = np.arange(n_finish) % 5
    for be in (a, b):
        be.pull_batch(uids, 0)
    gaps, weights = a.finish_async_batch(uids, np.zeros(n_finish, np.int64),
                                         lags, ETA, BETA)
    host = np.asarray(b.server.rule.weight(lags, None, None, fleet=fleet,
                                           users=uids), np.float32)
    p, v, vn = b.server.params, b.server._v, []
    j = 0
    for params, idx, mask in b._cohort_chunks(uids):
        trained = _masked_epoch(params, idx, mask, b._flat_x, b._flat_y,
                                b.eta, b.beta, b.model_loss)
        sq = torch.sum(v * v)
        for row in range(trained.shape[0]):
            vn.append(float(torch.sqrt(sq)))
            p, v, sq = fused_apply_flat_ref(p, v, trained[row],
                                            float(host[j]), 1.0 / b.eta,
                                            b.beta)
            j += 1
    assert torch.equal(a.server.params, p) and torch.equal(a.server._v, v)
    np.testing.assert_array_equal(weights, host.astype(np.float64))
    assert weights.min() < 1.0
    np.testing.assert_allclose(
        gaps, gradient_gap(np.array(vn), lags, ETA, BETA), rtol=1e-6)
    assert a.v_norm() == pytest.approx(float(torch.sqrt(sq)), rel=1e-6)


@pytest.mark.parametrize("rule", NEW_RULES)
def test_real_mode_matches_jax_backend(rule):
    a = JaxScenario(policy="online", ml="lenet", ml_kwargs=ML_KW,
                    aggregation=rule, **SIM_KW).run()
    sim = Scenario(policy="online", ml="lenet", aggregation=rule,
                   ml_kwargs=dict(ML_KW, device="cpu"), **SIM_KW).build()
    backend = sim.ml_backend
    # the JAX initial parameters, and the JAX clients' permutations
    source = JaxLeNetBackend(SIM_KW["n_users"], seed=SIM_KW["seed"],
                             **ML_KW)
    backend.server.params = params_from_jax(
        jax.tree.map(np.asarray, source.server.params))
    backend._next_perm = source._next_perm
    b = sim.run()
    assert a.mean_H == b.mean_H == 0.0
    assert b.updates == a.updates > 0
    assert _digest(_schedule(b.push_log)) == _digest(_schedule(a.push_log))
    assert b.energy_j == pytest.approx(a.energy_j, rel=1e-9)
    np.testing.assert_allclose([e["gap"] for e in b.push_log],
                               [e["gap"] for e in a.push_log],
                               rtol=2e-5, atol=1e-6)
    wb = [e["weight"] for e in b.push_log]
    np.testing.assert_allclose(wb, [e["weight"] for e in a.push_log],
                               rtol=2e-5)
    assert min(wb) < 1.0
    assert [t for t, _ in b.accuracy] == [t for t, _ in a.accuracy]
    np.testing.assert_allclose([x for _, x in b.accuracy],
                               [x for _, x in a.accuracy], atol=0.03)
