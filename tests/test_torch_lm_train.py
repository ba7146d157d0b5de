"""The port's LM training path — ``launch/steps.py`` and the async
federated trainer ``launch/train.py`` — against the JAX package on the
CPU, on the float32 variant of Qwen3-0.6B's smoke config, with the JAX
initial parameters carried across.

One train step: theta', v' and the Eq. 4 gap at rtol 1e-5 (atol 1e-6
beside it for entries near 0). A whole trainer run: the same numpy draws in
the same order, so ``updates`` and ``failures`` must be equal, energy at
rtol 1e-9, the evaluation slots equal and their losses at rtol 1e-4. The
JAX initial parameters enter the port through a monkeypatch of the
``build_model`` that ``launch/train.py`` calls, whose ``init`` then
returns them."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.server import AsyncParameterServer as JaxServer  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa: E402
from repro.launch.train import IslandConfig as JaxIslandConfig  # noqa: E402
from repro.launch.train import run as jax_run  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
import repro_torch.launch.train as train  # noqa: E402
from repro_torch.core.server import AsyncParameterServer  # noqa: E402
from repro_torch.kernels.fused_update.ops import tree_leaves  # noqa: E402
from repro_torch.launch.steps import make_train_step, make_update_step  # noqa: E402
from repro_torch.models.zoo import params_from_jax  # noqa: E402

CFG = dataclasses.replace(get_smoke_config("qwen3-0.6b"), dtype="float32")
RUN_KW = dict(n_islands=2, slots=120, local_steps=2, batch=4, seq=32,
              eval_every=60, app_arrival_p=0.05)


def _jax_params(seed=0):
    return jax.tree.map(np.asarray, jax_build(CFG).init(
        jax.random.PRNGKey(seed)))


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("microbatches", (1, 2))
def test_train_step_matches_jax(microbatches):
    rng = np.random.default_rng(microbatches)
    jp = _jax_params()
    v = jax.tree.map(lambda p: 0.01 * rng.standard_normal(p.shape)
                     .astype(np.float32), jp)
    lead = (microbatches,) if microbatches > 1 else ()
    batch = {k: rng.integers(0, CFG.vocab_size, lead + (4, 32))
             .astype(np.int32) for k in ("tokens", "labels")}
    lag = 3
    pj, vj, mj = jax.jit(jax_train_step(CFG, eta=0.05, beta=0.9,
                                        microbatches=microbatches))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, v),
        {k: jnp.asarray(x) for k, x in batch.items()}, jnp.int32(lag))
    step = make_train_step(CFG, eta=0.05, beta=0.9, microbatches=microbatches)
    pt, vt, mt = step(params_from_jax(jp, "cpu"), params_from_jax(v, "cpu"),
                      {k: torch.from_numpy(x) for k, x in batch.items()},
                      lag)
    for ours, theirs in ((pt, pj), (vt, vj)):
        ours, theirs = tree_leaves(ours), jax.tree.leaves(theirs)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert tuple(a.shape) == b.shape
            _close(a, b)
    assert mt["gap"].shape == () and mt["loss"].shape == ()
    assert float(mt["gap"]) == pytest.approx(float(mj["gap"]), rel=1e-5)
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-5)


def test_update_step_is_the_k2_epilogue():
    rng = np.random.default_rng(4)
    p, v, g = ({"w": torch.from_numpy(rng.standard_normal((9, 5))
                                      .astype(np.float32))}
               for _ in range(3))
    p2, v2, gap = make_update_step(CFG, eta=0.1, beta=0.0)(p, v, g, 1)
    _close(v2["w"], g["w"])
    _close(p2["w"], p["w"] - 0.1 * g["w"])
    assert float(gap) == pytest.approx(
        0.1 * float(torch.linalg.vector_norm(g["w"])), rel=1e-6)


def test_lag_estimates_match_jax():
    """Alg. 2 line 4's server-side lag estimate through a pull/push
    sequence, and the tracker's ``estimate_lag_during``."""
    ours = AsyncParameterServer(torch.zeros(4), eta=0.05, beta=0.9,
                                device="cpu")
    theirs = JaxServer(jnp.zeros(4), eta=0.05, beta=0.9)
    events = [("pull", 0), ("pull", 1), ("pull", 2), ("push", 1),
              ("pull", 3), ("push", 0), ("push", 2), ("pull", 1)]
    for op, uid in events:
        for server, params in ((ours, torch.ones(4)), (theirs, jnp.ones(4))):
            server.pull(uid) if op == "pull" else server.push(uid, params)
        for uid2 in range(5):
            assert ours.lag_estimate(uid2) == theirs.lag_estimate(uid2)
        n = len(ours.in_flight)
        assert ours.lag_tracker.estimate_lag_during(n) == \
            theirs.lag_tracker.estimate_lag_during(n) == n


def _port_run(monkeypatch, jp, **kw):
    real = train.build_model

    def with_jax_init(cfg):
        return real(cfg)._replace(
            init=lambda generator, device: params_from_jax(jp, device))

    monkeypatch.setattr(train, "build_model", with_jax_init)
    return train.run(CFG, train.IslandConfig(**kw), device="cpu",
                     log=lambda *a: None)


@pytest.mark.parametrize("fail_p", (0.0, 0.02))
def test_trainer_matches_jax(monkeypatch, fail_p):
    kw = dict(RUN_KW, fail_p=fail_p)
    a = jax_run(CFG, JaxIslandConfig(**kw), log=lambda *x: None)
    b = _port_run(monkeypatch, _jax_params(), **kw)
    assert b["updates"] == a["updates"] > 0
    assert b["failures"] == a["failures"]
    assert (fail_p > 0) == (a["failures"] > 0)
    assert b["energy_j"] == pytest.approx(a["energy_j"], rel=1e-9)
    assert [h[0] for h in b["history"]] == [h[0] for h in a["history"]]
    np.testing.assert_allclose([h[1] for h in b["history"]],
                               [h[1] for h in a["history"]], rtol=1e-4)
    np.testing.assert_allclose([h[2] for h in b["history"]],
                               [h[2] for h in a["history"]], rtol=1e-9)
    assert b["final_loss"] == pytest.approx(a["final_loss"], rel=1e-4)
    assert b["stragglers"] == a["stragglers"]
    assert b["final_slot"] == a["final_slot"]


@pytest.mark.parametrize("aggregation", ("fedasync_poly", "gap_aware"))
def test_trainer_rules_match_jax(monkeypatch, aggregation):
    """The aggregation rules beyond ``replace``: each push's host weight
    (from the server's momentum norm) mixes the model in both trainers."""
    kw = dict(RUN_KW, slots=60, eval_every=30, aggregation=aggregation)
    a = jax_run(CFG, JaxIslandConfig(**kw), log=lambda *x: None)
    b = _port_run(monkeypatch, _jax_params(), **kw)
    assert b["updates"] == a["updates"] > 0
    assert b["energy_j"] == pytest.approx(a["energy_j"], rel=1e-9)
    assert [h[0] for h in b["history"]] == [h[0] for h in a["history"]]
    np.testing.assert_allclose([h[1] for h in b["history"]],
                               [h[1] for h in a["history"]], rtol=1e-4)
    assert b["final_loss"] == pytest.approx(a["final_loss"], rel=1e-4)


def test_trainer_hetero_aware_needs_a_fleet_like_jax():
    kw = dict(RUN_KW, slots=60, aggregation="hetero_aware")
    with pytest.raises(ValueError, match="FleetSpec"):
        jax_run(CFG, JaxIslandConfig(**kw), log=lambda *x: None)
    with pytest.raises(ValueError, match="FleetSpec"):
        train.run(CFG, train.IslandConfig(**kw), device="cpu",
                  log=lambda *x: None)


@pytest.mark.parametrize("option", (
    dict(ckpt_dir="ckpt"), dict(resume=True), dict(compress_ratio=0.1),
    dict(n_shards=2)))
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        train.run(CFG, train.IslandConfig(**RUN_KW, **option), device="cpu",
                  log=lambda *a: None)


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        train.run(CFG, train.IslandConfig(**RUN_KW), log=lambda *a: None)


def test_cli_runs_smoke_on_cpu(capsys):
    train.main(["--device", "cpu", "--islands", "2", "--slots", "40",
                "--steps-per-epoch", "1"])
    out = capsys.readouterr().out
    assert "final_loss=" in out and "updates=" in out
