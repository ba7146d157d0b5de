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
import os
import shutil

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


# the options' parity runs: 60 slots, 2 islands, a low V and frequent
# short windows so that ~30 pushes land (the default 0.05 arrival rate
# gives one in 60 slots)
OPT_KW = dict(RUN_KW, slots=60, eval_every=20, app_arrival_p=0.3,
              train_slots=3, V=1.0)


def _same_run(a, b, rtol=1e-4):
    """The decisions equal, the losses at rtol 1e-4 (the trainers' f32
    forward passes differ by a few ulps a step)."""
    assert b["updates"] == a["updates"] > 0
    assert b["energy_j"] == pytest.approx(a["energy_j"], rel=1e-9)
    assert [h[0] for h in b["history"]] == [h[0] for h in a["history"]]
    np.testing.assert_allclose([h[1] for h in b["history"]],
                               [h[1] for h in a["history"]], rtol=rtol)
    assert b["final_loss"] == pytest.approx(a["final_loss"], rel=rtol)
    assert b["final_slot"] == a["final_slot"]


def _params_close(ours, theirs, rtol=1e-4, atol=1e-5):
    """Parameters after ~30 pushes: each island's epoch carries the f32
    ulps of its forward and backward passes."""
    a, b = tree_leaves(ours), jax.tree.leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _close(x, y, rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_shards", (1, 4))
def test_trainer_sharded_matches_jax(monkeypatch, n_shards):
    """``n_shards > 0``: the sharded serving-tier server, against the JAX
    trainer on its own sharded server."""
    kw = dict(OPT_KW, n_shards=n_shards)
    a = jax_run(CFG, JaxIslandConfig(**kw), log=lambda *x: None)
    b = _port_run(monkeypatch, _jax_params(), **kw)
    _same_run(a, b)
    _params_close(b["params"], a["params"])


def test_trainer_sharded_equals_unsharded(monkeypatch):
    """The port's sharded server applies the same elementwise K1 shard by
    shard, so the trainer's model equals the unsharded run's bit for
    bit; the norms (and so the Eq. 4 gaps) differ only in the order of
    their sums, which moves no decision here."""
    jp = _jax_params()
    a = _port_run(monkeypatch, jp, **OPT_KW)
    b = _port_run(monkeypatch, jp, **dict(OPT_KW, n_shards=4))
    assert b["updates"] == a["updates"] > 0
    for x, y in zip(tree_leaves(b["params"]), tree_leaves(a["params"])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("ratio", (0.01, 0.2))
def test_trainer_compressed_matches_jax(monkeypatch, ratio):
    """``compress_ratio > 0``: each push is the island's delta through
    top-k with error feedback. The deltas' magnitudes are distinct, but
    the two trainers' deltas differ by f32 ulps, so an entry next to the
    k-th magnitude can be kept by one and carried by the other: the
    losses are held at rtol 1e-4 at both ratios, the parameters at 1%
    (where no swap shows in this run) at the bound of the other options;
    at 20% a swap moves a handful of entries by up to the k-th magnitude
    (10 of 8,192 in one leaf, by up to 3e-4)."""
    kw = dict(OPT_KW, compress_ratio=ratio)
    a = jax_run(CFG, JaxIslandConfig(**kw), log=lambda *x: None)
    b = _port_run(monkeypatch, _jax_params(), **kw)
    _same_run(a, b)
    if ratio == 0.01:
        _params_close(b["params"], a["params"])
    plain = _port_run(monkeypatch, _jax_params(), **OPT_KW)
    assert b["final_loss"] != plain["final_loss"]


def _steps(path):
    return sorted(d for d in os.listdir(path) if d.startswith("step_"))


def test_trainer_checkpoints_and_resume_match_jax(monkeypatch, tmp_path):
    """``ckpt_dir``: both trainers save at the same slots (every
    ``ckpt_every`` and at the end, keep 3) in one layout; each package's
    checkpoint restores in the other to the saved parameters; and a run
    resumed from either package's last checkpoint continues like the JAX
    trainer resumed from the same files."""
    from repro.checkpoint.checkpointer import restore_pytree as jax_restore
    from repro_torch.checkpoint.checkpointer import restore_pytree

    jp = _jax_params()
    kw = dict(OPT_KW, ckpt_every=15)
    dirs = {k: str(tmp_path / k) for k in ("jax", "port")}
    a = jax_run(CFG, JaxIslandConfig(**kw, ckpt_dir=dirs["jax"]),
                log=lambda *x: None)
    b = _port_run(monkeypatch, jp, **kw, ckpt_dir=dirs["port"])
    _same_run(a, b)
    assert _steps(dirs["port"]) == _steps(dirs["jax"]) == [
        "step_00000030", "step_00000045", "step_00000060"]
    template = {"params": params_from_jax(jp, "cpu"),
                "slot": torch.tensor(0, dtype=torch.int32)}
    jax_template = {"params": jax.tree.map(jnp.asarray, jp),
                    "slot": jnp.int32(0)}
    for step in (30, 45, 60):
        ours, s1 = restore_pytree(template, dirs["port"], step)
        theirs, s2 = jax_restore(jax_template, dirs["jax"], step)
        assert s1 == s2 == step and int(ours["slot"]) == step
        _params_close(ours["params"], theirs["params"])
        # across packages: each reads the other's files exactly
        cross, _ = restore_pytree(template, dirs["jax"], step)
        _params_close(cross["params"], theirs["params"], rtol=0, atol=0)
        cross_j, _ = jax_restore(jax_template, dirs["port"], step)
        _params_close(ours["params"], cross_j["params"], rtol=0, atol=0)
    _params_close(b["params"], a["params"])
    for name in ("jax", "port"):
        # resume from a copy of each package's files, in both trainers
        res = dict(OPT_KW, slots=20, resume=True)
        for k in ("jax2", "port2"):
            shutil.copytree(dirs[name], str(tmp_path / k), dirs_exist_ok=True)
        ra = jax_run(CFG, JaxIslandConfig(**res, ckpt_dir=str(
            tmp_path / "jax2")), log=lambda *x: None)
        rb = _port_run(monkeypatch, jp, **res,
                       ckpt_dir=str(tmp_path / "port2"))
        assert rb["final_slot"] == ra["final_slot"] == 80
        _same_run(ra, rb)
        for k in ("jax2", "port2"):
            shutil.rmtree(tmp_path / k)


def test_resume_without_a_checkpoint_starts_fresh(monkeypatch, tmp_path):
    jp = _jax_params()
    a = _port_run(monkeypatch, jp, **dict(OPT_KW, slots=30))
    b = _port_run(monkeypatch, jp, **dict(OPT_KW, slots=30, resume=True,
                                          ckpt_dir=str(tmp_path / "c")))
    assert b["final_slot"] == 30 and b["updates"] == a["updates"]
    assert _steps(tmp_path / "c") == ["step_00000030"]


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


def test_cli_options_run_on_cpu(capsys, tmp_path):
    ckpt = tmp_path / "ckpt"
    train.main(["--device", "cpu", "--islands", "2", "--slots", "40",
                "--steps-per-epoch", "1", "--shards", "3", "--compress",
                "0.05", "--ckpt-dir", str(ckpt)])
    out = capsys.readouterr().out
    assert "final_loss=" in out
    assert _steps(ckpt) == ["step_00000040"]
