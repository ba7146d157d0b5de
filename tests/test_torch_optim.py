"""The port's optimizers and staleness helpers (``repro_torch/optim``)
against the JAX package's on the CPU, inputs drawn from numpy seeds.

Each is a few elementwise f32 operations (AdamW adds a power, a square
root and divisions), so every output is held at rtol 1e-6 / atol 1e-7:
a few f32 ulps where the two libraries' pow or division round apart."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.optim as jo  # noqa: E402
import repro_torch.optim as to  # noqa: E402
from repro_torch.kernels.fused_update.ops import tree_leaves  # noqa: E402

SHAPES = {"w": (12, 7), "b": (7,), "s": ()}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(ours, theirs, rtol=1e-6, atol=1e-7):
    a, b = tree_leaves(ours), jax.tree.leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(x.shape) == y.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=rtol,
                                   atol=atol)


def test_exports_match_jax():
    assert set(to.__all__) == set(jo.__all__)
    for name in to.__all__:
        assert callable(getattr(to, name)) or name == "OptState"


@pytest.mark.parametrize("opt", ("sgd", "adamw"))
def test_optimizer_steps_match_jax(opt):
    rng = np.random.default_rng(0 if opt == "sgd" else 1)
    params = _tree(rng)
    if opt == "sgd":
        (ti, tu), (ji, ju) = to.momentum_sgd(0.05, 0.9), \
            jo.momentum_sgd(0.05, 0.9)
    else:
        (ti, tu), (ji, ju) = to.adamw(1e-2, weight_decay=0.1), \
            jo.adamw(1e-2, weight_decay=0.1)
    tp, jp = _t(params), _j(params)
    ts, js = ti(tp), ji(jp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for _ in range(5):
        g = _tree(rng, 0.5)
        tup, ts = tu(_t(g), ts, tp)
        jup, js = ju(_j(g), js, jp)
        _close(tup, jup)
        _close(ts.mu, js.mu)
        if opt == "adamw":
            _close(ts.nu, js.nu)
        else:
            assert ts.nu is None and js.nu is None
        tp, jp = to.apply_updates(tp, tup), jo.apply_updates(jp, jup)
        _close(tp, jp)
    assert int(ts.step) == int(js.step) == 5


def test_apply_updates_keeps_dtype_like_jax():
    p = np.linspace(-1, 1, 9, dtype=np.float32)
    u = np.full(9, 0.01, np.float32)
    ours = to.apply_updates({"p": torch.from_numpy(p).bfloat16()},
                            {"p": torch.from_numpy(u)})
    theirs = jo.apply_updates({"p": jnp.asarray(p, jnp.bfloat16)},
                              {"p": jnp.asarray(u)})
    assert ours["p"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ours["p"].float().numpy(),
                                  np.asarray(theirs["p"], np.float32))


@pytest.mark.parametrize("max_norm", (0.5, 1e3))
def test_global_norm_and_clip_match_jax(max_norm):
    g = _tree(np.random.default_rng(2))
    n_t, n_j = to.global_norm(_t(g)), jo.global_norm(_j(g))
    assert float(n_t) == pytest.approx(float(n_j), rel=1e-6)
    (ct, nt), (cj, nj) = to.clip_by_global_norm(_t(g), max_norm), \
        jo.clip_by_global_norm(_j(g), max_norm)
    assert float(nt) == pytest.approx(float(nj), rel=1e-6)
    _close(ct, cj)
    clipped = float(to.global_norm(ct))
    assert clipped == pytest.approx(min(max_norm, float(nt)), rel=1e-5)


@pytest.mark.parametrize("gap,gap_ref", [
    (0.0, 1.0), (2.0, 1.0), (0.3, 0.0), (5.0, 1e-12), (1e3, 7.5)])
def test_gap_aware_scale_matches_jax(gap, gap_ref):
    ours = to.gap_aware_scale(gap, gap_ref)
    theirs = jo.gap_aware_scale(gap, gap_ref)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    gaps = np.array([0.0, 0.5, 3.0, 40.0], np.float32)
    np.testing.assert_allclose(
        to.gap_aware_scale(torch.from_numpy(gaps), gap_ref).numpy(),
        np.asarray(jo.gap_aware_scale(jnp.asarray(gaps), gap_ref)),
        rtol=1e-6)


@pytest.mark.parametrize("lambda_dc", (0.5, 0.0, 2.0))
def test_delay_compensate_matches_jax(lambda_dc):
    rng = np.random.default_rng(3)
    g, now, then = _tree(rng), _tree(rng), _tree(rng)
    ours = to.delay_compensate(_t(g), _t(now), _t(then), lambda_dc)
    theirs = jo.delay_compensate(_j(g), _j(now), _j(then), lambda_dc)
    _close(ours, theirs)
    if lambda_dc == 0.0:
        _close(ours, _j(g), rtol=0, atol=0)
