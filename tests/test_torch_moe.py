"""The port's Mixture-of-Experts family (``models/moe.py``, the ``moe``
branch of the transformer block, ``build_model`` for granite-moe-1b-a400m
and qwen3-moe-30b-a3b) against the JAX package, live, with the JAX
parameters carried across by ``params_from_jax`` and the inputs drawn
with numpy.

Bounds, in float32: ``router_topk``, ``moe_dense``, ``moe_sorted`` and
``moe`` at rtol 1e-5 (atol 1e-6 x max(1, max|ref|) beside it for entries
near 0), the expert indices and the dropped (token, expert) slots equal;
``router_topk`` only where the router's probabilities are distinct
(``torch.topk`` and ``lax.top_k`` order ties differently). The smoke
models' loss and aux loss at rel 1e-5, every gradient leaf at rtol 1e-4 /
atol 1e-6 (tests/test_torch_lm.py's bounds), prefill and three decode
steps' logits at rtol 1e-5 / atol 1e-6 x max(1, max|ref|), the greedy
tokens equal."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.fused_update.ops import tree_leaves  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.models.zoo import params_from_jax  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b")


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def _jax_params(cfg, seed=0):
    """A parameter tree of the JAX model's structure and shapes
    (``jax.eval_shape`` of its ``init``: nothing is compiled), drawn with
    numpy: fan-in scaled normals, vectors at 0.1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(seed))
    return jax.tree.map(lambda l: (rng.standard_normal(l.shape) * (
        l.shape[-2] ** -0.5 if len(l.shape) >= 2 else 0.1)).astype(
        np.float32), shapes)


def _jit(fn):
    """A JAX function of (x, params, cfg), jitted with cfg static."""
    return jax.jit(fn, static_argnums=2)


def _layer0(arch):
    """Layer 0's MoE parameters of ``arch``'s smoke model, as numpy (JAX)
    and tensors (port)."""
    p = {k: v[0] for k, v in
         _jax_params(jax_smoke(arch))["layers"]["moe"].items()}
    return p, params_from_jax(p, "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(a, b, rtol=1e-5, atol=1e-6):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b, dtype=np.float64)
    atol = atol * max(1.0, float(np.abs(b).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64), b,
                               rtol=rtol, atol=atol)


def _dropped(idx, k, E, C):
    """The (flat slot) set a capacity-C sorted dispatch drops, from a
    row's expert indices (T, k), by the stable sort JAX's argsort uses."""
    flat = np.asarray(idx).reshape(-1)
    order = np.argsort(flat, kind="stable")
    pos = np.empty_like(order)
    pos[order] = np.arange(len(order))
    sizes = np.bincount(flat, minlength=E)
    offsets = np.cumsum(sizes) - sizes
    return set(np.nonzero(pos - offsets[flat] >= C)[0].tolist())


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for get, jget in ((get_smoke_config, jax_smoke),
                      (get_config, jax_config)):
        ours, theirs = get(arch), jget(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
    full = get_config(arch)
    assert full.family == "moe" and full.moe_impl == "sorted"


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_order_matches_jax_tree_leaves(arch):
    cfg = get_smoke_config(arch)
    jp = _jax_params(cfg)
    assert sorted(jp["layers"]["moe"]) == ["router", "w_down", "w_gate",
                                           "w_up"]
    ours = tree_leaves(params_from_jax(jp, "cpu"))
    theirs = jax.tree.leaves(jp)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    own = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert [tuple(l.shape) for l in tree_leaves(own)] == \
        [l.shape for l in theirs]
    assert [l.dtype for l in theirs] == [np.float32] * len(theirs)
    assert sum(l.numel() for l in tree_leaves(own)) == cfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_router_topk_matches_jax(arch):
    cfg = _f32(get_smoke_config(arch))
    jp, tp = _layer0(arch)
    x = _x((40, cfg.d_model), 1)
    jw, ji, ja = _jit(jax_moe.router_topk)(jnp.asarray(x), jp["router"],
                                           cfg)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jp["router"]))
    assert all(len(set(r.tolist())) == len(r) for r in probs)  # no ties
    tw, ti, ta = moe.router_topk(torch.from_numpy(x), tp["router"], cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw)
    _close(ta, ja)
    assert tuple(ta.shape) == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_jax(arch):
    cfg = _f32(get_smoke_config(arch), moe_impl="dense")
    jp, tp = _layer0(arch)
    x = _x((24, cfg.d_model), 2)
    jo, ja = _jit(jax_moe.moe_dense)(jnp.asarray(x), jp, cfg)
    to, ta = moe.moe_dense(torch.from_numpy(x), tp, cfg)
    _close(to, jo)
    _close(ta, ja)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_sorted_drops_the_slots_jax_drops(arch):
    """At a capacity factor of 0.5 (C = int(T k / E * 0.5)) some experts
    overflow: the same (token, expert) slots are dropped, the outputs and
    the aux loss agree, and ``moe.DROPPED`` counts the drops."""
    cfg = _f32(get_smoke_config(arch), moe_capacity_factor=0.5)
    jp, tp = _layer0(arch)
    T, k, E = 48, cfg.num_experts_per_tok, cfg.num_experts
    C = max(int(T * k / E * cfg.moe_capacity_factor), 1)
    x = _x((T, cfg.d_model), 3)
    _, ji, _ = _jit(jax_moe.router_topk)(jnp.asarray(x), jp["router"], cfg)
    _, ti, _ = moe.router_topk(torch.from_numpy(x), tp["router"], cfg)
    want = _dropped(ji, k, E, C)
    assert want and _dropped(ti.numpy(), k, E, C) == want
    jo, ja = _jit(jax_moe.moe_sorted)(jnp.asarray(x), jp, cfg)
    moe.DROPPED = []
    try:
        to, ta = moe.moe_sorted(torch.from_numpy(x), tp, cfg)
        assert sum(int(d) for d in moe.DROPPED) == len(want)
    finally:
        moe.DROPPED = None
    _close(to, jo)
    _close(ta, ja)
    # a token all of whose slots were dropped comes out as zeros
    gone = [t for t in range(T) if {t * k + j for j in range(k)} <= want]
    for t in gone:
        assert not to[t].any()


@pytest.mark.parametrize("S,chunk", ((64, 4096), (64, 16), (40, 16),
                                     (1, 4096)))
def test_moe_matches_jax(S, chunk):
    """``moe`` on (B, S, D): the per-row sorted dispatch (S >= 4 E), over
    ``moe_dispatch_chunk`` chunks when S is a larger multiple of it (64
    over 16; 40 is not a multiple and runs whole), and the dense fallback
    below 4 E (S 1: every decode step)."""
    cfg = _f32(get_smoke_config("granite-moe-1b-a400m"),
               moe_dispatch_chunk=chunk)
    jp, tp = _layer0("granite-moe-1b-a400m")
    x = _x((3, S, cfg.d_model), S + chunk)
    jo, ja = _jit(jax_moe.moe)(jnp.asarray(x), jp, cfg)
    to, ta = moe.moe(torch.from_numpy(x), tp, cfg)
    _close(to, jo)
    _close(ta, ja)


def _batch(cfg, B=2, S=40, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, -1] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_loss_aux_and_grads_match_jax(arch):
    cfg = _f32(get_smoke_config(arch))
    jp, batch = _jax_params(jax_smoke(arch)), _batch(cfg)
    (lj, mj), gj = jax.jit(jax.value_and_grad(jax_build(cfg).loss,
                                              has_aux=True))(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jp, "cpu")
    leaves = [l.requires_grad_(True) for l in tree_leaves(params)]
    lt, mt = build_model(cfg).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves)
    lt = lt.detach()
    assert float(lt) == pytest.approx(float(lj), rel=1e-5)
    loss, aux = (float(mt[k].detach()) for k in ("loss", "aux_loss"))
    assert loss == pytest.approx(float(mj["loss"]), rel=1e-5)
    assert aux == pytest.approx(float(mj["aux_loss"]), rel=1e-5)
    assert aux > 0.0
    theirs = jax.tree.leaves(gj)
    assert len(gt) == len(theirs)
    for a, b in zip(gt, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_prefill_and_decode_match_jax(arch):
    """32-token prompts take the sorted dispatch at prefill (S >= 4 E for
    both smoke configs); decode takes the dense combine."""
    cfg = _f32(get_smoke_config(arch))
    jp = _jax_params(jax_smoke(arch))
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    jm, tm = jax_build(cfg), build_model(cfg)
    params = params_from_jax(jp, "cpu")
    jcache = jm.init_cache(2, 36)
    jl, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens)},
                                     jcache)
    decode = jax.jit(jm.decode_step)
    with torch.inference_mode():
        cache = tm.init_cache(2, 36, device="cpu")
        tl, cache = tm.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               cache)
        for _ in range(3):
            _close(tl, jl)
            jt = jnp.argmax(jl[:, -1], axis=-1)[:, None]
            tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            jl, jcache = decode(jp, jcache, {"tokens": jt})
            tl, cache = tm.decode_step(params, cache, {"tokens": tt})
        _close(tl, jl)
    for a, b in zip(tree_leaves(cache["layers"]),
                    jax.tree.leaves(jcache["layers"])):
        _close(a, b)
