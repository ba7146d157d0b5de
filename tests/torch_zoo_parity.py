"""Shared checks of the port's hybrid, audio and VLM families against the
JAX package, live (``tests/test_torch_hybrid.py``,
``test_torch_encdec.py``, ``test_torch_vlm.py``).

Each family's smoke config runs in float32. The JAX parameters are the
JAX model's own ``init`` with numpy draws added to its vectors
(``jax_params``), carried across with ``params_from_jax``; prompts and
the frontends' embeddings are numpy draws. Bounds: rtol 1e-5 / atol 1e-6 x max(1, max|ref|)
(``tests/test_torch_serve.py``'s), the greedy tokens equal. The JAX side
is jitted (eager JAX is ~10x slower here) and each run is cached, so a
file compiles each function once."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.serve import BatchedServer as JaxServer
from repro.models import build_model as jax_build
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.fused_update.ops import tree_leaves
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.zoo import params_from_jax

B, S, GEN = 2, 12, 6


def f32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", **kw)


# the SSM's decay, step and skip vectors keep the JAX init's values (A in
# [-16, -1], dt = 0.01, D = 1): the regime the model is built for
SSM_KEEP = ("A_log", "dt_bias", "D_skip")


@functools.lru_cache(maxsize=None)
def jax_params(arch, seed=0):
    """The JAX smoke model's own ``init`` from ``PRNGKey(seed)``, as
    numpy, with 0.1 x normal numpy draws added to its vectors (norm
    scales, biases; the JAX init leaves them at 0 and 1) but ``SSM_KEEP``,
    so that every bias and norm path carries a value."""
    rng = np.random.default_rng(seed)
    tree = jax.jit(jax_build(jax_smoke(arch)).init)(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map_with_path(
        lambda path, l: np.asarray(l) if l.ndim > 1 or any(
            getattr(k, "key", None) in SSM_KEEP for k in path) else
        (np.asarray(l) + 0.1 * rng.standard_normal(l.shape)).astype(
            np.float32), tree)


def batch(cfg, seed=0, labels=False):
    """Tokens (B, S) and, for the audio and VLM families, the frontend's
    embeddings, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "audio":
        out["audio_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    if labels:
        out["labels"] = np.roll(out["tokens"], -1, axis=1)
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def close(a, b, rtol=1e-5, atol=1e-6):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b, dtype=np.float64)
    atol = atol * max(1.0, float(np.abs(b).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64), b,
                               rtol=rtol, atol=atol)


@functools.lru_cache(maxsize=None)
def jax_serving(arch, n_decode=3):
    """JAX's prefill and ``n_decode`` greedy decode steps: [(logits, cache
    as numpy), ...]."""
    cfg = f32(jax_smoke(arch))
    m = jax_build(cfg)
    jp = jax_params(arch)
    logits, cache = jax.jit(m.prefill)(jp, to_jax(batch(cfg)),
                                       m.init_cache(B, S + n_decode + 1))
    out = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
    decode = jax.jit(m.decode_step)
    for _ in range(n_decode):
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        logits, cache = decode(jp, cache, {"tokens": tok})
        out.append((np.asarray(logits), jax.tree.map(np.asarray, cache)))
    return out


def port_serving(cfg, params, n_decode=3):
    """The port's run of ``jax_serving``, the cache's tensors cloned after
    each step (the port writes them in place)."""
    m = build_model(cfg)
    out = []
    with torch.inference_mode():
        cache = m.init_cache(B, S + n_decode + 1, device="cpu")
        logits, cache = m.prefill(params, to_torch(batch(cfg)), cache)
        out.append((logits, {k: v if k == "pos" else
                             [t.clone() for t in tree_leaves(v)]
                             for k, v in cache.items()}))
        for _ in range(n_decode):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, cache = m.decode_step(params, cache, {"tokens": tok})
            out.append((logits, {k: v if k == "pos" else
                                 [t.clone() for t in tree_leaves(v)]
                                 for k, v in cache.items()}))
    return out


def check_serving(arch, cache_keys, **over):
    """Prefill logits, every cache leaf under ``cache_keys`` and three
    decode steps against JAX's. ``over``: config fields the JAX package
    never reads (``attention_impl``), which must not move the numbers
    beyond the bound."""
    cfg = f32(get_smoke_config(arch), **over)
    ours = port_serving(cfg, params_from_jax(jax_params(arch), "cpu"))
    theirs = jax_serving(arch)
    for step, ((tl, tc), (jl, jc)) in enumerate(zip(ours, theirs)):
        assert tuple(tl.shape) == jl.shape == (B, 1, cfg.vocab_size)
        close(tl, jl)
        assert sorted(tc) == sorted(jc) == sorted(cache_keys + ("pos",))
        assert tc["pos"] == int(jc["pos"])
        for key in cache_keys:
            leaves = jax.tree.leaves(jc[key])
            assert [tuple(t.shape) for t in tc[key]] == \
                [t.shape for t in leaves]
            for a, b in zip(tc[key], leaves):
                close(a, b)
    return ours


def check_loss(arch, grads=False, **over):
    """``loss`` and its metrics against JAX's; with ``grads`` every
    gradient leaf too, at rtol 1e-4 / atol 1e-6 (tests/test_torch_lm.py's
    bounds for gradients)."""
    cfg = f32(get_smoke_config(arch), **over)
    jp = jax_params(arch)
    b = batch(cfg, seed=5, labels=True)
    jloss = jax.jit(jax.value_and_grad(jax_build(cfg).loss, has_aux=True)
                    if grads else jax_build(cfg).loss)
    if grads:
        (lj, mj), gj = jloss(jp, to_jax(b))
    else:
        lj, mj = jloss(jp, to_jax(b))
    params = params_from_jax(jp, "cpu")
    leaves = [l.requires_grad_(grads) for l in tree_leaves(params)]
    lt, mt = build_model(cfg).loss(params, to_torch(b))
    close(lt, lj)
    assert sorted(mt) == sorted(mj)
    for k in mj:
        close(mt[k], mj[k])
    if grads:
        for a, g in zip(torch.autograd.grad(lt, leaves),
                        jax.tree.leaves(gj)):
            np.testing.assert_allclose(a.numpy(), np.asarray(g), rtol=1e-4,
                                       atol=1e-6)


def check_generate(arch):
    """``BatchedServer.generate``'s greedy tokens equal JAX's (zero
    frontend embeddings in both servers)."""
    cfg = f32(get_smoke_config(arch))
    jp = jax_params(arch)
    tokens = batch(cfg, seed=1)["tokens"]
    theirs = JaxServer(cfg, params=jax.tree.map(jnp.asarray, jp)) \
        .generate(tokens, GEN)
    ours = serve.BatchedServer(cfg, params=params_from_jax(jp, "cpu"),
                               device="cpu").generate(tokens, GEN)
    assert ours.dtype == np.int32 and ours.shape == (B, GEN)
    np.testing.assert_array_equal(ours, theirs)


def check_params(arch):
    """The port's own ``init`` gives JAX's tree: leaves, shapes, count."""
    cfg = get_smoke_config(arch)
    own = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    theirs = jax.tree.leaves(jax_params(arch))
    assert [tuple(l.shape) for l in tree_leaves(own)] == \
        [l.shape for l in theirs]
    assert sum(l.numel() for l in tree_leaves(own)) == cfg.param_count()


def check_flash_route(arch, cfg=None, params=None):
    """``attention_impl="flash"`` with K4's plain version (the CPU route,
    ``kernel="reference"``) against the port's einsum route on the same
    parameters: prefill logits, every cache leaf and three decode steps at
    2e-5 (tests/test_kernels.py's bound between the two)."""
    cfg = cfg or f32(get_smoke_config(arch))
    params = params or params_from_jax(jax_params(arch), "cpu")
    flash = port_serving(dataclasses.replace(cfg, attention_impl="flash"),
                         params)
    xla = port_serving(dataclasses.replace(cfg, attention_impl="xla"),
                       params)
    for (fl, fc), (xl, xc) in zip(flash, xla):
        np.testing.assert_allclose(fl.numpy(), xl.numpy(), rtol=2e-5,
                                   atol=2e-5)
        for key in fc:
            if key != "pos":
                for a, b in zip(fc[key], xc[key]):
                    np.testing.assert_allclose(a.numpy(), b.numpy(),
                                               rtol=2e-5, atol=2e-5)
