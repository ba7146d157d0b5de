"""The port's dense configs qwen2.5-3b, phi4-mini-3.8b and internlm2-20b,
chunked attention (``attention_impl="chunked"``, ``_sdpa_chunked``) and
the serving steps (``launch/steps.py`` ``make_prefill_step`` /
``make_decode_step``) against the JAX package, live, with the JAX
parameters carried across by ``params_from_jax`` and the inputs drawn
with numpy.

Bounds, in float32: logits, cache leaves and attention outputs at rtol
1e-5 / atol 1e-6 x max(1, max|ref|) (tests/test_torch_serve.py's), the
greedy tokens equal; the chunked route against the einsum route of the
same package at rtol 1e-5 as well (the same function, blocked)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.fused_update.ops import tree_leaves  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.models.zoo import params_from_jax  # noqa: E402

DENSE = ("qwen2.5-3b", "phi4-mini-3.8b", "internlm2-20b")
B, S = 2, 12


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """A parameter tree of the JAX smoke model's structure and shapes
    (``jax.eval_shape`` of its ``init``: nothing is compiled), drawn with
    numpy: fan-in scaled normals, vectors (norms, biases) at 0.1."""
    rng = np.random.default_rng(len(arch))
    shapes = jax.eval_shape(jax_build(jax_smoke(arch)).init,
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda l: (rng.standard_normal(l.shape) * (
        l.shape[-2] ** -0.5 if len(l.shape) >= 2 else 0.1)).astype(
        np.float32), shapes)


def _prompts(cfg, seed=0, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def _close(a, b, rtol=1e-5, atol=1e-6):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b, dtype=np.float64)
    atol = atol * max(1.0, float(np.abs(b).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64), b,
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_match_jax(arch):
    for get, jget in ((get_smoke_config, jax_smoke),
                      (get_config, jax_config)):
        ours, theirs = get(arch), jget(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
    jp = _jax_params(arch)
    ours = tree_leaves(params_from_jax(jp, "cpu"))
    theirs = jax.tree.leaves(jp)
    assert [tuple(a.shape) for a in ours] == [b.shape for b in theirs]
    own = build_model(get_smoke_config(arch)).init(
        torch.Generator().manual_seed(0), "cpu")
    assert [tuple(l.shape) for l in tree_leaves(own)] == \
        [l.shape for l in theirs]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_and_decode_match_jax(arch):
    """Through the serving steps of both packages: ``make_prefill_step``,
    then three greedy ``make_decode_step`` steps (tokens), and one
    ``greedy=False`` step (logits) for qwen2.5-3b; the cache after
    each."""
    cfg = _f32(get_smoke_config(arch))
    jp = _jax_params(arch)
    params = params_from_jax(jp, "cpu")
    tokens = _prompts(cfg, seed=len(arch))
    jpre = jax.jit(jax_steps.make_prefill_step(cfg))
    jdec = jax.jit(jax_steps.make_decode_step(cfg))
    tpre = steps.make_prefill_step(cfg)
    tdec = steps.make_decode_step(cfg)
    jcache = jax_build(cfg).init_cache(B, S + 5)
    cache = build_model(cfg).init_cache(B, S + 5, device="cpu")
    jl, jcache = jpre(jp, {"tokens": jnp.asarray(tokens)}, jcache)
    tl, cache = tpre(params, {"tokens": torch.from_numpy(tokens)}, cache)
    _close(tl, jl)
    jt = jnp.argmax(jl[:, -1], axis=-1)[:, None]
    tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
    for _ in range(3):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt, jcache = jdec(jp, jcache, {"tokens": jt})
        tt, cache = tdec(params, cache, {"tokens": tt})
        assert tt.dtype == torch.int64 and tuple(tt.shape) == (B, 1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    steps_taken = 3
    if arch == "qwen2.5-3b":
        jl, jcache = jax.jit(jax_steps.make_decode_step(cfg, greedy=False))(
            jp, jcache, {"tokens": jt})
        tl, cache = steps.make_decode_step(cfg, greedy=False)(
            params, cache, {"tokens": tt})
        _close(tl, jl)
        steps_taken += 1
    assert cache["pos"] == int(jcache["pos"]) == S + steps_taken
    for a, b in zip(tree_leaves(cache["layers"]),
                    jax.tree.leaves(jcache["layers"])):
        _close(a, b)


def _qkv(Sq, Sk, H=4, KV=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))


@pytest.mark.parametrize("Sq,Sk,causal,offset,block", (
    (24, 24, True, 0, 8),       # causal, whole blocks
    (20, 32, False, 0, 8),      # full (no mask), a tail block
    (10, 32, True, 7, 4)))      # causal at a cache offset, a tail block
def test_sdpa_chunked_matches_jax(Sq, Sk, causal, offset, block):
    cfg = _f32(get_smoke_config("qwen2.5-3b"), attn_q_block=block)
    q, k, v = _qkv(Sq, Sk, seed=Sq + Sk)
    theirs = jax.jit(jax_attention._sdpa_chunked, static_argnums=3,
                     static_argnames=("causal", "offset"))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg, causal=causal,
        offset=offset)
    ours = attention._sdpa_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cfg,
        causal=causal, offset=offset)
    _close(ours, theirs)
    if causal:      # the same function as the masked einsum attention
        mask = attention.causal_mask(Sq, Sk, offset=offset)
        _close(ours, attention._sdpa(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), mask, cfg))


def test_chunked_model_routes_match_jax():
    """``attention_impl="chunked"`` with ``attn_q_block`` 8: a 20-token
    prefill (the chunked route over the cache at offset 0, a tail block)
    against JAX's chunked model and the port's einsum route, and the loss
    with its gradients (each block recomputed in the backward pass)
    against the port's einsum route (the same function)."""
    arch = "qwen2.5-3b"
    cfg = _f32(get_smoke_config(arch), attention_impl="chunked",
               attn_q_block=8)
    jp = _jax_params(arch)
    params = params_from_jax(jp, "cpu")
    tokens = _prompts(cfg, seed=4, s=20)
    jm, tm = jax_build(cfg), build_model(cfg)
    xla = build_model(dataclasses.replace(cfg, attention_impl="xla"))
    jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens)},
                                jm.init_cache(B, 24))
    with torch.no_grad():
        tl, _ = tm.prefill(params, {"tokens": torch.from_numpy(tokens)},
                           tm.init_cache(B, 24, device="cpu"))
        xl, _ = xla.prefill(params, {"tokens": torch.from_numpy(tokens)},
                            xla.init_cache(B, 24, device="cpu"))
    _close(tl, jl)
    _close(tl, xl)
    batch = {k: torch.from_numpy(v) for k, v in (
        ("tokens", tokens), ("labels", np.roll(tokens, -1, axis=1)))}
    out = []
    for m in (tm, xla):
        p = params_from_jax(jp, "cpu")
        leaves = [l.requires_grad_(True) for l in tree_leaves(p)]
        loss, _ = m.loss(p, batch)
        out.append((float(loss.detach()), torch.autograd.grad(loss, leaves)))
    (lt, gt), (lx, gx) = out
    assert lt == pytest.approx(lx, rel=1e-5)
    for a, b in zip(gt, gx):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)
