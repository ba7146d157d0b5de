"""The port's dense LM (Qwen3-0.6B's smoke config: 2 layers, d_model 64,
GQA 4/2 heads, qk-norm, tied embeddings) against the JAX package, with
the JAX initial parameters carried across by ``params_from_jax`` and the
tokens drawn with numpy.

Bounds: the building blocks (``rms_norm``, ``apply_rope``, ``attention``)
at rtol 1e-5 in float32 (atol 1e-6 beside it for entries that pass
through 0); in the float32 variant of the config the loss at rtol 1e-5
and every gradient leaf at rtol 1e-4 / atol 1e-6; at the config's own
bfloat16 compute the loss at rtol 2e-2 (the two libraries round bf16 at
different places)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.fused_update.ops import tree_leaves  # noqa: E402
from repro_torch.models import attention, common  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.zoo import params_from_jax  # noqa: E402

ARCH = "qwen3-0.6b"


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jax_build(cfg).init(
        jax.random.PRNGKey(seed)))


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, -1] = -1          # a masked position
    return {"tokens": tokens, "labels": labels}


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64),
                               rtol=rtol, atol=atol)


def test_configs_match_and_full_width_count():
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jax_smoke(ARCH))
    full = get_config(ARCH)
    assert full.param_count() == 596_049_920
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size) == \
        (28, 1024, 16, 8, 128, 3072, 151936)
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("qwen3-0.6")


def test_leaf_order_matches_jax_tree_leaves():
    cfg = get_smoke_config(ARCH)
    jp = _jax_params(cfg)
    ours = tree_leaves(params_from_jax(jp, "cpu"))
    theirs = jax.tree.leaves(jp)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    # the port's own init has the same tree and leaf shapes
    own = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert [tuple(l.shape) for l in tree_leaves(own)] == \
        [l.shape for l in theirs]
    assert sum(l.numel() for l in tree_leaves(own)) == cfg.param_count()


def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    scale = 0.1 * rng.standard_normal(16).astype(np.float32)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jax_common.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    pos = np.arange(16)
    for theta in (1e4, 1e6):
        _close(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 theta),
               jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_attention_matches():
    cfg = _f32(get_smoke_config(ARCH))
    p = _jax_params(cfg)["layers"]["attn"]
    p0 = {k: v[0] for k, v in p.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.arange(16)
    ours, cache = attention.attention(torch.from_numpy(x),
                                      params_from_jax(p0, "cpu"), cfg,
                                      positions=torch.from_numpy(pos))
    theirs, _ = jax_attention.attention(jnp.asarray(x), p0, cfg,
                                        positions=jnp.asarray(pos))
    assert cache is None
    _close(ours, theirs)


def _jax_loss_grads(cfg, jp, batch):
    model = jax_build(cfg)
    (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.leaves(grads)


def _torch_loss_grads(cfg, jp, batch):
    params = params_from_jax(jp, "cpu")
    leaves = [l.requires_grad_(True) for l in tree_leaves(params)]
    loss, _ = build_model(cfg).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), grads


@pytest.mark.parametrize("remat", ("none", "full"))
def test_f32_loss_and_grads_match(remat):
    cfg = dataclasses.replace(_f32(get_smoke_config(ARCH)), remat=remat)
    jp, batch = _jax_params(cfg), _batch(cfg)
    loss_j, grads_j = _jax_loss_grads(cfg, jp, batch)
    loss_t, grads_t = _torch_loss_grads(cfg, jp, batch)
    assert loss_t == pytest.approx(loss_j, rel=1e-5)
    assert len(grads_t) == len(grads_j)
    for a, b in zip(grads_t, grads_j):
        _close(a, b, rtol=1e-4, atol=1e-6)


def test_bf16_loss_matches():
    cfg = get_smoke_config(ARCH)
    assert cfg.dtype == "bfloat16"
    jp, batch = _jax_params(cfg), _batch(cfg, seed=3)
    loss_j, _ = _jax_loss_grads(cfg, jp, batch)
    loss_t, _ = _torch_loss_grads(cfg, jp, batch)
    assert np.isfinite(loss_t)
    assert loss_t == pytest.approx(loss_j, rel=2e-2)


def test_unported_model_paths_raise():
    """Every family of the JAX zoo builds (the audio, hybrid and VLM
    families: tests/test_torch_encdec.py, test_torch_hybrid.py,
    test_torch_vlm.py); a config of no LM family (the paper's LeNet-5)
    raises, as it has no model in either package's zoo."""
    cfg = get_smoke_config(ARCH)
    for family in (dict(family="audio", is_encoder_decoder=True),
                   dict(family="hybrid", ssm_state=16, hybrid_period=2,
                        num_shared_blocks=1),
                   dict(family="vlm", num_vision_tokens=4)):
        build_model(dataclasses.replace(cfg, **family))
    with pytest.raises(ValueError, match="not an LM family"):
        build_model(get_config("paper-lenet5"))
    build_model(dataclasses.replace(cfg, family="moe", num_experts=4))
    chunked = dataclasses.replace(cfg, attention_impl="chunked")
    loss, _ = build_model(chunked).loss(
        params_from_jax(_jax_params(cfg), "cpu"),
        {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
    assert np.isfinite(float(loss.detach()))


def test_default_device_init_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_smoke_config(ARCH)).init(torch.Generator())
