"""The port's audio family (whisper-large-v3: a non-causal LayerNorm
encoder over stub frame embeddings, a decoder with cross-attention whose
K/V are cached at prefill) against the JAX package, live, on the smoke
config in float32 (checks and bounds in ``tests/torch_zoo_parity.py``:
rtol 1e-5 / atol 1e-6 x max(1, max|ref|), the greedy tokens equal);
``layer_norm``, ``cross_kv`` and ``attention(..., kv_override=...)``
against the JAX functions at the same bound; the flash routes (K4's plain
version, non-causal: the encoder and the cross-attention) against the
einsum route."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_zoo_parity as zp  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import attention, common  # noqa: E402

ARCH = "whisper-large-v3"


def test_config_matches_jax_and_full_width_count():
    for get, jget in ((get_smoke_config, jax_smoke),
                      (get_config, jax_config)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    full = get_config(ARCH)
    assert full.param_count() == 1_603_527_680
    assert (full.num_layers, full.encoder_layers, full.d_model,
            full.num_heads, full.head_dim, full.encoder_seq, full.norm_type,
            full.mlp_act) == (32, 32, 1280, 20, 64, 1500, "layernorm",
                              "gelu")
    zp.check_params(ARCH)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_layer_norm_matches_jax(dtype):
    """f32 mean and biased variance, a cast back: at rtol 1e-5 in f32 and
    equal bf16 roundings but for a few ulp-boundary entries."""
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((4, 7, 96)) + 1.5).astype(np.float32)
    scale, bias = (rng.standard_normal(96).astype(np.float32)
                   for _ in "sb")
    ours = common.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(scale), torch.from_numpy(bias))
    theirs = jax_common.layer_norm(jnp.asarray(x).astype(dtype),
                                   jnp.asarray(scale), jnp.asarray(bias))
    assert str(ours.dtype).endswith(dtype)
    if dtype == "float32":
        zp.close(ours, theirs)
    else:
        diff = np.abs(ours.float().numpy() - np.asarray(theirs, np.float32))
        assert (diff > 0).mean() < 0.01 and diff.max() <= 2 ** -7 * max(
            1.0, float(np.abs(np.asarray(theirs, np.float32)).max()))
    cfg = get_smoke_config(ARCH)
    p = common.norm_params(96, cfg)
    assert torch.equal(p["scale"], torch.ones(96))
    assert torch.equal(p["bias"], torch.zeros(96))


@pytest.mark.parametrize("over", ({}, {"qkv_bias": True, "qk_norm": True},
                                  {"attention_impl": "chunked",
                                   "attn_q_block": 4}))
def test_cross_kv_and_kv_override_match_jax(over):
    """Cross-attention of 12 queries over 24 encoder frames: the cached
    K/V and the attention output, with and without bias and qk-norm, and
    through the chunked impl (its non-causal blocks)."""
    cfg = zp.f32(get_smoke_config(ARCH), **over)
    jp = jax.tree.map(lambda l: l[0], zp.jax_params(ARCH)["dec_layers"])
    p = jp["cross_attn"]
    rng = np.random.default_rng(2)
    H, hd = cfg.num_heads, cfg.head_dim
    if cfg.qkv_bias:
        p = dict(p, **{k: rng.standard_normal(n).astype(np.float32)
                       for k, n in (("bq", H * hd), ("bk", H * hd),
                                    ("bv", H * hd))})
    if cfg.qk_norm:
        p = dict(p, q_norm=0.1 * rng.standard_normal(hd).astype(np.float32),
                 k_norm=0.1 * rng.standard_normal(hd).astype(np.float32))
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    jk, jv = jax.jit(jax_attention.cross_kv, static_argnums=2)(
        jnp.asarray(enc), p, cfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    tk, tv = attention.cross_kv(torch.from_numpy(enc), tp, cfg)
    zp.close(tk, jk)
    zp.close(tv, jv)
    jo, jc = jax.jit(lambda x, p, kv: jax_attention.attention(
        x, p, cfg, kv_override=kv))(jnp.asarray(x), p, (jk, jv))
    to, tc = attention.attention(torch.from_numpy(x), tp, cfg,
                                 kv_override=(tk, tv))
    assert jc is None and tc is None
    zp.close(to, jo)


def test_loss_matches_jax():
    """The loss, its metrics and every gradient leaf."""
    zp.check_loss(ARCH, grads=True)


def test_prefill_cache_and_decode_match_jax():
    zp.check_serving(ARCH, ("cross", "layers"))


def test_generate_tokens_equal_jax():
    zp.check_generate(ARCH)


def test_flash_routes_match_einsum_route():
    """The encoder's non-causal self-attention (``mask=True``) and the
    decoder's cross-attention at prefill through K4's plain version, the
    decoder's causal prefill too; decode on the einsum route in both."""
    zp.check_flash_route(ARCH)


def test_flash_encoder_and_cross_attention_match_einsum():
    """Each new route alone, at 2e-5: self-attention with ``mask=True``
    (no positions) and cross-attention over 24 frames, through K4's plain
    version against ``_sdpa``."""
    cfg = zp.f32(get_smoke_config(ARCH))
    flash = dataclasses.replace(cfg, attention_impl="flash")
    g = torch.Generator().manual_seed(1)
    p = attention.init_attention(g, cfg)
    x = torch.randn(2, 24, cfg.d_model, generator=g)
    k, v = attention.cross_kv(torch.randn(2, 40, cfg.d_model, generator=g),
                              p, cfg)
    for kw in (dict(mask=True), dict(kv_override=(k, v))):
        ours, _ = attention.attention(x, p, flash, kernel="reference", **kw)
        ref, _ = attention.attention(x, p, cfg, **kw)
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=2e-5,
                                   atol=2e-5)
