"""The port's VLM family (internvl2-76b: stub patch embeddings prepended
to the token embeddings, positions over Nv + S, the loss over the text
rows, a cache of ``max_seq + Nv`` slots) against the JAX package, live,
on the smoke config in float32 (checks and bounds in
``tests/torch_zoo_parity.py``: rtol 1e-5 / atol 1e-6 x max(1, max|ref|),
the greedy tokens equal); its flash route (K4's plain version) against
the einsum route."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_zoo_parity as zp  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCH = "internvl2-76b"


def test_config_matches_jax_and_full_width_count():
    for get, jget in ((get_smoke_config, jax_smoke),
                      (get_config, jax_config)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    full = get_config(ARCH)
    assert full.param_count() == jax_config(ARCH).param_count()
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size,
            full.num_vision_tokens) == (80, 8192, 64, 8, 128, 28672, 128256,
                                        256)
    zp.check_params(ARCH)


def test_loss_matches_jax():
    """The loss (the Nv vision rows dropped before the LM head), its
    metrics and every gradient leaf."""
    zp.check_loss(ARCH, grads=True)


def test_prefill_cache_and_decode_match_jax():
    ours = zp.check_serving(ARCH, ("layers",))
    cfg = get_smoke_config(ARCH)
    assert ours[0][1]["pos"] == cfg.num_vision_tokens + zp.S
    assert ours[0][1]["layers"][0].shape[2] == \
        cfg.num_vision_tokens + zp.S + 4


def test_generate_tokens_equal_jax():
    zp.check_generate(ARCH)


def test_flash_route_matches_einsum_route():
    zp.check_flash_route(ARCH)


def test_serving_steps_pass_the_vision_embeds():
    """``make_prefill_step`` / ``make_decode_step`` hand the batch to the
    model as it comes, the vision embeddings with it."""
    cfg = zp.f32(get_smoke_config(ARCH))
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    b = zp.to_torch(zp.batch(cfg))
    with torch.inference_mode():
        want, _ = m.prefill(params, b, m.init_cache(zp.B, zp.S + 1,
                                                    device="cpu"))
    got, cache = steps.make_prefill_step(cfg)(
        params, b, m.init_cache(zp.B, zp.S + 1, device="cpu"))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    tok, cache = steps.make_decode_step(cfg)(params, cache, {
        "tokens": torch.argmax(got[:, -1], -1)[:, None]})
    assert tok.shape == (zp.B, 1) and cache["pos"] == \
        cfg.num_vision_tokens + zp.S + 1
    extra = serve.frontend_inputs(cfg, 3, "cpu")
    assert list(extra) == ["vision_embeds"]
    assert extra["vision_embeds"].shape == (3, cfg.num_vision_tokens,
                                            cfg.d_model)
    assert extra["vision_embeds"].dtype == torch.float32
    assert not extra["vision_embeds"].any()
    np.testing.assert_array_equal(tok.shape, (zp.B, 1))
