"""The port's hybrid family (zamba2-2.7b: groups of Mamba2 layers, each
followed by a shared attention block with its own KV cache slot) against
the JAX package, live, on the smoke config in float32 (checks and bounds
in ``tests/torch_zoo_parity.py``: rtol 1e-5 / atol 1e-6 x max(1,
max|ref|), the greedy tokens equal); the flash route (K4's plain version,
head dim 80 too) against the einsum route; and ``_stacked_init``, which
fills preallocated stacked leaves layer by layer, against stacking a list
of drawn layers, bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import torch_zoo_parity as zp  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.fused_update.ops import tree_leaves, tree_map  # noqa: E402,E501
from repro_torch.models import attention, build_model, model  # noqa: E402

ARCH = "zamba2-2.7b"


def test_config_matches_jax_and_full_width_count():
    for get, jget in ((get_smoke_config, jax_smoke),
                      (get_config, jax_config)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    full = get_config(ARCH)
    assert full.param_count() == 2_527_532_960
    assert (full.num_layers, full.d_model, full.head_dim, full.ssm_nheads,
            full.ssm_head_dim, full.ssm_state, full.ssm_chunk,
            full.hybrid_period, full.num_shared_blocks) == \
        (54, 2560, 80, 80, 64, 64, 256, 6, 2)
    assert get_config("zamba2_2_7b") is get_config("zamba2-2-7b") is full
    zp.check_params(ARCH)


@pytest.mark.parametrize("remat", ("none", "full"))
def test_loss_and_grads_match_jax(remat):
    """The loss without remat; with ``remat="full"`` (each Mamba2 layer
    and shared block recomputed in the backward pass, the JAX group body
    under ``jax.checkpoint``) every gradient leaf too."""
    zp.check_loss(ARCH, grads=remat == "full", remat=remat)


def test_prefill_cache_and_decode_match_jax():
    zp.check_serving(ARCH, ("attn", "ssm"))


def test_generate_tokens_equal_jax():
    zp.check_generate(ARCH)


def test_flash_route_matches_einsum_route():
    zp.check_flash_route(ARCH)


def test_head_dim_80_flash_route_matches_einsum_route():
    """zamba2's shared blocks at their published head dim, 80, in a model
    of two heads (d_model 160): the flash route's prefill (K4's plain
    version at d = 80) against the einsum route, prefill and decode, and
    attention itself at 2e-5."""
    cfg = zp.f32(get_smoke_config(ARCH), d_model=160, num_heads=2,
                 num_kv_heads=2, head_dim=0)
    assert cfg.head_dim == 80
    params = build_model(cfg).init(torch.Generator().manual_seed(3), "cpu")
    zp.check_flash_route(ARCH, cfg, params)
    g = torch.Generator().manual_seed(4)
    p = attention.init_attention(g, cfg)
    x = torch.randn(2, 20, 160, generator=g)
    pos = torch.arange(20)
    ours, _ = attention.attention(
        x, p, dataclasses.replace(cfg, attention_impl="flash"), pos,
        kernel="reference")
    ref, _ = attention.attention(x, p, cfg, pos)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_grouped_states_are_written_in_place():
    """The groups' SSM states are views of the cache's (L, ...) leaves:
    prefill and decode write the very tensors ``init_cache`` made."""
    cfg = zp.f32(get_smoke_config(ARCH))
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    cache = m.init_cache(zp.B, zp.S + 2, device="cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(cache["ssm"])]
    with torch.inference_mode():
        _, out = m.prefill(params, zp.to_torch(zp.batch(cfg)), cache)
        written = [t.clone() for t in tree_leaves(out["ssm"])]
        _, out = m.decode_step(params, out, {"tokens": torch.zeros(
            (zp.B, 1), dtype=torch.int64)})
    assert [t.data_ptr() for t in tree_leaves(out["ssm"])] == ptrs
    for before, after in zip(written, tree_leaves(out["ssm"])):
        assert before.abs().max() > 0 and not torch.equal(before, after)


@pytest.mark.parametrize("arch,init", (
    (ARCH, "mamba"), (ARCH, "shared"), ("whisper-large-v3", "cross")))
def test_stacked_init_fills_the_stack_bitwise(arch, init):
    """The stack filled layer by layer equals the list of drawn layers
    stacked (the draw order is the same), bit for bit, from one
    generator."""
    cfg = get_smoke_config(arch)
    one = {"mamba": lambda g: model.init_mamba_layer(g, cfg),
           "shared": lambda g: model.init_transformer_block(g, cfg),
           "cross": lambda g: model.init_transformer_block(g, cfg,
                                                           cross=True)}[init]
    got = model._stacked_init(one, torch.Generator().manual_seed(7), 5)
    g = torch.Generator().manual_seed(7)
    layers = [one(g) for _ in range(5)]
    want = tree_map(lambda *xs: torch.stack(xs), *layers)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
