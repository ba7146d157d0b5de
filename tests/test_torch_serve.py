"""The port's serving path — ``Model.init_cache``/``prefill``/
``decode_step`` and ``launch.serve.BatchedServer`` — for the dense family
(Qwen3-0.6B's smoke config) and the SSM family (Mamba2-370m's smoke
config: 2 layers, d_model 64, 8 SSD heads of head_dim 16, state 16,
chunk 8) against live runs of the JAX package, with the JAX parameters
carried across by ``params_from_jax`` and the prompts drawn with numpy.

Bounds: in the float32 variant of each config, the prefill logits, every
cache leaf and three decode steps at rtol 1e-5 / atol 1e-6 x max(1,
max|ref|) (an entry near 0 carries the f32 rounding of the tensor's
largest terms: logits of magnitude ~3 differ by up to 1.6e-6 where they
pass through 0), and the greedy tokens equal; the port's flash route
(K4's plain version) against JAX's einsum route at 2e-5
(``tests/test_kernels.py``'s bound between the two); at the configs' own
bfloat16, the prefill logits within 5 % of the logits' largest magnitude
(bf16 keeps 8 significant bits, and the two libraries round at different
places in a 2-layer model, K3 also reading C and B as f32 where JAX forms
C B^T in bf16); the teacher-forcing check at ``tests/test_models.py``'s
own tolerances (2e-2 dense, 6e-2 SSM)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch.serve import BatchedServer as JaxServer  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.fused_update.ops import tree_leaves  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.zoo import params_from_jax  # noqa: E402

ARCHS = ("qwen3-0.6b", "mamba2-370m")
ROUTES = (("qwen3-0.6b", "xla"), ("qwen3-0.6b", "flash"),
          ("mamba2-370m", "xla"))     # attention_impl: attention only
B, S, GEN = 2, 12, 6


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jax_build(cfg).init(
        jax.random.PRNGKey(seed)))


def _prompts(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(a, b, rtol=1e-5, atol=1e-6, scaled=True):
    """allclose; with ``scaled``, atol is taken relative to max(1,
    max|b|)."""
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b, dtype=np.float64)
    if scaled:
        atol = atol * max(1.0, float(np.abs(b).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64), b,
                               rtol=rtol, atol=atol)


def _jax_run(cfg, jp, tokens, n_decode, max_seq):
    m = jax_build(cfg)
    cache = m.init_cache(tokens.shape[0], max_seq)
    logits, cache = jax.jit(m.prefill)(jp, {"tokens": jnp.asarray(tokens)},
                                       cache)
    out = [(logits, cache)]
    decode = jax.jit(m.decode_step)
    for _ in range(n_decode):
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        logits, cache = decode(jp, cache, {"tokens": tok})
        out.append((logits, cache))
    return out


def _port_run(cfg, params, tokens, n_decode, max_seq):
    """Like ``_jax_run``; copies each cache, which the port updates in
    place."""
    m = build_model(cfg)
    with torch.inference_mode():
        cache = m.init_cache(tokens.shape[0], max_seq, device="cpu")
        logits, cache = m.prefill(params, {"tokens": torch.from_numpy(
            tokens)}, cache)
        out = [(logits, [t.clone() for t in tree_leaves(cache["layers"])],
                cache["pos"])]
        for _ in range(n_decode):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, cache = m.decode_step(params, cache, {"tokens": tok})
            out.append((logits, [t.clone() for t in
                                 tree_leaves(cache["layers"])],
                        cache["pos"]))
    return out


def test_mamba2_config_matches_and_full_width_count():
    assert dataclasses.asdict(get_smoke_config("mamba2-370m")) == \
        dataclasses.asdict(jax_smoke("mamba2-370m"))
    full = get_config("mamba2-370m")
    assert full.param_count() == 368_338_432
    assert (full.num_layers, full.d_model, full.d_inner, full.ssm_nheads,
            full.ssm_head_dim, full.ssm_state, full.ssm_ngroups,
            full.ssm_chunk, full.vocab_size, full.tie_embeddings,
            full.dtype) == (48, 1024, 2048, 32, 64, 128, 1, 256, 50280,
                            True, "bfloat16")


def test_mamba2_leaf_order_matches_jax_tree_leaves():
    cfg = get_smoke_config("mamba2-370m")
    jp = _jax_params(cfg)
    ours = tree_leaves(params_from_jax(jp, "cpu"))
    theirs = jax.tree.leaves(jp)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    own = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert [tuple(l.shape) for l in tree_leaves(own)] == \
        [l.shape for l in theirs]
    assert sum(l.numel() for l in tree_leaves(own)) == cfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    cfg = get_smoke_config(arch)
    theirs = jax_build(cfg).init_cache(3, 20)
    ours = build_model(cfg).init_cache(3, 20, device="cpu")
    assert ours["pos"] == int(theirs["pos"]) == 0
    j, t = jax.tree.leaves(theirs["layers"]), tree_leaves(ours["layers"])
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in t] == \
        [(x.shape, str(x.dtype)) for x in j]
    assert all(not x.any() for x in t)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_prefill_and_decode_match_jax(arch):
    cfg = _f32(get_smoke_config(arch))
    jp = _jax_params(cfg)
    tokens = _prompts(cfg)
    theirs = _jax_run(cfg, jp, tokens, 3, S + 4)
    ours = _port_run(cfg, params_from_jax(jp, "cpu"), tokens, 3, S + 4)
    for step, ((jl, jc), (tl, tc, pos)) in enumerate(zip(theirs, ours)):
        assert pos == int(jc["pos"]) == S + step
        assert tuple(tl.shape) == jl.shape == (B, 1, cfg.vocab_size)
        _close(tl, jl)
        leaves = jax.tree.leaves(jc["layers"])
        assert len(leaves) == len(tc)
        for a, b in zip(tc, leaves):
            _close(a, b)


@pytest.mark.parametrize("groups", (2, 4))
def test_mamba2_grouped_prefill_and_decode_match_jax(groups):
    """Mamba2 with its 8 SSD heads in 2 or 4 groups: the port passes each
    group's B and C projections to K3 (never repeated over the group's
    heads, which JAX's ``jnp.repeat`` does); prefill, cache leaves and
    three decode steps at the same bounds as above."""
    cfg = dataclasses.replace(_f32(get_smoke_config("mamba2-370m")),
                              ssm_ngroups=groups)
    jp = _jax_params(cfg)
    tokens = _prompts(cfg, seed=groups)
    theirs = _jax_run(cfg, jp, tokens, 3, S + 4)
    ours = _port_run(cfg, params_from_jax(jp, "cpu"), tokens, 3, S + 4)
    for (jl, jc), (tl, tc, _) in zip(theirs, ours):
        _close(tl, jl)
        for a, b in zip(tc, jax.tree.leaves(jc["layers"])):
            _close(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_equal_jax(arch):
    cfg = _f32(get_smoke_config(arch))
    jp = _jax_params(cfg)
    tokens = _prompts(cfg, seed=1)
    theirs = JaxServer(cfg, params=jax.tree.map(jnp.asarray, jp)) \
        .generate(tokens, GEN)
    ours = serve.BatchedServer(cfg, params=params_from_jax(jp, "cpu"),
                               device="cpu").generate(tokens, GEN)
    assert ours.dtype == np.int32 and ours.shape == (B, GEN)
    np.testing.assert_array_equal(ours, theirs)


def test_qwen3_flash_route_matches_jax_xla():
    """``attention_impl="flash"``: the prefill goes through K4's plain
    version on the fresh keys, decode through the einsum attention; the
    JAX package never reads "flash", so its run is the einsum route."""
    cfg = _f32(get_smoke_config("qwen3-0.6b"))
    flash = dataclasses.replace(cfg, attention_impl="flash")
    jp = _jax_params(cfg)
    tokens = _prompts(cfg, seed=2)
    theirs = _jax_run(cfg, jp, tokens, 3, S + 4)
    ours = _port_run(flash, params_from_jax(jp, "cpu"), tokens, 3, S + 4)
    for (jl, jc), (tl, tc, _) in zip(theirs, ours):
        _close(tl, jl, 2e-5, 2e-5, scaled=False)
        for a, b in zip(tc, jax.tree.leaves(jc["layers"])):
            _close(a, b, 2e-5, 2e-5, scaled=False)
    np.testing.assert_array_equal(
        serve.BatchedServer(flash, params=params_from_jax(jp, "cpu"),
                            device="cpu").generate(tokens, GEN),
        JaxServer(cfg, params=jax.tree.map(jnp.asarray, jp))
        .generate(tokens, GEN))


@pytest.mark.parametrize("arch,impl", ROUTES)
def test_bf16_prefill_logits_match_jax(arch, impl):
    cfg = get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    jp = _jax_params(cfg)
    tokens = _prompts(cfg, seed=3)
    (jl, _), = _jax_run(cfg, jp, tokens, 0, S)
    (tl, _, _), = _port_run(dataclasses.replace(cfg, attention_impl=impl),
                            params_from_jax(jp, "cpu"), tokens, 0, S)
    assert tl.dtype == torch.bfloat16
    scale = float(np.abs(np.asarray(jl, np.float32)).max())
    _close(tl, jl, 0.0, 5e-2 * scale, scaled=False)


@pytest.mark.parametrize("arch,impl", ROUTES)
def test_prefill_decode_matches_full_forward(arch, impl):
    """Teacher forcing (``tests/test_models.py``): prefill(S-1) and one
    decode step give prefill(S)'s last logits, at the config's bf16."""
    cfg = dataclasses.replace(get_smoke_config(arch), attention_impl=impl)
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_prompts(cfg, seed=4))
    with torch.inference_mode():
        full, _ = m.prefill(params, {"tokens": tokens},
                            m.init_cache(B, S, device="cpu"))
        _, cache = m.prefill(params, {"tokens": tokens[:, :S - 1]},
                             m.init_cache(B, S, device="cpu"))
        step, _ = m.decode_step(params, cache, {"tokens": tokens[:, S - 1:]})
    tol = 6e-2 if cfg.sub_quadratic else 2e-2
    _close(full[:, -1], step[:, -1].float().numpy(), tol, tol, scaled=False)


@pytest.mark.parametrize("remat", ("none", "full"))
def test_mamba2_f32_loss_and_grads_match_jax(remat):
    """The SSM stack's training form (no states): loss at rtol 1e-5 and
    every gradient leaf at rtol 1e-4 / atol 1e-6, as for the dense LM."""
    cfg = dataclasses.replace(_f32(get_smoke_config("mamba2-370m")),
                              remat=remat)
    jp = _jax_params(cfg)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
             for k in ("tokens", "labels")}
    (lj, _), gj = jax.value_and_grad(jax_build(cfg).loss, has_aux=True)(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jp, "cpu")
    leaves = [l.requires_grad_(True) for l in tree_leaves(params)]
    lt, _ = build_model(cfg).loss(params, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    grads = torch.autograd.grad(lt, leaves)
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-5)
    for a, b in zip(grads, jax.tree.leaves(gj)):
        _close(a, b, 1e-4, 1e-6, scaled=False)


def test_unported_families_raise():
    """Every family builds and serves (the audio and VLM families with the
    JAX package's zero frontend embeddings); what no zoo family takes
    raises: a non-LM config, an unknown id, a kernel mode."""
    cfg = get_smoke_config("qwen3-0.6b")
    for other in (dict(family="hybrid", ssm_state=16, hybrid_period=2,
                       num_shared_blocks=1),
                  dict(family="audio", is_encoder_decoder=True,
                       encoder_layers=1, encoder_seq=8),
                  dict(family="vlm", num_vision_tokens=4)):
        srv = serve.BatchedServer(dataclasses.replace(cfg, **other),
                                  device="cpu")
        out = srv.generate(_prompts(cfg), 2)
        assert out.shape == (B, 2) and out.dtype == np.int32
    with pytest.raises(ValueError, match="not an LM family"):
        build_model(get_config("paper-lenet5"))
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("zamba2")
    with pytest.raises(ValueError, match="kernel mode"):
        build_model(cfg, kernel="triton")


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.BatchedServer(get_smoke_config("mamba2-370m"))


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_runs_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                "--prompt-len", "9", "--gen", "3"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "tok/s" in out
