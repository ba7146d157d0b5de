"""K4's plain version — the CPU route of the port's ``flash_attention`` —
against the JAX package's Pallas kernel (run as its own tests run it, in
interpret mode) and its oracle ``attention_ref``, on inputs drawn with
numpy.

Bounds are those of ``tests/test_kernels.py`` (TestFlashAttention): 2e-5
in float32 and 2e-2 in bfloat16 (both libraries round the same bf16
inputs; the softmax and the sums are f32 in every version). The CUDA
kernel itself is held against this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    attention_ref as jax_ref, flash_attention as jax_flash)
from repro.models import attention as jax_attention  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro_torch.kernels import _cuda_build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention)
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SHAPES = ((1, 4, 4, 256, 64), (2, 8, 2, 256, 128), (1, 4, 2, 384, 64),
          (1, 2, 1, 512, 32))
DTYPES = (("float32", 2e-5), ("bfloat16", 2e-2))


def _qkv(B, H, KV, Sq, d, seed, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    return (rng.standard_normal((B, H, Sq, d)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, d)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, d)).astype(np.float32))


def _both(arrays, dtype):
    ours = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    theirs = [jnp.asarray(a).astype(dtype) for a in arrays]
    return ours, theirs


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a.float()),
                               np.asarray(b, dtype=np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,H,KV,S,d", SHAPES)
def test_causal_matches_jax_kernel_and_ref(B, H, KV, S, d, dtype, tol):
    (q, k, v), (jq, jk, jv) = _both(_qkv(B, H, KV, S, d, B * H * S), dtype)
    out = flash_attention(q, k, v, causal=True)
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(out, jax_flash(jq, jk, jv, causal=True, block_q=128, block_k=128,
                          interpret=True), tol)
    _close(out, jax_ref(jq, jk, jv, causal=True), tol)


def test_non_causal_matches_jax_kernel_and_ref():
    (q, k, v), (jq, jk, jv) = _both(_qkv(1, 2, 2, 256, 64, 0), "float32")
    out = flash_attention(q, k, v, causal=False)
    _close(out, jax_flash(jq, jk, jv, causal=False, block_q=128,
                          block_k=128, interpret=True), 2e-5)
    _close(out, jax_ref(jq, jk, jv, causal=False), 2e-5)


@pytest.mark.parametrize("causal", (True, False))
def test_head_dim_80_matches_jax_kernel_and_ref(causal):
    """zamba2's head dim, 2560 / 32 = 80, which the TPU kernel takes as
    any d: the plain version against it in interpret mode, f32 at 2e-5."""
    (q, k, v), (jq, jk, jv) = _both(_qkv(1, 4, 2, 256, 80, 80 + causal),
                                    "float32")
    out = flash_attention(q, k, v, causal=causal)
    assert out.shape == q.shape
    _close(out, jax_flash(jq, jk, jv, causal=causal, block_q=128,
                          block_k=128, interpret=True), 2e-5)
    _close(out, jax_ref(jq, jk, jv, causal=causal), 2e-5)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_ragged_causal_matches_ref(dtype, tol):
    """S = 200 is no block multiple: the JAX wrapper pads, the port's
    kernel masks the tail itself; both equal the oracle."""
    (q, k, v), (jq, jk, jv) = _both(_qkv(2, 4, 2, 200, 64, 5), dtype)
    _close(flash_attention(q, k, v), jax_ref(jq, jk, jv, causal=True), tol)


def test_causal_needs_equal_lengths():
    """The TPU kernel masks top-left (cols <= rows) and its oracle
    bottom-right (tril(k=Sk-Sq)); they agree only for Sq == Sk, so the
    port raises elsewhere instead of picking one."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 10, 16, 1, Sk=20))
    for fn in (flash_attention, attention_ref):
        with pytest.raises(ValueError, match="Sq == Sk"):
            fn(q, k, v, causal=True)
    assert flash_attention(q, k, v, causal=False).shape == q.shape


def test_cuda_route_on_cpu_tensors_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 16, 16, 2))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v, kernel="cuda")
    with pytest.raises(ValueError, match="kernel mode"):
        flash_attention(q, k, v, kernel="triton")
    torch.testing.assert_close(flash_attention(q, k, v, kernel="reference"),
                               flash_attention(q, k, v))


def test_flash_equals_the_model_sdpa():
    """Both packages' einsum attention ``_sdpa`` (the JAX oracle in the
    model stack) against the port's flash route, f32 at 2e-5."""
    kw = dict(name="t", family="dense", num_layers=1, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
              head_dim=16)
    rng = np.random.default_rng(0)
    B, S = 2, 256
    q = rng.standard_normal((B, S, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, 2, 16)).astype(np.float32)
            for _ in "kv")
    ref = jax_attention._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jax_attention.causal_mask(S, S),
                              JaxModelConfig(**kw))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ours = attention._sdpa(tq, tk, tv, attention.causal_mask(S, S),
                           ModelConfig(**kw))
    _close(ours, ref, 2e-5)
    _close(attention._flash(tq, tk, tv, "auto"), ref, 2e-5)


def test_modules_import_and_run_without_nvcc(monkeypatch, tmp_path):
    """Importing the kernels and running their plain versions builds
    nothing; asking for a build with no toolkit raises a clear error."""
    code = (
        "import torch\n"
        "from repro_torch.kernels import _cuda_build\n"
        "from repro_torch.kernels.flash_attention import flash_attention\n"
        "from repro_torch.kernels.ssd_scan import ssd_chunked\n"
        "import repro_torch.launch.serve\n"
        "q = torch.randn(1, 2, 8, 16)\n"
        "flash_attention(q, q, q)\n"
        "assert _cuda_build.load.cache_info().currsize == 0\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               PATH=os.path.dirname(sys.executable), CUDA_HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(_cuda_build.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _cuda_build.find_nvcc()


def test_model_routes_outside_k4_raise():
    """A softcap is not part of K4's contract: the flash route raises on
    it in self- and cross-attention alike, where the einsum route takes
    it."""
    cfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=32,
                      num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=64,
                      head_dim=16, attention_impl="flash",
                      logits_softcap=30.0)
    g = torch.Generator().manual_seed(0)
    p = attention.init_attention(g, cfg)
    x = torch.randn(1, 8, 32, generator=g)
    kv = attention.cross_kv(x, p, cfg)
    for kw in ({}, dict(kv_override=kv), dict(mask=True)):
        with pytest.raises(NotImplementedError, match="softcap"):
            attention.attention(x, p, cfg, **kw)
    plain = dataclasses.replace(cfg, attention_impl="xla")
    out, cache = attention.attention(x, p, plain, kv_override=kv)
    assert out.shape == x.shape and cache is None
