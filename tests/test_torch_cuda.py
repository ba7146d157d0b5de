"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA device and imports no JAX, so it runs on a machine that has
only PyTorch, Triton and the CUDA toolkit: ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Without a card every case skips. Bounds are
those of ``tests/test_kernels.py``: for K1, rtol 1e-6 / atol 1e-6 on
``mixed``, atol 1e-6 * (max|v'| + 1) on ``v'`` (the implied step
cancels); for K2, rtol 1e-6 / atol 1e-6 on theta' and v'; rtol 1e-5 on
the sum of squares of both; for K4, 2e-5 in f32 and 2e-2 in bf16; for
K3, 1e-4 (f32 sums of up to chunk x state products in another order than
the plain version's), with atol scaled by max(1, max|ref|) at the serving
shape, whose outputs reach ~40."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.server import AsyncParameterServer  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention, flash_attention_cuda)
from repro_torch.kernels.fused_update import (  # noqa: E402
    fused_apply_flat, fused_apply_flat_ref, fused_apply_triton,
    fused_momentum_gap_update, fused_update_flat, fused_update_flat_ref,
    fused_update_triton)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_chunked, ssd_chunked_ref, ssd_intra_chunk_cuda, ssd_intra_chunk_ref)

WEIGHTS = (1.0, 0.6, 0.05)
BETA_ETA = ((0.9, 0.01), (0.0, 0.5), (0.99, 1e-4))
K2_ETA_BETA = ((0.01, 0.9), (0.05, 0.9), (0.1, 0.0))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton and CUDA C++ kernels "
                    "run only on the card")
    return torch.device("cuda")


def _inputs(n, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            .to(device) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 1029, 62006, 2 ** 20 + 3))
def test_triton_kernel_matches_plain(cuda_device, n):
    cur, v, new = _inputs(n, n, cuda_device)
    for w, (beta, eta) in zip(WEIGHTS, BETA_ETA):
        m, v2, sq = (x.cpu().numpy() for x in fused_apply_flat(
            cur, v, new, w, 1.0 / eta, beta, kernel="triton"))
        mr, vr, sqr = (x.cpu().numpy() for x in fused_apply_flat_ref(
            cur, v, new, w, 1.0 / eta, beta))
        np.testing.assert_allclose(m, mr, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            v2, vr, rtol=1e-6, atol=1e-6 * (float(np.abs(vr).max()) + 1.0))
        assert float(sq) == pytest.approx(float(sqr), rel=1e-5)


@pytest.mark.cuda
def test_auto_launches_the_kernel_on_cuda_tensors(cuda_device):
    cur, v, new = _inputs(4097, 0, cuda_device)
    before = fused_apply_triton.launches
    fused_apply_flat(cur, v, new, 0.5, 10.0, 0.9)
    fused_apply_flat(cur, v, new, 0.5, 10.0, 0.9, kernel="reference")
    assert fused_apply_triton.launches == before + 1


@pytest.mark.cuda
def test_default_server_lives_on_cuda(cuda_device):
    server = AsyncParameterServer(torch.zeros(300), eta=0.01, beta=0.9)
    assert server.params.is_cuda
    before = fused_apply_triton.launches
    server.push(0, torch.ones(300, device=cuda_device))
    assert fused_apply_triton.launches == before + 1
    assert server.v_norm == pytest.approx(
        float(torch.linalg.vector_norm(torch.full((300,), 10.0))), rel=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 1029, 82304, 2 ** 20 + 3))
def test_k2_triton_kernel_matches_plain(cuda_device, n):
    theta, v, g = _inputs(n, n, cuda_device)
    for eta, beta in K2_ETA_BETA:
        t2, v2, sq = (x.cpu().numpy() for x in fused_update_flat(
            theta, v, g, eta, beta, kernel="triton"))
        tr, vr, sqr = (x.cpu().numpy() for x in fused_update_flat_ref(
            theta, v, g, eta, beta))
        np.testing.assert_allclose(t2, tr, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(v2, vr, rtol=1e-6, atol=1e-6)
        assert float(sq) == pytest.approx(float(sqr), rel=1e-5)


@pytest.mark.cuda
def test_k2_leaves_its_inputs_and_counts_launches(cuda_device):
    theta, v, g = _inputs(4097, 1, cuda_device)
    before = [t.clone() for t in (theta, v, g)]
    launches = fused_update_triton.launches
    t2, v2, _ = fused_update_flat(theta, v, g, 0.05, 0.9)
    fused_update_flat(theta, v, g, 0.05, 0.9, kernel="reference")
    p2, nv, gap = fused_momentum_gap_update(theta, v, g, eta=0.05, beta=0.9,
                                            lag=3)
    assert fused_update_triton.launches == launches + 2
    ptrs = {t.data_ptr() for t in (theta, v, g)}
    assert not ptrs & {t2.data_ptr(), v2.data_ptr(), p2.data_ptr(),
                       nv.data_ptr()}
    for t, b in zip((theta, v, g), before):
        assert torch.equal(t, b)
    scale = 0.05 * (1 - 0.9 ** 3) / (1 - 0.9)
    assert float(gap) == pytest.approx(
        scale * float(torch.linalg.vector_norm(v2)), rel=1e-5)


# ---------------------------------------------------------------- K4, K3
FLASH_SHAPES = ((1, 4, 4, 256, 64), (2, 8, 2, 256, 128), (1, 4, 2, 384, 64),
                (1, 2, 1, 512, 32), (1, 4, 2, 200, 64), (2, 4, 2, 37, 16))
SSD_SHAPES = ((2, 64, 4, 16, 16, 16), (1, 128, 2, 32, 64, 32),
              (2, 96, 3, 8, 24, 32), (1, 64, 8, 64, 128, 16))


def _normal(rng, shape, device, dtype=torch.float32, scale=1.0):
    return (scale * torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))).to(device, dtype)


def _assert_close(a, b, tol, scaled=False):
    atol = tol * max(1.0, float(b.abs().max())) if scaled else tol
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", ((torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)))
@pytest.mark.parametrize("B,H,KV,S,d", FLASH_SHAPES)
def test_k4_cuda_kernel_matches_plain(cuda_device, B, H, KV, S, d, dtype,
                                      tol):
    rng = np.random.default_rng(B * H * S)
    q = _normal(rng, (B, H, S, d), cuda_device, dtype)
    k, v = (_normal(rng, (B, KV, S, d), cuda_device, dtype) for _ in "kv")
    for causal in (True, False):
        out = flash_attention(q, k, v, causal=causal, kernel="cuda")
        assert out.dtype == dtype and out.shape == q.shape
        _assert_close(out, attention_ref(q, k, v, causal=causal), tol)


@pytest.mark.cuda
def test_k4_reads_strided_layouts_and_counts_launches(cuda_device):
    rng = np.random.default_rng(3)
    # the model's (B, S, heads, d) activations, viewed as (B, heads, S, d)
    q = _normal(rng, (2, 70, 8, 64), cuda_device).transpose(1, 2)
    k, v = (_normal(rng, (2, 70, 2, 64), cuda_device).transpose(1, 2)
            for _ in "kv")
    before = flash_attention_cuda.launches
    out = flash_attention(q, k, v)
    flash_attention(q, k, v, kernel="reference")
    assert flash_attention_cuda.launches == before + 1
    assert out.stride() == q.stride()
    _assert_close(out, attention_ref(q, k, v), 2e-5)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q[:, :, :10], k, v, kernel="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.requires_grad_(True), k, v, kernel="cuda")


def _ssd_inputs(rng, B, S, nh, ph, s, device, dtype=torch.float32):
    X = _normal(rng, (B, S, nh, ph), device, dtype)
    dtv = torch.nn.functional.softplus(_normal(rng, (B, S, nh), device))
    A = -torch.exp(_normal(rng, (nh,), device, scale=0.3))
    Bh, Ch = (_normal(rng, (B, S, nh, s), device, dtype, scale=0.5)
              for _ in "BC")
    return X, dtv, A, Bh, Ch


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,ph,s,chunk", SSD_SHAPES)
def test_k3_cuda_kernel_matches_plain_and_recurrence(cuda_device, B, S, nh,
                                                     ph, s, chunk):
    X, dtv, A, Bh, Ch = _ssd_inputs(np.random.default_rng(B + S + nh), B, S,
                                    nh, ph, s, cuda_device)
    fold = [t.movedim(2, 1).reshape(B * nh, S, -1).contiguous()
            for t in (X, Bh, Ch)]
    dtf = dtv.movedim(2, 1).reshape(B * nh, S).contiguous()
    Af = A.repeat(B)
    got = ssd_intra_chunk_cuda(fold[0], dtf, Af, *fold[1:], chunk=chunk)
    ref = ssd_intra_chunk_ref(fold[0], dtf, Af, *fold[1:], chunk=chunk)
    for a, b in zip(got, ref):
        _assert_close(a, b, 1e-4)
    y, final = ssd_chunked(X, dtv, A, Bh, Ch, chunk, kernel="cuda")
    yr, fr = ssd_chunked_ref(X, dtv, A, Bh, Ch)
    _assert_close(y, yr, 1e-4)
    _assert_close(final, fr, 1e-4)


@pytest.mark.cuda
def test_k3_serving_shape_bf16_and_continuation(cuda_device):
    rng = np.random.default_rng(7)
    # Mamba2-370m's prefill: batch 8 x 32 heads, 512 tokens, chunk 256
    BH, S, ph, s, Q = 256, 512, 64, 128, 256
    X = _normal(rng, (BH, S, ph), cuda_device, torch.bfloat16)
    dtv = torch.nn.functional.softplus(_normal(rng, (BH, S), cuda_device))
    A = -torch.linspace(1.0, 16.0, 32, device=cuda_device).repeat(8)
    Bh, Ch = (_normal(rng, (BH, S, s), cuda_device, torch.bfloat16, 0.5)
              for _ in "BC")
    before = ssd_intra_chunk_cuda.launches
    got = ssd_intra_chunk_cuda(X, dtv, A, Bh, Ch, chunk=Q)
    assert ssd_intra_chunk_cuda.launches == before + 1
    for a, b in zip(got, ssd_intra_chunk_ref(X, dtv, A, Bh, Ch, chunk=Q)):
        assert torch.isfinite(a).all()
        _assert_close(a, b, 1e-4, scaled=True)
    # prefill continuation: two halves with the state carried == one call
    X, dtv, A, Bh, Ch = _ssd_inputs(rng, 1, 64, 2, 8, 16, cuda_device)
    y_all, f_all = ssd_chunked(X, dtv, A, Bh, Ch, 16)
    y1, f1 = ssd_chunked(X[:, :32], dtv[:, :32], A, Bh[:, :32], Ch[:, :32],
                         16)
    y2, f2 = ssd_chunked(X[:, 32:], dtv[:, 32:], A, Bh[:, 32:], Ch[:, 32:],
                         16, init_state=f1)
    _assert_close(y2, y_all[:, 32:], 1e-4)
    _assert_close(f2, f_all, 1e-4)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_chunked(X.requires_grad_(True), dtv, A, Bh, Ch, 16)
