"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA device and imports no JAX, so it runs on a machine that has
only PyTorch, Triton and the CUDA toolkit: ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Without a card every case skips. Bounds are
those of ``tests/test_kernels.py``: for K1, rtol 1e-6 / atol 1e-6 on
``mixed``, atol 1e-6 * (max|v'| + 1) on ``v'`` (the implied step
cancels), rtol 1e-5 on the sums of squares and norms; a k-push K1 launch
equals k one-push launches bit for bit; for K2, rtol 1e-6 / atol 1e-6 on theta' and v'; rtol 1e-5 on
the sum of squares of both; for K4, 2e-5 in f32 and 2e-2 in bf16 (the
bf16 kernel rounds P to bf16 before P V); for K3 in f32, 1e-4 (f32 sums
of up to chunk x state products in another order than the plain
version's). The bf16 K3 rounds G o M, dt X and B exp(cum_Q - cum) to
bf16: it is held against ``ssd_intra_chunk_ref_bf16``, which rounds the
same operands, at 1e-4 x max(1, max|ref|) plus ``bf16_rounding_slack``
(one bf16 step where a product of G's f32 sum, taken in another order on
the tensor cores, lies on a rounding boundary), and against the unrounded
``ssd_intra_chunk_ref`` at ``bf16_bound`` (derived from bf16's unit
roundoff and the sums' lengths)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.server import AsyncParameterServer  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention, flash_attention_cuda)
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS  # noqa: E402
from repro_torch.kernels.fused_update import (  # noqa: E402
    fused_apply_cohort, fused_apply_cohort_ref, fused_apply_flat,
    fused_apply_flat_ref, fused_apply_triton, fused_momentum_gap_update,
    fused_update_flat, fused_update_flat_ref, fused_update_triton)
from repro_torch.kernels.fused_update.kernel import (  # noqa: E402
    ticket_counter)
from repro_torch.models import ssm  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    bf16_bound, bf16_rounding_slack, ssd_chunked, ssd_chunked_ref,
    ssd_intra_chunk_cuda, ssd_intra_chunk_ref, ssd_intra_chunk_ref_bf16)

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


def _cohort(n, k, seed, device, mixed=True):
    """cur, v, trained (k, n) and weights (k,) — or None — on ``device``."""
    rng = np.random.default_rng(seed)
    cur, v = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              .to(device) for _ in range(2))
    trained = torch.from_numpy(
        rng.standard_normal((k, n)).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.uniform(0.05, 1.0, k).astype(np.float32))
    return cur, v, trained, w.to(device) if mixed else None


def _assert_cohort_close(out, ref):
    (p2, v2, sums, norms), (pr, vr, sr, nr) = (
        [x.cpu().numpy() for x in o] for o in (out, ref))
    np.testing.assert_allclose(p2, pr, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        v2, vr, rtol=1e-6,
        atol=1e-6 * (float(np.abs(vr).max(initial=0.0)) + 1.0))
    np.testing.assert_allclose(sums, sr, rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(norms, nr, rtol=1e-5, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", (False, True))
@pytest.mark.parametrize("n", (1, 1029, 62006, 2 ** 20 + 3))
@pytest.mark.parametrize("k", (1, 2, 5, 16))
def test_k1_cohort_matches_plain(cuda_device, k, n, mixed):
    cur, v, trained, w = _cohort(n, k, k + n, cuda_device, mixed)
    for beta, eta in BETA_ETA:
        out = fused_apply_cohort(cur, v, trained, w, 1.0 / eta, beta,
                                 kernel="triton")
        assert out[2].shape == out[3].shape == (k + 1,)
        _assert_cohort_close(out, fused_apply_cohort_ref(
            cur, v, trained, w, 1.0 / eta, beta))


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1029, 62006, 2 ** 20 + 3))
@pytest.mark.parametrize("k", (2, 5, 16))
def test_k1_cohort_equals_single_pushes_bitwise(cuda_device, k, n):
    cur, v, trained, w = _cohort(n, k, n - k, cuda_device)
    p2, v2, sums, norms = fused_apply_cohort(cur, v, trained, w, 100.0, 0.9,
                                             kernel="triton")
    p, vv, chain_sums, chain_norms = cur, v, [], []
    for j in range(k):
        p, vv, s1, n1 = fused_apply_cohort(p, vv, trained[j:j + 1],
                                           w[j:j + 1], 100.0, 0.9,
                                           kernel="triton")
        chain_sums.append(s1[0])
        chain_norms.append(n1[0])
    chain_sums.append(s1[1])
    chain_norms.append(n1[1])
    assert torch.equal(p2, p) and torch.equal(v2, vv)
    assert torch.equal(sums, torch.stack(chain_sums))
    assert torch.equal(norms, torch.stack(chain_norms))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", ((62006, 16), (2 ** 20 + 3, 1)))
def test_k1_cohort_repeats_bitwise_and_resets_its_ticket(cuda_device, n, k):
    cur, v, trained, w = _cohort(n, k, 5, cuda_device)
    first = fused_apply_cohort(cur, v, trained, w, 100.0, 0.9,
                               kernel="triton")
    for _ in range(100):
        again = fused_apply_cohort(cur, v, trained, w, 100.0, 0.9,
                                   kernel="triton")
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    torch.cuda.synchronize()
    assert int(ticket_counter(cuda_device)) == 0


@pytest.mark.cuda
def test_k1_cohort_non_unit_weights_through_the_device_tensor(cuda_device):
    cur, v, trained, w = _cohort(4097, 4, 9, cuda_device)
    out = fused_apply_cohort(cur, v, trained, w, 10.0, 0.9)
    ones = fused_apply_cohort(cur, v, trained, None, 10.0, 0.9)
    # weights of 1: mixed is the last trained row
    assert torch.equal(ones[0], trained[-1])
    assert not torch.equal(out[0], ones[0])
    _assert_cohort_close(out, fused_apply_cohort_ref(cur, v, trained, w,
                                                     10.0, 0.9))
    _assert_cohort_close(ones, fused_apply_cohort_ref(
        cur, v, trained, torch.ones_like(w), 10.0, 0.9))
    for t in (cur, v, trained, w):       # nothing written in place
        assert t.data_ptr() not in {o.data_ptr() for o in out[:2]}


@pytest.mark.cuda
def test_k1_cohort_counts_launches_and_pushes(cuda_device):
    cur, v, trained, w = _cohort(62006, 7, 2, cuda_device)
    launches, pushes = fused_apply_triton.launches, fused_apply_triton.pushes
    fused_apply_cohort(cur, v, trained, w, 100.0, 0.9)
    fused_apply_cohort(cur, v, trained[:1], None, 100.0, 0.9)
    fused_apply_cohort(cur, v, trained, w, 100.0, 0.9, kernel="reference")
    fused_apply_flat(cur, v, trained[0], 0.5, 100.0, 0.9)
    assert fused_apply_triton.launches == launches + 3
    assert fused_apply_triton.pushes == pushes + 9


@pytest.mark.cuda
def test_k1_one_push_at_2_24_plus_17_matches_plain(cuda_device):
    n = 2 ** 24 + 17
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    cur, v = (torch.randn(n, generator=gen, device=cuda_device)
              for _ in range(2))
    trained = torch.randn((1, n), generator=gen, device=cuda_device)
    for w in (None, torch.full((1,), 0.3, device=cuda_device)):
        _assert_cohort_close(
            fused_apply_cohort(cur, v, trained, w, 100.0, 0.9,
                               kernel="triton"),
            fused_apply_cohort_ref(cur, v, trained, w, 100.0, 0.9))


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
# the serving prefill (8 x 512 tokens) of granite-moe-1b-a400m, qwen2.5-3b
# and phi4-mini-3.8b
ZOO_FLASH_SHAPES = ((8, 16, 8, 512, 64), (8, 16, 2, 512, 128),
                    (8, 24, 8, 512, 128))
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
@pytest.mark.parametrize("B,H,KV,S,d", FLASH_SHAPES + ZOO_FLASH_SHAPES)
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


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("S", (70, 165))
def test_k4_bf16_reads_strided_cache_views(cuda_device, d, S):
    """The model's prefill call: q a (B, S, H, d) activation and k/v the
    first S slots of a (B, Smax, KV, d) bf16 cache, all as (B, heads, S,
    d) views that TMA reads in place."""
    rng = np.random.default_rng(d + S)
    B, H, KV, Smax = 2, 8, 2, 200
    q = _normal(rng, (B, S, H, d), cuda_device, torch.bfloat16)
    cache = [_normal(rng, (B, Smax, KV, d), cuda_device, torch.bfloat16)
             for _ in "kv"]
    q4, k4, v4 = (t.transpose(1, 2) for t in
                  (q, cache[0][:, :S], cache[1][:, :S]))
    for causal in (True, False):
        out = flash_attention(q4, k4, v4, causal=causal, kernel="cuda")
        assert out.stride() == q4.stride()
        _assert_close(out, attention_ref(q4, k4, v4, causal=causal), 2e-2)
    flat = torch.zeros(B * H * S * d + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:].view(B, H, S, d)       # a 2-byte offset: not for TMA
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(shifted, k4, v4, kernel="cuda")


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


def _check_k3_bf16(args, chunk):
    """The bf16 K3 on ``args`` (the 4-D form) against the rounded and the
    unrounded plain versions, at the bounds of the module docstring."""
    got = ssd_intra_chunk_cuda(*args, chunk=chunk)
    comp = ssd_intra_chunk_ref_bf16(*args, chunk=chunk)
    ref = ssd_intra_chunk_ref(*args, chunk=chunk)
    slack = (bf16_rounding_slack(*args, chunk=chunk), 0.0, 0.0, 0.0)
    bound = bf16_bound(*args, chunk=chunk)
    for i, (a, c, r, sl) in enumerate(zip(got, comp, ref, slack)):
        assert torch.isfinite(a).all()
        tol = 1e-4 * max(1.0, float(c.abs().max()))
        assert bool(torch.all((a - c).abs() <= tol + sl)), (
            i, float((a - c).abs().max()), tol)
        if i < 2:
            assert bool(torch.all((a - r).abs() <= bound[i])), i
        else:
            _assert_close(a, r, 1e-4)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("per_head", (False, True))
@pytest.mark.parametrize("B,S,nh,ph,s,chunk", SSD_SHAPES)
def test_k3_bf16_kernel_matches_rounded_plain(cuda_device, B, S, nh, ph, s,
                                              chunk, per_head):
    """The bf16 K3 at the TestSSDScan shapes on the model's views: X
    (B, S, nh, ph) and B/C (B, S, g, s) moved to (B, heads, S, .) without
    a copy, one group (Mamba2's) or one per head."""
    rng = np.random.default_rng(B + S + nh + per_head)
    g = nh if per_head else 1
    X, dtv, A, _, _ = _ssd_inputs(rng, B, S, nh, ph, s, cuda_device,
                                  torch.bfloat16)
    Bg, Cg = (_normal(rng, (B, S, g, s), cuda_device, torch.bfloat16, 0.5)
              for _ in "BC")
    before = ssd_intra_chunk_cuda.launches
    _check_k3_bf16((X.movedim(2, 1), dtv.movedim(2, 1), A,
                    Bg.movedim(2, 1), Cg.movedim(2, 1)), chunk)
    assert ssd_intra_chunk_cuda.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("g", (1, 2))
def test_k3_f32_group_shared_matches_recurrence(cuda_device, g):
    """The f32 K3 reads a group's B and C for its heads: the scan equals
    the sequential recurrence on B and C repeated over the heads."""
    rng = np.random.default_rng(g)
    B, S, nh, ph, s = 2, 64, 4, 16, 32
    X, dtv, A, _, _ = _ssd_inputs(rng, B, S, nh, ph, s, cuda_device)
    Bg, Cg = (_normal(rng, (B, S, g, s), cuda_device, scale=0.5)
              for _ in "BC")
    y, final = ssd_chunked(X, dtv, A, Bg, Cg, 16, kernel="cuda")
    yr, fr = ssd_chunked_ref(X, dtv, A,
                             *(t.repeat_interleave(nh // g, dim=2)
                               for t in (Bg, Cg)))
    _assert_close(y, yr, 1e-4)
    _assert_close(final, fr, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_k3_f32_long_chunk_matches_recurrence(cuda_device, seed):
    """A 256-step chunk (S = 300, padded to 512 by the model's
    ssd_chunked) in f32: cum reaches ~-200, where an f32 scan moves
    exp(cum_t - cum_u) by ~1e-4; the kernel takes cum in f64 and holds
    the sequential recurrence at 1e-4."""
    X, dtv, A, Bh, Ch = _ssd_inputs(np.random.default_rng(seed), 1, 300, 4,
                                    64, 128, cuda_device)
    y, final = ssm.ssd_chunked(X, dtv, A, Bh, Ch, 256, kernel="cuda")
    yr, fr = ssd_chunked_ref(X, dtv, A, Bh, Ch)
    _assert_close(y, yr, 1e-4)
    _assert_close(final, fr, 1e-4)


@pytest.mark.cuda
def test_k3_serving_shape_bf16_and_continuation(cuda_device):
    rng = np.random.default_rng(7)
    # Mamba2-370m's prefill: batch 8 x 32 heads of one group, 512 tokens,
    # chunk 256, on the model's (B, S, heads, .) layout
    B, S, nh, ph, s, Q = 8, 512, 32, 64, 128, 256
    X = _normal(rng, (B, S, nh, ph), cuda_device, torch.bfloat16)
    dtv = torch.nn.functional.softplus(_normal(rng, (B, S, nh), cuda_device))
    A = -torch.linspace(1.0, 16.0, nh, device=cuda_device)
    Bg, Cg = (_normal(rng, (B, S, 1, s), cuda_device, torch.bfloat16, 0.5)
              for _ in "BC")
    before = ssd_intra_chunk_cuda.launches
    _check_k3_bf16((X.movedim(2, 1), dtv.movedim(2, 1), A,
                    Bg.movedim(2, 1), Cg.movedim(2, 1)), Q)
    assert ssd_intra_chunk_cuda.launches == before + 1
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


# ---------------------------------------------------------------------------
# The aggregation rules through K1, and the LeNet backend's repeatability
# ---------------------------------------------------------------------------
def _lenet_backend(rule, kernel, device, seed=0, n=20):
    from repro_torch.core.fleet import resolve_fleet
    from repro_torch.core.realml import LeNetBackend
    b = LeNetBackend(n, n_train=2000, n_test=64, seed=seed, aggregation=rule,
                     kernel=kernel, device=device)
    b.bind_fleet(resolve_fleet("paper").build(np.random.default_rng(0), n))
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("k", (1, 3, 16))
def test_gap_aware_per_push_k1_matches_plain_chain(cuda_device, k):
    """gap_aware: one one-push K1 launch a push, each weight computed on the
    card from the previous launch's norm, against the same chain through
    the plain K1 on the card."""
    from repro_torch.core.aggregation import GapAwareRule
    from repro_torch.core.realml import gap_aware_pushes
    cur, v, trained, _ = _cohort(62006, k, 40 + k, cuda_device)
    lags = np.arange(k) % 4 + 1
    uids = np.arange(k)
    rule = GapAwareRule(0.5)
    vn0 = torch.linalg.vector_norm(v).reshape(1)
    launches, pushes = fused_apply_triton.launches, fused_apply_triton.pushes
    out = gap_aware_pushes(cur, v, trained, lags, vn0, rule, None, uids,
                           0.01, 0.9, 100.0, "triton")
    assert fused_apply_triton.launches == launches + k
    assert fused_apply_triton.pushes == pushes + k
    ref = gap_aware_pushes(cur, v, trained, lags, vn0, rule, None, uids,
                           0.01, 0.9, 100.0, "reference")
    p2, v2, pre, w, fin = (x.cpu().numpy() for x in out)
    pr, vr, prer, wr, finr = (x.cpu().numpy() for x in ref)
    np.testing.assert_allclose(p2, pr, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v2, vr, rtol=1e-6,
                               atol=1e-6 * (float(np.abs(vr).max()) + 1.0))
    np.testing.assert_allclose(pre, prer, rtol=1e-5)
    np.testing.assert_allclose(w, wr, rtol=1e-6)
    np.testing.assert_allclose(fin, finr, rtol=1e-5)
    assert w.min() < 1.0 and all(x.is_cuda for x in out)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ("fedasync_poly", "hetero_aware",
                                  "gap_aware"))
def test_lenet_finish_under_rules_matches_plain_k1(cuda_device, rule):
    """The finish on the card with K1 against the same finish with the
    plain K1: launches = chunks (fedasync_poly/hetero_aware, non-unit
    weights from the cohort's device tensor) or = pushes (gap_aware)."""
    uids = np.arange(20)[::-1].copy()
    lags = np.arange(20) % 5
    a = _lenet_backend(rule, "auto", cuda_device)
    b = _lenet_backend(rule, "reference", cuda_device)
    for be in (a, b):
        be.pull_batch(uids, 0)
    launches, pushes = fused_apply_triton.launches, fused_apply_triton.pushes
    gaps, weights = a.finish_async_batch(uids, np.zeros(20, np.int64), lags,
                                         0.01, 0.9)
    n_launch = fused_apply_triton.launches - launches
    assert n_launch == (20 if rule == "gap_aware" else 2)   # chunks 16 + 4
    assert fused_apply_triton.pushes - pushes == 20
    gr, wr = b.finish_async_batch(uids, np.zeros(20, np.int64), lags, 0.01,
                                  0.9)
    assert fused_apply_triton.launches - launches == n_launch
    assert weights.min() < 1.0
    np.testing.assert_allclose(weights, wr, rtol=1e-6)
    np.testing.assert_allclose(gaps, gr, rtol=1e-5, atol=1e-9)
    pa, pb = a.server.params.cpu().numpy(), b.server.params.cpu().numpy()
    np.testing.assert_allclose(pa, pb, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_two_card_runs_of_a_lenet_schedule_repeat(cuda_device):
    """The model's convolutions are im2col and a matmul on the card: two
    runs of the same short online schedule give the same push log,
    accuracy and model."""
    from repro_torch.core import Scenario
    runs = []
    for _ in range(2):
        sim = Scenario(policy="online", ml="lenet", n_users=12,
                       horizon_s=900, V=5.0, app_arrival_p=0.004, seed=0,
                       ml_kwargs=dict(n_train=3000, n_test=500,
                                      eval_every=300)).build()
        res = sim.run()
        runs.append((res, sim.ml_backend.server.params.cpu()))
    (r1, p1), (r2, p2) = runs
    assert r1.updates > 0
    assert list(r1.push_log) == list(r2.push_log)
    assert r1.accuracy == r2.accuracy
    assert torch.equal(p1, p2)


@pytest.mark.cuda
def test_im2col_conv_on_the_card_matches_the_cpu(cuda_device):
    """LeNet's logits and loss gradient on the card (im2col + matmul) against
    the CPU's (F.conv2d), TF32 off."""
    from repro_torch.models.lenet import init_lenet, lenet_logits, lenet_loss
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((8, 32, 32, 3))
                             .astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 10, 8))
        p = init_lenet(torch.Generator().manual_seed(1))
        for fn in (lenet_logits, lambda p_, x_: torch.autograd.grad(
                lenet_loss(p_.requires_grad_(), x_, y.to(x_.device)), p_)[0]):
            got = fn(p.to(cuda_device), x.to(cuda_device)).cpu()
            want = fn(p.clone(), x)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("n", (62006, 379774))     # LeNet, the MLP
def test_k1_one_push_through_the_server_matches_plain(cuda_device, n):
    """The loop path's push: ``AsyncParameterServer.push`` launches K1 once
    a push; p', v' and the norm against the plain K1's chain on the card
    (the K1 bounds), the server's logged gap the Eq. 4 gap of the plain
    chain's pre-push norm."""
    from repro_torch.core.staleness import gradient_gap
    rng = np.random.default_rng(n)
    p0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    pushes = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              .to(cuda_device) for _ in range(4)]
    srv = AsyncParameterServer(p0, eta=0.01, beta=0.9, device=cuda_device)
    p, v = srv.params, torch.zeros_like(srv.params)
    vn = 0.0
    for j in range(len(pushes)):
        srv.pull(j)                 # push j then lands with lag j
    for j, new in enumerate(pushes):
        before = fused_apply_triton.launches
        res = srv.push(j, new)
        assert fused_apply_triton.launches == before + 1
        assert res.lag == j
        assert res.gap_estimate == pytest.approx(
            gradient_gap(vn, j, 0.01, 0.9), rel=1e-5)
        p, v, sq = fused_apply_flat_ref(p, v, new, 1.0, 100.0, 0.9)
        vn = float(torch.sqrt(sq))
        m, v2 = srv.params.cpu().numpy(), srv._v.cpu().numpy()
        pr, vr = p.cpu().numpy(), v.cpu().numpy()
        np.testing.assert_allclose(m, pr, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            v2, vr, rtol=1e-6, atol=1e-6 * (float(np.abs(vr).max()) + 1.0))
        assert srv.v_norm == pytest.approx(vn, rel=1e-5)
        assert res.version == j + 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", (1, 16))
def test_mlp_cohort_finish_equals_chained_one_push_launches(cuda_device, k):
    """``MLPBackend``'s cohort finish (one K1 launch for the chunk) against
    the same trained models pushed by k one-push K1 launches: p', v' and
    every norm bit for bit."""
    from repro_torch.core.realml import MLPBackend
    b = MLPBackend(k, n_train=100 * k, n_test=32, device=cuda_device)
    uids = np.arange(k)[::-1].copy()
    b.pull_batch(uids, 0)
    p0, v0 = b.server.params, b.server._v
    captured = []
    train = b._train

    def keep(*a):
        out = train(*a)
        captured.append(out)
        return out

    b._train = keep
    lags = np.arange(k) % 3
    launches = fused_apply_triton.launches
    gaps, _ = b.finish_async_batch(uids, np.zeros(k, np.int64), lags, 0.01,
                                   0.9)
    assert fused_apply_triton.launches == launches + 1
    (trained,) = captured
    assert trained.shape == (k, 379774)
    p, v, norms = p0, v0, []
    for j in range(k):
        p, v, _, n1 = fused_apply_cohort(p, v, trained[j:j + 1], None,
                                         100.0, 0.9, kernel="triton")
        norms.append(n1[0])
    assert torch.equal(b.server.params, p) and torch.equal(b.server._v, v)
    assert torch.equal(b.server.v_norm.reshape(1), n1[1:])
    from repro_torch.core.staleness import gradient_gap
    pre = torch.stack(norms).cpu().numpy().astype(np.float64)
    assert np.array_equal(gaps, gradient_gap(pre, lags, 0.01, 0.9))
    assert float(b.server.v_norm) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ("replace", "fedasync_poly"))
def test_sharded_server_k1_per_shard_equals_unsharded(cuda_device, rule):
    """At LeNet's n = 62,006 in 4 shards: one K1 launch a shard a push,
    and p' and v' equal the unsharded server's (one launch a push) bit
    for bit after every push; v_norm within rel 1e-4 (its sums reduce in
    another order)."""
    from repro_torch.serve import ShardedAsyncParameterServer
    n, shards = 62006, 4
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = {"a": torch.randn(n - 6, generator=gen, device="cuda"),
              "b": torch.randn(2, 3, generator=gen, device="cuda")}
    core = AsyncParameterServer(params, eta=0.05, beta=0.9,
                                aggregation=rule, device="cuda")
    shd = ShardedAsyncParameterServer(params, eta=0.05, beta=0.9,
                                      aggregation=rule, n_shards=shards,
                                      device="cuda")
    core.pull(1)
    shd.pull(1)
    for step in range(6):
        cid = step % 2
        p, _ = shd.pull(cid)
        core.pull(cid)
        new = {k: x + 0.01 * torch.randn(x.shape, generator=gen,
                                         device="cuda")
               for k, x in p.items()}
        before = fused_apply_triton.launches
        rc = core.push(cid, new)
        assert fused_apply_triton.launches == before + 1
        rs = shd.push(cid, new)
        assert fused_apply_triton.launches == before + 1 + shards
        assert (rc.lag, rc.applied_weight) == (rs.lag, rs.applied_weight)
        flat = shd.spec.join(shd.snapshot_flat()[0])
        mom = torch.cat([st.momentum for st in shd._shards])
        assert torch.equal(flat, shd.spec.flatten(core.params))
        assert torch.equal(mom, shd.spec.flatten(core._v))
        assert shd.v_norm == pytest.approx(core.v_norm, rel=1e-4)
    shd.assert_consistent()
    assert int(ticket_counter("cuda")) == 0


@pytest.mark.cuda
def test_bf16_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    gen = torch.Generator(device="cuda").manual_seed(3)
    tree = {"w": torch.randn(64, 33, generator=gen, device="cuda")
            .bfloat16(),
            "v": torch.randn(1000, generator=gen, device="cuda"),
            "step": torch.tensor(5, dtype=torch.int32, device="cuda")}
    c = Checkpointer(str(tmp_path))
    try:
        c.save(tree, 9)
    finally:
        c.wait()
    template = {k: torch.zeros_like(x) for k, x in tree.items()}
    restored, step = c.restore(template)
    assert step == 9
    for k, x in tree.items():
        assert restored[k].device == x.device and restored[k].dtype == x.dtype
        assert torch.equal(restored[k], x)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", ((1000, 10), (62006, 620), (2 ** 20, 7)))
def test_topk_compress_on_cuda_matches_cpu(cuda_device, n, k):
    """Distinct magnitudes (a permutation of evenly spaced values): the
    card keeps the same entries as the CPU."""
    from repro_torch.optim.compression import topk_compress, topk_decompress
    rng = np.random.default_rng(n)
    x = (rng.permutation(n) + 1).astype(np.float32) / n
    x *= rng.choice([-1.0, 1.0], n).astype(np.float32)
    ours = topk_compress(torch.from_numpy(x).to(cuda_device), k)
    cpu = topk_compress(torch.from_numpy(x), k)
    assert ours.values.is_cuda and ours.indices.dtype == torch.int32
    assert torch.equal(torch.sort(ours.indices.cpu()).values,
                       torch.sort(cpu.indices).values)
    assert torch.equal(topk_decompress(ours).cpu(), topk_decompress(cpu))


def _replay_args(B, n, H, seed, device):
    """Online's replay operands with ties on purpose (base == rhs and an
    idle gap equal to a gap_vec entry for a third of the users)."""
    rng = np.random.default_rng(seed)
    powers = np.array([0.3, 0.55, 1.2, 2.4])
    rhs = 4000.0 * rng.choice(powers, (B, n))
    base = 4000.0 * rng.choice(powers, (B, n)) - 7.0
    lag = (3 + np.arange(n + 1)).astype(float)
    gap_vec = np.tile(0.01 * (1.0 - 0.9 ** lag) / 0.1, (B, 1))
    gap_idle = rng.choice([0.05, 0.1, 0.5], (B, n))
    tie = rng.random((B, n)) < 1 / 3
    base = np.where(tie, rhs, base)
    k = rng.integers(0, n + 1, (B, n))
    gap_idle = np.where(tie, np.take_along_axis(gap_vec, k, 1), gap_idle)
    t = lambda a, dt: torch.as_tensor(a).to(device, dt)
    return (t(rng.random((B, n)) < 0.7, torch.bool),
            t(base, torch.float64), t(rhs, torch.float64),
            t(gap_idle, torch.float64), t(gap_vec, torch.float64),
            t(np.full(B, H), torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", ((1, 0), (1, 1), (16, 1029), (1, 100_000)))
@pytest.mark.parametrize("H", (0.0, 37.5))
def test_online_replay_kernel_matches_plain_bitwise(cuda_device, B, n, H):
    """Online's in-slot replay (CUDA C++) against its plain version on the
    same CUDA tensors: start and gap_sum bit for bit."""
    from repro_torch.kernels.online_replay import (online_replay,
                                                   online_replay_cuda)
    args = _replay_args(B, n, H, n + B, cuda_device)
    before = online_replay_cuda.launches
    ks, kg = online_replay(*args, kernel="cuda")
    rows = online_replay_cuda.last_rows.cpu().numpy()
    ps, pg = online_replay(*args, kernel="reference")
    torch.cuda.synchronize()
    assert online_replay_cuda.launches == before + 1
    assert ks.is_cuda and torch.equal(ks, ps)
    assert torch.equal(kg.view(torch.int64), pg.view(torch.int64))
    np.testing.assert_array_equal(rows, _replay_rows(args))


def _replay_rows(args):
    from repro_torch.kernels.online_replay import online_replay_rows_ref
    return online_replay_rows_ref(*args).numpy()


def _replay_edge_args(kind, device):
    """Rows that take each path and sit on the kernel's edges: an unsorted
    gap_vec (the literal walk); 16 rows, sorted and unsorted mixed; a row
    whose waiting users are all undecided but the first; every user
    waiting at 8,191, 8,193 and 16,385 (numpy's 8,192-operand blocks)."""
    rng = np.random.default_rng(len(kind))
    if kind == "undecided":
        n = 3000
        r = np.full((1, n), 4000.0)
        gv = 1e-3 * (3.0 + np.arange(n + 1))[None]
        k = rng.integers(0, np.maximum(np.arange(n), 1))[None]
        args = (np.ones((1, n), bool), r.copy(), r, gv[:, k[0]], gv,
                np.full(1, 1.0))
    else:
        B, n = {"unsorted": (1, 2000), "mixed16": (16, 1500)}[kind] \
            if kind[0] != "w" else (1, int(kind[1:]))
        w, b, r, gi, gv, H = (t.cpu().numpy() for t in
                              _replay_args(B, n, 37.5, n + B, "cpu"))
        if kind[0] == "w":
            w = np.ones_like(w)
        else:   # strictly increasing, so that reversed it descends early
            gv = np.tile(1e-3 * (3.0 + np.arange(n + 1)), (B, 1))
            base_tie = b == r
            k = rng.integers(0, n + 1, (B, n))
            gi = np.where(base_tie, np.take_along_axis(gv, k, 1), gi)
        flip = np.ones(B, bool) if kind == "unsorted" else (
            rng.random(B) < 0.5 if kind == "mixed16" else np.zeros(B, bool))
        if kind == "mixed16":
            flip[:2] = (True, False)
        gv = np.where(flip[:, None], gv[:, ::-1], gv)
        args = (w, b, r, gi, gv, H)
    dt = (torch.bool,) + (torch.float64,) * 5
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(device, d)
                 for a, d in zip(args, dt))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("unsorted", "mixed16", "undecided",
                                  "w8191", "w8193", "w16385"))
def test_online_replay_kernel_paths_and_edges(cuda_device, kind):
    """Both paths of the replay kernel against its plain version, start
    and gap_sum bit for bit; the path each row took and its counts as the
    inputs give them; the per-device path counters."""
    from repro_torch.kernels.online_replay import (
        online_replay, online_replay_cuda, path_rows, reset_path_rows)
    args = _replay_edge_args(kind, cuda_device)
    reset_path_rows(cuda_device)
    ks, kg = online_replay(*args, kernel="cuda")
    rows = online_replay_cuda.last_rows.cpu().numpy()
    ps, pg = online_replay(*args, kernel="reference")
    torch.cuda.synchronize()
    assert torch.equal(ks, ps)
    assert torch.equal(kg.view(torch.int64), pg.view(torch.int64))
    want = _replay_rows(args)
    np.testing.assert_array_equal(rows, want)
    literal = int((want[:, 0] == 0).sum())
    assert path_rows(cuda_device) == (len(want) - literal, literal)
    if kind == "unsorted":
        assert literal == 1
    if kind == "mixed16":
        assert (want[0, 0], want[1, 0]) == (0, 1)
    if kind == "undecided":
        assert want[0, 3] == want[0, 1] - 1


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ("online", "eps_greedy"))
def test_scan_engine_on_the_card_matches_numpy_engine(cuda_device, policy):
    """A short scan run on the card (L_b = 2.0, so online's replay walks
    with H > 0; a gap-aware push log; chunks of 100 slots) against the
    numpy engine: schedule (t, user, lag, corun) equal, energy and mean_Q
    at rel 1e-9, mean_H at rel 1e-6, gaps and weights at rtol 1e-9."""
    from repro_torch.core import Scenario
    from repro_torch.kernels.online_replay import online_replay_cuda
    kw = dict(policy=policy, n_users=10, horizon_s=600, app_arrival_p=0.01,
              seed=11, V=2000.0, L_b=2.0, aggregation="gap_aware")
    online_replay_cuda.launches = 0
    res = Scenario(engine="jax", jax_chunk=100, **kw).run(device="cuda")
    ref = Scenario(engine="vectorized", **kw).run()
    assert online_replay_cuda.launches == (600 if policy == "online" else 0)
    key = lambda log: [(e["t"], e["user"], e["lag"], e["corun"]) for e in log]
    assert key(res.push_log) == key(ref.push_log) and res.updates > 0
    assert res.energy_j == pytest.approx(ref.energy_j, rel=1e-9)
    assert res.mean_Q == pytest.approx(ref.mean_Q, rel=1e-9, abs=1e-12)
    assert res.mean_H == pytest.approx(ref.mean_H, rel=1e-6, abs=1e-9)
    for col in ("gap", "weight"):
        np.testing.assert_allclose(res.push_log.field(col),
                                   ref.push_log.field(col), rtol=1e-9,
                                   atol=1e-15)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ("online", "eps_greedy"))
@pytest.mark.parametrize("dynamics", ("none", "markov"))
def test_scan_engine_padded_users_on_the_card_bitwise(cuda_device, policy,
                                                      dynamics):
    """The scan engine on the card with its user axis padded past n (the
    internal ``n_arr``) and with ``n_devices=1`` equals the plain run bit
    for bit: push log, traces, every live user's final state."""
    import dataclasses
    from repro_torch.core import FederatedSim, SimConfig, vector_engine
    cfg = SimConfig(policy=policy, dynamics=dynamics, n_users=10,
                    horizon_s=600, app_arrival_p=0.01, seed=11, V=2000.0,
                    L_b=2.0, engine="jax", jax_chunk=100)
    runs = []
    for n_arr, over in ((0, {}), (13, {}), (0, {"n_devices": 1})):
        sim = FederatedSim(dataclasses.replace(cfg, **over), device="cuda")
        res = vector_engine._Scan([sim], cuda_device, n_arr=n_arr).run()[0]
        runs.append((res, sim))
    (ref, rsim), *rest = runs
    assert ref.updates > 0
    for res, sim in rest:
        assert list(res.push_log) == list(ref.push_log)
        assert (res.energy_j, res.mean_Q, res.mean_H, res.drops) == \
            (ref.energy_j, ref.mean_Q, ref.mean_H, ref.drops)
        for f in ("trace_Q", "trace_H", "trace_energy"):
            np.testing.assert_array_equal(getattr(res, f), getattr(ref, f))
        for f in ("mode", "energy", "updates", "idle_gap", "pulled_at"):
            np.testing.assert_array_equal(getattr(sim.state, f),
                                          getattr(rsim.state, f))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("granite-moe-1b-a400m",
                                  "qwen3-moe-30b-a3b"))
def test_moe_smoke_model_on_the_card_matches_the_cpu(cuda_device, arch):
    """The MoE smoke model in f32 on the card (the flash route: K4's
    CUDA-core form) against the same parameters on the CPU (K4's plain
    version): a 32-token prefill (the sorted dispatch) and two decode
    steps (the dense combine), logits at 1e-4 x max(1, max|ref|)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.fused_update.ops import tree_map
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              attention_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)))
    out = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(dev), params)
        with torch.inference_mode():
            cache = model.init_cache(2, 35, device=dev)
            logits, cache = model.prefill(p, {"tokens": tokens.to(dev)},
                                          cache)
            steps = [logits]
            for i in range(2):      # the same tokens on both devices
                logits, cache = model.decode_step(
                    p, cache, {"tokens": tokens[:, i:i + 1].to(dev)})
                steps.append(logits)
        out[str(dev)] = [t.cpu() for t in steps]
    for a, b in zip(out["cuda"], out["cpu"]):
        _assert_close(a, b, 1e-4, scaled=True)
