"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA device and imports no JAX, so it runs on a machine that has
only PyTorch and Triton: ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Without a card every case skips. Bounds are
those of ``tests/test_kernels.py``: for K1, rtol 1e-6 / atol 1e-6 on
``mixed``, atol 1e-6 * (max|v'| + 1) on ``v'`` (the implied step
cancels); for K2, rtol 1e-6 / atol 1e-6 on theta' and v'; rtol 1e-5 on
the sum of squares of both."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.server import AsyncParameterServer  # noqa: E402
from repro_torch.kernels.fused_update import (  # noqa: E402
    fused_apply_flat, fused_apply_flat_ref, fused_apply_triton,
    fused_momentum_gap_update, fused_update_flat, fused_update_flat_ref,
    fused_update_triton)

WEIGHTS = (1.0, 0.6, 0.05)
BETA_ETA = ((0.9, 0.01), (0.0, 0.5), (0.99, 1e-4))
K2_ETA_BETA = ((0.01, 0.9), (0.05, 0.9), (0.1, 0.0))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton kernel runs only on "
                    "the card")
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
