"""K1, the server push apply, in the PyTorch port against the JAX package.

The port's ``fused_apply_flat`` (one push) and ``fused_apply_cohort`` (a
chunk of up to ``KMAX`` pushes in one launch) take their plain versions
for CPU tensors; they are held against the JAX Pallas kernel (interpret
mode, as the JAX package's own CPU tests run it) and the JAX oracle on the
same numpy inputs — a chunk against k chained JAX pushes — at the bounds
of ``tests/test_kernels.py``: rtol 1e-6 with atol 1e-6 on ``mixed``, atol
1e-6 * (max|v'| + 1) on ``v'`` because ``(cur - mixed) * inv_eta``
cancels, rtol 1e-5 on the sums of squares and their roots. The Triton
kernel itself runs only on a card: ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_update.ops import fused_apply_flat as jax_apply  # noqa: E402
from repro.kernels.fused_update.ref import fused_apply_flat_ref as jax_ref  # noqa: E402
from repro.optim.gap import fused_weighted_apply as jax_tree_apply  # noqa: E402
from repro_torch.core.server import AsyncParameterServer  # noqa: E402
from repro_torch.kernels.fused_update import (  # noqa: E402
    KMAX, fused_apply_cohort, fused_apply_flat, fused_weighted_apply)

SIZES = (0, 1, 127, 1029, 62006)
WEIGHTS = (1.0, 0.6, 0.05)
BETA_ETA = ((0.9, 0.01), (0.0, 0.5), (0.99, 1e-4))


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(3)]


def _assert_apply_close(m, v2, sq, mr, vr, sqr):
    np.testing.assert_allclose(m, mr, rtol=1e-6, atol=1e-6)
    v_scale = float(np.max(np.abs(vr), initial=0.0)) + 1.0
    np.testing.assert_allclose(v2, vr, rtol=1e-6, atol=1e-6 * v_scale)
    assert float(sq) == pytest.approx(float(sqr), rel=1e-5, abs=1e-10)


@pytest.mark.parametrize("w", WEIGHTS)
@pytest.mark.parametrize("n", SIZES)
def test_flat_matches_jax_kernel_and_oracle(n, w):
    beta, eta = BETA_ETA[SIZES.index(n) % len(BETA_ETA)]
    inv_eta = 1.0 / eta
    cur, v, new = _inputs(n, seed=n)
    m, v2, sq = fused_apply_flat(*(torch.from_numpy(a) for a in (cur, v, new)),
                                 w, inv_eta, beta)
    assert m.shape == v2.shape == (n,) and sq.shape == ()
    m, v2 = m.numpy(), v2.numpy()
    args = [jnp.asarray(a) for a in (cur, v, new)]
    for mr, vr, sqr in (jax_apply(*args, w, inv_eta, beta, interpret=True),
                        jax_ref(*args, w, inv_eta, beta)):
        _assert_apply_close(m, v2, sq, np.asarray(mr), np.asarray(vr),
                            float(sqr))


def test_tree_matches_jax_oracle():
    rng = np.random.default_rng(3)
    shapes = {"conv": {"w": (5, 5, 3, 6), "b": (6,)}, "fc": {"w": (40, 7),
                                                        "b": (7,)}}

    def tree():
        return {k: {kk: rng.standard_normal(s).astype(np.float32)
                    for kk, s in d.items()} for k, d in shapes.items()}

    p, v, new = tree(), tree(), tree()
    to_t = lambda t: {k: {kk: torch.from_numpy(a) for kk, a in d.items()}
                      for k, d in t.items()}
    to_j = lambda t: {k: {kk: jnp.asarray(a) for kk, a in d.items()}
                      for k, d in t.items()}
    for w, (beta, eta) in zip(WEIGHTS, BETA_ETA):
        m, v2, vn = fused_weighted_apply(to_t(p), to_t(v), to_t(new), w=w,
                                         eta=eta, beta=beta)
        mr, vr, vnr = jax_tree_apply(to_j(p), to_j(v), to_j(new), w=w,
                                     eta=eta, beta=beta)
        for layer, d in shapes.items():
            for kk in d:
                _assert_apply_close(m[layer][kk].numpy(),
                                    v2[layer][kk].numpy(), 0.0,
                                    np.asarray(mr[layer][kk]),
                                    np.asarray(vr[layer][kk]), 0.0)
        assert float(vn) == pytest.approx(float(vnr), rel=1e-5)


def test_triton_on_cpu_tensors_raises():
    cur, v, new = (torch.from_numpy(a) for a in _inputs(129, 0))
    with pytest.raises(ValueError, match="CUDA"):
        fused_apply_flat(cur, v, new, 0.5, 10.0, 0.9, kernel="triton")


def test_unknown_kernel_mode_raises():
    cur, v, new = (torch.from_numpy(a) for a in _inputs(8, 0))
    with pytest.raises(ValueError, match="unknown kernel mode"):
        fused_apply_flat(cur, v, new, 0.5, 10.0, 0.9, kernel="pallas")


def test_default_device_server_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        AsyncParameterServer(torch.zeros(8), eta=0.01, beta=0.9)



COHORT_K = (1, 3, 16)
COHORT_SIZES = (0, 1, 1029, 62006)


def _cohort_inputs(n, k, seed):
    rng = np.random.default_rng(seed)
    cur, v = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    trained = rng.standard_normal((k, n)).astype(np.float32)
    return cur, v, trained, rng.uniform(0.05, 1.0, k).astype(np.float32)


@pytest.mark.parametrize("mixed_weights", (False, True))
@pytest.mark.parametrize("n", COHORT_SIZES)
@pytest.mark.parametrize("k", COHORT_K)
def test_cohort_matches_chained_jax_pushes(k, n, mixed_weights):
    beta, eta = BETA_ETA[(k + COHORT_SIZES.index(n)) % len(BETA_ETA)]
    inv_eta = 1.0 / eta
    cur, v, trained, w = _cohort_inputs(n, k, seed=100 * k + n)
    if not mixed_weights:
        w = np.ones(k, np.float32)
    p2, v2, sums, norms = fused_apply_cohort(
        torch.from_numpy(cur), torch.from_numpy(v),
        torch.from_numpy(trained),
        torch.from_numpy(w) if mixed_weights else None, inv_eta, beta)
    assert p2.shape == v2.shape == (n,)
    assert sums.shape == norms.shape == (k + 1,)
    for step in (lambda c, vv, t, wj: jax_apply(c, vv, t, wj, inv_eta, beta,
                                                interpret=True),
                 lambda c, vv, t, wj: jax_ref(c, vv, t, wj, inv_eta, beta)):
        c, vv = jnp.asarray(cur), jnp.asarray(v)
        sums_ref = [float(jnp.sum(vv * vv))]
        for j in range(k):
            c, vv, sq = step(c, vv, jnp.asarray(trained[j]), float(w[j]))
            sums_ref.append(float(sq))
        _assert_apply_close(p2.numpy(), v2.numpy(), 0.0, np.asarray(c),
                            np.asarray(vv), 0.0)
        np.testing.assert_allclose(sums.numpy(), sums_ref, rtol=1e-5,
                                   atol=1e-10)
        np.testing.assert_allclose(norms.numpy(), np.sqrt(sums_ref),
                                   rtol=1e-5, atol=1e-10)


def test_cohort_of_k_equals_k_single_pushes():
    cur, v, trained, w = (torch.from_numpy(a)
                          for a in _cohort_inputs(1029, 5, seed=7))
    p2, v2, sums, norms = fused_apply_cohort(cur, v, trained, w, 100.0, 0.9)
    sq = [torch.sum(v * v)]
    for j in range(5):
        cur, v, s = fused_apply_flat(cur, v, trained[j], float(w[j]), 100.0,
                                     0.9)
        sq.append(s)
    assert torch.equal(p2, cur) and torch.equal(v2, v)
    assert torch.equal(sums, torch.stack(sq))
    assert torch.equal(norms, torch.sqrt(sums))


def _bad_cohort_args(case):
    cur, v, trained, w = (torch.from_numpy(a)
                          for a in _cohort_inputs(64, KMAX + 1, seed=1))
    if case == "k_above_kmax":
        return (cur, v, trained, None), "1 to 16"
    if case == "k_zero":
        return (cur, v, trained[:0], None), "1 to 16"
    if case == "trained_width":
        return (cur, v, trained[:2, :63], None), r"\(k, 64\)"
    if case == "trained_flat":
        return (cur, v, trained[0], None), r"\(k, 64\)"
    if case == "trained_strided":
        return (cur, v, trained[:2].t().contiguous().t(), None), \
            "contiguous"
    if case == "trained_f64":
        return (cur, v, trained[:2].double(), None), "contiguous f32"
    if case == "weights_shape":
        return (cur, v, trained[:2], w[:3]), r"\(2,\) f32"
    raise AssertionError(case)


@pytest.mark.parametrize("case", ("k_above_kmax", "k_zero", "trained_width",
                                  "trained_flat", "trained_strided",
                                  "trained_f64", "weights_shape"))
def test_cohort_argument_checks_raise(case):
    args, match = _bad_cohort_args(case)
    with pytest.raises(ValueError, match=match):
        fused_apply_cohort(*args, 10.0, 0.9)


def test_cohort_triton_on_cpu_tensors_raises():
    cur, v, trained, w = (torch.from_numpy(a)
                          for a in _cohort_inputs(129, 3, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        fused_apply_cohort(cur, v, trained, w, 10.0, 0.9, kernel="triton")
