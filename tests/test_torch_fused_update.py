"""K2, the client momentum step, in the PyTorch port against the JAX
package.

The port's ``fused_update_flat`` takes its plain version for CPU tensors;
it is held against the JAX Pallas kernel (interpret mode, as the JAX
package's own CPU tests run it) and the JAX oracle on the same numpy
inputs, at the bounds of ``tests/test_kernels.py``'s update property test:
rtol 1e-6 / atol 1e-6 on theta' and v', rtol 1e-5 on the sum of squares.
The tree wrapper is held against ``repro.optim.gap.fused_momentum_gap_update``
at rtol 3e-5 (the bound of ``tests/test_kernels.py``'s pytree test). The
Triton kernel itself runs only on a card: ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_update.ops import fused_update_flat as jax_update  # noqa: E402
from repro.kernels.fused_update.ref import fused_update_flat_ref as jax_ref  # noqa: E402
from repro.optim.gap import fused_momentum_gap_update as jax_tree_update  # noqa: E402
from repro_torch.kernels.fused_update import (  # noqa: E402
    fused_momentum_gap_update, fused_update_flat)
from repro_torch.optim.gap import (  # noqa: E402
    fused_momentum_gap_update as optim_update)

SIZES = (0, 1, 127, 1029, 82304)
ETA_BETA = ((0.01, 0.9), (0.05, 0.9), (0.1, 0.0))
SHAPES = {"a": (33, 7), "b": {"c": (129,), "d": (2, 3, 5)}}


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("eta,beta", ETA_BETA)
@pytest.mark.parametrize("n", SIZES)
def test_flat_matches_jax_kernel_and_oracle(n, eta, beta):
    theta, v, g = _inputs(n, seed=n)
    t2, v2, sq = fused_update_flat(*(torch.from_numpy(a)
                                     for a in (theta, v, g)), eta, beta)
    assert t2.shape == v2.shape == (n,) and sq.shape == ()
    assert t2.dtype == v2.dtype == sq.dtype == torch.float32
    args = [jnp.asarray(a) for a in (theta, v, g)]
    for tr, vr, sqr in (jax_update(*args, eta, beta, interpret=True),
                        jax_ref(*args, eta, beta)):
        np.testing.assert_allclose(t2.numpy(), np.asarray(tr), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(v2.numpy(), np.asarray(vr), rtol=1e-6,
                                   atol=1e-6)
        assert float(sq) == pytest.approx(float(sqr), rel=1e-5, abs=1e-10)


def _tree(rng, shapes):
    if isinstance(shapes, dict):
        return {k: _tree(rng, s) for k, s in shapes.items()}
    return rng.standard_normal(shapes).astype(np.float32)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pairs(a, b):
    if isinstance(a, dict):
        return [p for k in sorted(a) for p in _pairs(a[k], b[k])]
    return [(a, b)]


@pytest.mark.parametrize("lag", (0, 1, 5))
@pytest.mark.parametrize("entry", (fused_momentum_gap_update, optim_update))
def test_tree_matches_jax_oracle(entry, lag):
    rng = np.random.default_rng(lag)
    p, v, g = (_tree(rng, SHAPES) for _ in range(3))
    for eta, beta in ETA_BETA:
        p2, v2, gap = entry(*(_map(torch.from_numpy, t) for t in (p, v, g)),
                            eta=eta, beta=beta, lag=lag)
        pr, vr, gapr = jax_tree_update(*(_map(jnp.asarray, t)
                                         for t in (p, v, g)),
                                       eta=eta, beta=beta,
                                       lag=jnp.int32(lag))
        for ours, ref in _pairs(p2, pr) + _pairs(v2, vr):
            assert ours.shape == ref.shape
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       rtol=3e-5, atol=3e-5)
        assert gap.shape == () and gap.dtype == torch.float32
        assert float(gap) == pytest.approx(float(gapr), rel=3e-5, abs=1e-12)


def test_outputs_do_not_alias_inputs():
    theta, v, g = (torch.from_numpy(a) for a in _inputs(1029, 0))
    before = [t.clone() for t in (theta, v, g)]
    t2, v2, _ = fused_update_flat(theta, v, g, 0.05, 0.9)
    ptrs = {t.data_ptr() for t in (theta, v, g)}
    assert t2.data_ptr() not in ptrs and v2.data_ptr() not in ptrs
    for t, b in zip((theta, v, g), before):
        assert torch.equal(t, b)
    # a one-leaf tree (a flat buffer) goes through without a concat: the
    # kernel's outputs must still be fresh tensors
    p2, nv, _ = fused_momentum_gap_update(theta, v, g, eta=0.05, beta=0.9,
                                          lag=2)
    assert p2.data_ptr() not in ptrs and nv.data_ptr() not in ptrs
    for t, b in zip((theta, v, g), before):
        assert torch.equal(t, b)


def test_triton_on_cpu_tensors_raises():
    theta, v, g = (torch.from_numpy(a) for a in _inputs(129, 0))
    with pytest.raises(ValueError, match="CUDA"):
        fused_update_flat(theta, v, g, 0.05, 0.9, kernel="triton")
    with pytest.raises(ValueError, match="CUDA"):
        fused_momentum_gap_update({"w": theta}, {"w": v}, {"w": g},
                                  eta=0.05, beta=0.9, lag=1,
                                  kernel="triton")


def test_unknown_kernel_mode_raises():
    theta, v, g = (torch.from_numpy(a) for a in _inputs(8, 0))
    with pytest.raises(ValueError, match="unknown kernel mode"):
        fused_update_flat(theta, v, g, 0.05, 0.9, kernel="pallas")
