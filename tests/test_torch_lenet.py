"""The port's LeNet-5 against the JAX package's, with the JAX parameters
carried over by ``params_from_jax``: logits and loss at rtol 1e-5, and one
batched local epoch (``_masked_epoch``, 20 momentum-SGD steps of batch 20,
three lanes, one of them ragged).

The epoch is held two ways. In float64 in both libraries it must agree to
rtol 1e-9: that pins the algorithm (masking, momentum, layout). In float32
it agrees to about 1e-7 — unless some ReLU pre-activation lies within f32
rounding of 0, where the two libraries can take different sides; the step
then moves by the gradient of one unit for one sample (7e-5 to 2e-3 after
20 steps). Drawing the minibatch rows with ``default_rng(s)``, s = 0..9,
s = 0, 3, 4 and 6 meet such a unit in some lane (seed 4: fc1 unit 51 at
step 6, pre-activation 8.3e-7). The float32 case uses s = 1, at the bound
rtol 1e-4 / atol 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.realml import _masked_epoch as jax_epoch  # noqa: E402
from repro.data.synthetic import cifarlike_dataset  # noqa: E402
from repro.models.lenet import init_lenet as jax_init  # noqa: E402
from repro.models.lenet import lenet_logits as jax_logits  # noqa: E402
from repro.models.lenet import lenet_loss as jax_loss  # noqa: E402
from repro_torch.core.realml import _masked_epoch  # noqa: E402
from repro_torch.models import lenet as lenet_mod  # noqa: E402
from repro_torch.models.lenet import (PARAM_COUNT, conv_im2col,  # noqa: E402
                                      init_lenet, lenet_logits, lenet_loss,
                                      params_from_jax, unflatten)


def _jax_params(seed):
    return jax_init(jax.random.PRNGKey(seed))


def _flat_jax(tree):
    return np.concatenate([np.asarray(l).reshape(-1)
                           for l in jax.tree.leaves(tree)])


def test_flat_layout_is_jax_leaf_order():
    p = _jax_params(0)
    flat = params_from_jax(jax.tree.map(np.asarray, p))
    assert flat.shape == (PARAM_COUNT,) == (62006,)
    np.testing.assert_array_equal(flat.numpy(), _flat_jax(p))
    views = unflatten(flat)
    np.testing.assert_array_equal(views["fc1/w"].numpy(),
                                  np.asarray(p["fc1"]["w"]))


def test_init_scale_matches_jax_init():
    flat = init_lenet(torch.Generator().manual_seed(0))
    ref = _flat_jax(_jax_params(0))
    for name, t in unflatten(flat).items():
        layer, kind = name.split("/")
        r = np.asarray(_jax_params(0)[layer][kind])
        if kind == "b":
            assert not t.any()
        else:
            assert t.abs().max() <= 3.0 * (r.size / r.shape[-1]) ** -0.5
            assert float(t.std()) == pytest.approx(float(r.std()), rel=0.15)
    assert flat.shape == ref.shape


@pytest.mark.parametrize("seed", (0, 1))
def test_logits_and_loss_match(seed):
    p = _jax_params(seed)
    flat = params_from_jax(jax.tree.map(np.asarray, p))
    x, y = cifarlike_dataset(16, seed=seed, noise=8.0)
    want = np.asarray(jax_logits(p, jnp.asarray(x)))
    # atol: a few f32 ulps of the largest logit (sums of ~2,400 products)
    np.testing.assert_allclose(
        lenet_logits(flat, torch.from_numpy(x)).numpy(), want, rtol=1e-5,
        atol=1e-6 * float(np.max(np.abs(want))))
    loss, _ = jax_loss(p, {"images": jnp.asarray(x),
                           "labels": jnp.asarray(y)})
    got = lenet_loss(flat, torch.from_numpy(x),
                     torch.from_numpy(y.astype(np.int64)))
    assert float(got) == pytest.approx(float(loss), rel=1e-5)


@pytest.fixture
def jax_x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _epoch_pair(dtype, seed):
    """(port, JAX) trained lanes of one 20-step epoch in ``dtype``."""
    rng = np.random.default_rng(seed)
    eta, beta = 0.01, 0.9
    x, y = cifarlike_dataset(600, seed=2, noise=8.0)
    x = x.astype(dtype)
    S, B = 20, 20
    steps = (20, 20, 13)                      # the last lane is ragged
    idx = rng.integers(0, len(x), (len(steps), S, B))
    mask = np.arange(S)[None, :] < np.array(steps)[:, None]
    # f32 parameters (the init draws f64 under x64), then ``dtype``
    lanes = [jax.tree.map(lambda a: np.asarray(a, np.float32).astype(dtype),
                          _jax_params(s)) for s in range(len(steps))]
    got = _masked_epoch(
        torch.stack([params_from_jax(p).to(getattr(torch, dtype))
                     for p in lanes]),
        torch.from_numpy(idx), torch.from_numpy(mask), torch.from_numpy(x),
        torch.from_numpy(y.astype(np.int64)), eta, beta, lenet_loss)
    want = [_flat_jax(jax_epoch(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(idx[j]), jnp.asarray(mask[j]),
                                jnp.asarray(x), jnp.asarray(y), eta, beta,
                                jax_loss))
            for j, p in enumerate(lanes)]
    return got.numpy(), want


def test_masked_epoch_matches_in_float64(jax_x64):
    got, want = _epoch_pair("float64", seed=4)
    for j, w in enumerate(want):
        assert w.dtype == got.dtype == np.float64
        np.testing.assert_allclose(got[j], w, rtol=1e-9, atol=1e-12)


def test_masked_epoch_matches():
    got, want = _epoch_pair("float32", seed=1)
    for j, w in enumerate(want):
        np.testing.assert_allclose(got[j], w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,c,h,o", ((4, 3, 32, 6), (5, 6, 14, 16)))
def test_im2col_conv_matches_conv2d(n, c, h, o):
    """The card's convolution (im2col + matmul) is F.conv2d's function:
    outputs and all three gradients at rtol 1e-12 in float64."""
    rng = np.random.default_rng(n)
    x, w, b = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((n, c, h, h), (5, 5, c, o), (o,)))
    r = torch.from_numpy(rng.standard_normal((n, o, h - 4, h - 4)))
    outs = []
    for conv in (conv_im2col, lambda x, w, b: torch.nn.functional.conv2d(
            x, w.permute(3, 2, 0, 1), b)):
        y = conv(x, w, b)
        outs.append([y] + list(torch.autograd.grad((y * r).sum(), (x, w, b))))
    for got, want in zip(*outs):
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_masked_epoch_im2col_route_matches_in_float64(jax_x64, monkeypatch):
    """The batched epoch through the card's convolution route equals JAX's
    in float64, as the CPU's route does."""
    monkeypatch.setattr(lenet_mod, "_conv", conv_im2col)
    got, want = _epoch_pair("float64", seed=4)
    for j, w in enumerate(want):
        np.testing.assert_allclose(got[j], w, rtol=1e-9, atol=1e-12)
