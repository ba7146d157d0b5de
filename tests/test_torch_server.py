"""The port's ``AsyncParameterServer`` (K1 in ``push``) against the JAX
package's, on one stream of pushes made with numpy: lags, gaps and weights
equal; parameters, momentum and momentum norm at rtol 1e-6 (the momentum
with atol 1e-6 * (max|v| + 1): the implied step (old - new) / eta cancels).
The JAX server runs both its reference path and its Pallas kernel in
interpret mode; the port runs on the CPU, where K1 is its plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.server import AsyncParameterServer as JaxServer  # noqa: E402
from repro.models.lenet import init_lenet  # noqa: E402
from repro_torch.core.server import AsyncParameterServer  # noqa: E402
from repro_torch.core.staleness import tree_l2_norm  # noqa: E402
from repro_torch.kernels.fused_update.ops import (flatten_concat,  # noqa: E402
                                                  tree_map)
from repro_torch.models.lenet import params_from_jax  # noqa: E402

ETA, BETA = 0.01, 0.9


def _flat(tree):
    return np.concatenate([np.asarray(l).reshape(-1)
                           for l in jax.tree.leaves(tree)])


def _assert_state_close(port, ref):
    np.testing.assert_allclose(flatten_concat(port.params).numpy(),
                               _flat(ref.params), rtol=1e-6, atol=1e-6)
    v_ref = _flat(ref._v)
    np.testing.assert_allclose(
        flatten_concat(port._v).numpy(), v_ref, rtol=1e-6,
        atol=1e-6 * (float(np.max(np.abs(v_ref))) + 1.0))
    assert port.v_norm == pytest.approx(ref.v_norm, rel=1e-6)
    assert tree_l2_norm(port._v) == pytest.approx(port.v_norm, rel=1e-6)


@pytest.mark.parametrize("form", ("flat", "tree"))
@pytest.mark.parametrize("jax_kernel", ("reference", "pallas"))
def test_push_stream_matches_jax_server(jax_kernel, form):
    params = jax.tree.map(np.asarray, init_lenet(jax.random.PRNGKey(0)))
    ref = JaxServer(jax.tree.map(jnp.asarray, params), eta=ETA, beta=BETA,
                    kernel=jax_kernel)
    if form == "flat":
        port_params = params_from_jax(params)
    else:
        port_params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                   params)
    port = AsyncParameterServer(port_params, eta=ETA, beta=BETA,
                                device="cpu")
    rng = np.random.default_rng(11)
    for c in range(3):
        assert port.pull(c)[1] == ref.pull(c)[1]
    for i, c in enumerate((0, 2, 1, 1, 0, 2, 2)):
        # a trained model: the current global one plus a local step
        noise = jax.tree.map(
            lambda a: (0.01 * rng.standard_normal(a.shape)).astype(
                np.float32), params)
        new_ref = jax.tree.map(lambda p, d: p + d, ref.params, noise)
        new_port = params_from_jax(jax.tree.map(np.asarray, new_ref)) \
            if form == "flat" else jax.tree.map(
                lambda a: torch.from_numpy(np.array(a)), new_ref)
        a, b = port.push(c, new_port), ref.push(c, new_ref)
        assert (a.lag, a.applied_weight, a.version) == \
            (b.lag, b.applied_weight, b.version)
        assert a.gap_estimate == pytest.approx(b.gap_estimate, rel=1e-6)
        _assert_state_close(port, ref)
        if i % 2:
            assert port.pull(c)[1] == ref.pull(c)[1]
    assert port.v_norm > 0.0


def test_pulled_params_are_not_mutated_by_later_pushes():
    params = params_from_jax(jax.tree.map(
        np.asarray, init_lenet(jax.random.PRNGKey(1))))
    server = AsyncParameterServer(params, eta=ETA, beta=BETA, device="cpu")
    pulled, _ = server.pull(0)
    snapshot = pulled.clone()
    server.push(1, tree_map(lambda p: p + 1.0, params))
    assert torch.equal(pulled, snapshot)
    assert not torch.equal(server.params, snapshot)
