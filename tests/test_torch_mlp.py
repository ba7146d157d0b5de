"""The port's MLP (``models/mlp.py``), ``Client`` (``core/client.py``) and
``MLPBackend`` against the JAX package's, with the JAX parameters carried
over (``params_from_jax``).

Logits and loss on the same parameters at rtol 1e-5; one ``Client``
epoch from the same parameters and permutation at rtol 1e-4 / atol 1e-5
(f32 in two libraries: 12 momentum-SGD steps). ``Scenario(ml="mlp")`` at
``n_users=4`` on the setup of ``tests/test_real_mode.py``, batched and
loop, against the JAX ``MLPBackend`` with its initial parameters and
permutations fed in: the schedule equal (H == 0), energy at rel 1e-9, gaps
at rtol 1e-6 / atol 1e-9 and accuracy within 0.03 at every sample."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import Scenario as JaxScenario  # noqa: E402
from repro.core.client import Client as JaxClient  # noqa: E402
from repro.core.realml import MLPBackend as JaxMLPBackend  # noqa: E402
from repro.data.synthetic import cifarlike_dataset  # noqa: E402
from repro.models import mlp as jax_mlp  # noqa: E402
from repro_torch.core import MLPBackend, Scenario  # noqa: E402
from repro_torch.core.client import Client  # noqa: E402
from repro_torch.models import mlp  # noqa: E402

SIM_KW = dict(n_users=4, horizon_s=900, app_arrival_p=0.004, seed=0, V=5.0)
ML_KW = dict(n_train=256, n_test=128, seed=0, eval_every=300)


def _params(seed):
    tree = jax_mlp.init_mlp(jax.random.PRNGKey(seed))
    return tree, mlp.params_from_jax(jax.tree.map(np.asarray, tree))


def test_layout_matches_jax_leaves():
    tree, flat = _params(0)
    leaves = [np.asarray(l).reshape(-1) for l in jax.tree.leaves(tree)]
    assert mlp.PARAM_COUNT == flat.numel() == 379_774
    np.testing.assert_array_equal(flat.numpy(), np.concatenate(leaves))
    gen = torch.Generator().manual_seed(0)
    own = mlp.init_mlp(gen)
    assert own.shape == flat.shape and own.dtype == torch.float32
    views = mlp.unflatten(own)
    assert float(views["fc1/b"].abs().max()) == 0.0
    w = views["fc1/w"]
    assert float(w.abs().max()) <= 3.0 * 3072 ** -0.5 + 1e-7


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_logits_and_loss_match_jax(seed):
    tree, flat = _params(seed)
    x, y = cifarlike_dataset(40, seed=seed, noise=8.0)
    ref = np.asarray(jax_mlp.mlp_logits(tree, jnp.asarray(x)))
    out = mlp.mlp_logits(flat, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    ref_loss, _ = jax_mlp.mlp_loss(tree, {"images": jnp.asarray(x),
                                          "labels": jnp.asarray(y)})
    loss = mlp.mlp_loss(flat, torch.from_numpy(x),
                        torch.from_numpy(y.astype(np.int64)))
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)


def test_client_epoch_matches_jax_client():
    tree, flat = _params(3)
    x, y = cifarlike_dataset(250, seed=3, noise=8.0)
    jc = JaxClient(5, jnp.asarray(x), jnp.asarray(y), jax_mlp.mlp_loss,
                   batch_size=20)
    # the permutation JAX's next local_train draws
    key = jax.random.split(jc._key)[1]
    perm = np.asarray(jax.random.permutation(key, len(x)))
    ref, ref_v, ref_loss = jc.local_train(tree)
    c = Client(5, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)),
               mlp.mlp_loss, batch_size=20, next_perm=lambda: perm)
    p, v, loss = c.local_train(flat)
    np.testing.assert_allclose(
        p.numpy(), mlp.params_from_jax(jax.tree.map(np.asarray, ref)).numpy(),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        v.numpy(),
        mlp.params_from_jax(jax.tree.map(np.asarray, ref_v)).numpy(),
        rtol=1e-4, atol=1e-5)
    assert float(loss) == pytest.approx(ref_loss, rel=1e-4)
    assert not torch.equal(p, flat)


def test_standalone_client_draws_its_own_permutations():
    x = torch.zeros((45, 32, 32, 3))
    y = torch.zeros(45, dtype=torch.int64)
    a, b = (Client(7, x, y, mlp.mlp_loss, batch_size=20) for _ in range(2))
    pa = [a.next_perm() for _ in range(3)]
    assert all(np.array_equal(u, w) for u, w in
               zip(pa, (b.next_perm() for _ in range(3))))
    assert sorted(pa[0].tolist()) == list(range(45))
    assert not np.array_equal(pa[0], pa[1])


def _carry_over(backend, source):
    backend.server.params = mlp.params_from_jax(
        jax.tree.map(np.asarray, source.server.params))
    backend._next_perm = source._next_perm


@pytest.mark.parametrize("engine", ("vectorized", "loop"))
@pytest.mark.parametrize("policy", ("online", "immediate"))
def test_mlp_backend_matches_jax(policy, engine):
    a = JaxScenario(policy=policy, engine=engine, ml="mlp", ml_kwargs=ML_KW,
                    **SIM_KW).run()
    sim = Scenario(policy=policy, engine=engine, ml="mlp",
                   ml_kwargs=dict(ML_KW, device="cpu"), **SIM_KW).build()
    assert isinstance(sim.ml_backend, MLPBackend)
    _carry_over(sim.ml_backend, JaxMLPBackend(SIM_KW["n_users"], **ML_KW))
    b = sim.run()
    assert a.mean_H == b.mean_H == 0.0
    assert b.updates == a.updates > 0
    assert [(e["t"], e["user"], e["lag"], e["corun"]) for e in b.push_log] \
        == [(e["t"], e["user"], e["lag"], e["corun"]) for e in a.push_log]
    assert b.energy_j == pytest.approx(a.energy_j, rel=1e-9)
    np.testing.assert_allclose([e["gap"] for e in b.push_log],
                               [e["gap"] for e in a.push_log],
                               rtol=1e-6, atol=1e-9)
    assert [t for t, _ in b.accuracy] == [t for t, _ in a.accuracy]
    np.testing.assert_allclose([x for _, x in b.accuracy],
                               [x for _, x in a.accuracy], atol=0.03)


@pytest.mark.parametrize("partition", ("dirichlet", "uniform"))
def test_backend_knobs_match_jax_shards(partition):
    kw = dict(n_train=300, n_test=32, seed=2, alpha=0.5, noise=3.0,
              partition=partition)
    a = JaxMLPBackend(5, **kw)
    b = MLPBackend(5, device="cpu", **kw)
    np.testing.assert_array_equal(b._shard_sizes, a._shard_sizes)
    np.testing.assert_array_equal(b._flat_x.numpy(), np.asarray(a._flat_x))
    assert [c.images.shape[0] for c in b.clients] == a._shard_sizes.tolist()
    with pytest.raises(ValueError, match="partition"):
        MLPBackend(5, device="cpu", partition="zipf", n_train=64, n_test=8)
