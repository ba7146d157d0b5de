"""The port's sync schedule (FedAvg: ``SyncPolicy``, the engine's round
close, ``SyncServer`` and the sync LeNet backend) against the JAX
package's, live.

``SyncServer.aggregate`` must equal the reference's tree mean bit for bit
in f32 (the same left fold from 0, in submission order). A LeNet sync run
with the JAX initial parameters and permutations carried over must give
the JAX backend's schedule digest, train as the JAX run trains (the final
model within 1e-3 of JAX's, accuracy within 0.03 at every sample, rising
above its first sample), and make no K1 launch."""
import hashlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import Scenario as JaxScenario  # noqa: E402
from repro.core.realml import LeNetBackend as JaxLeNetBackend  # noqa: E402
from repro.core.server import SyncServer as JaxSyncServer  # noqa: E402
from repro_torch.core import Scenario, SyncServer  # noqa: E402
from repro_torch.core import realml  # noqa: E402
from repro_torch.kernels.fused_update.ops import tree_leaves  # noqa: E402
from repro_torch.models.lenet import params_from_jax  # noqa: E402

ML_KW = dict(n_train=1024, n_test=256, eval_every=300)
SIM_KW = dict(n_users=4, horizon_s=1800, app_arrival_p=0.004, seed=0, V=5.0)


def _tree(rng, scale=1.0):
    return {"a": {"w": (scale * rng.standard_normal((7, 5))).astype(
        np.float32), "b": np.zeros(5, np.float32) - 0.0},
        "c": (scale * rng.standard_normal(33)).astype(np.float32)}


@pytest.mark.parametrize("n", (1, 3, 25))
def test_aggregate_equals_jax_mean_bit_for_bit(n):
    rng = np.random.default_rng(n)
    p0 = _tree(rng)
    subs = [_tree(rng, scale=1.0 + i) for i in range(n)]
    ref = JaxSyncServer(jax.tree.map(jnp.asarray, p0))
    port = SyncServer(jax.tree.map(torch.from_numpy, p0), device="cpu")
    for s in subs:
        ref.submit(jax.tree.map(jnp.asarray, s))
        port.submit(jax.tree.map(torch.from_numpy, s))
    assert port.aggregate() == ref.aggregate() == 1
    mine, theirs = tree_leaves(port.params), jax.tree.leaves(ref.params)
    assert len(mine) == len(theirs) == 3
    for a, b in zip(mine, theirs):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_server_rounds_like_jax():
    p0 = torch.zeros(4)
    server = SyncServer(p0, device="cpu")
    assert server.pull(3) == (server.params, 0)
    assert server.aggregate() == 0 and server.params is p0   # empty round
    server.submit(torch.ones(4))
    server.submit(3 * torch.ones(4))
    pulled, rnd = server.pull()
    assert rnd == 0 and pulled is p0
    assert server.aggregate() == 1
    assert torch.equal(server.params, 2 * torch.ones(4))
    assert torch.equal(p0, torch.zeros(4))      # pulled params unchanged
    assert server._pending == []


def _digest(push_log) -> str:
    return hashlib.sha256(json.dumps(
        [(e["t"], e["user"], e["lag"], e["corun"]) for e in push_log])
        .encode()).hexdigest()


def test_lenet_sync_run_trains_as_jax_does(monkeypatch):
    jsim = JaxScenario(policy="sync", ml="lenet", ml_kwargs=ML_KW,
                       **SIM_KW).build()
    a = jsim.run()
    sim = Scenario(policy="sync", ml="lenet",
                   ml_kwargs=dict(ML_KW, device="cpu"), **SIM_KW).build()
    backend = sim.ml_backend
    assert backend.sync and isinstance(backend.server, SyncServer)
    source = JaxLeNetBackend(SIM_KW["n_users"], sync=True,
                             seed=SIM_KW["seed"], **ML_KW)
    p0 = params_from_jax(jax.tree.map(np.asarray, source.server.params))
    backend.server.params = p0
    backend._next_perm = source._next_perm
    launches = []
    real = realml.fused_apply_cohort
    monkeypatch.setattr(realml, "fused_apply_cohort",
                        lambda *x, **k: launches.append(1) or real(*x, **k))
    b = sim.run()
    assert launches == []                       # no K1 under sync
    assert a.mean_H == b.mean_H == 0.0
    assert b.updates == a.updates > 0
    assert _digest(b.push_log) == _digest(a.push_log)
    assert list(b.push_log) == list(a.push_log)  # lags 0, gaps 0, weights 1
    assert b.energy_j == pytest.approx(a.energy_j, rel=1e-9)
    assert sim.state.version == jsim.state.version > 1       # rounds closed
    assert backend.server.round == jsim.ml_backend.server.round
    p_jax = params_from_jax(jax.tree.map(np.asarray,
                                         jsim.ml_backend.server.params))
    assert float((p_jax - p0).abs().max()) > 0.02            # JAX trained
    np.testing.assert_allclose(backend.server.params.numpy(), p_jax.numpy(),
                               atol=1e-3)
    assert [t for t, _ in b.accuracy] == [t for t, _ in a.accuracy]
    np.testing.assert_allclose([x for _, x in b.accuracy],
                               [x for _, x in a.accuracy], atol=0.03)
    assert b.accuracy[-1][1] > b.accuracy[0][1] + 0.1
    assert backend.v_norm() == 0.0


def test_trace_sync_rounds_match_jax_state():
    kw = dict(n_users=9, horizon_s=1500, seed=4, app_arrival_p=0.01)
    jsim = JaxScenario(policy="sync", engine="vectorized", **kw).build()
    a = jsim.run()
    sim = Scenario(policy="sync", **kw).build()
    b = sim.run()
    assert list(b.push_log) == list(a.push_log)
    assert sim.state.version == jsim.state.version > 1
    assert sim.state.round_open == jsim.state.round_open
    assert all(e["lag"] == 0 and e["weight"] == 1.0 for e in b.push_log)


def test_round_mode_mismatch_trains_nothing():
    """An async backend under the sync policy: as in the JAX package, no
    hook matches, so the run schedules but nothing trains or pushes."""
    backend = realml.make_backend("lenet", 4, sync=False, seed=0,
                                  device="cpu", **ML_KW)
    p0 = backend.server.params
    res = Scenario(policy="sync", ml="lenet", **SIM_KW).run(
        ml_backend=backend)
    assert res.updates > 0 and backend.server.params is p0


def _main_path_sync(seeds):
    """The sync schedule at the main-path setting on the CPU: the JAX
    package's own run for each seed, then the port's with the JAX seed's
    initial parameters and permutations carried over, and the port's own
    (torch-drawn) initial parameters. Prints each run's accuracy samples.

        PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sync.py 0 1 2
    """
    kw = dict(n_users=25, horizon_s=3600, V=5.0, app_arrival_p=0.004)
    for seed in seeds:
        a = JaxScenario(policy="sync", ml="lenet", seed=seed, **kw).run()
        print(f"JAX sync, seed {seed}: energy {a.energy_j!r} J, updates "
              f"{a.updates}, schedule {_digest(a.push_log)[:16]}, accuracy "
              f"{a.accuracy}", flush=True)
        for carry in (True, False):
            sim = Scenario(policy="sync", ml="lenet", seed=seed,
                           ml_kwargs=dict(device="cpu"), **kw).build()
            if carry:
                source = JaxLeNetBackend(kw["n_users"], sync=True, seed=seed)
                sim.ml_backend.server.params = params_from_jax(
                    jax.tree.map(np.asarray, source.server.params))
                sim.ml_backend._next_perm = source._next_perm
            b = sim.run()
            print(f"port sync, seed {seed}, "
                  f"{'JAX' if carry else 'its own'} initial parameters and "
                  f"permutations: schedule {_digest(b.push_log)[:16]}, "
                  f"accuracy {b.accuracy}", flush=True)


if __name__ == "__main__":
    import sys
    _main_path_sync([int(s) for s in sys.argv[1:]] or [0])
