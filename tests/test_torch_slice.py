"""The port's slice as a whole — ``Scenario`` through the numpy engine, the
online/immediate policies, Eq. 10 energy, and real LeNet-5 training with
K1 pushes — against live runs of the JAX package on the same seeds.

Trace mode must reproduce the JAX vectorized engine's full push log (every
field) and its energy. Real mode uses the setup of
``tests/test_real_mode.py`` on the CPU, with the JAX initial parameters
carried over and the JAX backend's minibatch permutations fed in: the
schedule (t, user, lag, corun) must be identical while H == 0, energy at
rtol 1e-9, the Eq. 4 gaps at rtol 2e-5 / atol 1e-6 and accuracy at atol
0.03 (f32 training in two libraries)."""
import ast
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import Scenario as JaxScenario  # noqa: E402
from repro.core.realml import LeNetBackend as JaxLeNetBackend  # noqa: E402
import torch  # noqa: E402
from repro_torch.core import Scenario  # noqa: E402
from repro_torch.core.realml import LeNetBackend, _masked_epoch  # noqa: E402
from repro_torch.core.staleness import gradient_gap  # noqa: E402
from repro_torch.kernels.fused_update import fused_apply_flat_ref  # noqa: E402
from repro_torch.models.lenet import params_from_jax  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SIM_KW = dict(n_users=4, horizon_s=900, app_arrival_p=0.004, seed=0, V=5.0)
ML_KW = dict(n_train=256, n_test=128, eval_every=300)
TRACE_KW = (dict(n_users=12, horizon_s=2000, seed=2, app_arrival_p=0.01,
                 V=5.0),
            dict(n_users=30, horizon_s=3000, seed=5, L_b=2.0, V=50.0))


def _digest(rows) -> str:
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def _schedule(push_log):
    return [(e["t"], e["user"], e["lag"], e["corun"]) for e in push_log]


@pytest.mark.parametrize("case", range(len(TRACE_KW)))
@pytest.mark.parametrize("policy", ("online", "immediate"))
def test_trace_mode_matches_jax_engine(policy, case):
    kw = TRACE_KW[case]
    a = JaxScenario(policy=policy, engine="vectorized", **kw).run()
    b = Scenario(policy=policy, **kw).run()
    assert b.updates == a.updates > 0
    assert _digest(list(b.push_log)) == _digest(list(a.push_log))
    assert b.energy_j == pytest.approx(a.energy_j, rel=1e-9)
    assert (b.mean_Q, b.mean_H, b.corun_fraction) == \
        (a.mean_Q, a.mean_H, a.corun_fraction)
    np.testing.assert_array_equal(b.trace_Q, a.trace_Q)
    np.testing.assert_allclose(b.trace_energy, a.trace_energy, rtol=1e-9)


@pytest.mark.parametrize("policy", ("online", "immediate"))
def test_real_mode_matches_jax_backend(policy):
    a = JaxScenario(policy=policy, ml="lenet", ml_kwargs=ML_KW,
                    **SIM_KW).run()
    sim = Scenario(policy=policy, ml="lenet",
                   ml_kwargs=dict(ML_KW, device="cpu"), **SIM_KW).build()
    backend = sim.ml_backend
    # the JAX initial parameters, and the JAX clients' permutations
    source = JaxLeNetBackend(SIM_KW["n_users"], seed=SIM_KW["seed"],
                             **ML_KW)
    backend.server.params = params_from_jax(
        jax.tree.map(np.asarray, source.server.params))
    backend._next_perm = source._next_perm
    b = sim.run()
    assert a.mean_H == b.mean_H == 0.0
    assert b.updates == a.updates > 0
    assert _digest(_schedule(b.push_log)) == _digest(_schedule(a.push_log))
    assert b.energy_j == pytest.approx(a.energy_j, rel=1e-9)
    np.testing.assert_allclose([e["gap"] for e in b.push_log],
                               [e["gap"] for e in a.push_log],
                               rtol=2e-5, atol=1e-6)
    assert [e["weight"] for e in b.push_log] == \
        [e["weight"] for e in a.push_log]
    assert [t for t, _ in b.accuracy] == [t for t, _ in a.accuracy]
    np.testing.assert_allclose([x for _, x in b.accuracy],
                               [x for _, x in a.accuracy], atol=0.03)


@pytest.mark.parametrize("n_finish", (3, 20))
def test_finish_cohort_matches_per_push_chain(n_finish):
    """One K1 call a chunk (20 finishers: chunks of 16 and 4) gives what
    the per-push chain of ``fused_apply_flat_ref`` gave: parameters and
    momentum bit for bit, the gaps at rtol 1e-6 (the chain summed the
    entry norm as ``torch.sum`` before each chunk, the cohort plain
    version does the same; the kernel on the card sums in its own order)."""
    kw = dict(n_train=2000, n_test=64, seed=0, device="cpu")
    a, b = LeNetBackend(20, **kw), LeNetBackend(20, **kw)
    uids = np.arange(n_finish)[::-1].copy()
    lags = np.arange(n_finish) % 4
    for be in (a, b):
        be.pull_batch(uids, 0)
    gaps, weights = a.finish_async_batch(uids, np.zeros(n_finish, np.int64),
                                         lags, 0.01, 0.9)
    p, v, vn = b.server.params, b.server._v, []
    for params, idx, mask in b._cohort_chunks(uids):
        trained = _masked_epoch(params, idx, mask, b._flat_x, b._flat_y,
                                b.eta, b.beta, b.model_loss)
        sq = torch.sum(v * v)
        for j in range(trained.shape[0]):
            vn.append(float(torch.sqrt(sq)))
            p, v, sq = fused_apply_flat_ref(p, v, trained[j], 1.0,
                                            1.0 / b.eta, b.beta)
    assert not torch.equal(p, b._inflight[int(uids[0])])     # trained
    assert torch.equal(a.server.params, p) and torch.equal(a.server._v, v)
    np.testing.assert_allclose(
        gaps, gradient_gap(np.array(vn), lags, 0.01, 0.9), rtol=1e-6)
    assert weights.tolist() == [1.0] * n_finish
    assert a.v_norm() == pytest.approx(float(torch.sqrt(sq)), rel=1e-6)
    assert a.server.lag_tracker.version == n_finish


def test_real_mode_triton_kernel_on_cpu_raises():
    sim = Scenario(policy="immediate", ml="lenet", kernel="triton",
                   ml_kwargs=dict(ML_KW, device="cpu"), **SIM_KW).build()
    with pytest.raises(ValueError, match="CUDA"):
        sim.run()


@pytest.mark.parametrize("engine", ("jax",))
def test_unported_engines_raise(engine):
    """The device scan engine is ported; without CUDA its default device
    raises (the port never carries on on the CPU unasked)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scenario(policy="online", engine=engine, **SIM_KW).run()


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.models, "
        "repro_torch.data, repro_torch.kernels.fused_update, "
        "repro_torch.configs, repro_torch.optim.gap, repro_torch.fault, "
        "repro_torch.launch.steps, repro_torch.launch.train, "
        "repro_torch.launch.serve, repro_torch.models.ssm, "
        "repro_torch.kernels.flash_attention, repro_torch.kernels.ssd_scan, "
        "repro_torch.optim, repro_torch.checkpoint, repro_torch.serve\n"
        "from repro_torch.configs import get_config\n"
        "get_config('qwen3-0.6b'), get_config('mamba2-370m')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_import_neither_jax_nor_repro():
    root = os.path.join(SRC, "repro_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    names = [node.module or ""]
                else:
                    continue
                for n in names:
                    assert n.split(".")[0] not in ("jax", "jaxlib", "repro",
                                                   "ml_dtypes"), \
                        f"{path} imports {n}"
