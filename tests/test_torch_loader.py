"""The port's ``data/loader.py::ShardedLoader`` (a host iterator's
batches placed on a device, ``depth`` ahead on a worker thread, in order)
on the CPU, beside the JAX loader fed the same batches, and the
registry's trailing entry, the paper's LeNet-5 config (``paper-lenet5``),
against the JAX package's. The loader's CUDA route (pinned memory, a side
stream and an event) runs in ``tests/test_torch_cuda.py``."""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import ShardedLoader as JaxLoader  # noqa: E402
from repro_torch.configs import ALIASES, get_config, get_smoke_config  # noqa: E402,E501
from repro_torch.data import ShardedLoader  # noqa: E402


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 50, (2, 8)).astype(np.int32),
             "pair": (rng.standard_normal(3).astype(np.float32),
                      np.float32(i))} for i in range(n)]


@pytest.mark.parametrize("depth", (1, 2, 5))
def test_order_and_content_match_the_jax_loader(depth):
    host = _batches(7, depth)
    ours = list(ShardedLoader(iter(host), "cpu", depth=depth))
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    theirs = list(JaxLoader(iter(host), jax.tree.map(lambda _: sharding,
                                                     host[0]), depth=depth))
    assert len(ours) == len(theirs) == 7
    for o, t in zip(ours, theirs):
        assert o["tokens"].dtype == torch.int32
        assert jax.tree.structure(o) == jax.tree.structure(t)
        for a, b in zip(jax.tree.leaves(o), jax.tree.leaves(t)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_prefetches_at_most_depth_ahead_and_copies():
    """The worker runs ahead of the consumer by ``depth`` placed batches
    (and one in hand); a placed batch is a copy, so an iterator that
    reuses its buffer does not change batches already placed."""
    pulled = []
    buf = np.zeros(4, np.float32)

    def source():
        for i in range(10):
            buf[:] = i
            pulled.append(i)
            yield {"x": buf}

    loader = ShardedLoader(source(), "cpu", depth=3)
    deadline = time.time() + 10
    while len(pulled) < 4 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    assert len(pulled) == 4             # 3 queued, 1 waiting to be queued
    got = [float(b["x"][0]) for b in loader]
    assert got == [float(i) for i in range(10)]
    with pytest.raises(StopIteration):
        next(loader)


def test_iterator_errors_reach_the_consumer():
    def source():
        yield {"x": np.ones(2)}
        raise RuntimeError("reader failed")

    loader = ShardedLoader(source(), "cpu")
    assert torch.equal(next(loader)["x"], torch.ones(2, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="reader failed"):
        next(loader)
    with pytest.raises(StopIteration):
        next(loader)
    with pytest.raises(ValueError, match="depth"):
        ShardedLoader(iter(()), "cpu", depth=0)


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedLoader(iter(()))


def test_paper_lenet5_config_matches_jax():
    for get, jget in ((get_config, jax_config),
                      (get_smoke_config, jax_smoke)):
        for arch in ("paper-lenet5", "paper_lenet5"):
            ours, theirs = get(arch), jget(arch)
            assert type(ours).__name__ == type(theirs).__name__ == \
                "LeNetConfig"
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_every_jax_registry_id_resolves():
    """Each id the JAX registry takes (its ALIASES keys and module names)
    gives an equal config in the port."""
    from repro.configs import ALIASES as JAX_ALIASES
    for arch in set(JAX_ALIASES) | set(JAX_ALIASES.values()):
        assert arch in ALIASES, arch
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jax_smoke(arch))
