"""The port's checkpointer (``repro_torch/checkpoint``) on the CPU: its own
round trips, atomicity and keep-N GC, and the JAX package's on-disk
layout — the same manifest and .npy bytes for the same tree, so a
checkpoint written by ``repro.checkpoint`` restores in the port and the
other way round, bf16 leaves included. Everything is written under
``tmp_path``; every background save is joined (``wait``)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpointer as jck  # noqa: E402
from repro_torch.checkpoint.checkpointer import (  # noqa: E402
    Checkpointer, latest_step_dir, restore_pytree, save_pytree)
from repro_torch.kernels.fused_update.ops import tree_leaves  # noqa: E402


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((8, 4)).astype(np.float32),
                       "b": rng.standard_normal(4).astype(np.float32)},
            "opt": {"mu": rng.standard_normal((8, 4)).astype(np.float32)},
            "layers": [rng.standard_normal(3).astype(np.float32),
                       rng.standard_normal((2, 2)).astype(np.float32)],
            "step": np.int32(17 + seed)}


def _tree(seed=0):
    """The port's tree: ``params.b`` in bf16, ``step`` a 0-d int32."""
    t = _np_tree(seed)
    out = {"params": {"w": torch.from_numpy(t["params"]["w"]),
                      "b": torch.from_numpy(t["params"]["b"]).bfloat16()},
           "opt": {"mu": torch.from_numpy(t["opt"]["mu"])},
           "layers": [torch.from_numpy(x) for x in t["layers"]],
           "step": torch.tensor(int(t["step"]), dtype=torch.int32)}
    return out


def _jax_tree(seed=0):
    t = _np_tree(seed)
    return {"params": {"w": jnp.asarray(t["params"]["w"]),
                       "b": jnp.asarray(t["params"]["b"], jnp.bfloat16)},
            "opt": {"mu": jnp.asarray(t["opt"]["mu"])},
            "layers": [jnp.asarray(x) for x in t["layers"]],
            "step": jnp.int32(t["step"])}


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _same_as_jax(ours, theirs):
    la, lb = tree_leaves(ours), jax.tree.leaves(theirs)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert tuple(x.shape) == y.shape
        assert str(x.dtype).removeprefix("torch.") == str(y.dtype)
        np.testing.assert_array_equal(x.float().numpy(),
                                      np.asarray(y, np.float32))


def test_roundtrip(tmp_path):
    t = _tree()
    save_pytree(t, str(tmp_path), 5)
    restored, step = restore_pytree(_tree(seed=9), str(tmp_path))
    assert step == 5
    _same(restored, t)


def test_latest_and_specific_step(tmp_path):
    save_pytree(_tree(0), str(tmp_path), 1)
    save_pytree(_tree(1), str(tmp_path), 2)
    r, step = restore_pytree(_tree(), str(tmp_path))
    assert step == 2
    _same(r, _tree(1))
    r, step = restore_pytree(_tree(), str(tmp_path), step=1)
    assert step == 1
    _same(r, _tree(0))


def test_restore_takes_template_device_and_dtype(tmp_path):
    save_pytree(_tree(), str(tmp_path), 3)
    template = _tree()
    template["params"]["w"] = template["params"]["w"].double()
    template["params"]["b"] = template["params"]["b"].float()
    r, _ = restore_pytree(template, str(tmp_path))
    assert r["params"]["w"].dtype == torch.float64
    assert r["params"]["b"].dtype == torch.float32
    assert torch.equal(r["params"]["b"], _tree()["params"]["b"].float())
    assert all(l.device == torch.device("cpu") for l in tree_leaves(r))


def test_shape_mismatch_and_missing_raise(tmp_path):
    save_pytree(_tree(), str(tmp_path), 1)
    bad = _tree()
    bad["params"]["w"] = torch.zeros((3, 3))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree(bad, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        restore_pytree(_tree(), str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError):
        restore_pytree(_tree(), str(tmp_path), step=4)


def test_no_tmp_dirs_left(tmp_path):
    save_pytree(_tree(), str(tmp_path), 1)
    save_pytree(_tree(1), str(tmp_path), 1)      # overwrite a step
    assert os.listdir(tmp_path) == ["step_00000001"]
    _same(restore_pytree(_tree(), str(tmp_path))[0], _tree(1))


def test_async_save_and_gc(tmp_path):
    c = Checkpointer(str(tmp_path), keep=2)
    try:
        for s in (1, 2, 3, 4):
            c.save(_tree(s), s)
    finally:
        c.wait()
    assert c._thread is None
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    assert c.latest_step() == 4
    r, step = c.restore(_tree(0))
    assert step == 4
    _same(r, _tree(4))


def test_save_snapshots_the_tree_before_returning(tmp_path):
    """``save`` copies to the host before the background write: a tensor
    rebound (or mutated) after ``save`` returns does not reach the disk."""
    c = Checkpointer(str(tmp_path))
    t = _tree(3)
    try:
        c.save(t, 10)
        t["params"]["w"].zero_()
    finally:
        c.wait()
    r, step = c.restore(_tree(0))
    assert step == 10
    _same(r, _tree(3))


def test_interrupted_write_invisible(tmp_path):
    """A .tmp directory (a crash mid-write) is never restored."""
    save_pytree(_tree(0), str(tmp_path), 1)
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert latest_step_dir(str(tmp_path)).endswith("step_00000001")
    assert Checkpointer(str(tmp_path)).latest_step() == 1
    assert latest_step_dir(str(tmp_path / "nope")) is None


def test_layout_equals_jax(tmp_path):
    """The same tree saved by both packages: equal manifests (paths in
    ``jax.tree_util.keystr`` form, files, logical dtypes, shapes) and
    byte-equal .npy files, bf16 as its uint16 view."""
    ours = save_pytree(_tree(), str(tmp_path / "torch"), 7)
    theirs = jck.save_pytree(_jax_tree(), str(tmp_path / "jax"), 7)
    with open(os.path.join(ours, "manifest.json")) as f:
        m_ours = json.load(f)
    with open(os.path.join(theirs, "manifest.json")) as f:
        m_theirs = json.load(f)
    assert m_ours == m_theirs
    assert "['params']['b']" in [e["path"] for e in m_ours["leaves"]]
    assert "['layers'][1]" in [e["path"] for e in m_ours["leaves"]]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for e in m_ours["leaves"]:
        a = np.load(os.path.join(ours, e["file"]))
        b = np.load(os.path.join(theirs, e["file"]))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_jax_checkpoint_restores_in_port_and_back(tmp_path):
    jck.save_pytree(_jax_tree(2), str(tmp_path / "a"), 11)
    r, step = restore_pytree(_tree(0), str(tmp_path / "a"))
    assert step == 11
    _same(r, _tree(2))
    save_pytree(_tree(5), str(tmp_path / "b"), 12)
    rj, step = jck.restore_pytree(_jax_tree(0), str(tmp_path / "b"))
    assert step == 12
    _same_as_jax(_tree(5), rj)
    assert rj["params"]["b"].dtype == jnp.bfloat16
