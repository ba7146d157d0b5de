"""Checkpoint/restart: per-leaf .npy files + JSON manifest, atomic
directory commit, async background save, keep-N GC — the counterpart of
``repro/checkpoint/checkpointer.py``, with its on-disk layout exactly, so
a checkpoint written by either package restores in the other:

    <dir>/step_00000123.tmp/...   (during write)
    <dir>/step_00000123/manifest.json
    <dir>/step_00000123/leaf_00000.npy ...

The manifest lists each leaf's ``path`` (the string
``jax.tree_util.keystr`` gives it: ``['params']['embed']``, ``[0]`` for a
sequence index), ``file``, logical ``dtype`` and ``shape``, in the JAX
package's leaf order (sorted dict keys). numpy has no bfloat16 or float8,
so those leaves are stored as a same-width unsigned view (``uint16`` /
``uint8``) with the logical dtype in the manifest.

One card has no counterpart of the JAX package's ``shardings``: restore
places each leaf on its template leaf's device, in its dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..kernels.fused_update.ops import tree_map, tree_unflatten

# logical dtypes numpy cannot hold -> (torch dtype, the signed int of the
# same width torch views it as, the unsigned numpy view on disk)
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.int8, np.uint8),
}
_EXOTIC_OF = {v[0]: k for k, v in _EXOTIC.items()}


def _flatten_with_paths(tree, prefix=""):
    """(leaves, keystr paths) in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", x) for i, x in enumerate(tree)]
    else:
        return [tree], [prefix]
    leaves, paths = [], []
    for key, sub in items:
        l, p = _flatten_with_paths(sub, prefix + key)
        leaves += l
        paths += p
    return leaves, paths


def _to_numpy(leaf):
    """A host leaf as (array to save, logical dtype name)."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype in _EXOTIC_OF:
            name = _EXOTIC_OF[leaf.dtype]
            _, signed, unsigned = _EXOTIC[name]
            return leaf.view(signed).numpy().view(unsigned), name
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_pytree(tree: Any, path: str, step: int) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves, paths = _flatten_with_paths(tree)
    manifest = {"step": step, "leaves": []}
    for i, (leaf, p) in enumerate(zip(leaves, paths)):
        arr, logical = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": p, "file": fname,
                                   "dtype": logical,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)        # atomic commit
    return final


def _load_leaf(step_dir: str, entry: dict) -> torch.Tensor:
    arr = np.load(os.path.join(step_dir, entry["file"]))
    if entry["dtype"] in _EXOTIC:
        logical, signed, _ = _EXOTIC[entry["dtype"]]
        signed_np = np.int16 if signed is torch.int16 else np.int8
        return torch.from_numpy(arr.view(signed_np)).view(logical)
    return torch.from_numpy(arr)


def restore_pytree(template: Any, path: str,
                   step: Optional[int] = None) -> tuple[Any, int]:
    """Restore into the structure of ``template`` (a tree of tensors): each
    leaf lands on its template leaf's device, in its dtype."""
    step_dir = latest_step_dir(path) if step is None else \
        os.path.join(path, f"step_{step:08d}")
    if step_dir is None or not os.path.isdir(step_dir):
        raise FileNotFoundError(f"no checkpoint under {path}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, paths = _flatten_with_paths(template)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for leaf, p in zip(leaves, paths):
        t = _load_leaf(step_dir, by_path[p])
        if list(t.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {p}: ckpt "
                             f"{tuple(t.shape)} vs template "
                             f"{tuple(leaf.shape)}")
        out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return tree_unflatten(template, out), manifest["step"]


def _step_dirs(path: str) -> list:
    return sorted(d for d in os.listdir(path)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step_dir(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    steps = _step_dirs(path)
    return os.path.join(path, steps[-1]) if steps else None


class Checkpointer:
    """Async keep-N checkpointer: ``save`` copies the tree to the host,
    then writes it on a background thread (``wait`` joins it; the next
    ``save`` and ``restore`` wait first)."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        os.makedirs(path, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def save(self, tree: Any, step: int, blocking: bool = False):
        self.wait()
        host_tree = tree_map(
            lambda l: l.detach().to("cpu", copy=True), tree)

        def work():
            save_pytree(host_tree, self.path, step)
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, template: Any, step: Optional[int] = None):
        self.wait()
        return restore_pytree(template, self.path, step)

    def latest_step(self) -> Optional[int]:
        d = latest_step_dir(self.path)
        if d is None:
            return None
        return int(os.path.basename(d).split("_")[1])

    def _gc(self):
        for d in _step_dirs(self.path)[: -self.keep]:
            shutil.rmtree(os.path.join(self.path, d), ignore_errors=True)
