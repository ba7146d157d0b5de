"""Public wrappers of the server push apply: flat tensors and whole trees.

``fused_apply_flat`` is the one dispatch point of K1. ``kernel`` picks the
implementation from the device of the tensors it is given:

- ``"auto"``: the Triton kernel for CUDA tensors, the plain version for
  CPU tensors (which only a caller that asked for the CPU has);
- ``"triton"``: the Triton kernel; a CPU tensor raises;
- ``"reference"``: the plain version on either device, an explicit choice
  (``chip_smoke.py`` uses it to hold the kernel against it on the card).

There is no fallback: a CUDA tensor under ``auto``/``triton`` launches the
kernel or raises.

``fused_weighted_apply`` is the tree version (the counterpart of
``repro.kernels.fused_update.ops.fused_weighted_apply_pallas``): flatten
the leaves once, one K1 pass, split back. A flat tensor is a one-leaf
tree, so a server that keeps its parameters in one flat buffer pays no
flatten or concat at all.
"""
from __future__ import annotations

from typing import Any

import torch

from .kernel import fused_apply_triton
from .ref import fused_apply_flat_ref

KERNEL_MODES = ("auto", "triton", "reference")


def check_kernel_mode(mode: str) -> str:
    if mode not in KERNEL_MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; expected one of "
                         f"{KERNEL_MODES}")
    return mode


def fused_apply_flat(cur, v, new, w, inv_eta, beta, *, kernel="auto"):
    """Server push apply on flat f32 tensors of one size: mix + momentum +
    sum of squares in one pass. Returns (mixed, v', sumsq), sumsq a 0-d
    f32 tensor on the inputs' device."""
    check_kernel_mode(kernel)
    if cur.numel() == 0:
        return (cur.float(), v.float(),
                torch.zeros((), dtype=torch.float32, device=cur.device))
    if kernel == "reference" or (kernel == "auto" and not cur.is_cuda):
        return fused_apply_flat_ref(cur, v, new, w, inv_eta, beta)
    if not cur.is_cuda:
        raise ValueError("kernel='triton' needs CUDA tensors; got tensors "
                         f"on {cur.device}")
    return fused_apply_triton(cur, v, new, w, inv_eta, beta)


# ---------------------------------------------------------------------------
# Trees of tensors: nested dicts (sorted keys, the ``jax.tree.leaves``
# order), lists or tuples with tensor leaves; a bare tensor is one leaf.
# ---------------------------------------------------------------------------
def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for x in tree for l in tree_leaves(x)]
    return [tree]


def tree_unflatten(like, leaves):
    """Rebuild ``like``'s structure from ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    return tree_unflatten(tree, [fn(*xs) for xs in
                                 zip(tree_leaves(tree),
                                     *(tree_leaves(r) for r in rest))])


def flatten_concat(tree):
    leaves = tree_leaves(tree)
    if len(leaves) == 1:
        return leaves[0].reshape(-1).float()
    return torch.cat([l.reshape(-1).float() for l in leaves])


def split_back(flat, like, keep_dtype: bool):
    out, off = [], 0
    for l in tree_leaves(like):
        piece = flat[off:off + l.numel()].view(l.shape)
        out.append(piece.to(l.dtype) if keep_dtype else piece)
        off += l.numel()
    return tree_unflatten(like, out)


def fused_weighted_apply(params: Any, v: Any, new_params: Any, *, w,
                         eta: float, beta: float, kernel: str = "auto"):
    """Tree version of the server push apply; same contract as
    ``repro.optim.gap.fused_weighted_apply``: one flatten, one K1 pass for
    the weighted mix, the server momentum recursion and the post-update
    norm, one split back.

    Returns (mixed_params, new_v, v_norm), v_norm = ||v'||_2 as a 0-d f32
    tensor (callers ``float()`` it when the host needs it)."""
    inv_eta = 1.0 / max(eta, 1e-12)
    m, v2, sumsq = fused_apply_flat(
        flatten_concat(params), flatten_concat(v), flatten_concat(new_params),
        w, inv_eta, beta, kernel=kernel)
    return (split_back(m, params, keep_dtype=True),
            split_back(v2, params, keep_dtype=False),
            torch.sqrt(sumsq))
