"""Public wrappers of the client momentum step (K2) and the server push
apply (K1): flat tensors and whole trees.

``fused_update_flat`` is the one dispatch point of K2 and
``fused_apply_flat`` that of K1. ``kernel`` picks the implementation from
the device of the tensors it is given:

- ``"auto"``: the Triton kernel for CUDA tensors, the plain version for
  CPU tensors (which only a caller that asked for the CPU has);
- ``"triton"``: the Triton kernel; a CPU tensor raises;
- ``"reference"``: the plain version on either device, an explicit choice
  (``chip_smoke.py`` uses it to hold the kernels against it on the card).

There is no fallback: a CUDA tensor under ``auto``/``triton`` launches the
kernel or raises.

``fused_momentum_gap_update`` and ``fused_weighted_apply`` are the tree
versions (the counterparts of ``repro.kernels.fused_update.ops``'s
``fused_momentum_gap_update_pallas`` and ``fused_weighted_apply_pallas``):
flatten the leaves once, one kernel pass, split back. A flat tensor is a
one-leaf tree, so a caller that keeps its parameters in one flat buffer
pays no flatten or concat at all.
"""
from __future__ import annotations

from typing import Any

import torch

from .kernel import fused_apply_triton, fused_update_triton
from .ref import fused_apply_flat_ref, fused_update_flat_ref

KERNEL_MODES = ("auto", "triton", "reference")


def check_kernel_mode(mode: str) -> str:
    if mode not in KERNEL_MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; expected one of "
                         f"{KERNEL_MODES}")
    return mode


def _use_kernel(kernel: str, t) -> bool:
    """Whether ``kernel`` launches the Triton kernel for tensor ``t``."""
    check_kernel_mode(kernel)
    if kernel == "reference" or (kernel == "auto" and not t.is_cuda):
        return False
    if not t.is_cuda:
        raise ValueError("kernel='triton' needs CUDA tensors; got tensors "
                         f"on {t.device}")
    return True


def _empty_result(a, b):
    return (torch.empty_like(a, dtype=torch.float32),
            torch.empty_like(b, dtype=torch.float32),
            torch.zeros((), dtype=torch.float32, device=a.device))


def fused_update_flat(theta, v, g, eta, beta, *, kernel="auto"):
    """Client momentum step on flat f32 tensors of one size: Eq. 1 and the
    sum of squares of the new momentum in one pass. Returns
    (theta', v', sumsq), sumsq a 0-d f32 tensor on the inputs' device;
    the outputs are new tensors (the inputs are left as they were)."""
    if theta.numel() == 0:
        check_kernel_mode(kernel)
        return _empty_result(theta, v)
    if _use_kernel(kernel, theta):
        return fused_update_triton(theta, v, g, eta, beta)
    return fused_update_flat_ref(theta, v, g, eta, beta)


def fused_apply_flat(cur, v, new, w, inv_eta, beta, *, kernel="auto"):
    """Server push apply on flat f32 tensors of one size: mix + momentum +
    sum of squares in one pass. Returns (mixed, v', sumsq), sumsq a 0-d
    f32 tensor on the inputs' device."""
    if cur.numel() == 0:
        check_kernel_mode(kernel)
        return _empty_result(cur, v)
    if _use_kernel(kernel, cur):
        return fused_apply_triton(cur, v, new, w, inv_eta, beta)
    return fused_apply_flat_ref(cur, v, new, w, inv_eta, beta)


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


def fused_momentum_gap_update(params: Any, v: Any, grads: Any, *, eta: float,
                              beta: float, lag, kernel: str = "auto"):
    """Tree version of the client momentum step; same contract as
    ``repro.optim.gap.fused_momentum_gap_update``: one flatten, one K2
    pass for Eq. 1 and the new momentum's sum of squares, one split back.

    Returns (new_params, new_v, gap) with the Eq. 4 gap
    ``eta * (1 - beta^lag) / (1 - beta) * ||v'||_2`` as a 0-d f32 tensor,
    its scale computed in f32 as the JAX wrapper does."""
    p_o, v_o, sumsq = fused_update_flat(
        flatten_concat(params), flatten_concat(v), flatten_concat(grads),
        eta, beta, kernel=kernel)
    lag = torch.as_tensor(lag, dtype=torch.float32, device=sumsq.device)
    scale = eta * (1.0 - beta ** lag) / (1.0 - beta)
    return (split_back(p_o, params, keep_dtype=True),
            split_back(v_o, params, keep_dtype=False),
            scale * torch.sqrt(sumsq))
