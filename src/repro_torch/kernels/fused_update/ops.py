"""Public wrappers of the client momentum step (K2) and the server push
apply (K1): flat tensors, a chunk of pushes and whole trees.

``fused_update_flat`` is the one dispatch point of K2 and
``fused_apply_cohort`` that of K1: one launch applies a chunk of up to
``KMAX`` pushes and returns every norm the finish needs.
``fused_apply_flat`` is its one-push case. ``kernel`` (``"auto"``,
``"triton"`` or ``"reference"``) picks the implementation from the device
of the tensors it is given, by the rule of ``kernels/mode.py``.

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

from .. import mode
from .kernel import K1_BLOCK, KMAX, fused_apply_triton, fused_update_triton
from .ref import fused_apply_cohort_ref, fused_update_flat_ref

KERNEL_MODES = mode.kernel_modes("triton")


def check_kernel_mode(kernel: str) -> str:
    return mode.check_kernel_mode(kernel, "triton")


def _use_kernel(kernel: str, t) -> bool:
    """Whether ``kernel`` launches the Triton kernel for tensor ``t``."""
    return mode.use_kernel(kernel, t, "triton")


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


def _check_cohort(cur, v, trained, weights):
    """Raise unless ``cur`` and ``v`` are flat contiguous f32 tensors of N
    elements on one device (N within the kernel's int32 offsets),
    ``trained`` a contiguous ``(k, N)`` f32 tensor there with 1 <= k <=
    KMAX (k = 0 only for N = 0) and ``weights`` None or a ``(k,)`` f32
    tensor there."""
    n = cur.numel()
    for name, t in (("cur", cur), ("v", v)):
        if t.dtype != torch.float32 or t.dim() != 1 or t.numel() != n \
                or not t.is_contiguous() or t.device != cur.device:
            raise ValueError(
                f"fused_apply_cohort: {name} must be a flat contiguous f32 "
                f"tensor of {n} elements on {cur.device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if n >= 2 ** 31 - K1_BLOCK:
        raise ValueError(f"fused_apply_cohort: {n} elements exceed the "
                         "kernel's int32 offsets")
    if trained.dim() != 2 or trained.shape[1] != n:
        raise ValueError(
            f"fused_apply_cohort: trained must be (k, {n}) for cur and v "
            f"of {n} elements; got {tuple(trained.shape)}")
    k = trained.shape[0]
    if k > KMAX or (k == 0 and n > 0):
        raise ValueError(f"fused_apply_cohort: k = {k} pushes; a launch "
                         f"applies 1 to {KMAX}")
    if trained.dtype != torch.float32 or not trained.is_contiguous() \
            or trained.device != cur.device:
        raise ValueError(
            "fused_apply_cohort: trained must be a contiguous f32 tensor on "
            f"{cur.device}; got {trained.dtype} on {trained.device}, "
            f"contiguous={trained.is_contiguous()}")
    if weights is not None and (
            weights.shape != (k,) or weights.dtype != torch.float32
            or weights.device != cur.device):
        raise ValueError(
            f"fused_apply_cohort: weights must be a ({k},) f32 tensor on "
            f"{cur.device}; got {weights.dtype} {tuple(weights.shape)} on "
            f"{weights.device}")


def fused_apply_cohort(cur, v, trained, weights, inv_eta, beta, *,
                       kernel="auto"):
    """Apply a chunk's k pushes in order — for each row j of ``trained``
    (``(k, N)``, k <= ``KMAX``) with weight ``weights[j]`` (a ``(k,)`` f32
    tensor on the inputs' device; None for weights of 1, the ``replace``
    rule) the mix, the momentum update and its sum of squares — in one
    K1 launch.

    Returns (p', v', sumsq, norms): p' and v' new flat tensors (the inputs
    are left as they were), sumsq and norms ``(k + 1,)`` f32 on the
    inputs' device: the entry momentum's, then each push's post-push sum
    of squares, and their square roots (norm j is push j's pre-push norm
    for Eq. 4, norm k the final ``||v||``)."""
    _check_cohort(cur, v, trained, weights)
    if cur.numel() == 0:
        check_kernel_mode(kernel)
        k = trained.shape[0]
        zeros = torch.zeros(k + 1, dtype=torch.float32, device=cur.device)
        return torch.empty_like(cur), torch.empty_like(v), zeros, \
            zeros.clone()
    if _use_kernel(kernel, cur):
        return fused_apply_triton(cur, v, trained, weights, inv_eta, beta)
    return fused_apply_cohort_ref(cur, v, trained, weights, inv_eta, beta)


def _apply_one(cur, v, new, w, inv_eta, beta, kernel):
    """One push (weight ``w``, a number) as a one-row chunk."""
    w = float(w)
    weights = None if w == 1.0 else torch.full(
        (1,), w, dtype=torch.float32, device=cur.device)
    return fused_apply_cohort(cur, v, new.reshape(1, -1), weights, inv_eta,
                              beta, kernel=kernel)


def fused_apply_flat(cur, v, new, w, inv_eta, beta, *, kernel="auto"):
    """Server push apply on flat f32 tensors of one size: mix + momentum +
    sum of squares in one pass (``fused_apply_cohort`` with one push).
    Returns (mixed, v', sumsq), sumsq a 0-d f32 tensor on the inputs'
    device."""
    mixed, v_new, sums, _ = _apply_one(cur, v, new, w, inv_eta, beta,
                                       kernel)
    return mixed, v_new, sums[1]


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


def _build(t, it):
    if isinstance(t, dict):
        out = {k: _build(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    return next(it)


def tree_unflatten(like, leaves):
    """Rebuild ``like``'s structure from ``leaves`` (in ``tree_leaves``
    order). A module-level recursion: a nested recursive closure is a
    reference cycle, which kept every call's leaves alive until the
    cyclic garbage collector ran (tens of GiB of the LM trainer's
    tensors at full width)."""
    return _build(like, iter(leaves))


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
    m, v2, _, norms = _apply_one(
        flatten_concat(params), flatten_concat(v), flatten_concat(new_params),
        w, inv_eta, beta, kernel)
    return (split_back(m, params, keep_dtype=True),
            split_back(v2, params, keep_dtype=False), norms[1])


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
