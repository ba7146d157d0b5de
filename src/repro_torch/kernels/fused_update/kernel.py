"""Triton kernels for Hopper: the two fused momentum passes with their sum
of squares, K1 (the server push apply) and K2 (the client momentum step).

K1 replaces ``repro/kernels/fused_update/kernel.py::_apply_kernel``
(launched by ``fused_apply_2d``), the TPU kernel of the aggregation hot
path:

    mixed = w * new + (1 - w) * cur              (read new, cur; write mixed)
    s     = (cur - mixed) * inv_eta
    v'    = beta * v + (1 - beta) * s            (read v; write v')
    Sum(v'^2)                                    (one partial per program)

K2 replaces ``repro/kernels/fused_update/kernel.py::_kernel`` (launched by
``fused_update_2d``), the client step of Eq. 1 with the Eq. 4 norm:

    v'     = beta * v + (1 - beta) * g           (read v, g; write v')
    theta' = theta - eta * v'                    (read theta; write theta')
    Sum(v'^2)                                    (one partial per program)

What bounds both on an H100: memory. Each element reads 3 f32 and writes
2 f32 (20 bytes) for 6-8 flops, so the least time is 20 bytes per element
at 3.35 TB/s (HBM3): 3.56 ms for K2 at Qwen3-0.6B's 596,049,920
parameters. The flops are three orders of magnitude below the f32 peak.
The design does only what keeps them at that bound:

- one pass, 1-D grid over ``BLOCK`` elements; the tail block masks its
  loads (masked lanes read 0, so their v' is 0 and adds 0 to the sum)
  instead of the TPU version's zero padding to a (rows, 128) grid;
- the scalars (``w``, ``inv_eta``, ``eta``, ``beta``) are runtime f32
  arguments, so one compile serves every push and every step;
- each program writes its block's partial ``Sum(v'^2)`` and the wrapper
  sums the partials in a second, deterministic stage (no atomics), so the
  momentum norm and the Eq. 4 gap repeat bit for bit from run to run;
- both kernels allocate their outputs and never write into their inputs:
  the server's live parameters are what a client pulls, so an in-place
  pass would change the global model under it;
- K1 launches with ``enable_fp_fusion=False``: ``s = (cur - mixed) *
  inv_eta`` cancels, and an FMA-contracted ``mixed`` would move ``v'`` past
  the reference's bound. K2 has no such cancellation (``theta - eta * v'``
  is an update, not a difference of near-equal values), so it keeps
  Triton's default contraction.

``triton`` is imported inside the launching functions, never at module
import, so the CPU-only test environment imports this module freely.
"""
from __future__ import annotations

import functools
import os
import pathlib

import torch

BLOCK = 1024            # elements per program: 8 per thread at 4 warps
NUM_WARPS = 4
BYTES_PER_ELEMENT = 20  # 3 f32 reads + 2 f32 writes (K1 and K2 alike)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)

# kernel builds land inside the checkout, in a directory .gitignore lists
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / ".kernel_build"


@functools.cache
def _apply_kernel():
    """Build (once per process) the jitted Triton kernel of K1."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(_BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def fused_apply_kernel(cur_ptr, v_ptr, new_ptr, mixed_ptr, v_out_ptr,
                           partial_ptr, n, w, inv_eta, beta,
                           BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        cur = tl.load(cur_ptr + offs, mask=m, other=0.0)
        v = tl.load(v_ptr + offs, mask=m, other=0.0)
        new = tl.load(new_ptr + offs, mask=m, other=0.0)
        mixed = w * new + (1.0 - w) * cur
        s = (cur - mixed) * inv_eta
        v_new = beta * v + (1.0 - beta) * s
        tl.store(mixed_ptr + offs, mixed, mask=m)
        tl.store(v_out_ptr + offs, v_new, mask=m)
        tl.store(partial_ptr + pid, tl.sum(v_new * v_new, axis=0))

    return fused_apply_kernel


def _check_flat_f32_cuda(fn, first, named):
    """Raise unless every tensor is a flat contiguous f32 CUDA tensor of
    ``first``'s size, with offsets that fit the kernels' int32 indexing."""
    if first.numel() >= 2 ** 31 - BLOCK:
        raise ValueError(f"{fn}: {first.numel()} elements exceed the "
                         "kernel's int32 offsets")
    for name, t in named:
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 1 \
                or not t.is_contiguous() or t.numel() != first.numel():
            raise ValueError(
                f"{fn}: {name} must be a flat contiguous f32 CUDA tensor of "
                f"{first.numel()} elements, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def fused_apply_triton(cur, v, new, w, inv_eta, beta):
    """Launch K1 on flat, contiguous, same-size f32 CUDA tensors.

    Returns (mixed, v', sumsq) with sumsq a 0-d f32 tensor; allocates its
    outputs (nothing is updated in place). The caller has short-circuited
    empty inputs."""
    _check_flat_f32_cuda("fused_apply_triton", cur,
                         (("cur", cur), ("v", v), ("new", new)))
    n = cur.numel()
    nblk = -(-n // BLOCK)
    mixed = torch.empty_like(cur)
    v_out = torch.empty_like(v)
    partials = torch.empty(nblk, dtype=torch.float32, device=cur.device)
    _apply_kernel()[(nblk,)](cur, v, new, mixed, v_out, partials, n,
                             float(w), float(inv_eta), float(beta),
                             BLOCK=BLOCK, num_warps=NUM_WARPS,
                             enable_fp_fusion=False)
    fused_apply_triton.launches += 1
    return mixed, v_out, torch.sum(partials)


fused_apply_triton.launches = 0     # K1 launches since the last reset


@functools.cache
def _update_kernel():
    """Build (once per process) the jitted Triton kernel of K2."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(_BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def fused_update_kernel(theta_ptr, v_ptr, g_ptr, theta_out_ptr,
                            v_out_ptr, partial_ptr, n, eta, beta,
                            BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        theta = tl.load(theta_ptr + offs, mask=m, other=0.0)
        v = tl.load(v_ptr + offs, mask=m, other=0.0)
        g = tl.load(g_ptr + offs, mask=m, other=0.0)
        v_new = beta * v + (1.0 - beta) * g
        tl.store(theta_out_ptr + offs, theta - eta * v_new, mask=m)
        tl.store(v_out_ptr + offs, v_new, mask=m)
        tl.store(partial_ptr + pid, tl.sum(v_new * v_new, axis=0))

    return fused_update_kernel


def fused_update_triton(theta, v, g, eta, beta):
    """Launch K2 on flat, contiguous, same-size f32 CUDA tensors.

    Returns (theta', v', sumsq) with sumsq a 0-d f32 tensor; allocates its
    outputs (nothing is updated in place). The caller has short-circuited
    empty inputs."""
    _check_flat_f32_cuda("fused_update_triton", theta,
                         (("theta", theta), ("v", v), ("g", g)))
    n = theta.numel()
    nblk = -(-n // BLOCK)
    theta_out = torch.empty_like(theta)
    v_out = torch.empty_like(v)
    partials = torch.empty(nblk, dtype=torch.float32, device=theta.device)
    _update_kernel()[(nblk,)](theta, v, g, theta_out, v_out, partials, n,
                              float(eta), float(beta), BLOCK=BLOCK,
                              num_warps=NUM_WARPS)
    fused_update_triton.launches += 1
    return theta_out, v_out, torch.sum(partials)


fused_update_triton.launches = 0    # K2 launches since the last reset
