"""Triton kernels for Hopper: the two fused momentum passes with their sums
of squares, K1 (the server push apply, a whole cohort of pushes in one
launch) and K2 (the client momentum step).

K1 replaces ``repro/kernels/fused_update/kernel.py::_apply_kernel``
(launched by ``fused_apply_2d``), the TPU kernel of the aggregation hot
path, and with it the JAX package's compiled scan of a finisher chunk's
pushes (``repro/core/realml.py::_build_finish_chunk_pallas``). It applies
k pushes in order, for j = 0 .. k-1:

    mixed = w_j * new_j + (1 - w_j) * cur       (cur <- mixed)
    s     = (cur - mixed) * inv_eta
    v     = beta * v + (1 - beta) * s
    Sum(v^2)                                     (push j's post-push sum)

and returns the final parameters and momentum, the k + 1 sums of squares
(the entry momentum's, then each push's) and their square roots: norm j
is push j's pre-push norm (Eq. 4), norm k the final ||v||.

K2 replaces ``repro/kernels/fused_update/kernel.py::_kernel`` (launched by
``fused_update_2d``), the client step of Eq. 1 with the Eq. 4 norm:

    v'     = beta * v + (1 - beta) * g           (read v, g; write v')
    theta' = theta - eta * v'                    (read theta; write theta')
    Sum(v'^2)                                    (one partial per program)

What bounds them on an H100. K2, and K1 at the LM's 596,049,920
parameters (one push a call): memory, 20 bytes an element (3 f32 reads, 2
writes) at 3.35 TB/s, 3.56 ms; the flops are three orders of magnitude
below the f32 peak. K1 at LeNet-5's 62,006 parameters (a chunk of 1-16
pushes, 1.2 MB a push): the host. Its bytes take 0.4 us of HBM time, less
than one launch, so what costs is the count of launches and of the torch
operations around each.

K1's design does only what serves both regimes:

- one launch a chunk: a grid of at most ``PROGRAMS_PER_SM`` programs an
  SM walks ``K1_BLOCK``-element tiles; each program loads its
  tile of ``cur`` and ``v`` once, keeps them in registers while it reads
  the k rows of ``trained`` (a contiguous ``(k, N)`` tensor) in order, and
  writes the final p' and v' once: ``((2 + k) * 4 + 8)`` bytes an element
  instead of ``20 * k``. Full tiles load and store without a mask; only
  the ragged tail tile masks (its masked lanes read 0, so v stays 0 there
  and adds 0 to every sum);
- every norm from the same launch: each program sums each row's squares
  per tile (``tl.sum``) into one register vector of ``ROWS`` sums (row 0
  the entry ``v``, row j + 1 push j), walking its tiles in a fixed order,
  and writes k + 1 partials. The last program to finish — found with an
  acq_rel atomic ticket on a cached per-device int32 counter, which it
  resets to 0 — reads the partials past L1 (``.cg``), reduces each row in
  one fixed order, and writes the k + 1 sums and their ``sqrt_rn``. No
  torch reduction follows the launch, and no float atomics: the result
  repeats bit for bit. Every row is summed by the same code in the same
  order and the grid depends on N alone, so a k-push launch equals k
  one-push launches bit for bit, norms included;
- the k weights are a ``(k,)`` f32 device tensor. Weights of 1 (the
  ``replace`` rule: mixed is the trained row) are a cached tensor of ones,
  so the main path copies nothing to the device;
- two allocations: p', and one slab holding v' and, 128 bytes aligned
  after it, the 2(k + 1) sums; v' and the sums are views into it. p'
  stands alone because it outlives v': a client's pulled parameters, and
  the trained model handed on to serving, are references to it, and a
  shared slab would keep each one's momentum alive too (2.2 GiB at the
  LM's width). Nothing is written in place;
- ``enable_fp_fusion=False``: ``s = (cur - mixed) * inv_eta`` cancels,
  and an FMA-contracted ``mixed`` would move ``v`` past the reference's
  bound; it also keeps each push's arithmetic the same in every launch.
  K2 has no such cancellation (``theta - eta * v'`` is an update, not a
  difference of near-equal values), so it keeps Triton's default
  contraction;
- the ticket counter and the partials are per-device scratch shared by
  every launch, so K1 launches are ordered on one stream (the port uses
  the current stream throughout).

K2 is one pass, a 1-D grid over ``BLOCK`` elements with a masked tail;
each program writes its block's partial ``Sum(v'^2)`` and the wrapper sums
the partials in a second, deterministic stage. Both kernels take their
scalars as runtime f32 arguments, so one compile serves every push and
every step, and allocate their outputs.

``triton`` is imported inside the launching functions, never at module
import, so the CPU-only test environment imports this module freely.
"""
from __future__ import annotations

import functools
import os
import pathlib

import torch

BLOCK = 1024            # K2's elements per program: 8 a thread at 4 warps
NUM_WARPS = 4
BYTES_PER_ELEMENT = 20  # 3 f32 reads + 2 f32 writes (K1 at k = 1, K2)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)

KMAX = 16               # pushes a K1 launch applies at most
K1_ROWS = 32            # the sums' register vector: KMAX + 1, a power of 2
K1_BLOCK = 4096         # elements per K1 tile: 16 per thread at 8 warps
K1_WARPS = 8
PROGRAMS_PER_SM = 8     # K1's grid: at most this many programs per SM
_ALIGN = 32             # f32 elements: the sums start 128 B aligned

# kernel builds land inside the checkout, in a directory .gitignore lists
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / ".kernel_build"


def cohort_bytes(n: int, k: int) -> int:
    """The bytes a k-push K1 launch must move at N = ``n``: cur and v read
    and p' and v' written once (16 B an element), each trained row read
    once (4k B), the k weights and the 2(k + 1) sums."""
    return ((2 + k) * 4 + 8) * n + 4 * k + 8 * (k + 1)


@functools.cache
def _cohort_kernel():
    """Build (once per process) the jitted Triton kernel of K1."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(_BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def push(p, v, new, w, inv_eta, beta, acc, rows, row):
        """One push on a tile in registers; adds Sum(v'^2) to ``acc[row]``."""
        mixed = w * new + (1.0 - w) * p
        s = (p - mixed) * inv_eta
        v = beta * v + (1.0 - beta) * s
        acc = tl.where(rows == row, acc + tl.sum(v * v, axis=0), acc)
        return mixed, v, acc

    @triton.jit
    def push_tile(cur_ptr, v_ptr, tr_ptr, w_ptr, p_out_ptr, v_out_ptr, offs,
                  n, k, row_stride, inv_eta, beta, acc, rows,
                  MASKED: tl.constexpr):
        """Apply the k pushes to one tile; returns ``acc`` with each row's
        sum of squares over the tile added. Push j + 1's row and weight
        are loaded before push j's arithmetic and sum (the last push is
        peeled off the loop, so nothing loads past row k - 1), and each
        load's latency hides behind the push before it."""
        m = offs < n
        if MASKED:
            p = tl.load(cur_ptr + offs, mask=m, other=0.0)
            v = tl.load(v_ptr + offs, mask=m, other=0.0)
            new = tl.load(tr_ptr + offs, mask=m, other=0.0)
        else:
            p = tl.load(cur_ptr + offs)
            v = tl.load(v_ptr + offs)
            new = tl.load(tr_ptr + offs)
        w = tl.load(w_ptr)
        acc = tl.where(rows == 0, acc + tl.sum(v * v, axis=0), acc)
        row_ptr = tr_ptr
        for j in range(k - 1):
            row_ptr += row_stride
            if MASKED:
                new_next = tl.load(row_ptr + offs, mask=m, other=0.0)
            else:
                new_next = tl.load(row_ptr + offs)
            w_next = tl.load(w_ptr + j + 1)
            p, v, acc = push(p, v, new, w, inv_eta, beta, acc, rows, j + 1)
            new = new_next
            w = w_next
        p, v, acc = push(p, v, new, w, inv_eta, beta, acc, rows, k)
        if MASKED:
            tl.store(p_out_ptr + offs, p, mask=m)
            tl.store(v_out_ptr + offs, v, mask=m)
        else:
            tl.store(p_out_ptr + offs, p)
            tl.store(v_out_ptr + offs, v)
        return acc

    @triton.jit(do_not_specialize=["n", "k"])
    def fused_apply_cohort_kernel(cur_ptr, v_ptr, tr_ptr, w_ptr, p_out_ptr,
                                  v_out_ptr, part_ptr, ticket_ptr, n, k,
                                  off, row_stride, inv_eta, beta,
                                  BLOCK: tl.constexpr, ROWS: tl.constexpr,
                                  GMAX: tl.constexpr):
        pid = tl.program_id(0)
        grid = tl.num_programs(0)
        rows = tl.arange(0, ROWS)
        lanes = tl.arange(0, BLOCK)
        acc = tl.zeros((ROWS,), tl.float32)
        n_full = n // BLOCK
        for t in range(pid, n_full, grid):
            acc = push_tile(cur_ptr, v_ptr, tr_ptr, w_ptr, p_out_ptr,
                            v_out_ptr, t * BLOCK + lanes, n, k, row_stride,
                            inv_eta, beta, acc, rows, MASKED=False)
        # the ragged tail is the next tile of the program whose walk it
        # continues, so every program sums its tiles in index order
        if (n_full * BLOCK < n) & (n_full % grid == pid):
            acc = push_tile(cur_ptr, v_ptr, tr_ptr, w_ptr, p_out_ptr,
                            v_out_ptr, n_full * BLOCK + lanes, n, k,
                            row_stride, inv_eta, beta, acc, rows,
                            MASKED=True)
        # the barrier orders every thread's partial stores before the
        # ticket's release, the ticket's acquire before the last program's
        # reads
        for j in range(k + 1):
            tl.store(part_ptr + j * grid + pid,
                     tl.sum(tl.where(rows == j, acc, 0.0), axis=0))
        tl.debug_barrier()
        ticket = tl.atomic_add(ticket_ptr, 1, sem="acq_rel")
        if ticket == grid - 1:
            cols = tl.arange(0, GMAX)
            sums_ptr = v_out_ptr + off
            for j in range(k + 1):
                parts = tl.load(part_ptr + j * grid + cols,
                                mask=cols < grid, other=0.0,
                                cache_modifier=".cg")
                sq = tl.sum(parts, axis=0)
                tl.store(sums_ptr + j, sq)
                tl.store(sums_ptr + k + 1 + j, tl.sqrt_rn(sq))
            tl.store(ticket_ptr, 0)

    return fused_apply_cohort_kernel


@functools.cache
def _device_state(device: int):
    """Per-device state shared by every K1 launch: the grid's cap, the
    partial sums ((KMAX + 1) rows of it), the ticket counter (0 between
    launches: the last program resets it) and KMAX weights of 1."""
    programs = PROGRAMS_PER_SM * torch.cuda.get_device_properties(
        device).multi_processor_count
    return (programs,
            torch.empty((KMAX + 1) * programs, dtype=torch.float32,
                        device=device),
            torch.zeros(1, dtype=torch.int32, device=device),
            torch.ones(KMAX, dtype=torch.float32, device=device))


def ticket_counter(device) -> torch.Tensor:
    """The K1 ticket counter of ``device`` (0 between launches)."""
    device = torch.device(device)
    return _device_state(torch.cuda.current_device() if device.index is None
                         else device.index)[2]


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


def fused_apply_triton(cur, v, trained, weights, inv_eta, beta):
    """Launch K1 once for the k = ``trained.shape[0]`` pushes of a chunk:
    ``cur``/``v`` flat f32 CUDA tensors of N elements, ``trained`` a
    contiguous ``(k, N)`` f32 tensor on their device, ``weights`` a
    ``(k,)`` f32 tensor there or None for weights of 1.

    Returns (p', v', sumsq, norms), all new: p' one tensor, v' and sumsq
    and norms ``(k + 1,)`` views into one slab, row j push j's pre-push
    sum (row k the final one).
    The caller (``ops.fused_apply_cohort``) has checked every argument
    (``ops._check_cohort``) and short-circuited empty inputs."""
    k, n = trained.shape
    programs, partials, ticket, ones = _device_state(cur.get_device())
    off = -(-n // _ALIGN) * _ALIGN
    p_new = torch.empty(n, dtype=torch.float32, device=cur.device)
    slab = torch.empty(off + 2 * (k + 1), dtype=torch.float32,
                       device=cur.device)
    _cohort_kernel()[(min(-(-n // K1_BLOCK), programs),)](
        cur, v, trained, ones if weights is None else weights, p_new, slab,
        partials, ticket, n, k, off, n if k > 1 else 0, float(inv_eta),
        float(beta), BLOCK=K1_BLOCK, ROWS=K1_ROWS,
        GMAX=1 << (programs - 1).bit_length(), num_warps=K1_WARPS,
        enable_fp_fusion=False)
    fused_apply_triton.launches += 1
    fused_apply_triton.pushes += k
    v_new, _, sums, norms = slab.split_with_sizes((n, off - n, k + 1, k + 1))
    return p_new, v_new, sums, norms


fused_apply_triton.launches = 0     # K1 launches since the last reset
fused_apply_triton.pushes = 0       # pushes those launches applied (Sum k)


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
