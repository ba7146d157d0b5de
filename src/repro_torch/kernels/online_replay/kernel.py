"""The ctypes binding of online's in-slot replay, the CUDA C++ kernel in
``src/repro_torch/csrc/online_replay.cu`` (built by
``kernels/_cuda_build.py`` on first use).

``online_replay_cuda`` checks its tensors, allocates the two outputs and
launches one block a config row on the current stream;
``online_replay_cuda.launches`` counts its launches. ``dadd_chain_cuda``
runs the file's yardstick, a chain of dependent f64 adds in one thread.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _cuda_build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _cuda_build.load("online_replay")
    fn = lib.online_replay_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + \
        [ctypes.c_void_p]
    fn = lib.dadd_chain_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double,
                   ctypes.c_void_p]
    return lib


def check_inputs(waiting, base, rhs, gap_idle, gap_vec, H):
    """Shapes and dtypes the kernel and its plain version take: waiting
    (B, n) bool, base/rhs/gap_idle (B, n) f64, gap_vec (B, n + 1) f64, H
    (B,) f64, all on one device."""
    if base.dim() != 2:
        raise ValueError(f"online_replay: base must be (B, n), got "
                         f"{tuple(base.shape)}")
    B, n = base.shape
    want = {"waiting": (waiting, (B, n), torch.bool),
            "base": (base, (B, n), torch.float64),
            "rhs": (rhs, (B, n), torch.float64),
            "gap_idle": (gap_idle, (B, n), torch.float64),
            "gap_vec": (gap_vec, (B, n + 1), torch.float64),
            "H": (H, (B,), torch.float64)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or \
                t.device != base.device:
            raise ValueError(
                f"online_replay: {name} must be {shape} {dtype} on "
                f"{base.device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")


def online_replay_cuda(waiting, base, rhs, gap_idle, gap_vec, H):
    """Launch the replay on CUDA tensors (see ``check_inputs``). Returns
    (start (B, n) bool, gap_sum (B,) f64), new tensors."""
    check_inputs(waiting, base, rhs, gap_idle, gap_vec, H)
    if not base.is_cuda:
        raise ValueError(f"online_replay_cuda needs CUDA tensors, got "
                         f"{base.device}")
    B, n = base.shape
    ins = [t.contiguous() for t in (waiting, base, rhs, gap_idle, gap_vec,
                                    H)]
    start = torch.empty((B, n), dtype=torch.bool, device=base.device)
    gap_sum = torch.empty(B, dtype=torch.float64, device=base.device)
    if B:
        lib = _lib()
        code = lib.online_replay_launch(
            *(t.data_ptr() for t in ins), start.data_ptr(),
            gap_sum.data_ptr(), B, n,
            torch.cuda.current_stream(base.device).cuda_stream)
        _cuda_build.check(lib, "online_replay_launch", code)
        online_replay_cuda.launches += 1
    return start, gap_sum


online_replay_cuda.launches = 0   # replay launches since the last reset


def dadd_chain_cuda(m: int):
    """m dependent f64 adds in one thread on the current CUDA device:
    returns a (2,) f64 tensor, the chain's end and the clock64 cycles it
    took (time it with CUDA events for milliseconds)."""
    out = torch.zeros(2, dtype=torch.float64, device="cuda")
    lib = _lib()
    code = lib.dadd_chain_launch(
        out.data_ptr(), int(m), 1.0,
        torch.cuda.current_stream(out.device).cuda_stream)
    _cuda_build.check(lib, "dadd_chain_launch", code)
    return out
