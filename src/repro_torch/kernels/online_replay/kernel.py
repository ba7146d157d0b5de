"""The ctypes binding of online's in-slot replay, the CUDA C++ kernel in
``src/repro_torch/csrc/online_replay.cu`` (built by
``kernels/_cuda_build.py`` on first use).

``online_replay_cuda`` checks its tensors, allocates the outputs and the
launch's scratch (``torch.empty``: no kernel) and makes one cooperative
launch on the current stream; ``online_replay_cuda.launches`` counts its
launches. The kernel also writes, per row, the path it took and its
counts (``online_replay_cuda.last_rows``) and counts the rows each path
took in a per-device buffer (``path_rows``, ``reset_path_rows``): tests
and ``chip_smoke.py`` read them, the engine never does. That buffer also
holds the kernel's grid-barrier words, which every launch leaves as it
found them, so launches on one device go on one stream at a time.
``dadd_chain_cuda`` and ``walk_chain_cuda`` run the file's yardsticks: a
chain of dependent f64 adds, and the walk's integer step, in one thread.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _cuda_build

# rows' columns: path (1 threshold, 0 literal walk), waiting users,
# always-users, undecided users (-1 on the literal walk)
ROW_FIELDS = ("path", "waiting", "always", "undecided")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _cuda_build.load("online_replay")
    fn = lib.online_replay_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 2 + \
        [ctypes.c_void_p]
    fn = lib.online_replay_scratch_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_longlong] * 2
    fn = lib.dadd_chain_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double,
                   ctypes.c_void_p]
    fn = lib.walk_chain_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    return lib


def _sync_words(device) -> torch.Tensor:
    """The kernel's per-device words: the grid barrier's count and
    generation, then the rows that took the threshold path and the rows
    that took the literal walk."""
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _sync_words_at(index)


@functools.cache
def _sync_words_at(index: int) -> torch.Tensor:
    return torch.zeros(4, dtype=torch.int64, device=f"cuda:{index}")


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


def online_replay_cuda(waiting, base, rhs, gap_idle, gap_vec, H, *,
                       trace=None):
    """Launch the replay on CUDA tensors (see ``check_inputs``). Returns
    (start (B, n) bool, gap_sum (B,) f64), new tensors; the launch's
    per-row record ((B, 4) int32, columns ``ROW_FIELDS``) is kept as
    ``online_replay_cuda.last_rows``. ``trace``, a zeroed (7,) int64
    tensor on the same device, receives the card's clock (ns) at the
    launch's start, after each of its five phase barriers and at its last
    row's end (``phase_ns``)."""
    check_inputs(waiting, base, rhs, gap_idle, gap_vec, H)
    if not base.is_cuda:
        raise ValueError(f"online_replay_cuda needs CUDA tensors, got "
                         f"{base.device}")
    B, n = base.shape
    dev = base.device
    ins = [t.contiguous() for t in (waiting, base, rhs, gap_idle, gap_vec,
                                    H)]
    start = torch.empty((B, n), dtype=torch.bool, device=dev)
    gap_sum = torch.empty(B, dtype=torch.float64, device=dev)
    rows = torch.empty((B, 4), dtype=torch.int32, device=dev)
    if B:
        lib = _lib()
        scratch = torch.empty(int(lib.online_replay_scratch_bytes(B, n)),
                              dtype=torch.uint8, device=dev)
        code = lib.online_replay_launch(
            *(t.data_ptr() for t in ins), start.data_ptr(),
            gap_sum.data_ptr(), rows.data_ptr(),
            _sync_words(dev).data_ptr(), scratch.data_ptr(),
            None if trace is None else trace.data_ptr(), B, n,
            torch.cuda.current_stream(dev).cuda_stream)
        _cuda_build.check(lib, "online_replay_launch", code)
        online_replay_cuda.launches += 1
    online_replay_cuda.last_rows = rows
    return start, gap_sum


online_replay_cuda.launches = 0   # replay launches since the last reset
online_replay_cuda.last_rows = None


PHASES = ("counts", "thresholds", "classify", "walk", "operands", "sum")


def phase_ns(*args) -> dict:
    """One launch of the replay on ``args`` with a trace: ns from the
    launch's start to its first barrier and between barriers, named by
    ``PHASES`` (the last up to the last row's gap_sum). Reads the card."""
    trace = torch.zeros(7, dtype=torch.int64, device=args[1].device)
    online_replay_cuda(*args, trace=trace)
    t = trace.tolist()
    return {name: t[k + 1] - t[k] for k, name in enumerate(PHASES)}


def path_rows(device="cuda") -> tuple:
    """(rows that took the threshold path, rows that took the literal
    walk) on ``device`` since the last ``reset_path_rows`` (reads the
    card)."""
    words = _sync_words(device).tolist()
    return words[2], words[3]


def reset_path_rows(device="cuda") -> None:
    _sync_words(device)[2:].zero_()


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


def walk_chain_cuda(m: int):
    """m dependent steps of the replay's walk (``m += (m <= T)``, T staged
    in shared memory, each m stored beside, as the kernel's phase (d)
    runs them) in one thread on the current CUDA device: returns a (2,)
    int64 tensor, the walk's end and the clock64 cycles it took."""
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    lib = _lib()
    code = lib.walk_chain_launch(
        out.data_ptr(), int(m),
        torch.cuda.current_stream(out.device).cuda_stream)
    _cuda_build.check(lib, "walk_chain_launch", code)
    return out
