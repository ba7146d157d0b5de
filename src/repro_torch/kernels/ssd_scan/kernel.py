"""The ctypes binding of K3, the CUDA C++ SSD intra-chunk step in
``src/repro_torch/csrc/ssd_scan.cu`` (built by ``kernels/_cuda_build.py``
on first use).

``ssd_intra_chunk_cuda`` checks its tensors, allocates the four outputs
and launches the kernel on the current stream; ``ssd_intra_chunk_cuda.
launches`` counts its launches. The kernel has no backward (neither has
the TPU kernel it replaces), so a call that would need a gradient raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _cuda_build

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 64, 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _cuda_build.load("ssd_scan")
    fn = lib.ssd_intra_chunk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    return lib


def _check(X, dtv, A, Bh, Ch, chunk):
    if X.dim() != 3 or Bh.dim() != 3 or Bh.shape != Ch.shape:
        raise ValueError("ssd_intra_chunk_cuda: X must be (BH, S, ph) and "
                         f"B, C (BH, S, s), got {tuple(X.shape)}, "
                         f"{tuple(Bh.shape)}, {tuple(Ch.shape)}")
    BH, S, ph = X.shape
    s = Bh.shape[-1]
    if Bh.shape[:2] != (BH, S) or tuple(dtv.shape) != (BH, S) \
            or tuple(A.shape) != (BH,):
        raise ValueError("ssd_intra_chunk_cuda: dt must be (BH, S) and A "
                         f"(BH,) with BH={BH}, S={S}; got "
                         f"{tuple(dtv.shape)}, {tuple(A.shape)}, B/C "
                         f"{tuple(Bh.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk or not 1 <= ph <= \
            MAX_HEAD_DIM or not 1 <= s <= MAX_STATE:
        raise ValueError(
            f"ssd_intra_chunk_cuda: needs S % chunk == 0, chunk <= "
            f"{MAX_CHUNK}, ph <= {MAX_HEAD_DIM}, s <= {MAX_STATE}; got S={S}, "
            f"chunk={chunk}, ph={ph}, s={s}")
    for name, t, dtypes in (("X", X, DTYPES), ("B", Bh, (X.dtype,)),
                            ("C", Ch, (X.dtype,)),
                            ("dt", dtv, (torch.float32,)),
                            ("A", A, (torch.float32,))):
        if not t.is_cuda or t.device != X.device or t.dtype not in dtypes \
                or not t.is_contiguous():
            raise ValueError(
                f"ssd_intra_chunk_cuda: {name} must be a contiguous CUDA "
                f"tensor of dtype {[str(d) for d in dtypes]} on "
                f"{X.device}, got {t.dtype} on {t.device}")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"ssd_intra_chunk_cuda: {name} exceeds the "
                             "kernel's int32 sizes")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (X, dtv, A, Bh, Ch)):
        raise RuntimeError("ssd_intra_chunk_cuda has no backward (nor has "
                           "the TPU kernel it replaces); call it under "
                           "torch.no_grad() or torch.inference_mode()")


def ssd_intra_chunk_cuda(X, dtv, A, Bh, Ch, *, chunk: int):
    """Launch K3 on contiguous CUDA tensors: X (BH, S, ph) and Bh/Ch
    (BH, S, s) f32 or bf16 alike, dtv (BH, S) and A (BH,) f32. Returns
    (Y_intra (BH, S, ph), S_chunk (BH, nc, s, ph), expcum (BH, S),
    chunk_decay (BH, nc)), new f32 tensors."""
    _check(X, dtv, A, Bh, Ch, chunk)
    BH, S, ph = X.shape
    s, nc = Bh.shape[-1], S // chunk
    f32 = dict(dtype=torch.float32, device=X.device)
    Y = torch.empty((BH, S, ph), **f32)
    S_chunk = torch.empty((BH, nc, s, ph), **f32)
    expcum = torch.empty((BH, S), **f32)
    decay = torch.empty((BH, nc), **f32)
    if Y.numel() == 0:
        return Y, S_chunk, expcum, decay
    lib = _lib()
    code = lib.ssd_intra_chunk_launch(
        X.data_ptr(), dtv.data_ptr(), A.data_ptr(), Bh.data_ptr(),
        Ch.data_ptr(), Y.data_ptr(), S_chunk.data_ptr(), expcum.data_ptr(),
        decay.data_ptr(), DTYPES[X.dtype], BH, S, chunk, ph, s,
        torch.cuda.current_stream(X.device).cuda_stream)
    _cuda_build.check(lib, "ssd_intra_chunk_launch", code)
    ssd_intra_chunk_cuda.launches += 1
    return Y, S_chunk, expcum, decay


ssd_intra_chunk_cuda.launches = 0   # K3 launches since the last reset
