"""The ctypes binding of K3, the CUDA C++ SSD intra-chunk step in
``src/repro_torch/csrc/ssd_scan.cu`` (built by ``kernels/_cuda_build.py``
on first use).

``ssd_intra_chunk_cuda`` checks its tensors, allocates the four outputs
and launches the kernel on the current stream; ``ssd_intra_chunk_cuda.
launches`` counts its launches. The dtype picks the kernel: bf16 runs
the tensor-core form (wgmma fed by TMA), f32 the CUDA-core form. Inputs
are read through their strides (the last dimension contiguous), and B and
C once per group. TMA reads the bf16 tiles, so for bf16 the bases and the
strides of every dimension longer than 1 must be multiples of 16 bytes.
Extents and strides are int32 arguments; the kernel forms every offset
in 64 bits, so a view may span more than 2^31 elements (mamba2-370m's
32,768-token prefill: X, a view of the 2,304-wide conv output, spans
2.4e9).
The kernel has no backward (neither has the TPU kernel it replaces), so a
call that would need a gradient raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _cuda_build

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 64, 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT31 = 2 ** 31


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _cuda_build.load("ssd_scan")
    fn = lib.ssd_intra_chunk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 20
                   + [ctypes.c_void_p])
    return lib


def as_4d(X, dtv, A, Bh, Ch):
    """The two forms K3 and its plain versions take, as the 4-D one:
    X (Bt, H, S, ph), dtv (Bt, H, S), A (H,), Bh/Ch (Bt, G, S, s) with
    H % G == 0, head h reading group h // (H // G); or the folded 3-D one,
    X (BH, S, ph), dtv (BH, S), A (BH,), Bh/Ch (BH / hpg, S, s), read as
    Bt = 1 (row bh reads group row bh // hpg). Returns the 4-D views and
    whether the input was 3-D."""
    folded = X.dim() == 3
    if folded:
        X, dtv, Bh, Ch = X[None], dtv[None], Bh[None], Ch[None]
    if X.dim() != 4 or Bh.dim() != 4 or Bh.shape != Ch.shape:
        raise ValueError("K3: X must be (Bt, H, S, ph) or (BH, S, ph) and B, "
                         "C (Bt, G, S, s) or (BH / hpg, S, s), got "
                         f"{tuple(X.shape)}, {tuple(Bh.shape)}, "
                         f"{tuple(Ch.shape)}")
    Bt, H, S, _ = X.shape
    G = Bh.shape[1]
    if Bh.shape[0] != Bt or Bh.shape[2] != S or G == 0 or H % G \
            or tuple(dtv.shape) != (Bt, H, S) or tuple(A.shape) != (H,):
        raise ValueError(f"K3: with X {tuple(X.shape)}, dt must be "
                         f"{(Bt, H, S)}, A {(H,)} and B/C (Bt, G, S, s) with "
                         f"H % G == 0; got dt {tuple(dtv.shape)}, A "
                         f"{tuple(A.shape)}, B/C {tuple(Bh.shape)}")
    return X, dtv, A, Bh, Ch, folded


def _check(X, dtv, A, Bh, Ch, chunk):
    Bt, H, S, ph = X.shape
    s = Bh.shape[-1]
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
        if not t.is_cuda or t.device != X.device or t.dtype not in dtypes:
            raise ValueError(
                f"ssd_intra_chunk_cuda: {name} must be a CUDA tensor of "
                f"dtype {[str(d) for d in dtypes]} on {X.device}, got "
                f"{t.dtype} on {t.device}")
        if name in "XBC" and t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"ssd_intra_chunk_cuda: {name} needs a "
                             f"contiguous last dimension, got strides "
                             f"{t.stride()}")
        if any(n >= _INT31 or st >= _INT31
               for n, st in zip(t.shape, t.stride())):
            raise ValueError(f"ssd_intra_chunk_cuda: {name}'s extents and "
                             "strides must fit the kernel's int32 "
                             f"arguments, got {tuple(t.shape)}, strides "
                             f"{t.stride()}")
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(st % 8 for n, st in
                                         zip(t.shape[:3], t.stride()[:3])
                                         if n > 1)):
            raise ValueError(f"ssd_intra_chunk_cuda: bf16 {name} needs a "
                             "16-byte aligned base and strides for TMA, got "
                             f"strides {t.stride()} at offset "
                             f"{t.data_ptr() % 16} mod 16")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (X, dtv, A, Bh, Ch)):
        raise RuntimeError("ssd_intra_chunk_cuda has no backward (nor has "
                           "the TPU kernel it replaces); call it under "
                           "torch.no_grad() or torch.inference_mode()")


def ssd_intra_chunk_cuda(X, dtv, A, Bh, Ch, *, chunk: int):
    """Launch K3 on CUDA tensors of either form of ``as_4d`` (X, B and C
    f32 or bf16 alike, dt and A f32). Returns (Y_intra (Bt, H, S, ph),
    S_chunk (Bt, H, nc, s, ph), expcum (Bt, H, S), chunk_decay
    (Bt, H, nc)), new contiguous f32 tensors, without the leading Bt for
    the 3-D form."""
    X, dtv, A, Bh, Ch, folded = as_4d(X, dtv, A, Bh, Ch)
    _check(X, dtv, A, Bh, Ch, chunk)
    Bt, H, S, ph = X.shape
    G, s, nc = Bh.shape[1], Bh.shape[-1], S // chunk
    A = A.contiguous()
    f32 = dict(dtype=torch.float32, device=X.device)
    outs = (torch.empty((Bt, H, S, ph), **f32),
            torch.empty((Bt, H, nc, s, ph), **f32),
            torch.empty((Bt, H, S), **f32), torch.empty((Bt, H, nc), **f32))
    if outs[0].numel():
        lib = _lib()
        strides = [st for t in (X, Bh, Ch, dtv) for st in t.stride()[:3]]
        code = lib.ssd_intra_chunk_launch(
            X.data_ptr(), dtv.data_ptr(), A.data_ptr(), Bh.data_ptr(),
            Ch.data_ptr(), *(t.data_ptr() for t in outs), DTYPES[X.dtype],
            Bt, H, G, S, chunk, ph, s, *strides,
            torch.cuda.current_stream(X.device).cuda_stream)
        _cuda_build.check(lib, "ssd_intra_chunk_launch", code)
        ssd_intra_chunk_cuda.launches += 1
    return tuple(t[0] for t in outs) if folded else outs


ssd_intra_chunk_cuda.launches = 0   # K3 launches since the last reset
