"""The ctypes binding of K4, the CUDA C++ flash attention in
``src/repro_torch/csrc/flash_attention.cu`` (built by
``kernels/_cuda_build.py`` on first use).

``flash_attention_cuda`` checks its tensors, allocates the output and
launches the kernel on the current stream; ``flash_attention_cuda.
launches`` counts its launches and ``flash_attention_cuda.by_shape``
the same launches by shape, (B, H, KV, Sq, Sk, d, causal). The dtype
picks the kernel: bf16 runs the tensor-core form (wgmma fed by TMA), f32
the CUDA-core form. TMA reads bf16 tiles straight from the caller's
strides, so for bf16 the base and every stride of a dimension longer
than 1 must be a multiple of 16 bytes (the wrapper raises otherwise;
nothing is copied). The kernel has no backward (neither has the TPU
kernel it replaces), so a call that would need a gradient raises.

Head dims: 16, 32, 64, 128 and 80 (zamba2's shared attention blocks). At
80 the f32 form tiles five 16-column strips a thread; the bf16 form runs
its d = 128 block on TMA maps of the real 80 columns, which zero-fill
columns 80-127 (a bf16 row of 160 B meets TMA's 16-byte rule). The TPU
kernel takes any d; other head dims raise here until the card's tests
cover them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _cuda_build

HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT31 = 2 ** 31


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _cuda_build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 19
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib


def _check(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_cuda: q must be (B, H, Sq, d) and "
                         "k, v (B, KV, Sk, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, d = q.shape
    _, KV, Sk, dk = k.shape
    if k.shape[0] != B or dk != d or KV == 0 or H % KV:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} and "
                         f"k/v {tuple(k.shape)} do not make GQA")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if causal and Sq != Sk:
        raise ValueError(f"causal attention needs Sq == Sk, got Sq={Sq}, "
                         f"Sk={Sk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device or t.dtype != q.dtype \
                or t.dtype not in DTYPES:
            raise ValueError(
                f"flash_attention_cuda: {name} must be an f32 or bf16 CUDA "
                f"tensor like q, got {t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_cuda: {name} needs a "
                             f"contiguous last dimension, got strides "
                             f"{t.stride()}")
        if sum((n - 1) * s for n, s in zip(t.shape, t.stride())) >= _INT31:
            raise ValueError(f"flash_attention_cuda: {name} exceeds the "
                             "kernel's int32 strides")
        if t.dtype == torch.bfloat16:
            _check_tma(name, t)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_cuda has no backward (nor has "
                           "the TPU kernel it replaces); call it under "
                           "torch.no_grad() or torch.inference_mode()")


def _check_tma(name, t):
    """TMA's rule for a bf16 tensor it reads: a 16-byte aligned base and
    16-byte strides (8 elements) in every dimension longer than 1."""
    if t.data_ptr() % 16 or any(s % 8 for n, s in
                                zip(t.shape[:3], t.stride()[:3]) if n > 1):
        raise ValueError(f"flash_attention_cuda: bf16 {name} needs a "
                         f"16-byte aligned base and strides for TMA, got "
                         f"strides {t.stride()} at offset "
                         f"{t.data_ptr() % 16} mod 16")


def flash_attention_cuda(q, k, v, *, causal: bool, scale: float):
    """Launch K4: q (B, H, Sq, d), k/v (B, KV, Sk, d) on one CUDA device,
    f32 or bf16 alike, last dimension contiguous. Returns o like q (same
    dtype and layout), a new tensor."""
    _check(q, k, v, causal)
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    lib = _lib()
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        DTYPES[q.dtype], B, H, KV, Sq, Sk, d, *strides, float(scale),
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    _cuda_build.check(lib, "flash_attention_launch", code)
    flash_attention_cuda.launches += 1
    key = (B, H, KV, Sq, Sk, d, bool(causal))
    by_shape = flash_attention_cuda.by_shape
    by_shape[key] = by_shape.get(key, 0) + 1
    return o


flash_attention_cuda.launches = 0   # K4 launches since the last reset
flash_attention_cuda.by_shape = {}  # the same launches by shape
