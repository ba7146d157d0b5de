"""Public wrapper of K3: the full chunked SSD scan — the counterpart of
``repro/kernels/ssd_scan/ops.py::ssd_chunked_pallas``, the drop-in for
``models/ssm.py``'s XLA ``ssd_chunked``.

The intra-chunk step is K3 (``csrc/ssd_scan.cu``) or its plain version,
picked by ``kernel`` (``"auto"``, ``"cuda"`` or ``"reference"``) by the
rule of ``kernels/mode.py``; the cheap inter-chunk recurrence over the
S / chunk chunk states and the ``Y_inter`` correction run in PyTorch, as
the JAX wrapper leaves them to XLA. B and C may be shared by a group of
heads, as Mamba2 projects them: the kernel reads each group's once.
"""
from __future__ import annotations

import torch

from .. import mode
from .kernel import ssd_intra_chunk_cuda
from .ref import ssd_intra_chunk_ref


def ssd_chunked(X, dtv, A, Bh, Ch, chunk: int, init_state=None, *,
                kernel: str = "auto"):
    """X: (B, S, nh, p); dtv: (B, S, nh); A: (nh,); Bh/Ch: (B, S, g, s),
    one B and C per group of nh / g heads (g = nh: one per head; head h
    reads group h // (nh / g)); S % chunk == 0.

    Returns (y (B, S, nh, p) in X's dtype, final state (B, nh, s, p) f32).
    The intra-chunk step reads (B, heads, S, .) views of X, dt, B and C
    (``movedim(2, 1)``): nothing is folded, copied or repeated."""
    B_, S, nh, ph = X.shape
    g, s = Bh.shape[2], Bh.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    if nh % g:
        raise ValueError(f"{nh} heads do not split into {g} groups")
    nc = S // chunk
    intra = ssd_intra_chunk_cuda if mode.use_kernel(kernel, X, "cuda") \
        else ssd_intra_chunk_ref
    Y_intra, S_chunk, expcum, chunk_decay = intra(
        X.movedim(2, 1), dtv.float().movedim(2, 1), A.float(),
        Bh.movedim(2, 1), Ch.movedim(2, 1), chunk=chunk)

    # inter-chunk recurrence: the state entering chunk c
    carry = (torch.zeros(B_, nh, s, ph, device=X.device)
             if init_state is None else init_state.float())
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = chunk_decay[:, :, c, None, None] * carry + S_chunk[:, :, c]
    S_prev = torch.stack(entering, dim=2)             # (B, nh, nc, s, ph)

    # Y_inter[t] = expcum[t] * C[t] . S_prev[chunk(t)], C per group
    Cg = Ch.float().reshape(B_, nc, chunk, g, s)
    Y_inter = torch.einsum("bcqgs,bghcsp->bghcqp", Cg,
                           S_prev.reshape(B_, g, nh // g, nc, s, ph))
    Y_inter = Y_inter.reshape(B_, nh, S, ph) * expcum[..., None]
    y = (Y_intra + Y_inter).movedim(1, 2)
    return y.to(X.dtype), carry
