"""Public wrapper of K3: the full chunked SSD scan — the counterpart of
``repro/kernels/ssd_scan/ops.py::ssd_chunked_pallas``, the drop-in for
``models/ssm.py``'s XLA ``ssd_chunked``.

The intra-chunk step is K3 (``csrc/ssd_scan.cu``) or its plain version,
picked by ``kernel`` (``"auto"``, ``"cuda"`` or ``"reference"``) by the
rule of ``kernels/mode.py``; the cheap inter-chunk recurrence over the
S / chunk chunk states and the ``Y_inter`` correction run in PyTorch, as
the JAX wrapper leaves them to XLA.
"""
from __future__ import annotations

import torch

from .. import mode
from .kernel import ssd_intra_chunk_cuda
from .ref import ssd_intra_chunk_ref


def ssd_chunked(X, dtv, A, Bh, Ch, chunk: int, init_state=None, *,
                kernel: str = "auto"):
    """X: (B, S, nh, p); dtv: (B, S, nh); A: (nh,); Bh/Ch: (B, S, nh, s);
    S % chunk == 0.

    Returns (y (B, S, nh, p) in X's dtype, final state (B, nh, s, p) f32).
    The (B, nh) pair folds to one index b * nh + h (``moveaxis(2, 1)``), so
    A is tiled B times."""
    B_, S, nh, ph = X.shape
    s = Bh.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc, BH = S // chunk, B_ * nh

    def fold(t):
        return t.movedim(2, 1).reshape(BH, S, t.shape[-1]).contiguous()

    Xf, Bf, Cf = fold(X), fold(Bh), fold(Ch)
    dtf = dtv.float().movedim(2, 1).reshape(BH, S).contiguous()
    Af = A.float().repeat(B_)
    intra = ssd_intra_chunk_cuda if mode.use_kernel(kernel, X, "cuda") \
        else ssd_intra_chunk_ref
    Y_intra, S_chunk, expcum, chunk_decay = intra(Xf, dtf, Af, Bf, Cf,
                                                  chunk=chunk)

    # inter-chunk recurrence: the state entering chunk c
    carry = (torch.zeros(BH, s, ph, device=X.device) if init_state is None
             else init_state.reshape(BH, s, ph).float())
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = chunk_decay[:, c, None, None] * carry + S_chunk[:, c]
    S_prev = torch.stack(entering, dim=1)                 # (BH, nc, s, ph)

    # Y_inter[t] = expcum[t] * C[t] . S_prev[chunk(t)]
    Cc = Cf.float().reshape(BH, nc, chunk, s) \
        * expcum.reshape(BH, nc, chunk)[..., None]
    Y_inter = torch.einsum("ints,insp->intp", Cc, S_prev).reshape(BH, S, ph)
    y = (Y_intra + Y_inter).reshape(B_, nh, S, ph).movedim(1, 2)
    return y.to(X.dtype), carry.reshape(B_, nh, s, ph)
