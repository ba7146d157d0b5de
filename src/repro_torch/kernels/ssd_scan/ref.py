"""Plain PyTorch versions of the chunked SSD scan — the counterparts of
``repro/kernels/ssd_scan/ref.py::ssd_chunked_ref`` and of the Pallas
kernel's body (``repro/kernels/ssd_scan/kernel.py::_kernel``).

``ssd_intra_chunk_ref`` is the oracle of K3 (``csrc/ssd_scan.cu``): the
CPU tests run it, ``chip_smoke.py`` holds the kernel against it on the
card, and ``ops.ssd_chunked`` takes it for tensors that lie on the CPU.
``ssd_chunked_ref`` is the sequential recurrence, the oracle of both.
"""
from __future__ import annotations

import torch


def ssd_intra_chunk_ref(X, dtv, A, Bh, Ch, *, chunk: int):
    """X: (BH, S, ph); dtv: (BH, S); A: (BH,); Bh/Ch: (BH, S, s);
    S % chunk == 0. Every input is read as f32.

    Returns (Y_intra (BH, S, ph), S_chunk (BH, nc, s, ph), expcum (BH, S),
    chunk_decay (BH, nc)), all f32, with per chunk (Q = chunk):
        cum     = cumsum(dt * A)
        M[t, u] = exp(cum_t - cum_u) for u <= t, else 0
        Y_intra = ((C B^T) * M) (dt X)
        S_chunk = (B * dt * exp(cum_Q - cum))^T X
    M is taken by masking the exponent to -inf above the diagonal, so the
    exp there (which overflows for large |A|) is never formed."""
    BH, S, ph = X.shape
    s = Bh.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk
    dt = dtv.float().reshape(BH, nc, chunk)
    cum = torch.cumsum(dt * A.float()[:, None, None], dim=-1)
    Xc = X.float().reshape(BH, nc, chunk, ph)
    Bc = Bh.float().reshape(BH, nc, chunk, s)
    Cc = Ch.float().reshape(BH, nc, chunk, s)
    diff = cum[..., :, None] - cum[..., None, :]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=X.device).tril()
    M = torch.exp(diff.masked_fill(~causal, float("-inf")))
    scores = (Cc @ Bc.transpose(-1, -2)) * M
    Y = scores @ (dt[..., None] * Xc)
    decay_end = torch.exp(cum[..., -1:] - cum)
    Bw = Bc * (dt * decay_end)[..., None]
    S_chunk = Bw.transpose(-1, -2) @ Xc
    return (Y.reshape(BH, S, ph), S_chunk, torch.exp(cum).reshape(BH, S),
            torch.exp(cum[..., -1]))


def ssd_chunked_ref(X, dtv, A, Bh, Ch, init_state=None):
    """X: (B, S, nh, p); dtv: (B, S, nh) (already softplus'd); A: (nh,)
    negative; Bh/Ch: (B, S, nh, s). The sequential recurrence

        h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t h_t

    in f32. Returns (y (B, S, nh, p) f32, final state (B, nh, s, p))."""
    B_, S, nh, ph = X.shape
    s = Bh.shape[-1]
    h = (torch.zeros(B_, nh, s, ph, device=X.device) if init_state is None
         else init_state.float())
    Xf, dtf, Bf, Cf = X.float(), dtv.float(), Bh.float(), Ch.float()
    A = A.float()
    ys = []
    for t in range(S):
        dec = torch.exp(dtf[:, t] * A)
        inc = torch.einsum("bns,bnp,bn->bnsp", Bf[:, t], Xf[:, t], dtf[:, t])
        h = dec[:, :, None, None] * h + inc
        ys.append(torch.einsum("bns,bnsp->bnp", Cf[:, t], h))
    return torch.stack(ys, dim=1), h
