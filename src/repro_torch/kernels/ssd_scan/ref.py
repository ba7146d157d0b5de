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

from .kernel import as_4d


def _warp_cumsum(x):
    """cumsum over the last axis (<= 256) in the bf16 CUDA kernel's order
    of f32 additions: an inclusive Hillis-Steele scan within each 32
    positions (offsets 1, 2, 4, 8, 16), then each 32's total added to the
    later ones, first to last. The same additions in the same order give
    the same bits, so the companion's exp(cum_t - cum_u) is the kernel's:
    a different order moves cum by ~|cum| 2^-24, enough to push a product
    across a bf16 rounding boundary where cum is large."""
    Q = x.shape[-1]
    nw = -(-Q // 32)
    x = torch.nn.functional.pad(x, (0, nw * 32 - Q)).reshape(
        *x.shape[:-1], nw, 32)
    for off in (1, 2, 4, 8, 16):
        x = torch.cat([x[..., :off], x[..., off:] + x[..., :-off]], dim=-1)
    tot = x[..., 31:]
    for k in range(nw - 1):
        x = torch.cat([x[..., :k + 1, :],
                       x[..., k + 1:, :] + tot[..., k:k + 1, :]], dim=-2)
    return x.reshape(*x.shape[:-2], nw * 32)[..., :Q]


def _chunks(X, dtv, A, Bh, Ch, chunk, scan=torch.cumsum):
    """The per-chunk pieces of the intra-chunk step in f32, every head
    reading its group's B and C (``jnp.repeat`` on the group axis):
    (dt, cum, X, B, C by chunk, W = (C B^T) o M, exp(cum_Q - cum), the
    4-D shape, whether the input was folded)."""
    X, dtv, A, Bh, Ch, folded = as_4d(X, dtv, A, Bh, Ch)
    Bt, H, S, ph = X.shape
    G, s = Bh.shape[1], Bh.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk
    Bh, Ch = (t.repeat_interleave(H // G, dim=1) for t in (Bh, Ch))
    dt = dtv.float().reshape(Bt, H, nc, chunk)
    cum = scan(dt * A.float()[None, :, None, None], dim=-1)
    Xc = X.float().reshape(Bt, H, nc, chunk, ph)
    Bc = Bh.float().reshape(Bt, H, nc, chunk, s)
    Cc = Ch.float().reshape(Bt, H, nc, chunk, s)
    diff = cum[..., :, None] - cum[..., None, :]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=X.device).tril()
    M = torch.exp(diff.masked_fill(~causal, float("-inf")))
    W = (Cc @ Bc.transpose(-1, -2)) * M
    decay_end = torch.exp(cum[..., -1:] - cum)
    return dt, cum, Xc, Bc, W, decay_end, (Bt, H, S, ph), folded


def _unfold(out, folded):
    return tuple(t[0] for t in out) if folded else out


def _intra(X, dtv, A, Bh, Ch, chunk, rnd):
    dt, cum, Xc, Bc, W, decay_end, (Bt, H, S, ph), folded = _chunks(
        X, dtv, A, Bh, Ch, chunk,
        torch.cumsum if rnd is None else lambda x, dim: _warp_cumsum(x))
    if rnd is None:
        Y = W @ (dt[..., None] * Xc)
        S_chunk = (Bc * (dt * decay_end)[..., None]).transpose(-1, -2) @ Xc
    else:
        dX = rnd(dt[..., None] * Xc)
        Y = rnd(W) @ dX
        S_chunk = rnd(Bc * decay_end[..., None]).transpose(-1, -2) @ dX
    return _unfold((Y.reshape(Bt, H, S, ph), S_chunk,
                    torch.exp(cum).reshape(Bt, H, S),
                    torch.exp(cum[..., -1])), folded)


def ssd_intra_chunk_ref(X, dtv, A, Bh, Ch, *, chunk: int):
    """The intra-chunk step in f32, on either form of
    ``kernel.as_4d``: X (Bt, H, S, ph), dtv (Bt, H, S), A (H,), Bh/Ch
    (Bt, G, S, s), or the folded X (BH, S, ph), dtv (BH, S), A (BH,),
    Bh/Ch (BH / hpg, S, s); S % chunk == 0. Every input is read as f32.

    Returns (Y_intra (.., S, ph), S_chunk (.., nc, s, ph), expcum (.., S),
    chunk_decay (.., nc)), all f32, with per chunk (Q = chunk):
        cum     = cumsum(dt * A)
        M[t, u] = exp(cum_t - cum_u) for u <= t, else 0
        Y_intra = ((C B^T) * M) (dt X)
        S_chunk = (B * dt * exp(cum_Q - cum))^T X
    M is taken by masking the exponent to -inf above the diagonal, so the
    exp there (which overflows for large |A|) is never formed."""
    return _intra(X, dtv, A, Bh, Ch, chunk, None)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def ssd_intra_chunk_ref_bf16(X, dtv, A, Bh, Ch, *, chunk: int):
    """``ssd_intra_chunk_ref`` with the three operands that the bf16 CUDA
    kernel rounds to bf16 rounded at the same points (every other value
    f32, as in the kernel, and cum summed in the kernel's order):
        Y_intra = bf16((C B^T) * M) bf16(dt X)
        S_chunk = bf16(B * exp(cum_Q - cum))^T bf16(dt X)
    (the state moves dt from B's weight to X's, which the f32 form leaves
    where it was). The kernel is held against this at the f32 bound; the
    rounding itself against ``ssd_intra_chunk_ref`` at the bound that
    ``bf16_bound`` derives."""
    return _intra(X, dtv, A, Bh, Ch, chunk, _bf16)


BF16_U = 2.0 ** -8      # bf16's unit roundoff (8 significand bits)


def bf16_bound(X, dtv, A, Bh, Ch, *, chunk: int):
    """Elementwise bounds on how far a computation that rounds like
    ``ssd_intra_chunk_ref_bf16`` (the companion, or the bf16 kernel) lies
    from ``ssd_intra_chunk_ref``, for Y_intra and S_chunk, in their shapes
    (expcum and chunk_decay are not rounded).

    Derivation. Y_intra[t, p] = sum_u W[t, u] dX[u, p] with W = G o M,
    G = C B^T and dX = dt X. Rounding both factors to bf16 gives
    W (1 + d1) and dX (1 + d2) with |d1|, |d2| <= u = 2^-8, so each term
    moves by at most (2u + u^2) |W[t, u]| |dX[u, p]|. The f32 sums add
    rounding of their own, in any order: the two sums over the Q = chunk
    terms of Y, each within ~Q 2^-24 of sum_u |W| |dX|, and the two sums
    over the s terms of G, each within ~s 2^-24 of sum_n |c b|, which the
    rounding then carries (plus 2^-24 for the product G M). So
        |dY[t, p]| <= (2u + u^2 + Q 2^-23) sum_u |W[t, u]| |dX[u, p]|
                      + (s + 1) 2^-23 sum_u ((|C| |B|^T) o M)[t, u]
                                              |dX[u, p]|,
    a bound that grows with the sums' lengths. S_chunk is the first line
    with B exp(cum_Q - cum) in W's place (no G: the exact products
    (B w)(dt X) and (B dt w) X agree to f32 rounding)."""
    k = 2 * BF16_U + BF16_U ** 2 + chunk * 2.0 ** -23
    y_abs, s_abs, y_cb = _abs_terms(X, dtv, A, Bh, Ch, chunk)
    s = Bh.shape[-1]
    return k * y_abs + (s + 1) * 2.0 ** -23 * y_cb, k * s_abs


def _abs_terms(X, dtv, A, Bh, Ch, chunk):
    """sum_u |W[t, u]| |dX[u, p]|, sum_u |B w|[u, n] |dX[u, p]| and
    sum_u ((|C| |B|^T) o M)[t, u] |dX[u, p]|, in the shapes of Y_intra,
    S_chunk and Y_intra."""
    dt, _, Xc, Bc, W, decay_end, (Bt, H, S, ph), folded = _chunks(
        X, dtv, A, Bh, Ch, chunk)
    W_cb = _chunks(X, dtv, A, Bh.abs(), Ch.abs(), chunk)[4]
    dX = (dt[..., None] * Xc).abs()
    Bw = (Bc * decay_end[..., None]).abs()
    return _unfold(((W.abs() @ dX).reshape(Bt, H, S, ph),
                    Bw.transpose(-1, -2) @ dX,
                    (W_cb @ dX).reshape(Bt, H, S, ph)), folded)


def bf16_rounding_slack(X, dtv, A, Bh, Ch, *, chunk: int):
    """What the bf16 kernel's Y_intra may differ from
    ``ssd_intra_chunk_ref_bf16``'s by beyond f32 rounding, elementwise in
    Y_intra's shape (S_chunk has no such term: B w and dt X are the same
    f32 operations on the same values in both, so round alike).

    G = C B^T is an f32 sum of s exact products taken in another order by
    the tensor cores than by the companion's matmul, so the two W = G o M
    differ by up to eps = (s + 1) 2^-23 (|C| |B|^T) o M (each sum within
    s 2^-24 of sum |c b|, each product G M within 2^-24). Where W lies
    within eps of a bf16 rounding boundary the two may round to
    neighbouring bf16 values: the spread bf16(W + eps) - bf16(W - eps) is
    that one step there and 0 elsewhere. Summed into Y_intra:
    sum_u spread[t, u] |dt X|[u, p]."""
    def scan(x, dim):
        return _warp_cumsum(x)

    dt, _, Xc, _, W, _, (Bt, H, S, ph), folded = _chunks(
        X, dtv, A, Bh, Ch, chunk, scan)
    W_cb = _chunks(X, dtv, A, Bh.abs(), Ch.abs(), chunk, scan)[4]
    eps = (Bh.shape[-1] + 1) * 2.0 ** -23 * W_cb
    spread = _bf16(W + eps) - _bf16(W - eps)
    dX = _bf16(dt[..., None] * Xc).abs()
    return _unfold(((spread @ dX).reshape(Bt, H, S, ph),), folded)[0]


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
