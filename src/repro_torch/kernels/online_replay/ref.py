"""The plain version of online's in-slot replay (``csrc/online_replay.cu``):
the literal walk over the users of a slot in index order, in Python floats
(IEEE doubles, each product and sum rounded, as the kernel's
``__dmul_rn``/``__dadd_rn``), and the gap sum of the waiting users'
operands in numpy's summation order (``np_sum_order``), written out here so
that it does not depend on the installed numpy. The CPU tests run it;
``chip_smoke.py`` holds the kernel to it bit for bit on the card. It is no
yardstick of speed."""
from __future__ import annotations

import numpy as np
import torch

# numpy's add.reduce over a contiguous float64 array: the iterator hands
# the loop blocks of BUFSIZE elements, each summed pairwise and added to
# the running total (which starts at 0.0); pairwise_sum's leaves hold at
# most PW_BLOCKSIZE elements
BUFSIZE = 8192
PW_BLOCKSIZE = 128


def pairwise_sum(a, lo: int, n: int) -> float:
    """numpy's ``pairwise_sum`` of ``a[lo:lo + n]``: below 8 a serial sum
    from 0.0; up to PW_BLOCKSIZE eight strided accumulators seeded with
    the first eight elements, combined as ((r0+r1)+(r2+r3))+((r4+r5)+
    (r6+r7)), then the tail added in order; above, split at
    n//2 - (n//2) % 8 and recurse."""
    if n < 8:
        res = 0.0
        for i in range(lo, lo + n):
            res += a[i]
        return res
    if n <= PW_BLOCKSIZE:
        r = a[lo:lo + 8]
        i = 8
        while i < n - n % 8:
            for q in range(8):
                r[q] += a[lo + i + q]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for i in range(i, n):
            res += a[lo + i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return pairwise_sum(a, lo, n2) + pairwise_sum(a, lo + n2, n - n2)


def np_sum_order(a) -> float:
    """``float(np.sum(np.asarray(a, float)))`` for a list of floats, in the
    same order of additions: blocks of BUFSIZE consecutive elements, each
    by ``pairwise_sum``, added left to right to 0.0."""
    acc = 0.0
    for lo in range(0, len(a), BUFSIZE):
        acc += pairwise_sum(a, lo, min(BUFSIZE, len(a) - lo))
    return acc


def online_replay_ref(waiting, base, rhs, gap_idle, gap_vec, H):
    """waiting (B, n) bool; base, rhs, gap_idle (B, n) f64; gap_vec
    (B, n + 1) f64; H (B,) f64. Returns (start (B, n) bool, gap_sum (B,)
    f64) on the inputs' device: the walk's decisions and the
    ``np_sum_order`` sum of the waiting users' operands (gap_vec[j] for a
    user who starts, its idle gap otherwise), in user order."""
    B, n = base.shape
    start = torch.zeros((B, n), dtype=torch.bool)
    gap_sum = torch.zeros(B, dtype=torch.float64)
    rows = zip(waiting.tolist(), base.tolist(), rhs.tolist(),
               gap_idle.tolist(), gap_vec.tolist(), H.tolist())
    for row, (w, b, r, gi, gv, h) in enumerate(rows):
        j, ops, out = 0, [], [False] * n
        for i in range(n):
            if w[i]:
                if b[i] + h * gv[j] <= r[i] + h * gi[i]:
                    out[i] = True
                    ops.append(gv[j])
                    j += 1
                else:
                    ops.append(gi[i])
        start[row] = torch.tensor(out, dtype=torch.bool)
        gap_sum[row] = np_sum_order(ops)
    return start.to(base.device), gap_sum.to(base.device)


def online_replay_rows_ref(waiting, base, rhs, gap_idle, gap_vec, H):
    """The kernel's per-row record ((B, 4) int32: path, waiting users W,
    always, undecided; ``kernel.ROW_FIELDS``) as the inputs give it: path
    1 where the threshold form holds (H finite and >= 0, gap_vec[0 .. W-1]
    non-decreasing, H gap_vec[0] and H gap_vec[W-1] finite), with the
    waiting users for whom the comparison holds at j = w_i (always) and
    those for whom it holds at 0 but not at w_i (undecided); path 0 and
    -1, -1 otherwise (the literal walk)."""
    w, b, r, gi, gv, H = (t.cpu().numpy() for t in
                          (waiting, base, rhs, gap_idle, gap_vec, H))
    out = np.zeros((len(H), 4), np.int32)
    for k, h in enumerate(H.tolist()):
        W = int(w[k].sum())
        with np.errstate(invalid="ignore", over="ignore"):
            ok = (np.isfinite(h) and h >= 0.0
                  and (W <= 1 or bool(np.all(gv[k, :W - 1] <= gv[k, 1:W])))
                  and (W == 0 or (np.isfinite(h * gv[k, 0])
                                  and np.isfinite(h * gv[k, W - 1]))))
        if not ok:
            out[k] = (0, W, -1, -1)
            continue
        wi = np.cumsum(w[k]) - w[k]
        c = r[k] + h * gi[k]
        top = b[k] + h * gv[k, wi] <= c
        bot = b[k] + h * gv[k, 0] <= c
        out[k] = (1, W, (w[k] & top).sum(), (w[k] & ~top & bot).sum())
    return torch.from_numpy(out)
