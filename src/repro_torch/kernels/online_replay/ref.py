"""The plain version of online's in-slot replay (``csrc/online_replay.cu``):
the same walk over the users of a slot, in Python floats (IEEE doubles,
each product and sum rounded, as the kernel's ``__dmul_rn``/``__dadd_rn``).
The CPU tests run it; ``chip_smoke.py`` holds the kernel to it bit for bit
on the card. It is no yardstick of speed."""
from __future__ import annotations

import torch


def online_replay_ref(waiting, base, rhs, gap_idle, gap_vec, H):
    """waiting (B, n) bool; base, rhs, gap_idle (B, n) f64; gap_vec
    (B, n + 1) f64; H (B,) f64. Returns (start (B, n) bool, gap_sum (B,)
    f64) on the inputs' device."""
    B, n = base.shape
    start = torch.zeros((B, n), dtype=torch.bool)
    gap_sum = torch.zeros(B, dtype=torch.float64)
    rows = zip(waiting.tolist(), base.tolist(), rhs.tolist(),
               gap_idle.tolist(), gap_vec.tolist(), H.tolist())
    for row, (w, b, r, gi, gv, h) in enumerate(rows):
        j, gs, out = 0, 0.0, [False] * n
        for i in range(n):
            add = 0.0
            if w[i]:
                if b[i] + h * gv[j] <= r[i] + h * gi[i]:
                    out[i] = True
                    add = gv[j]
                    j += 1
                else:
                    add = gi[i]
            gs += add
        start[row] = torch.tensor(out, dtype=torch.bool)
        gap_sum[row] = gs
    return start.to(base.device), gap_sum.to(base.device)
