"""Offline scheduling (Sec. IV, Algorithm 1) — a copy of
``repro/core/offline.py`` (numpy; the port keeps its own).

With all app arrivals known, choosing which users co-run is the 0/1 knapsack

    max sum_i s_i x_i   s.t.  sum_i g_i x_i <= L_b,  x_i in {0,1}   (P1)

solved by pseudo-polynomial DP (Eq. 8) after bounding each user's lag with
the interval-overlap count of Lemma 1 (Eq. 9) — the lag depends on other
users' decisions, and the lemma removes that circularity with a decision-free
upper bound.
"""
from __future__ import annotations

import numpy as np


def lemma1_lag_bounds(t_start, t_app, duration, *, block: int = 1024):
    """Lemma 1: decision-independent upper bound on each user's lag.

    For user i, count users j != i whose training could END inside either of
    i's candidate execution windows [t_i, t_i+d_i] or [t_i^a, t_i^a+d_i],
    considering both of j's candidate end times t_j+d_j and t_j^a+d_j.

    Fully broadcast over (i, j) pairs — no per-i Python loop — processed in
    row blocks of ``block`` users to bound peak memory at O(block * n).
    """
    t = np.asarray(t_start, float)
    ta = np.asarray(t_app, float)
    d = np.asarray(duration, float)
    n = len(t)
    ends = np.stack([t + d, ta + d], axis=1)                 # (n, 2) candidate ends
    lo = np.stack([t, ta], axis=1)                           # (n, 2) window starts
    hi = lo + d[:, None]
    bounds = np.empty(n, dtype=np.int64)
    for s in range(0, n, block):
        e = min(s + block, n)
        # (rows, n, ends(2), windows(2)): does end (j, e) land in window (i, w)?
        in_window = ((ends[None, :, :, None] >= lo[s:e, None, None, :]) &
                     (ends[None, :, :, None] <= hi[s:e, None, None, :]))
        overlaps = in_window.any(axis=(2, 3))                # (rows, n)
        overlaps[np.arange(e - s), np.arange(s, e)] = False  # exclude self
        bounds[s:e] = overlaps.sum(axis=1)
    return bounds


def lemma1_lag_bounds_loop(t_start, t_app, duration):
    """Reference per-i loop form of Lemma 1 (oracle for the broadcast one)."""
    t = np.asarray(t_start, float)
    ta = np.asarray(t_app, float)
    d = np.asarray(duration, float)
    n = len(t)
    ends = np.stack([t + d, ta + d], axis=1)
    lo = np.stack([t, ta], axis=1)
    hi = lo + d[:, None]
    bounds = np.zeros(n, dtype=np.int64)
    for i in range(n):
        in_window = ((ends[:, :, None] >= lo[i][None, None, :]) &
                     (ends[:, :, None] <= hi[i][None, None, :]))   # (n,2,2)
        overlaps = in_window.any(axis=(1, 2))
        overlaps[i] = False
        bounds[i] = int(overlaps.sum())
    return bounds


def knapsack_schedule(savings, gaps, L_b: float, resolution: float = 1.0):
    """Algorithm 1: DP over the staleness budget.

    savings: (n,) energy saving s_i of co-running user i (>0 entries useful).
    gaps:    (n,) gradient-gap weight g_i (>= 0).
    Returns (x: (n,) bool decisions, total_saving: float).

    Weights are discretized at `resolution` (ceil -> the budget is never
    exceeded); complexity O(n * L_b / resolution).
    """
    s = np.asarray(savings, float)
    g = np.asarray(gaps, float)
    n = len(s)
    W = int(np.floor(L_b / resolution))
    if W < 0:
        raise ValueError("L_b must be >= 0")
    w = np.ceil(g / resolution).astype(np.int64)

    # items with non-positive saving are never worth co-running
    # items with zero weight and positive saving are always taken
    dp = np.zeros(W + 1)
    keep = np.zeros((n, W + 1), dtype=bool)
    for i in range(n):
        if s[i] <= 0 or w[i] > W:
            continue
        if w[i] == 0:
            dp += s[i]
            keep[i, :] = True
            continue
        cand = np.concatenate([dp[: w[i]], dp[: W + 1 - w[i]] + s[i]])
        take = cand > dp
        take[: w[i]] = False
        keep[i] = take
        dp = np.maximum(dp, cand)

    # reconstruct
    x = np.zeros(n, dtype=bool)
    y = W
    for i in range(n - 1, -1, -1):
        if keep[i, y]:
            x[i] = True
            if w[i] > 0:
                y -= w[i]
    return x, float(np.sum(s[x]))


def offline_schedule(t_start, t_app, duration, savings, L_b: float,
                     eta: float, beta: float, v_norm: float,
                     resolution: float = 1.0):
    """Full Algorithm 1: Lemma-1 lag bounds -> Eq. 4 gaps -> knapsack DP."""
    from .staleness import gradient_gap

    lags = lemma1_lag_bounds(t_start, t_app, duration)
    gaps = np.asarray(gradient_gap(v_norm, lags, eta, beta), dtype=float)
    return knapsack_schedule(savings, gaps, L_b, resolution=resolution)
