"""Online scheduling via the Lyapunov drift-plus-penalty framework (Sec. V).

Queues:
    Q(t+1) = max(Q(t) - b(t), 0) + A(t)                       (Eq. 15)
    H(t+1) = max(H(t) + sum_i g_i(t,t+tau) - L_b, 0)          (Eq. 16)

Per-slot, per-user decision (Alg. 2 line 6, Eqs. 21-23):

    alpha_i = argmin over {schedule, idle} of
        V * P_i(alpha, s) * t_d  -  Q(t) * b_i(alpha)  +  H(t) * g_i(alpha)

with g_i(schedule) from Eq. (4) using the server-supplied lag estimate and
g_i(idle) = previous gap + epsilon (Eq. 12). Theorem 1 gives the
[O(1/V), O(V)] energy-staleness trade-off.

The implementation is the paper's *distributed* variant: each user needs only
(Q, H, V, its own power profile, the lag estimate and the momentum norm) —
two scalars from the server, no app-usage leakage.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .staleness import gradient_gap


@dataclasses.dataclass
class UserSlotState:
    """What user i knows at slot t."""
    p_corun: float        # P^{a'} for the currently-running app (if any)
    p_app: float          # P^a
    p_train: float        # P^b
    p_idle: float         # P^d
    app_running: bool
    lag_estimate: int     # supplied by server (Alg. 2 line 4)
    idle_gap: float       # accumulated g_i from idle slots (Eq. 12)


@dataclasses.dataclass
class Decision:
    schedule: bool
    gap: float            # the g_i(t, t+tau) this decision contributes
    cost: float


@dataclasses.dataclass
class BatchDecision:
    schedule: np.ndarray  # (k,) bool, in waiting-set order
    gaps: np.ndarray      # (k,) float, the g_i each decision contributes
    gap_sum: float        # sum of gaps (feeds Eq. 16)
    n_served: int


class OnlineScheduler:
    """Server-side queue state + the per-user argmin (distributed form)."""

    def __init__(self, V: float, L_b: float, eta: float, beta: float,
                 epsilon: float = 0.05, t_d: float = 1.0):
        self.V = float(V)
        self.L_b = float(L_b)
        self.eta = eta
        self.beta = beta
        self.epsilon = epsilon
        self.t_d = t_d
        self.Q = 0.0
        self.H = 0.0

    # ---------------------------------------------------------------- client
    def decide(self, u: UserSlotState, v_norm: float) -> Decision:
        """Alg. 2 line 6: argmin_{alpha} V*P - Q*b + H*g. Pure O(1)."""
        gap_sched = gradient_gap(v_norm, max(u.lag_estimate, 0), self.eta, self.beta)
        gap_idle = u.idle_gap + self.epsilon

        p_sched = u.p_corun if u.app_running else u.p_train     # Eq. (10)
        p_idle = u.p_app if u.app_running else u.p_idle

        cost_sched = self.V * p_sched * self.t_d - self.Q + self.H * gap_sched
        cost_idle = self.V * p_idle * self.t_d + self.H * gap_idle
        if cost_sched <= cost_idle:
            return Decision(True, gap_sched, cost_sched)
        return Decision(False, gap_idle, cost_idle)

    def decide_batch(self, p_sched, p_idle, idle_gap, lag_base: int,
                     v_norm: float) -> BatchDecision:
        """Vectorized Alg. 2 line 6 over the whole waiting set.

        ``p_sched``/``p_idle`` are the Eq. (10) powers of the schedule/idle
        branch for each waiting user (the caller already selected co-run vs
        background powers from the app status); ``idle_gap`` the accumulated
        Eq. (12) gaps; ``lag_base`` the server lag estimate (in-flight tasks)
        at the start of the slot.

        Replicates the sequential in-slot coupling of repeated ``decide``
        calls exactly: every user that schedules raises the next user's lag
        estimate by one. When H == 0 the gap term cannot influence the
        argmin, so all decisions collapse to one elementwise comparison; the
        sequential dependence only materializes when the staleness queue has
        backlog, where we fall back to an O(k) scalar pass over a shared
        precomputed gap table.
        """
        p_s = np.asarray(p_sched, dtype=float)
        p_i = np.asarray(p_idle, dtype=float)
        ig = np.asarray(idle_gap, dtype=float)
        k = len(p_s)
        # Same elementwise operation order as decide(): V * P * t_d - Q + H*g
        base = self.V * p_s * self.t_d - self.Q
        rhs = self.V * p_i * self.t_d
        gap_idle = ig + self.epsilon
        # g(schedule) at every possible in-slot lag: lag_base + #scheduled-so-far
        gap_vec = gradient_gap(v_norm,
                               max(int(lag_base), 0) + np.arange(k + 1),
                               self.eta, self.beta)
        if self.H == 0.0 or k == 0:
            # +H*g adds exactly 0.0 to both branches -> order-free argmin
            schedule = base <= rhs
        else:
            # cost_sched(j) = base + H*gap_vec[j] is nondecreasing in j
            # (gap_vec is sorted, H > 0, IEEE mult/add are monotone), so
            # user i schedules iff its prefix count j_i <= K_i, the largest
            # j where the comparison holds. Users that pass even at the
            # worst-case lag ("always") or fail at the best ("never") are
            # order-free; only the rest need the sequential prefix replay.
            H = self.H
            ci = rhs + H * gap_idle
            if not np.all(np.diff(gap_vec) >= 0.0):
                # eta/v_norm < 0 inverts the gap ordering; the threshold
                # trick below would misclassify, so replay sequentially
                return self._decide_batch_sequential(base, rhs, gap_idle,
                                                     gap_vec, k)
            p_best = base + H * gap_vec[0] <= ci
            p_worst = base + H * gap_vec[k - 1] <= ci
            schedule = p_worst.copy()
            middle = p_best & ~p_worst
            if middle.any():
                midx = np.nonzero(middle)[0]
                bm, cm = base[midx], ci[midx]
                blo = np.zeros(len(midx), np.int64)       # comparison true
                bhi = np.full(len(midx), k - 1, np.int64)  # comparison false
                while np.any(bhi - blo > 1):
                    mid = (blo + bhi) >> 1
                    ok = bm + H * gap_vec[mid] <= cm
                    blo = np.where(ok, mid, blo)
                    bhi = np.where(ok, bhi, mid)
                K = blo.tolist()
                ca = (np.cumsum(schedule) - schedule)[midx].tolist()
                m = 0
                x = np.zeros(len(midx), dtype=bool)
                for ii in range(len(midx)):
                    if ca[ii] + m <= K[ii]:
                        x[ii] = True
                        m += 1
                schedule[midx] = x
        before = np.cumsum(schedule) - schedule          # exclusive prefix
        gaps = np.where(schedule, gap_vec[before], gap_idle)
        return BatchDecision(schedule, gaps, float(np.sum(gaps)),
                             int(np.count_nonzero(schedule)))

    def _decide_batch_sequential(self, base, rhs, gap_idle, gap_vec, k):
        """Literal replay of k decide() calls — correct for any gap
        ordering, O(k) Python; only reached with pathological eta/v_norm."""
        H = self.H
        schedule = np.zeros(k, dtype=bool)
        gaps = np.empty(k)
        bl, rl, gl, gv = base.tolist(), rhs.tolist(), gap_idle.tolist(), \
            gap_vec.tolist()
        j = 0
        for i in range(k):
            if bl[i] + H * gv[j] <= rl[i] + H * gl[i]:
                schedule[i] = True
                gaps[i] = gv[j]
                j += 1
            else:
                gaps[i] = gl[i]
        return BatchDecision(schedule, gaps, float(np.sum(gaps)), j)

    # ---------------------------------------------------------------- server
    def update_queues(self, arrivals: int, served: int, gap_sum: float,
                      departures: int = 0):
        """Eqs. (15)-(16); called once per slot with that slot's totals.
        ``departures`` extends Eq. (15) for device churn
        (core/dynamics.py): a waiting user whose device goes down leaves
        the request queue without being served, so the backlog drains by
        ``served + departures``. Zero (the default) is the paper's
        always-on fleet — bit-identical to the historical update."""
        self.Q = max(self.Q - served - departures, 0.0) + arrivals
        self.H = max(self.H + gap_sum - self.L_b, 0.0)

    def queue_state(self):
        return self.Q, self.H


def schedule_threshold(V: float, t_d: float, p_sched: float, p_idle: float) -> float:
    """Sec. V.B (Eq. 22), no-staleness regime: schedule iff
    Q >= V * t_d * (P_sched - P_idle). Exposed for tests/analysis."""
    return V * t_d * (p_sched - p_idle)
