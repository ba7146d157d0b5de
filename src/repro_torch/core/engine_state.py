"""Engine state: ONE explicit state container for the simulator engine.

The counterpart of ``repro/core/engine_state.py``: ``EngineState`` holds the
per-user struct-of-arrays device state, the server/scheduler scalars
(version, in-flight count, the Eq. 15/16 queues Q and H and their running
sums), the policy's carry (``Policy.init_carry``) and the aggregation
rule's carry. It is a plain dataclass of numpy arrays: the numpy engine
mutates it in place.

The push log is a ``PushLog`` of fixed-width blocks (six columns — slot,
user, lag, gap, corun, applied aggregation weight); the
``SimResult.push_log`` dict schema is decoded lazily on access.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

# Shared state encodings of the engines. MODE_OFF is the device-dynamics
# parking state (core/dynamics.py): a user whose device churned off draws
# no power and re-enters the arrival process through cooldown when it
# comes back up.
MODE_WAIT, MODE_TRAIN, MODE_COOL, MODE_OFF = 0, 1, 2, 3
# Offline (Alg. 1) per-user plan codes: hold until the next plan, wait to
# co-run, train now separately.
PLAN_HOLD, PLAN_CORUN, PLAN_SEP = 0, 1, 2

# Column order of the push-event records. ``weight`` is the aggregation
# rule's applied mixing weight (core/aggregation.py) — 1.0 under the
# paper's replace rule.
EVENT_FIELDS = ("t", "user", "lag", "gap", "corun", "weight")


@dataclasses.dataclass
class EngineState:
    """The one state container threaded through the engine.

    Per-user struct-of-arrays (``(n_users,)`` each): ``mode`` (wait / train /
    cool / off), ``cooldown`` slots left, current ``app`` id (-1 = none), remaining
    app / training seconds, ``corun`` flag of the current/last training run,
    the accumulated Eq. (12) ``idle_gap``, the global ``pulled_at`` version,
    per-user ``energy`` (J) and ``updates``, and the offline policy's
    ``plan`` code (``PLAN_*``; reset to hold when a user re-enters the
    waiting queue).

    Scheduler / server scalars: global model ``version``, ``in_flight``
    trainer count, ``round_open`` (a sync round is training), the Lyapunov
    queues ``Q`` / ``H`` (Eqs. 15/16) plus their
    horizon sums, and the co-run update counter. ``rng_key`` is the run's
    raw threefry key ``[0, seed]`` (the JAX ``PRNGKey(seed)`` layout) that
    ``eps_greedy`` and the ``markov`` dynamics split once a slot.
    ``carry`` is the policy's carry (``Policy.init_carry``), ``agg_carry``
    the aggregation rule's (``AggregationRule.init_carry``) and ``dyn``
    the dynamics' per-user state (``DeviceDynamics.init_state``).
    """

    # ---- per-user struct-of-arrays -----------------------------------
    mode: Any
    cooldown: Any
    app: Any
    app_rem: Any
    train_rem: Any
    corun: Any
    idle_gap: Any
    pulled_at: Any
    energy: Any
    updates: Any
    plan: Any
    # ---- scheduler / server scalars ----------------------------------
    version: Any = 0
    in_flight: Any = 0
    round_open: Any = False
    Q: Any = 0.0
    H: Any = 0.0
    sum_Q: Any = 0.0
    sum_H: Any = 0.0
    corun_updates: Any = 0
    # ---- rng / policy, rule and dynamics carries ----------------------
    rng_key: Any = None
    carry: Any = None
    agg_carry: Any = None
    dyn: Any = None

    @classmethod
    def init(cls, n: int, cfg, policy, agg=None, fleet=None,
             dynamics=None) -> "EngineState":
        """Fresh state for an ``n``-user run: everyone cooling with zero
        cooldown (first slot moves the fleet to waiting), no apps, v0
        model, empty queues. ``agg``/``fleet`` initialize the rule carry;
        ``dynamics`` (a resolved DeviceDynamics) the churn state; ``None``
        or an inactive dynamics leaves it empty."""
        return cls(
            mode=np.full(n, MODE_COOL, dtype=np.int8),
            cooldown=np.zeros(n, dtype=np.int64),
            app=np.full(n, -1, dtype=np.int64),
            app_rem=np.zeros(n),
            train_rem=np.zeros(n),
            corun=np.zeros(n, dtype=bool),
            idle_gap=np.zeros(n),
            pulled_at=np.zeros(n, dtype=np.int64),
            energy=np.zeros(n),
            updates=np.zeros(n, dtype=np.int64),
            plan=np.full(n, PLAN_HOLD, dtype=np.int8),
            rng_key=np.array([0, cfg.seed & 0xFFFFFFFF], dtype=np.uint32),
            carry=policy.init_carry(n, cfg),
            agg_carry=None if agg is None else agg.init_carry(n, cfg, fleet),
            dyn=None if dynamics is None or not dynamics.active
            else dynamics.init_state(n, cfg, fleet),
        )


class PushLog:
    """Fixed-width push-log accumulator with the historical dict schema.

    The numpy engine appends one columnar block per slot (``extend``),
    the loop oracle one event per push (``append``). The
    sequence interface decodes per-event dicts
    ``{"t", "user", "lag", "gap", "corun", "weight"}`` lazily, so holding
    a fleet-scale log costs six flat arrays, not O(pushes) dicts;
    iteration and ``log == [...]`` behave exactly like the historical
    list of dicts.
    """

    __slots__ = ("_parts", "_n", "_cache")

    def __init__(self):
        self._parts = []   # (t, user, lag, gap, corun, weight) blocks
        self._n = 0
        self._cache = None

    # ------------------------------------------------------------- builders
    def append(self, t, user, lag, gap, corun, weight=1.0) -> None:
        """One event (the loop oracle's per-push path)."""
        self._parts.append((np.asarray([t], np.int64),
                            np.asarray([user], np.int64),
                            np.asarray([lag], np.int64),
                            np.asarray([gap], np.float64),
                            np.asarray([corun], bool),
                            np.asarray([weight], np.float64)))
        self._n += 1
        self._cache = None

    def extend(self, t, users, lags, gaps, corun, weights=None) -> None:
        """One slot's finisher cohort (the numpy engine's path); ``t`` is
        the scalar slot, the rest ``(k,)`` arrays in user order.
        ``weights=None`` means full-weight (replace) pushes."""
        users = np.asarray(users, np.int64)
        k = len(users)
        if not k:
            return
        self._parts.append((np.full(k, t, np.int64), users,
                            np.asarray(lags, np.int64),
                            np.asarray(gaps, np.float64),
                            np.asarray(corun, bool),
                            np.ones(k, np.float64) if weights is None
                            else np.asarray(weights, np.float64)))
        self._n += k
        self._cache = None

    # ------------------------------------------------------------- readers
    def arrays(self):
        """The six concatenated columns, ``EVENT_FIELDS`` order."""
        if self._cache is None:
            if self._parts:
                cols = tuple(np.concatenate([p[j] for p in self._parts])
                             for j in range(6))
            else:
                cols = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, np.int64), np.zeros(0, np.float64),
                        np.zeros(0, bool), np.zeros(0, np.float64))
            self._cache = cols
        return self._cache

    def field(self, name: str) -> np.ndarray:
        return self.arrays()[EVENT_FIELDS.index(name)]

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def _event(self, i: int) -> dict:
        t, u, l, g, c, w = self.arrays()
        # python scalars on purpose: digests/reprs must match the
        # historical dict-of-python-scalars schema byte for byte
        return {"t": int(t[i]), "user": int(u[i]), "lag": int(l[i]),
                "gap": float(g[i]), "corun": bool(c[i]),
                "weight": float(w[i])}

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._event(j) for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self._event(i)

    def __iter__(self):
        for i in range(self._n):
            yield self._event(i)

    def __eq__(self, other):
        if isinstance(other, PushLog):
            return list(self) == list(other)
        if isinstance(other, (list, tuple)):
            return list(self) == list(other)
        return NotImplemented

    def __repr__(self):
        return f"PushLog(n={self._n})"
