"""Engine state: ONE explicit state container for the simulator engine.

The counterpart of ``repro/core/engine_state.py``: ``EngineState`` holds the
per-user struct-of-arrays device state, the server/scheduler scalars
(version, in-flight count, the Eq. 15/16 queues Q and H and their running
sums), the policy's carry (``Policy.init_carry``) and the aggregation
rule's carry. It is a plain dataclass of numpy arrays: the numpy engine
mutates it in place.

The push log is a ``PushLog`` of fixed-width blocks (six columns — slot,
user, lag, gap, corun, applied aggregation weight); the
``SimResult.push_log`` dict schema is decoded lazily on access. The device
scan engine (core/vector_engine.py) keeps the same state as tensors with
a leading config axis and streams its pushes through a ``PushBuffer``, a
preallocated ``(B, capacity, 6)`` tensor filled by scatter and drained
into the ``PushLog`` once a chunk (``PushLog.extend_rows``).

``pad_to_devices``, ``pad_state_per_user`` and ``unpad_state_per_user``
extend a host state's user axis with INERT rows and cut them off again,
for the scan engine's user axis padded to a multiple of the device count
(``SimConfig.n_devices``). The reference's ``state_shardings`` (one
``NamedSharding`` a leaf over a JAX mesh) has no counterpart: the port's
scan runs on one device, where every leaf is whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

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


class PushBuffer(NamedTuple):
    """The scan engine's event buffer: ``rows`` is ``(B, capacity + 1,
    6)`` in ``EVENT_FIELDS`` order, one row a config; ``count`` ``(B, 1)``
    the pushes recorded since the last drain. Rows past the capacity land
    in the spare last row and are lost while ``count`` stays exact, so the
    engine sees an overflow as ``count > capacity`` and re-runs the chunk
    with a larger buffer."""

    rows: Any
    count: Any


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
    # ---- the scan engine's push buffer (None elsewhere) ----------------
    events: Any = None

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
    the loop oracle one event per push (``append``), the scan engine
    one drained buffer slice per chunk (``extend_rows``). The
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

    def extend_rows(self, rows) -> None:
        """A drained ``PushBuffer`` slice: ``rows`` is ``(k, 6)`` float
        in ``EVENT_FIELDS`` order (the scan engine's path)."""
        rows = np.asarray(rows)
        if not len(rows):
            return
        self._parts.append((rows[:, 0].astype(np.int64),
                            rows[:, 1].astype(np.int64),
                            rows[:, 2].astype(np.int64),
                            rows[:, 3].astype(np.float64),
                            rows[:, 4] != 0,
                            rows[:, 5].astype(np.float64)))
        self._n += len(rows)
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


# ---------------------------------------------------------------------------
# The padded user axis (``SimConfig.n_devices``, core/vector_engine.py):
# pad rows park in MODE_OFF with no app and a zeroed catalog row (the scan
# engine zero-pads its table gathers), so they draw no energy, never enter
# the waiting queue and never push; the scheduler scalars evolve exactly
# as at the live n.
# ---------------------------------------------------------------------------
_PER_USER_FIELDS = ("mode", "cooldown", "app", "app_rem", "train_rem",
                    "corun", "idle_gap", "pulled_at", "energy", "updates",
                    "plan")

# inert fill values of the per-user fields; everything not named is 0/False
_PAD_FILLS = {"mode": MODE_OFF, "app": -1, "plan": PLAN_HOLD}


def pad_to_devices(n: int, n_devices: int) -> int:
    """Smallest multiple of ``n_devices`` >= ``n`` (the padded user-axis
    length ``n_arr``)."""
    d = max(int(n_devices), 1)
    return -(-int(n) // d) * d


def _map_tree(fn, tree, *others):
    """Leaf-wise map over dict / list / tuple trees (``None`` passes
    through); ``others`` are trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, *xs) for xs in zip(tree, *others))
    return fn(tree, *others)


def _leaves(tree):
    out = []
    _map_tree(out.append, tree)
    return out


def _check_shapes(state: EngineState, n: int) -> None:
    """Every per-user array ``(n,)``-leading, and every ``dyn`` leaf with
    a leading axis too; raises ValueError naming the offender."""
    for f in _PER_USER_FIELDS:
        shape = np.shape(getattr(state, f))
        if not shape or shape[0] != n:
            raise ValueError(
                f"EngineState.{f} must be an ({n},)-leading per-user "
                f"array, got shape {shape}")
    for leaf in _leaves(state.dyn):
        shape = np.shape(leaf)
        if len(shape) >= 1 and shape[0] != n:
            raise ValueError(
                f"EngineState.dyn leaf has leading dim {shape[0]}, "
                f"expected the run's n_users={n} (shape {shape}); "
                "dynamics init_state must return (n,)-leading arrays")


def pad_state_per_user(state: EngineState, n_arr: int,
                       dyn_rows=None) -> EngineState:
    """Host copy of ``state`` with every per-user leaf extended to
    ``n_arr`` rows of INERT users: MODE_OFF, no app, zero
    energy/updates/cooldown. Policy and rule carries zero-pad their
    ``(n,)``-leading leaves. ``dyn_rows`` is the dynamics' ``pad_state(k)``
    tree of inert rows (required when ``state.dyn`` is populated), cast
    to the state's leaf dtypes. Shape-checked at ``n_arr``."""
    n = int(np.shape(state.mode)[0])
    k = int(n_arr) - n
    if k < 0:
        raise ValueError(f"n_arr={n_arr} is below the live n={n}")
    if k == 0:
        return state

    def pad(x, fill=0):
        x = np.asarray(x)
        return np.concatenate(
            [x, np.full((k,) + x.shape[1:], fill, dtype=x.dtype)])

    def pad_carry_leaf(x):
        a = np.asarray(x)
        return pad(a) if a.ndim >= 1 and a.shape[0] == n else x

    kw = {f: pad(getattr(state, f), _PAD_FILLS.get(f, 0))
          for f in _PER_USER_FIELDS}
    kw["carry"] = _map_tree(pad_carry_leaf, state.carry)
    kw["agg_carry"] = _map_tree(pad_carry_leaf, state.agg_carry)
    if state.dyn is not None:
        if dyn_rows is None:
            raise ValueError(
                "pad_state_per_user needs the dynamics' pad_state(k) rows "
                "to pad a populated EngineState.dyn")
        kw["dyn"] = _map_tree(
            lambda leaf, rows: np.concatenate(
                [np.asarray(leaf), np.asarray(rows, np.asarray(leaf).dtype)])
            if np.ndim(leaf) >= 1 and np.shape(leaf)[0] == n else leaf,
            state.dyn, dyn_rows)
    new = dataclasses.replace(state, **kw)
    _check_shapes(new, int(n_arr))
    return new


def unpad_state_per_user(state: EngineState, n: int) -> EngineState:
    """Drop the pad rows again: every ``(n_arr,)``-leading per-user, carry
    and dyn leaf sliced back to the live ``n``."""
    n_arr = int(np.shape(state.mode)[0])
    if n_arr == n:
        return state

    def cut(x):
        return x[:n] if np.ndim(x) >= 1 and np.shape(x)[0] == n_arr else x

    kw = {f: cut(getattr(state, f)) for f in _PER_USER_FIELDS}
    for f in ("carry", "agg_carry", "dyn"):
        kw[f] = _map_tree(cut, getattr(state, f))
    return dataclasses.replace(state, **kw)
