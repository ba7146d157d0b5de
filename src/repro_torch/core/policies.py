"""Pluggable scheduling policies: one registry, one carry protocol.

The counterpart of ``repro/core/policies.py``. A ``Policy`` is a
registered object; ``init_carry(n, cfg)`` returns its per-run state (which
the engine threads as ``EngineState.carry``), and ``decide_vectorized``
makes one slot's decisions on the struct-of-arrays numpy engine
(``core/vector_engine.py``).

Ships the paper's four schedulers (Sec. VII.B): the online Lyapunov
controller (Alg. 2, the paper's contribution), the immediate baseline the
energy saving is measured against, the offline knapsack oracle (Alg. 1)
and FedAvg's lock-step rounds (sync). The JAX package's ``greedy`` and
``eps_greedy`` are still to port (ROADMAP Queue 1 items 3 and 4). For a
given seed the decisions equal the JAX package's vectorized engine bit for
bit.
"""
from __future__ import annotations

from typing import Dict, Tuple, Type

import numpy as np

from .engine_state import PLAN_CORUN, PLAN_HOLD, PLAN_SEP
from .offline import knapsack_schedule, lemma1_lag_bounds
from .staleness import gradient_gap

__all__ = ["Policy", "register_policy", "registered_policies",
           "resolve_policy", "plan_window", "SyncPolicy", "ImmediatePolicy",
           "OnlinePolicy", "OfflinePolicy"]


class Policy:
    """Base scheduling policy. Subclass, set ``name``, implement
    ``decide_vectorized``, and decorate with ``@register_policy``.

    - ``sync_rounds``: lock-step rounds (FedAvg): the version advances
      once a round, when its last trainer finishes, and a real-ML backend
      averages the round's models instead of applying pushes.
    - ``uses_online_queue``: the per-slot Lyapunov decision runs on-device,
      so ``include_scheduler_overhead`` adds Table III's scheduler power
      while waiting.
    """

    name: str = ""
    sync_rounds: bool = False
    uses_online_queue: bool = False

    def init_carry(self, n: int, cfg):
        """Per-run policy state (``EngineState.carry``); ``None`` for
        stateless policies."""
        return None

    def decide_vectorized(self, eng, t: int, carry) -> Tuple[int, float]:
        """Decisions for slot ``t`` on the engine ``eng`` (state ``eng.s``,
        masks ``eng.waiting`` / ``eng.has_app``); schedule users with
        ``eng.begin_training(idx)``. Returns (served, gap_sum) feeding
        Eqs. (15)/(16)."""
        raise NotImplementedError(
            f"policy {self.name!r} implements no decide_vectorized hook")


_REGISTRY: Dict[str, Type[Policy]] = {}
_INSTANCES: Dict[str, Policy] = {}       # singletons for string lookups


def register_policy(cls: Type[Policy]) -> Type[Policy]:
    """Class decorator: make ``cls`` resolvable as ``cls.name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a registry name")
    _REGISTRY[cls.name] = cls
    _INSTANCES.pop(cls.name, None)       # re-registration wins
    return cls


def registered_policies() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def resolve_policy(policy) -> Policy:
    """String -> registered singleton; Policy instance -> itself."""
    if isinstance(policy, Policy):
        return policy
    if isinstance(policy, str):
        if policy not in _REGISTRY:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"expected one of {registered_policies()} "
                             "or a Policy instance")
        if policy not in _INSTANCES:
            _INSTANCES[policy] = _REGISTRY[policy]()
        return _INSTANCES[policy]
    raise ValueError(f"policy must be a name or Policy instance, "
                     f"got {type(policy).__name__}")


# ---------------------------------------------------------------------------
# Offline window planning (Alg. 1) over array state
# ---------------------------------------------------------------------------
def plan_window(plan, t, widx, app, app_sched, app_choice, T_COR, SRATE,
                window, v_norm, L_b, resolution, eta, beta, row0=0):
    """One Alg. 1 plan over the look-ahead window, mutating and returning
    ``plan`` (the per-user PLAN_* codes in ``EngineState.plan``).

    Candidates are waiting users (``widx``) with an app running now or an
    (oracle lookahead) arrival inside the window; the knapsack picks which
    of them wait to co-run, the rest train immediately. Users without an
    in-window arrival hold until the next plan.

    ``app_sched``/``app_choice`` may be the full horizon (``row0 = 0``,
    the numpy engine) or just a slice whose row i is absolute slot
    ``row0 + i``."""
    if not len(widx):
        return plan
    W = int(window)
    horizon = min(t + W, row0 + app_sched.shape[0])
    sub = app_sched[t - row0:horizon - row0][:, widx]  # (window, n_waiting)
    if sub.shape[0]:
        has_arr = sub.any(axis=0)
        first = sub.argmax(axis=0)                   # first arrival offset
    else:
        # sub-slot window or horizon tail: no lookahead rows — only users
        # with an app running now are candidates
        has_arr = np.zeros(len(widx), dtype=bool)
        first = np.zeros(len(widx), dtype=np.int64)
    ha = app[widx] >= 0
    cand = ha | has_arr
    plan[widx[~cand]] = PLAN_HOLD
    cidx = widx[cand]
    if not len(cidx):
        return plan
    ta = np.where(ha[cand], t, t + first[cand])      # absolute slots
    # np.where evaluates both branches: the app-running candidates' unused
    # app_choice gather still needs an in-bounds row
    if app_choice.shape[0]:
        pick = app_choice[np.minimum(ta - row0, app_choice.shape[0] - 1),
                          cidx]
    else:
        pick = np.zeros(len(cidx), dtype=np.int64)   # all-ha candidates
    aid = np.where(ha[cand], app[cidx], pick)
    durs = T_COR[cidx, aid]
    savings = SRATE[cidx, aid] * durs
    lags = lemma1_lag_bounds(np.full(len(cidx), t), ta, durs)
    gaps = np.asarray(gradient_gap(v_norm, lags, eta, beta), dtype=float)
    x, _ = knapsack_schedule(savings, gaps, L_b, resolution=resolution)
    plan[cidx] = np.where(x, PLAN_CORUN, PLAN_SEP)
    return plan


def _offline_plan_host(t, waiting, plan, app, version, sched_w, choice_w,
                       row0, T_COR, SRATE, window, L_b, resolution, eta,
                       beta, v_norm0):
    """The JAX scan engine's host callback for the offline plan: the same
    ``plan_window`` the numpy engine runs, fed only the look-ahead rows
    (``sched_w``/``choice_w``, row i = absolute slot ``row0 + i``) and the
    trace-mode norm model. Returns a new plan array (the input is not
    mutated). The port's scan engine (ROADMAP Queue 1 item 6) will call
    it; the numpy engine calls ``plan_window`` directly."""
    from .simulator import trace_v_norm

    t = int(t)
    plan = np.array(plan)                           # functional: copy
    widx = np.nonzero(np.asarray(waiting))[0]
    vn = trace_v_norm(float(v_norm0), int(version))
    out = plan_window(plan, t, widx, np.asarray(app),
                      np.asarray(sched_w), np.asarray(choice_w),
                      np.asarray(T_COR), np.asarray(SRATE),
                      float(window), vn, float(L_b), float(resolution),
                      float(eta), float(beta), row0=int(row0))
    return out.astype(plan.dtype, copy=False)


# ---------------------------------------------------------------------------
# The four paper policies (Sec. VII.B)
# ---------------------------------------------------------------------------
@register_policy
class SyncPolicy(Policy):
    """FedAvg lock-step: a round starts only when the whole cohort waits;
    the engine closes it (``round_open`` falls, ``version`` rises) once no
    user trains."""

    name = "sync"
    sync_rounds = True

    def decide_vectorized(self, eng, t, carry):
        s = eng.s
        if not s.round_open and \
                int(np.count_nonzero(eng.waiting)) == eng.n:
            eng.begin_training(eng.ar)
            s.round_open = True
            return eng.n, 0.0
        return 0, 0.0


@register_policy
class ImmediatePolicy(Policy):
    """ASync baseline: schedule every waiting user ASAP (energy ceiling)."""

    name = "immediate"

    def decide_vectorized(self, eng, t, carry):
        if eng.waiting.any():
            widx = np.nonzero(eng.waiting)[0]
            eng.begin_training(widx)
            return len(widx), 0.0
        return 0, 0.0


@register_policy
class OnlinePolicy(Policy):
    """Lyapunov drift-plus-penalty controller (Alg. 2, Eqs. 21-23)."""

    name = "online"
    uses_online_queue = True

    def decide_vectorized(self, eng, t, carry):
        if not eng.waiting.any():
            return 0, 0.0
        s = eng.s
        widx = np.nonzero(eng.waiting)[0]
        # real mode reads the server's momentum norm here: one host sync
        # per slot that has waiting users
        vn = eng.v_norm(s.version)
        d = eng.sched.decide_batch(eng.p_if_train[widx], eng.p_if_idle[widx],
                                   s.idle_gap[widx], s.in_flight, vn)
        if d.n_served:
            eng.begin_training(widx[d.schedule])
        if d.n_served != len(widx):
            s.idle_gap[widx[~d.schedule]] += eng.cfg.epsilon
        return d.n_served, d.gap_sum


@register_policy
class OfflinePolicy(Policy):
    """Oracle knapsack with look-ahead window (Alg. 1).

    Carry: the next plan slot. Every ``offline_window`` seconds
    ``plan_window`` writes the per-user ``plan`` codes in
    ``EngineState.plan`` (the engine resets a user's plan to hold when it
    re-enters the waiting queue); between plans, co-run-planned users
    start once their app runs and separate-planned users start at once."""

    name = "offline"

    def init_carry(self, n, cfg):
        return {"next_plan": 0.0}

    def decide_vectorized(self, eng, t, carry):
        cfg = eng.cfg
        s = eng.s
        if t >= carry["next_plan"]:
            carry["next_plan"] = t + cfg.offline_window
            plan_window(s.plan, t, np.nonzero(eng.waiting)[0], s.app,
                        eng.app_sched, eng.app_choice, eng.T_COR, eng.SRATE,
                        cfg.offline_window, eng.v_norm(s.version),
                        cfg.L_b, cfg.offline_resolution, cfg.eta, cfg.beta)
        start = eng.waiting & (((s.plan == PLAN_CORUN) & eng.has_app) |
                               (s.plan == PLAN_SEP))
        if start.any():
            sidx = np.nonzero(start)[0]
            eng.begin_training(sidx)
            return len(sidx), 0.0
        return 0, 0.0
