"""Pluggable scheduling policies: one registry, one carry protocol, one
hook per engine.

The counterpart of ``repro/core/policies.py``. A ``Policy`` is a
registered object; ``init_carry(n, cfg)`` returns its per-run state (which
the engines thread as ``EngineState.carry``), and two hooks make one
slot's decisions:

``decide_loop(sim, t, waiting, carry)``
    Reference semantics on the per-user loop oracle
    (``FederatedSim._run_loop``). Required.
``decide_vectorized(eng, t, carry)``
    The same decisions on the struct-of-arrays numpy engine
    (``core/vector_engine.py``); set ``supports_vectorized``.

Ships the paper's four schedulers (Sec. VII.B) — the online Lyapunov
controller (Alg. 2, the paper's contribution), the immediate baseline the
energy saving is measured against, the offline knapsack oracle (Alg. 1)
and FedAvg's lock-step rounds (sync) — and the JAX package's two extras:
the ``greedy`` energy-threshold baseline and ``eps_greedy``, whose draws
come from ``EngineState.rng_key`` through the threefry twin
(``core/prng.py``). For a given seed both hooks take the JAX package's
loop and numpy engines' decisions bit for bit. The JAX package's third
hook, ``scan_step``, belongs to its scan engine (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Type

import numpy as np

from . import prng
from .energy import APPS
from .engine_state import PLAN_CORUN, PLAN_HOLD, PLAN_SEP
from .lyapunov import UserSlotState
from .offline import knapsack_schedule, lemma1_lag_bounds
from .staleness import gradient_gap

__all__ = ["Policy", "register_policy", "registered_policies",
           "resolve_policy", "engine_support", "plan_window", "SyncPolicy",
           "ImmediatePolicy", "OnlinePolicy", "OfflinePolicy",
           "GreedyThresholdPolicy", "EpsGreedyPolicy"]


class Policy:
    """Base scheduling policy. Subclass, set ``name``, implement
    ``decide_loop`` (and ``decide_vectorized``), and decorate with
    ``@register_policy``.

    - ``sync_rounds``: lock-step rounds (FedAvg): the version advances
      once a round, when its last trainer finishes, and a real-ML backend
      averages the round's models instead of applying pushes.
    - ``uses_online_queue``: the per-slot Lyapunov decision runs on-device,
      so ``include_scheduler_overhead`` adds Table III's scheduler power
      while waiting.
    - ``supports_vectorized``: ``decide_vectorized`` exists, so
      ``engine="auto"`` may pick the numpy engine. ``SimConfig`` checks
      the flag against the hook at construction.
    """

    name: str = ""
    sync_rounds: bool = False
    uses_online_queue: bool = False
    supports_vectorized: bool = False

    def init_carry(self, n: int, cfg):
        """Per-run policy state (``EngineState.carry``) that both engines
        mutate in place; ``None`` for stateless policies."""
        return None

    def decide_loop(self, sim, t: int, waiting: list, carry
                    ) -> Tuple[int, float]:
        """Schedule the waiting ``UserState``s of slot ``t`` with
        ``sim.begin_training``. Returns (served, gap_sum) feeding Eqs.
        (15)/(16)."""
        raise NotImplementedError(
            f"policy {self.name!r} implements no loop hook")

    def decide_vectorized(self, eng, t: int, carry) -> Tuple[int, float]:
        """Decisions for slot ``t`` on the engine ``eng`` (state ``eng.s``,
        masks ``eng.waiting`` / ``eng.has_app``); schedule users with
        ``eng.begin_training(idx)``. Returns (served, gap_sum). Only called
        when ``supports_vectorized``."""
        raise TypeError(
            f"policy {self.name!r} sets supports_vectorized but inherits "
            "the base decide_vectorized; implement the hook or clear the "
            "flag")


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


def engine_support(policy: Policy) -> Dict[str, bool]:
    """Which engine hooks ``policy`` genuinely implements: ``vectorized``
    is the flag set AND the base stub overridden."""
    cls = type(policy)
    return {
        "vectorized": (policy.supports_vectorized and
                       cls.decide_vectorized is not Policy.decide_vectorized),
    }


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
    supports_vectorized = True

    def decide_loop(self, sim, t, waiting, carry):
        served = 0
        if not sim._round_open and len(waiting) == sim.cfg.n_users:
            for u in waiting:
                sim.begin_training(u, t, corun=u.app is not None)
                served += 1
            sim._round_open = True
        return served, 0.0

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
    supports_vectorized = True

    def decide_loop(self, sim, t, waiting, carry):
        for u in waiting:
            sim.begin_training(u, t, corun=u.app is not None)
        return len(waiting), 0.0

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
    supports_vectorized = True

    def decide_loop(self, sim, t, waiting, carry):
        cfg = sim.cfg
        # every slot, as the JAX oracle does: real mode reads the
        # server's momentum norm (a host float after a hooks push)
        vn = sim._v_norm()
        served = 0
        gap_sum = 0.0
        for u in waiting:
            a = u.app is not None
            ap = u.device.apps[u.app] if a else None
            st = UserSlotState(
                p_corun=ap.p_corun if a else 0.0,
                p_app=ap.p_app if a else 0.0,
                p_train=u.device.p_train, p_idle=u.device.p_idle,
                app_running=a,
                lag_estimate=sim.in_flight,
                idle_gap=u.idle_gap)
            d = sim.sched.decide(st, vn)
            gap_sum += d.gap
            if d.schedule:
                sim.begin_training(u, t, corun=a)
                served += 1
            else:
                u.idle_gap += cfg.epsilon
        return served, gap_sum

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
    supports_vectorized = True

    def init_carry(self, n, cfg):
        return {"next_plan": 0.0}

    def decide_loop(self, sim, t, waiting, carry):
        cfg = sim.cfg
        if t >= carry["next_plan"]:
            carry["next_plan"] = t + cfg.offline_window
            self._plan_loop(sim, t, waiting)
        served = 0
        for u in waiting:
            if u.plan == "corun":
                if u.app is not None:
                    sim.begin_training(u, t, corun=True)
                    served += 1
            elif u.plan == "separate":
                sim.begin_training(u, t, corun=u.app is not None)
                served += 1
            # plan "hold": idle until the next window
        return served, 0.0

    def _plan_loop(self, sim, t: int, waiting: List):
        """Knapsack over the look-ahead window (Alg. 1), object form (the
        oracle; ``plan_window`` is its array twin). Users whose app runs
        now or arrives inside the window are candidates: chosen -> wait
        and co-run, rejected -> train at once; the rest hold."""
        cfg = sim.cfg
        W = int(cfg.offline_window)
        cands, t_app, t_now, durs, savings = [], [], [], [], []
        for u in waiting:
            i = u._uid
            horizon = min(t + W, sim.app_sched.shape[0])
            arr = np.nonzero(sim.app_sched[t:horizon, i])[0]
            if u.app is not None:
                ta, app = t, u.app
            elif len(arr):
                ta = t + int(arr[0])
                app = APPS[sim.app_choice[ta, i]]
            else:
                u.plan = "hold"
                continue
            cands.append(u)
            t_now.append(t)
            t_app.append(ta)
            durs.append(u.device.apps[app].t_corun)
            savings.append(u.device.energy_saving_rate(app)
                           * u.device.apps[app].t_corun)
        if not cands:
            return
        lags = lemma1_lag_bounds(np.array(t_now), np.array(t_app),
                                 np.array(durs))
        vn = sim._v_norm()
        gaps = np.array([gradient_gap(vn, int(l), cfg.eta, cfg.beta)
                         for l in lags])
        x, _ = knapsack_schedule(np.array(savings), gaps, cfg.L_b,
                                 resolution=cfg.offline_resolution)
        for u, chosen in zip(cands, x):
            u.plan = "corun" if chosen else "separate"

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


# ---------------------------------------------------------------------------
# Registered extras beyond the paper's four
# ---------------------------------------------------------------------------
@register_policy
class GreedyThresholdPolicy(Policy):
    """Greedy energy-threshold baseline (not in the paper).

    Schedules a waiting user as soon as the marginal power of training is
    below ``theta`` watts — P^{a'} - P^a while an app runs, P^b - P^d
    when idle — or once it has waited ``patience`` slots. Carry: the
    per-user wait counters ``waited``."""

    name = "greedy"
    supports_vectorized = True

    def __init__(self, theta: float = 0.3, patience: int = 240):
        if patience < 0:
            raise ValueError(f"patience must be >= 0, got {patience}")
        self.theta = float(theta)
        self.patience = int(patience)

    def init_carry(self, n, cfg):
        return {"waited": np.zeros(n, dtype=np.int64)}

    def decide_loop(self, sim, t, waiting, carry):
        waited = carry["waited"]
        served = 0
        for u in waiting:
            a = u.app is not None
            if a:
                ap = u.device.apps[u.app]
                delta = ap.p_corun - ap.p_app
            else:
                delta = u.device.p_train - u.device.p_idle
            i = u._uid
            if delta <= self.theta or waited[i] >= self.patience:
                sim.begin_training(u, t, corun=a)
                waited[i] = 0
                served += 1
            else:
                waited[i] += 1
        return served, 0.0

    def decide_vectorized(self, eng, t, carry):
        w = eng.waiting
        if not w.any():
            return 0, 0.0
        # p_if_train/p_if_idle are (P^{a'}, P^a) with an app and (P^b,
        # P^d) without: the operands the loop hook compares
        delta = eng.p_if_train - eng.p_if_idle
        waited = carry["waited"]
        go = w & ((delta <= self.theta) | (waited >= self.patience))
        if go.any():
            eng.begin_training(np.nonzero(go)[0])
        waited[go] = 0
        waited[w & ~go] += 1
        return int(np.count_nonzero(go)), 0.0


def _eps_draw(rng_key, n):
    """One slot's exploration draws: split the run key, draw ``(n,)`` f32
    uniforms — the JAX package's ``_eps_draw`` bit for bit
    (``core/prng.py``)."""
    k2, sub = prng.split(rng_key)
    return k2, prng.uniform(sub, (n,))


@register_policy
class EpsGreedyPolicy(Policy):
    """Epsilon-greedy exploration over the greedy marginal-power rule:
    schedule a waiting user when ``delta <= theta`` or, with probability
    ``eps`` per user per slot, anyway. The draws split
    ``EngineState.rng_key`` once a slot, UNCONDITIONALLY (even with nobody
    waiting), so the key chain advances alike on both engines and in the
    JAX package."""

    name = "eps_greedy"
    supports_vectorized = True

    def __init__(self, eps: float = 0.05, theta: float = 0.3):
        if not 0.0 <= eps <= 1.0:
            raise ValueError(f"eps must be in [0, 1], got {eps}")
        self.eps = float(eps)
        self.theta = float(theta)

    def decide_loop(self, sim, t, waiting, carry):
        s = sim.state
        s.rng_key, u = _eps_draw(s.rng_key, sim.cfg.n_users)
        served = 0
        for usr in waiting:
            a = usr.app is not None
            if a:
                ap = usr.device.apps[usr.app]
                delta = ap.p_corun - ap.p_app
            else:
                delta = usr.device.p_train - usr.device.p_idle
            if u[usr._uid] < self.eps or delta <= self.theta:
                sim.begin_training(usr, t, corun=a)
                served += 1
        return served, 0.0

    def decide_vectorized(self, eng, t, carry):
        s = eng.s
        s.rng_key, u = _eps_draw(s.rng_key, eng.n)
        w = eng.waiting
        if not w.any():
            return 0, 0.0
        delta = eng.p_if_train - eng.p_if_idle
        go = w & ((u < self.eps) | (delta <= self.theta))
        if go.any():
            eng.begin_training(np.nonzero(go)[0])
        return int(np.count_nonzero(go)), 0.0
