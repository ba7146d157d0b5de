"""Pluggable scheduling policies: one registry, one carry protocol, one
hook per engine.

The counterpart of ``repro/core/policies.py``. A ``Policy`` is a
registered object; ``init_carry(n, cfg)`` returns its per-run state (which
the engines thread as ``EngineState.carry``), and three hooks make one
slot's decisions:

``decide_loop(sim, t, waiting, carry)``
    Reference semantics on the per-user loop oracle
    (``FederatedSim._run_loop``). Required.
``decide_vectorized(eng, t, carry)``
    The same decisions on the struct-of-arrays numpy engine
    (``core/vector_engine.py``); set ``supports_vectorized``.
``scan_step(carry, sv) -> (carry, (start, gap_sum))``
    The same decisions on the device scan engine (``engine="jax"``,
    core/vector_engine.py); set ``supports_jax``. ``sv`` is the slot
    view: per-user ``(B, n)`` tensors with a leading config axis (masks,
    catalog gathers, ``idle_gap``, ``plan``), ``(B, 1)`` scheduler
    scalars and knobs (``Q``, ``H``, ``version``, ``V``, ...; the
    policy's ``scan_operands`` as ``sv.consts``), the ``(B, 2)`` run key
    and the slot ``t`` as a Python int. The hook writes ``sv.idle_gap``,
    ``sv.plan``, ``sv.round_open`` or ``sv.rng_key`` where it owns them,
    and returns the ``(B, n)`` start mask and the ``(B, 1)`` Eq. (16) gap
    sum. It reads nothing back to the host, except where its decision
    logic is host code (offline's knapsack, at plan slots only).

Ships the paper's four schedulers (Sec. VII.B) — the online Lyapunov
controller (Alg. 2, the paper's contribution), the immediate baseline the
energy saving is measured against, the offline knapsack oracle (Alg. 1)
and FedAvg's lock-step rounds (sync) — and the JAX package's two extras:
the ``greedy`` energy-threshold baseline and ``eps_greedy``, whose draws
come from ``EngineState.rng_key`` through the threefry twin
(``core/prng.py``). For a given seed the hooks take the JAX package's
loop and numpy engines' decisions bit for bit, and ``scan_step`` its jax
engine's under x64. Online's ``scan_step`` walks the users of a slot in
the CUDA C++ replay kernel (``kernels/online_replay``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Type

import numpy as np

import torch

from ..kernels.online_replay import online_replay
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
    - ``supports_vectorized`` / ``supports_jax``: ``decide_vectorized``
      / ``scan_step`` exists. ``SimConfig`` checks each flag against its
      hook at construction.
    - ``supports_vmap``: ``scan_step`` may run on a batched sweep's
      ``(B, n)`` tensors (``run_sweep``). Offline clears it: its host
      knapsack plans one config at a time.
    - ``supports_shard``: ``scan_step`` may run on a user axis padded to
      a multiple of the device count (``SimConfig.n_devices``). The
      engine's slot view then carries ``sv.n`` (the LIVE user count),
      ``sv.n_arr`` (the padded length, ``sv.n`` unpadded) and
      ``sv.pad_users(x, fill)``: a hook draws its per-user randomness at
      ``sv.n`` and pads it (threefry draws depend on the shape, so a draw
      at ``n_arr`` would fork the stream from the unpadded engines).
      Offline clears it, as in the JAX package (host callbacks in the
      step).
    """

    name: str = ""
    sync_rounds: bool = False
    uses_online_queue: bool = False
    supports_vectorized: bool = False
    supports_jax: bool = False
    supports_vmap: bool = True
    supports_shard: bool = True

    def init_carry(self, n: int, cfg):
        """Per-run policy state (``EngineState.carry``): a dict that the
        host engines mutate in place. On the scan engine its numpy arrays
        ride as device tensors with a leading config axis; its Python
        numbers stay on the host (a hook may branch on them without a
        device read) and must be equal across a sweep's configs. ``None``
        for stateless policies."""
        return None

    def scan_operands(self, cfg) -> tuple:
        """Instance knobs ``scan_step`` reads, as a flat tuple of numbers
        (``sv.consts``: (B, 1) tensors, so a sweep over them is one
        batch)."""
        return ()

    def scan_statics(self, cfg) -> tuple:
        """Shape-like knobs ``scan_step`` reads as Python values
        (``sv.statics``); they join the sweep bucket key."""
        return ()

    def jax_cache_key(self):
        """Hashable token of this policy's ``scan_step`` behaviour (the
        JAX package's executable-cache key; here it joins the sweep bucket
        key): the class when the instance has no attributes or routes its
        knobs through ``scan_operands``, else the instance."""
        if not vars(self) or \
                type(self).scan_operands is not Policy.scan_operands:
            return type(self)
        return self

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

    def scan_step(self, carry, sv):
        """Decisions for slot ``sv.t`` on the scan engine's tensors.
        Returns ``(carry, (start (B, n) bool, gap_sum (B, 1) f64))``. Only
        called when ``supports_jax``."""
        raise TypeError(
            f"policy {self.name!r} sets supports_jax but inherits the base "
            "scan_step; implement the hook or clear the flag")


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
    """Which engine hooks ``policy`` genuinely implements: for
    ``vectorized`` and ``jax``, the flag set AND the base stub overridden
    (every policy has the loop hook)."""
    cls = type(policy)
    return {
        "vectorized": (policy.supports_vectorized and
                       cls.decide_vectorized is not Policy.decide_vectorized),
        "jax": (policy.supports_jax and
                cls.scan_step is not Policy.scan_step),
    }


# ---------------------------------------------------------------------------
# Tensor twins of the shared numpy formulas, for scan_step. Eager torch
# rounds every operation, as numpy does: no traced zero is needed.
# ---------------------------------------------------------------------------
def _trace_v_norm_t(v_norm0, version):
    """``simulator.trace_v_norm`` on (B, 1) tensors."""
    return v_norm0 / torch.sqrt(1.0 + 0.05 * version.to(v_norm0.dtype))


def _gradient_gap_t(v_norm, lag, eta, beta):
    """``staleness.gradient_gap`` (Eq. 4) on tensors, with no beta == 0
    branch: 0 ** 0 == 1 gives the same value at lag 0."""
    lag = lag.to(beta.dtype)
    return eta * (1.0 - beta ** lag) / (1.0 - beta) * v_norm


def _no_gap(sv):
    return torch.zeros_like(sv.Q)


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
    """The scan engine's host plan for offline: the same ``plan_window``
    the numpy engine runs, fed only the look-ahead rows
    (``sched_w``/``choice_w``, row i = absolute slot ``row0 + i``) and the
    trace-mode norm model. Returns a new plan array (the input is not
    mutated). ``OfflinePolicy.scan_step`` calls it at plan slots; the
    numpy engine calls ``plan_window`` directly."""
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
    supports_jax = True

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

    def scan_step(self, carry, sv):
        open_now = ~sv.round_open & \
            (sv.waiting.sum(-1, keepdim=True) == sv.n)
        start = sv.waiting & open_now
        sv.round_open = sv.round_open | open_now
        return carry, (start, _no_gap(sv))


@register_policy
class ImmediatePolicy(Policy):
    """ASync baseline: schedule every waiting user ASAP (energy ceiling)."""

    name = "immediate"
    supports_vectorized = True
    supports_jax = True

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

    def scan_step(self, carry, sv):
        return carry, (sv.waiting, _no_gap(sv))


@register_policy
class OnlinePolicy(Policy):
    """Lyapunov drift-plus-penalty controller (Alg. 2, Eqs. 21-23)."""

    name = "online"
    uses_online_queue = True
    supports_vectorized = True
    supports_jax = True

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

    def scan_step(self, carry, sv):
        # Alg. 2 line 6 for every waiting user, in the host engines'
        # operation order: V * P * t_d - Q + H * g against V * P * t_d +
        # H * (idle_gap + eps); gap_vec[j] is the gap at lag in_flight + j
        vn = _trace_v_norm_t(sv.v_norm0, sv.version)
        p_s = torch.where(sv.has_app, sv.pcor_g, sv.PT)
        p_i = torch.where(sv.has_app, sv.papp_g, sv.PI)
        base = sv.V * p_s * sv.t_d - sv.Q
        rhs = sv.V * p_i * sv.t_d
        gap_idle = sv.idle_gap + sv.epsilon
        # one entry a lag the slot can reach, over the (padded) user axis
        # (pad users never wait: entries past n + 1 are never read)
        lag = sv.in_flight + torch.arange(sv.n_arr + 1, device=sv.device)
        gap_vec = _gradient_gap_t(vn, lag, sv.eta, sv.beta)
        # the users' sequential lag coupling, replayed on the device (one
        # launch a slot; with H == 0 the same function is the elementwise
        # rule); gap_sum adds the waiting users' gaps in numpy's order, as
        # the numpy engine's decide_batch does
        start, gap_sum = online_replay(sv.waiting, base, rhs, gap_idle,
                                       gap_vec, sv.H[:, 0])
        sv.idle_gap = torch.where(sv.waiting & ~start,
                                  sv.idle_gap + sv.epsilon, sv.idle_gap)
        return carry, (start, gap_sum[:, None])


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
    supports_jax = True
    # the knapsack plans on the host, one config at a time, and is kept
    # off the padded user axis (SimConfig.n_devices), as in JAX
    supports_vmap = False
    supports_shard = False

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

    def scan_statics(self, cfg) -> tuple:
        return (int(cfg.offline_window),)

    def scan_step(self, carry, sv):
        # next_plan is a host number (it depends on t alone), so only a
        # plan slot reads the device: the look-ahead window's (W, n)
        # arrival rows and the waiting set go to the host, the plan back
        nxt = carry["next_plan"]
        if sv.t >= nxt:
            (W,) = sv.statics
            Wc = min(max(W, 0), sv.T)
            row0 = min(sv.t, sv.T - Wc)
            host = [x[0].cpu().numpy() for x in (
                sv.waiting, sv.plan, sv.app,
                sv.app_sched[:, row0:row0 + Wc],
                sv.app_choice[:, row0:row0 + Wc], sv.T_COR, sv.SRATE)]
            knobs = [float(x) for x in (
                sv.offline_window, sv.L_b, sv.offline_resolution, sv.eta,
                sv.beta, sv.v_norm0)]
            waiting, plan, app, sched_w, choice_w, T_COR, SRATE = host
            window = knobs[0]
            plan = _offline_plan_host(
                sv.t, waiting, plan, app, int(sv.version), sched_w,
                choice_w, row0, T_COR, SRATE, *knobs)
            sv.plan = torch.from_numpy(plan).to(sv.device)[None]
            nxt = sv.t + window
        start = sv.waiting & (((sv.plan == PLAN_CORUN) & sv.has_app) |
                              (sv.plan == PLAN_SEP))
        return {"next_plan": nxt}, (start, _no_gap(sv))


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
    supports_jax = True

    def __init__(self, theta: float = 0.3, patience: int = 240):
        if patience < 0:
            raise ValueError(f"patience must be >= 0, got {patience}")
        self.theta = float(theta)
        self.patience = int(patience)

    def init_carry(self, n, cfg):
        return {"waited": np.zeros(n, dtype=np.int64)}

    def scan_operands(self, cfg):
        return (self.theta, self.patience)

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

    def scan_step(self, carry, sv):
        theta, patience = sv.consts
        waited = carry["waited"]
        delta = torch.where(sv.has_app, sv.pcor_g - sv.papp_g,
                            sv.PT - sv.PI)
        go = sv.waiting & ((delta <= theta) | (waited >= patience))
        waited = torch.where(go, 0, torch.where(sv.waiting & ~go,
                                                waited + 1, waited))
        return {"waited": waited}, (go, _no_gap(sv))


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
    supports_jax = True

    def __init__(self, eps: float = 0.05, theta: float = 0.3):
        if not 0.0 <= eps <= 1.0:
            raise ValueError(f"eps must be in [0, 1], got {eps}")
        self.eps = float(eps)
        self.theta = float(theta)

    def scan_operands(self, cfg):
        return (self.eps, self.theta)

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

    def scan_step(self, carry, sv):
        eps, theta = sv.consts
        # the host hooks' draw, on the device: one split and n uniforms a
        # slot, unconditionally
        keys = prng.split_t(sv.rng_key)
        sv.rng_key = keys[..., 0, :]
        # the live-n draw padded with 1.0 (never < eps: pads never
        # explore), so the stream is the unpadded engines' at any padding
        u = sv.pad_users(prng.uniform_t(keys[..., 1, :], sv.n), 1.0)
        delta = torch.where(sv.has_app, sv.pcor_g - sv.papp_g,
                            sv.PT - sv.PI)
        # u against eps in f64, as the JAX scan compares them under x64
        go = sv.waiting & ((u.to(eps.dtype) < eps) | (delta <= theta))
        return carry, (go, _no_gap(sv))
