"""Slotted-time federated simulator (Sec. VII.B methodology).

The counterpart of ``repro/core/simulator.py``: n users each owning a
testbed device (Table II catalog), app arrivals per slot, a scheduling
policy, per-slot energy accounting per Eq. (10) and queue dynamics per
Eqs. (15-16). Policies, arrival processes and device fleets come from
registries (core/policies.py, core/arrivals.py, core/fleet.py).

ml_mode="trace" tracks updates and staleness without real gradients;
ml_mode="real" couples the schedule to actual PyTorch training of the
paper's LeNet-5 (or the MLP): through a batched ``ml_backend``
(core/realml.py), or through per-user ``ml_hooks`` (``make_ml_hooks``,
Fig. 5's oracle) on the loop engine.

Engines (``SimConfig.engine``): this class's per-user object loop is the
reference oracle (``"loop"``); ``"vectorized"`` runs the same semantics on
struct-of-arrays state (core/vector_engine.py), and ``"auto"`` picks it
for hook-free trace runs and for real runs with a batched backend, as in
the JAX package. ``"jax"`` is the device scan engine (the name kept for
parity with the JAX package's API): the same slot on ``(B, n)`` tensors
on the card (``FederatedSim(device=...)``, default ``"cuda"``), chunked
into ``jax_chunk`` slots, with the push log streamed through a
``PushBuffer`` (core/vector_engine.py). It runs hook-free trace runs of
policies, rules and dynamics that have their scan hooks, and degrades to
the numpy engine (or the loop) otherwise, by the JAX package's rule. All
engines thread ONE ``EngineState`` (``sim.state``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Union

import numpy as np

from ..kernels.fused_update import KERNEL_MODES
from .aggregation import (AggregationRule, aggregation_support,
                          resolve_aggregation)
from .arrivals import ArrivalProcess, resolve_arrival_or_default
from .dynamics import (DROPOUT_RULES, DeviceDynamics, dynamics_support,
                       resolve_dynamics)
from .energy import APPS, DeviceProfile
from .engine_state import (MODE_COOL, MODE_OFF, MODE_TRAIN, MODE_WAIT,
                           EngineState, PushLog)
from .fleet import Fleet, resolve_fleet
from .lyapunov import OnlineScheduler
from .policies import Policy, engine_support, resolve_policy
from .staleness import gradient_gap

# The paper's four schedulers (Sec. VII.B). The full registry — these plus
# any registered extras — is policies.registered_policies().
POLICIES = ("sync", "immediate", "offline", "online")
ENGINES = ("auto", "loop", "vectorized", "jax")


@dataclasses.dataclass
class SimConfig:
    n_users: int = 25
    horizon_s: int = 10800          # paper: 3 hours
    t_d: float = 1.0                # slot length (s)
    # scalar = the paper's i.i.d. rate; an (n_users,) vector gives every
    # user its own Bernoulli rate (heterogeneous fleets)
    app_arrival_p: Any = 0.001      # paper: ~1 app per 1000 s
    policy: Union[str, Policy] = "online"   # registry name or Policy object
    V: float = 4000.0
    L_b: float = 1000.0
    epsilon: float = 0.05
    eta: float = 0.01
    beta: float = 0.9
    offline_window: float = 500.0   # paper: 500 s look-ahead
    offline_resolution: float = 0.01
    seed: int = 0
    ml_mode: str = "trace"          # trace | real
    # how the server APPLIES pushes (core/aggregation.py); "replace" is
    # the paper's Sec. VI rule
    aggregation: Union[str, AggregationRule] = "replace"
    # how the apply is COMPUTED (kernels/fused_update): "auto" follows
    # the device of the tensors (the Triton kernel on CUDA, the plain
    # version on CPU tensors), "triton" insists on the kernel, "reference"
    # picks the plain version on either device. Only real-ML mode touches
    # parameters, so the knob is a no-op in trace mode.
    kernel: str = "auto"
    ready_delay: int = 5            # slots between push and re-arrival
    trace_every: int = 30           # slots between trace samples
    include_scheduler_overhead: bool = False
    v_norm0: float = 1.0            # trace-mode momentum-norm model scale
    engine: str = "auto"            # auto | loop | vectorized | jax
    collect_push_log: bool = True
    jax_chunk: int = 1024           # slots per chunk of the device scan
    #                                 engine; 0 = auto-tune from device
    #                                 memory (core/autotune.py)
    push_log_capacity: int = 0      # initial per-chunk push buffer rows
    #                                 of the scan engine (0 = auto-sized;
    #                                 doubled and the chunk re-run on
    #                                 overflow)
    # the scan engine's user axis sized to min(n_devices, available)
    # devices (launch/mesh.py make_sim_mesh) and padded with inert users
    # to a multiple of their count; Alg. 2's decisions stay bit for bit
    # the unpadded run's. 0 = unpadded. On one card the run is the
    # unpadded one (ROADMAP Queue 1 item 9: users over several GPUs wait
    # for hardware that can verify them).
    n_devices: int = 0
    # device dynamics (core/dynamics.py): "none" is the paper's always-on
    # fleet; "markov" (or a MarkovChurnDynamics) churns availability,
    # battery and network
    dynamics: Union[str, DeviceDynamics] = "none"

    def __post_init__(self):
        pol = resolve_policy(self.policy)   # raises ValueError on unknowns
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"expected one of {ENGINES}")
        # a support flag without its hook is a property of the policy,
        # so it is refused for every engine
        sup = engine_support(pol)
        if pol.supports_vectorized and not sup["vectorized"]:
            raise ValueError(
                f"policy {pol.name!r} sets supports_vectorized but "
                "implements no decide_vectorized hook; implement "
                "decide_vectorized(eng, t, carry) or clear the flag")
        if pol.supports_jax and not sup["jax"]:
            raise ValueError(
                f"policy {pol.name!r} sets supports_jax but implements no "
                "scan_step hook; implement scan_step(carry, sv) or clear "
                "the flag to degrade to the numpy engine")
        if self.engine == "vectorized" and not sup["vectorized"]:
            raise ValueError(
                f"policy {pol.name!r} implements no vectorized "
                "(decide_vectorized) hook; use engine='loop' (or 'auto', "
                "which falls back to the loop oracle)")
        if self.ml_mode not in ("trace", "real"):
            raise ValueError(f"unknown ml_mode {self.ml_mode!r}")
        if self.kernel not in KERNEL_MODES:
            raise ValueError(f"unknown kernel {self.kernel!r}; "
                             f"expected one of {KERNEL_MODES}")
        agg = resolve_aggregation(self.aggregation)  # raises on unknowns
        asup = aggregation_support(agg)
        if not asup["host"]:
            raise ValueError(
                f"aggregation rule {agg.name!r} implements no weight() "
                "host path; every rule needs one (the loop oracle and "
                "the numpy engine run on it)")
        if agg.supports_jax and not asup["jax"]:
            raise ValueError(
                f"aggregation rule {agg.name!r} sets supports_jax but "
                "implements no scan_weight hook; implement "
                "scan_weight(carry, pv) or clear the flag to degrade to "
                "the numpy engine")
        dyn = resolve_dynamics(self.dynamics)    # raises on unknowns
        dsup = dynamics_support(dyn)
        if not dsup["host"]:
            raise ValueError(
                f"dynamics {dyn.name!r} implements no host_step() path; "
                "every active dynamics needs one (the loop oracle and "
                "the numpy engine run on it)")
        if dyn.active and dyn.supports_jax and not dsup["jax"]:
            raise ValueError(
                f"dynamics {dyn.name!r} sets supports_jax but implements "
                "no scan_step hook; implement scan_step(dyn, dv) or "
                "clear the flag to degrade to the numpy engine")
        if dyn.active and dyn.dropout not in DROPOUT_RULES:
            raise ValueError(
                f"dynamics {dyn.name!r} has unknown dropout rule "
                f"{dyn.dropout!r}; engines apply one of {DROPOUT_RULES}")
        if self.n_users <= 0:
            raise ValueError(f"n_users must be positive, got {self.n_users}")
        if self.t_d <= 0:
            raise ValueError(f"t_d must be positive, got {self.t_d}")
        if self.horizon_s <= 0:
            raise ValueError(
                f"horizon_s must be positive, got {self.horizon_s}")
        p = np.asarray(self.app_arrival_p, dtype=float)
        if p.ndim > 1:
            raise ValueError(
                f"app_arrival_p must be a scalar or an (n_users,) vector, "
                f"got shape {p.shape}")
        if p.ndim == 1 and p.shape[0] != self.n_users:
            raise ValueError(
                f"app_arrival_p vector has {p.shape[0]} entries for "
                f"n_users={self.n_users}")
        if p.size and not np.all((p >= 0.0) & (p <= 1.0)):
            raise ValueError(
                f"app_arrival_p must be in [0, 1], got {self.app_arrival_p}")
        if p.ndim == 1:
            # a plain tuple keeps the dataclass __eq__/repr working
            self.app_arrival_p = tuple(float(x) for x in p)
        if not 0.0 <= self.beta < 1.0:
            raise ValueError(f"beta must be in [0, 1), got {self.beta}")
        if self.V < 0 or self.L_b < 0 or self.epsilon < 0:
            raise ValueError("V, L_b and epsilon must be non-negative")
        if self.eta < 0 or self.v_norm0 < 0:
            # negative eta/v_norm would invert Eq. 4's gap monotonicity,
            # which the batched online argmin relies on
            raise ValueError("eta and v_norm0 must be non-negative")
        if self.offline_window <= 0 or self.offline_resolution <= 0:
            raise ValueError(
                "offline_window and offline_resolution must be positive")
        if self.ready_delay < 0:
            raise ValueError(
                f"ready_delay must be non-negative, got {self.ready_delay}")
        if self.trace_every <= 0:
            raise ValueError(
                f"trace_every must be positive, got {self.trace_every}")
        if self.jax_chunk < 0:
            raise ValueError(
                f"jax_chunk must be positive (or 0 = auto-tune from "
                f"device memory), got {self.jax_chunk}")
        if self.push_log_capacity < 0:
            raise ValueError(
                f"push_log_capacity must be non-negative, got "
                f"{self.push_log_capacity}")
        if self.n_devices < 0:
            raise ValueError(
                f"n_devices must be >= 0 (0 = unsharded), got "
                f"{self.n_devices}")
        if self.n_devices:
            # the padded user axis exists only on the scan engine and never
            # degrades (a fallback would make the knob lie about what ran):
            # ineligible configs are refused here, with the reason
            if self.engine in ("loop", "vectorized"):
                raise ValueError(
                    f"n_devices={self.n_devices} shards the jax chunked "
                    f"scan; it cannot run under engine={self.engine!r} — "
                    "use engine='jax' or 'auto'")
            for what, obj in (("policy", pol), ("dynamics", dyn)):
                if what == "dynamics" and not dyn.active:
                    continue
                if not getattr(obj, "supports_jax", False):
                    raise ValueError(
                        f"n_devices={self.n_devices} needs a jax-capable "
                        f"{what}; {obj.name!r} has supports_jax=False")
                if not getattr(obj, "supports_shard", True):
                    raise ValueError(
                        f"{what} {obj.name!r} does not support the "
                        "sharded scan (supports_shard=False, e.g. host "
                        "callbacks inside the step); run with n_devices=0")
            if self.collect_push_log:
                if not asup["jax"]:
                    raise ValueError(
                        f"n_devices={self.n_devices} with a push log "
                        f"needs a jax-capable aggregation rule; "
                        f"{agg.name!r} implements no scan_weight hook")
                if not getattr(agg, "supports_shard", True):
                    raise ValueError(
                        f"aggregation rule {agg.name!r} does not support "
                        "the sharded scan (supports_shard=False); run "
                        "with n_devices=0")


@dataclasses.dataclass
class UserState:
    """One user on the loop oracle (its readable working view)."""
    device: DeviceProfile
    mode: str = "cooldown"          # waiting | training | cooldown | off
    cooldown: int = 0
    app: Optional[str] = None
    app_remaining: float = 0.0
    train_remaining: float = 0.0
    corun: bool = False
    idle_gap: float = 0.0
    pulled_at: int = 0              # global version at pull
    started_at: int = 0
    energy_j: float = 0.0
    updates: int = 0
    plan: str = "none"              # offline policy: corun | separate | hold


@dataclasses.dataclass
class SimResult:
    energy_j: float
    updates: int
    trace_t: np.ndarray
    trace_energy: np.ndarray
    trace_Q: np.ndarray
    trace_H: np.ndarray
    push_log: Any                   # PushLog (list-of-dicts view): per push
    #                                 t, user, lag, gap, corun, weight
    accuracy: List[tuple]           # (sim_t, test_acc) if ml_mode == real
    mean_Q: float
    mean_H: float
    corun_fraction: float
    drops: int = 0                  # mid-training dropouts (device churn;
    #                                 0 with dynamics="none")


# UserState.mode string <-> engine code; the loop oracle builds the
# dynamics layer's mode view through this map
_MODE_CODE = {"waiting": MODE_WAIT, "training": MODE_TRAIN,
              "cooldown": MODE_COOL, "off": MODE_OFF}


def n_slots(cfg: SimConfig) -> int:
    """Slots in the horizon. round() before int: 48 s / 1.6 s is
    29.999999999999996 in floats and plain int() would drop a slot."""
    return int(round(cfg.horizon_s / cfg.t_d))


def trace_v_norm(v_norm0: float, version) -> float:
    """Trace-mode momentum-norm model: ||v|| decays with global progress
    (version may be an array of per-finisher versions)."""
    return v_norm0 / np.sqrt(1.0 + 0.05 * version)


class FederatedSim:
    def __init__(self, cfg: SimConfig, ml_hooks: Optional[dict] = None, *,
                 ml_backend=None,
                 arrivals: Union[str, ArrivalProcess, None] = None,
                 fleet: Union[str, Fleet, None] = None,
                 device="cuda"):
        """``ml_hooks`` (real mode, the loop engine): {"pull": fn(uid) ->
        params, "local_train": fn(uid, params) -> params, "push": fn(uid,
        params) -> PushResult, "evaluate": fn() -> acc, "v_norm": fn() ->
        float, "sync_submit", "sync_aggregate", "eval_every"}
        (``core.realml.make_ml_hooks``).

        ``ml_backend`` (real mode): a ``core.realml.BatchedMLBackend``
        that the numpy engine drives cohort-at-a-time (the loop engine
        drives the same backend through its ``hooks()``). Pass one or the
        other, not both.

        ``arrivals``/``fleet`` plug in non-paper arrival processes and
        device fleets; the defaults — Bernoulli(cfg.app_arrival_p) on the
        Table II round-robin fleet — consume the seeded rng stream in the
        JAX package's order (fleet shuffle, then the arrival blocks), so
        seeded schedules equal its schedules bit for bit.

        ``device`` is where the device scan engine (``engine="jax"``)
        runs: ``"cuda"`` (the default; a run without CUDA raises) or
        ``"cpu"``, which the caller asks for. It is read only when that
        engine runs; the loop and numpy engines run on the host.

        ``self.state`` is the run's ``EngineState``. The loop oracle keeps
        its per-user ``UserState`` objects as the working view and routes
        the scalars (version, in_flight, round_open), the rng key and the
        carries through the container; the numpy engine consumes it
        whole."""
        self.cfg = cfg
        self.device = device
        self.policy = resolve_policy(cfg.policy)
        self.agg = resolve_aggregation(cfg.aggregation)
        self.dynamics = resolve_dynamics(cfg.dynamics)
        self.rng = np.random.default_rng(cfg.seed)
        self.ml_backend = ml_backend
        if ml_backend is not None:
            if ml_hooks is not None:
                raise ValueError(
                    "pass either ml_hooks or ml_backend, not both")
            if cfg.ml_mode != "real":
                raise ValueError(
                    "ml_backend requires ml_mode='real' (a backend couples "
                    "the schedule to actual training)")
            if ml_backend.n_users != cfg.n_users:
                raise ValueError(
                    f"ml_backend was built for {ml_backend.n_users} users; "
                    f"config has n_users={cfg.n_users}")
            self.ml = ml_backend.hooks()
        else:
            self.ml = ml_hooks or {}
        self.fleet = resolve_fleet(fleet if fleet is not None else "paper")
        self.fleet_spec = self.fleet.build(self.rng, cfg.n_users)
        self.users = [UserState(device=d) for d in self.fleet_spec.devices]
        self.sched = OnlineScheduler(cfg.V, cfg.L_b, cfg.eta, cfg.beta,
                                     cfg.epsilon, cfg.t_d)
        self.state = self._fresh_state()
        if ml_backend is not None:
            ml_backend.bind_fleet(self.fleet_spec, cfg)
            # a sync backend's SyncServer averages and has no rule
            brule = getattr(ml_backend.server, "rule", None)

            def _knobs(r):   # public instance attrs = the rule's knobs
                return {k: v for k, v in vars(r).items()
                        if not k.startswith("_")}

            if brule is not None and brule is not self.agg and \
                    (brule.name != self.agg.name or
                     _knobs(brule) != _knobs(self.agg)):
                raise ValueError(
                    f"ml_backend was built with aggregation rule "
                    f"{brule.name!r} ({_knobs(brule) or 'no knobs'}) but "
                    f"the config says {self.agg.name!r} "
                    f"({_knobs(self.agg) or 'no knobs'}); in real mode the "
                    "backend's server applies the pushes, so the two must "
                    "agree (Scenario threads cfg.aggregation automatically)")
        # Pre-sample the app arrival schedule, one row per SLOT.
        self.arrivals: ArrivalProcess = resolve_arrival_or_default(
            arrivals, cfg.app_arrival_p)
        T = n_slots(cfg)
        self.app_sched, self.app_choice = self.arrivals.sample(
            self.rng, T, cfg.n_users, len(APPS), cfg.t_d)
        self.app_sched = np.asarray(self.app_sched, dtype=bool)
        self.app_choice = np.asarray(self.app_choice, dtype=np.int64)
        if self.app_sched.shape != (T, cfg.n_users) or \
                self.app_choice.shape != (T, cfg.n_users):
            raise ValueError(
                f"arrival process {self.arrivals.name!r} produced shapes "
                f"{self.app_sched.shape}/{self.app_choice.shape}; "
                f"expected {(T, cfg.n_users)}")
        if T and (self.app_choice.min() < 0 or
                  self.app_choice.max() >= len(APPS)):
            raise ValueError(
                f"arrival process {self.arrivals.name!r} produced app "
                f"choices outside [0, {len(APPS)})")

    def _fresh_state(self) -> EngineState:
        return EngineState.init(self.cfg.n_users, self.cfg, self.policy,
                                agg=self.agg, fleet=self.fleet_spec,
                                dynamics=self.dynamics)

    # ------------------------------------------------------------ state views
    # The server scalars live in self.state; these keep the sim.version /
    # sim.in_flight / sim._round_open spelling of the policy hooks.
    @property
    def version(self) -> int:
        return self.state.version

    @version.setter
    def version(self, v: int):
        self.state.version = v

    @property
    def in_flight(self) -> int:
        return self.state.in_flight

    @in_flight.setter
    def in_flight(self, v: int):
        self.state.in_flight = v

    @property
    def _round_open(self) -> bool:
        return self.state.round_open

    @_round_open.setter
    def _round_open(self, v: bool):
        self.state.round_open = v

    # ------------------------------------------------------------------ utils
    def _v_norm(self) -> float:
        if "v_norm" in self.ml:
            return self.ml["v_norm"]()
        return trace_v_norm(self.cfg.v_norm0, self.version)

    def begin_training(self, u: UserState, t: int, corun: bool):
        """Start user ``u`` training this slot (the loop twin of the numpy
        engine's ``begin_training``, called from ``Policy.decide_loop``)."""
        u.mode = "training"
        u.corun = corun and u.app is not None
        u.train_remaining = u.device.duration(u.corun, u.app)
        u.pulled_at = self.version
        u.started_at = t
        self.in_flight += 1
        if self.ml.get("pull"):
            u._params = self.ml["pull"](u._uid)

    def _finish_training(self, u: UserState, t: int, log: PushLog,
                         extra_delay: int = 0):
        """``extra_delay`` is the dynamics' network penalty (slots): a
        finisher in the bad network state re-arrives late."""
        lag = self.version - u.pulled_at
        vn = self._v_norm()
        gap = gradient_gap(vn, lag, self.cfg.eta, self.cfg.beta)
        res = None
        if self.policy.sync_rounds:
            if self.ml.get("sync_submit"):
                trained = self.ml["local_train"](u._uid, u._params)
                self.ml["sync_submit"](trained)
        else:
            self.version += 1
            if self.ml.get("push"):
                trained = self.ml["local_train"](u._uid, u._params)
                res = self.ml["push"](u._uid, trained)
        u.updates += 1
        u.mode = "cooldown"
        u.cooldown = self.cfg.ready_delay + extra_delay
        u.idle_gap = 0.0
        self.in_flight -= 1
        if self.cfg.collect_push_log:
            # the applied weight: what the server did (real mode), the
            # rule's value (trace), 1.0 for FedAvg rounds
            if self.policy.sync_rounds:
                weight = 1.0
            elif res is not None and \
                    getattr(res, "applied_weight", None) is not None:
                weight = float(res.applied_weight)
            else:
                weight = float(self.agg.weight(lag, gap, vn,
                                               fleet=self.fleet_spec,
                                               users=u._uid))
            log.append(t, u._uid, lag, gap, u.corun, weight)

    # ------------------------------------------------------------------ main
    def resolve_engine(self) -> str:
        """The engine this run takes (the JAX package's rule). The numpy
        engine covers hook-free trace runs (a ``v_norm`` hook alone is
        slot-constant and allowed) and real runs with a batched
        ``ml_backend``; ``auto`` picks it there when the policy implements
        ``decide_vectorized``, else the loop oracle, which runs
        everything. ``jax``, the device scan engine, runs hook-free trace
        runs whose policy has ``scan_step``, whose dynamics (if active)
        has ``scan_step`` and whose rule has ``scan_weight`` (when a push
        log is collected); otherwise it degrades to the numpy engine when
        the policy has that hook, else to the loop. A run with
        ``n_devices`` takes the scan engine and never degrades."""
        cfg = self.cfg
        pol = self.policy
        vec_ok = (cfg.ml_mode == "trace" and set(self.ml) <= {"v_norm"}) \
            or (cfg.ml_mode == "real" and self.ml_backend is not None)
        engine = cfg.engine
        if cfg.n_devices:
            # the padded user axis (checked at construction) runs only on
            # the scan engine and never degrades; per-slot host callbacks
            # are what is left that it cannot run
            if self.ml or self.ml_backend is not None:
                raise ValueError(
                    f"n_devices={cfg.n_devices} shards the jax chunked "
                    "scan, which cannot run per-user ML hooks or a "
                    "real-ML backend; set n_devices=0 for those runs")
            return "jax"
        if engine == "auto":
            return "vectorized" if (vec_ok and pol.supports_vectorized) \
                else "loop"
        if engine in ("vectorized", "jax") and not vec_ok:
            raise ValueError(
                f"engine={engine!r} supports trace-mode runs without "
                "per-user ML hooks, or ml_mode='real' with a batched "
                "ml_backend; use engine='loop' (or 'auto') for hook-based "
                "real-ML runs")
        if engine == "vectorized" and not pol.supports_vectorized:
            raise ValueError(
                f"policy {pol.name!r} implements no vectorized hook; "
                "use engine='loop' (or 'auto')")
        if engine == "jax":
            agg_ok = aggregation_support(self.agg)["jax"] or \
                not cfg.collect_push_log
            dyn_ok = dynamics_support(self.dynamics)["jax"]
            if pol.supports_jax and agg_ok and dyn_ok and \
                    not self.ml and self.ml_backend is None:
                return "jax"
            return "vectorized" if pol.supports_vectorized else "loop"
        return engine

    def run(self) -> SimResult:
        if getattr(self, "_ran", False):
            # a run consumes the mutable EngineState / UserState objects;
            # start repeated runs fresh (ML backends and hook closures are
            # single-run by contract and are not reset)
            self.state = self._fresh_state()
            self.users = [UserState(device=d)
                          for d in self.fleet_spec.devices]
            self.sched.Q = 0.0
            self.sched.H = 0.0
        self._ran = True
        engine = self.resolve_engine()
        if engine == "loop":
            return self._run_loop()
        from .vector_engine import run_vectorized
        return run_vectorized(self, backend=engine)

    def _run_loop(self) -> SimResult:
        cfg = self.cfg
        policy = self.policy
        es = self.state
        dynamics = self.dynamics
        dyn_active = dynamics.active
        up = net_extra = None
        for i, u in enumerate(self.users):
            u._uid = i
            u._params = None
        T = n_slots(cfg)
        trace_t, trace_E, trace_Q, trace_H = [], [], [], []
        push_log = PushLog()
        accuracy: List[tuple] = []
        carry = es.carry

        for t in range(T):
            arrivals = 0
            departures = 0

            # --- device dynamics (churn) ---------------------------------
            # first in the slot: the shared host transition decides who
            # went up or down; a waiting user that goes down departs the
            # queue, a trainer follows the dropout rule, a cooling user
            # parks, a recovered one re-enters through cooldown
            if dyn_active:
                mode_arr = np.array([_MODE_CODE[u.mode] for u in self.users],
                                    dtype=np.int8)
                corun_arr = np.array([u.corun for u in self.users],
                                     dtype=bool)
                es.dyn, es.rng_key, eff = dynamics.host_step(
                    es.dyn, es.rng_key, mode_arr, corun_arr, cfg.t_d)
                up = np.asarray(eff.up)
                net_extra = np.asarray(eff.net_extra)
                for i, u in enumerate(self.users):
                    if eff.went_down[i]:
                        if u.mode == "waiting":
                            u.mode = "off"
                            departures += 1
                        elif u.mode == "training":
                            if dynamics.dropout == "lose":
                                u.mode = "off"
                                u.train_remaining = 0.0
                                self.in_flight -= 1
                            else:       # resume: paused, extra seconds
                                u.train_remaining += float(
                                    eff.resume_penalty)
                        elif u.mode == "cooldown":
                            u.mode = "off"
                    elif eff.went_up[i] and u.mode == "off":
                        u.mode = "cooldown"
                        u.cooldown = cfg.ready_delay + int(net_extra[i])

            # --- app arrivals / progression ------------------------------
            for i, u in enumerate(self.users):
                if u.app is None and self.app_sched[t, i]:
                    u.app = APPS[self.app_choice[t, i]]
                    u.app_remaining = u.device.apps[u.app].t_corun
                elif u.app is not None:
                    u.app_remaining -= cfg.t_d
                    if u.app_remaining <= 0:
                        u.app, u.app_remaining = None, 0.0

            # --- cooldown -> waiting (queue arrival) ---------------------
            for u in self.users:
                if u.mode == "cooldown":
                    u.cooldown -= 1
                    if u.cooldown <= 0:
                        u.mode = "waiting"
                        u.plan = "hold"   # offline: wait for the next plan
                        arrivals += 1

            # --- policy decisions for waiting users ----------------------
            waiting = [u for u in self.users if u.mode == "waiting"]
            served, gap_sum = policy.decide_loop(self, t, waiting, carry)

            # --- training progression ------------------------------------
            # under churn a down trainer makes no progress, and a
            # finisher's cooldown carries the network state's extra delay
            for u in self.users:
                if u.mode == "training" and (not dyn_active or up[u._uid]):
                    u.train_remaining -= cfg.t_d
                    if u.train_remaining <= 0:
                        self._finish_training(
                            u, t, push_log,
                            extra_delay=int(net_extra[u._uid])
                            if dyn_active else 0)
                        if u.corun:
                            es.corun_updates += 1
            if policy.sync_rounds and self._round_open and \
                    all(u.mode != "training" for u in self.users):
                self._round_open = False
                self.version += 1
                if self.ml.get("sync_aggregate"):
                    self.ml["sync_aggregate"]()

            # --- energy accounting (Eq. 10); a down device draws nothing --
            for u in self.users:
                p = u.device.power(u.mode == "training", u.app is not None,
                                   u.app)
                if cfg.include_scheduler_overhead and u.mode == "waiting" \
                        and policy.uses_online_queue:
                    p += u.device.p_sched - u.device.p_idle
                if dyn_active and not up[u._uid]:
                    p = 0.0
                u.energy_j += p * cfg.t_d

            # --- queues --------------------------------------------------
            self.sched.update_queues(arrivals, served, gap_sum, departures)
            es.Q, es.H = self.sched.Q, self.sched.H
            es.sum_Q += es.Q
            es.sum_H += es.H

            if t % cfg.trace_every == 0:
                trace_t.append(t)
                trace_E.append(sum(u.energy_j for u in self.users))
                trace_Q.append(es.Q)
                trace_H.append(es.H)
            eval_every = self.ml.get("eval_every", 600)
            if self.ml.get("evaluate") and eval_every and \
                    t % eval_every == 0 and t > 0:
                accuracy.append((t, self.ml["evaluate"]()))

        if self.ml.get("evaluate"):
            accuracy.append((T, self.ml["evaluate"]()))
        updates = sum(u.updates for u in self.users)
        return SimResult(
            energy_j=sum(u.energy_j for u in self.users),
            updates=updates,
            trace_t=np.array(trace_t), trace_energy=np.array(trace_E),
            trace_Q=np.array(trace_Q), trace_H=np.array(trace_H),
            push_log=push_log, accuracy=accuracy,
            mean_Q=es.sum_Q / T if T else 0.0,
            mean_H=es.sum_H / T if T else 0.0,
            corun_fraction=es.corun_updates / max(updates, 1),
            drops=dynamics.total_drops(es.dyn))
