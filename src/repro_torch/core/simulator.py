"""Slotted-time federated simulator (Sec. VII.B methodology).

The counterpart of ``repro/core/simulator.py``: n users each owning a
testbed device (Table II catalog), app arrivals per slot, a scheduling
policy, per-slot energy accounting per Eq. (10) and queue dynamics per
Eqs. (15-16). Policies, arrival processes and device fleets come from
registries (core/policies.py, core/arrivals.py, core/fleet.py).

ml_mode="trace" tracks updates and staleness without real gradients;
ml_mode="real" couples the schedule to actual PyTorch training of the
paper's LeNet-5 through a batched ``ml_backend`` (core/realml.py).

Engines (``SimConfig.engine``): the port runs the struct-of-arrays numpy
engine (core/vector_engine.py), which is what ``"auto"`` resolves to for
both modes in the JAX package too. The per-user loop oracle (``"loop"``,
ROADMAP Queue 1 item 3) and the accelerator scan (``"jax"``, item 6) are
still to port and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Union

import numpy as np

from ..kernels.fused_update import KERNEL_MODES
from .aggregation import AggregationRule, resolve_aggregation
from .arrivals import ArrivalProcess, resolve_arrival_or_default
from .dynamics import DeviceDynamics, resolve_dynamics
from .energy import APPS
from .engine_state import EngineState
from .fleet import Fleet, resolve_fleet
from .lyapunov import OnlineScheduler
from .policies import Policy, resolve_policy

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
    engine: str = "auto"            # auto | vectorized (loop/jax: to port)
    collect_push_log: bool = True
    # device dynamics (core/dynamics.py); "none" is the paper's always-on
    # fleet and the only one ported so far
    dynamics: Union[str, DeviceDynamics] = "none"

    def __post_init__(self):
        pol = resolve_policy(self.policy)   # raises ValueError on unknowns
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"expected one of {ENGINES}")
        if self.ml_mode not in ("trace", "real"):
            raise ValueError(f"unknown ml_mode {self.ml_mode!r}")
        if self.kernel not in KERNEL_MODES:
            raise ValueError(f"unknown kernel {self.kernel!r}; "
                             f"expected one of {KERNEL_MODES}")
        resolve_aggregation(self.aggregation)    # raises on unknowns
        if resolve_dynamics(self.dynamics).active:
            raise NotImplementedError(
                "active device dynamics are still to port (ROADMAP Queue 1 "
                "item 4); use dynamics='none'")
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


def n_slots(cfg: SimConfig) -> int:
    """Slots in the horizon. round() before int: 48 s / 1.6 s is
    29.999999999999996 in floats and plain int() would drop a slot."""
    return int(round(cfg.horizon_s / cfg.t_d))


def trace_v_norm(v_norm0: float, version) -> float:
    """Trace-mode momentum-norm model: ||v|| decays with global progress
    (version may be an array of per-finisher versions)."""
    return v_norm0 / np.sqrt(1.0 + 0.05 * version)


class FederatedSim:
    def __init__(self, cfg: SimConfig, *, ml_backend=None,
                 arrivals: Union[str, ArrivalProcess, None] = None,
                 fleet: Union[str, Fleet, None] = None):
        """``ml_backend`` (real mode): a ``core.realml.BatchedMLBackend``
        that the engine drives cohort-at-a-time.

        ``arrivals``/``fleet`` plug in non-paper arrival processes and
        device fleets; the defaults — Bernoulli(cfg.app_arrival_p) on the
        Table II round-robin fleet — consume the seeded rng stream in the
        JAX package's order (fleet shuffle, then the arrival blocks), so
        seeded schedules equal its schedules bit for bit.

        ``self.state`` is the run's ``EngineState``."""
        self.cfg = cfg
        self.policy = resolve_policy(cfg.policy)
        self.agg = resolve_aggregation(cfg.aggregation)
        self.dynamics = resolve_dynamics(cfg.dynamics)
        self.rng = np.random.default_rng(cfg.seed)
        self.ml_backend = ml_backend
        if ml_backend is not None:
            if cfg.ml_mode != "real":
                raise ValueError(
                    "ml_backend requires ml_mode='real' (a backend couples "
                    "the schedule to actual training)")
            if ml_backend.n_users != cfg.n_users:
                raise ValueError(
                    f"ml_backend was built for {ml_backend.n_users} users; "
                    f"config has n_users={cfg.n_users}")
        self.fleet = resolve_fleet(fleet if fleet is not None else "paper")
        self.fleet_spec = self.fleet.build(self.rng, cfg.n_users)
        self.sched = OnlineScheduler(cfg.V, cfg.L_b, cfg.eta, cfg.beta,
                                     cfg.epsilon, cfg.t_d)
        self.state = EngineState.init(cfg.n_users, cfg, self.policy,
                                      agg=self.agg, fleet=self.fleet_spec)
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

    def resolve_engine(self) -> str:
        """``auto``/``vectorized`` run the numpy engine; the loop oracle
        and the jax scan engine are not ported yet."""
        cfg = self.cfg
        if cfg.engine == "loop":
            raise NotImplementedError(
                "engine='loop' (the per-user loop oracle) is still to port "
                "(ROADMAP Queue 1 item 3); use engine='auto'")
        if cfg.engine == "jax":
            raise NotImplementedError(
                "engine='jax' has no port yet; its GPU counterpart is the "
                "scan engine of ROADMAP Queue 1 item 6; use engine='auto'")
        if cfg.ml_mode == "real" and self.ml_backend is None:
            raise ValueError(
                "ml_mode='real' needs a batched ml_backend (Scenario(ml=...) "
                "builds one); per-user hooks need the loop engine, which "
                "is still to port (ROADMAP Queue 1 item 3)")
        return "vectorized"

    def run(self):
        if getattr(self, "_ran", False):
            # a run consumes the mutable EngineState; start repeated runs
            # fresh (ML backends are single-run by contract)
            self.state = EngineState.init(self.cfg.n_users, self.cfg,
                                          self.policy, agg=self.agg,
                                          fleet=self.fleet_spec)
            self.sched.Q = 0.0
            self.sched.H = 0.0
        self._ran = True
        self.resolve_engine()
        from .vector_engine import run_vectorized
        return run_vectorized(self)
