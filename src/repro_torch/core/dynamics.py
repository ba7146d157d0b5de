"""Device dynamics: availability, battery and network churn.

The counterpart of ``repro/core/dynamics.py``: a registry of
``DeviceDynamics`` objects whose per-user state rides in
``EngineState.dyn`` and whose per-slot transition runs at the TOP of every
slot, on the loop oracle and the numpy engine alike:

``init_state(n, cfg, fleet=None)``
    One dict of per-user ``(n,)`` arrays (availability chain, battery,
    network state, drop counters and the per-user gathers of
    per-device-class knobs). ``None`` for the inactive ``none``.
``host_step(dyn, rng_key, mode, corun, t_d)``
    The host (numpy) transition, shared verbatim by both engines. Its
    uniforms come from the run's ``EngineState.rng_key`` through the
    threefry twin (``core/prng.py``), drawn UNCONDITIONALLY once a slot,
    so the key chain — and every draw after it — equals the JAX
    package's. Returns ``(new_dyn, new_rng_key, DynEffects)``.

The engines apply the effects (the dynamics only decides who went up or
down): a WAITING user that goes down leaves the request queue (a
departure in Eq. 15); a TRAINING user follows the ``dropout`` rule —
``"lose"`` discards the in-flight work, ``"resume"`` pauses it and adds
``resume_penalty`` seconds; a COOLING user parks in OFF; an OFF user that
comes back up re-enters through cooldown with ``ready_delay + net_extra``
slots. Down users draw no power and a paused trainer makes no progress.

``scan_step(dyn, dv)``
    The same transition on tensors, for the device scan engine
    (core/vector_engine.py): ``dyn`` holds ``(B, n)`` tensors with a
    leading config axis, ``dv`` is the slot view (``rng_key`` (B, 2),
    ``mode``, ``corun``, ``t_d``, ``consts`` from ``scan_operands`` as
    ``(B, 1)`` tensors, the live ``n``). It draws the same bits on the
    device (``prng.split_t``/``uniform_t``), writes the split key back to
    ``dv.rng_key`` and returns ``(new_dyn, DynEffects)``.

``none`` (the default, the paper's always-on fleet) is INACTIVE: no
state, no draws, no effect.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Type

import numpy as np
import torch

from . import prng
from .engine_state import MODE_TRAIN

__all__ = ["DeviceDynamics", "DynEffects", "NoDynamics",
           "MarkovChurnDynamics", "DROPOUT_RULES", "register_dynamics",
           "registered_dynamics", "resolve_dynamics", "dynamics_support"]

DROPOUT_RULES = ("lose", "resume")


@dataclasses.dataclass
class DynEffects:
    """One slot's transition outcome. ``up`` is the post-transition
    effective availability (chain on AND battery above threshold);
    ``went_down``/``went_up`` the edge masks; ``net_extra`` the per-user
    extra re-arrival delay (slots) of the current network state;
    ``resume_penalty`` the extra training seconds a dropped-and-resumed
    user pays (scalar)."""

    up: Any
    went_down: Any
    went_up: Any
    net_extra: Any
    resume_penalty: Any


class DeviceDynamics:
    """Base device-dynamics model. ``active`` False means the engines skip
    the dynamics phase (no state, no draws); only ``NoDynamics`` clears
    it. ``dropout`` is the mid-training rule, one of ``DROPOUT_RULES``,
    applied by the engines and so part of ``jax_cache_key``.
    ``supports_jax``: ``scan_step`` exists (``SimConfig`` checks the flag
    against the hook; active dynamics without it degrade the scan engine
    to the numpy engine). ``supports_vmap``: ``scan_step`` may run on a
    batched sweep's ``(B, n)`` tensors. ``supports_shard``: ``scan_step``
    may run on a user axis padded past the live ``n``
    (``SimConfig.n_devices``): it draws at ``dv.n`` and pads with
    ``dv.pad_users(x, fill)``, a fill that keeps the ``pad_state`` rows
    inert."""

    name: str = ""
    active: bool = True
    supports_jax: bool = True
    supports_vmap: bool = True
    supports_shard: bool = True
    dropout: str = "lose"

    def init_state(self, n: int, cfg=None, fleet=None):
        """Per-run per-user state (``EngineState.dyn``); ``None`` for
        inactive dynamics."""
        return None

    def scan_operands(self, cfg) -> tuple:
        """Scalar knobs ``scan_step`` reads (``dv.consts``)."""
        return ()

    def pad_state(self, k: int):
        """``(k,)``-leading inert rows matching ``init_state``'s dict,
        for a user axis padded past the live ``n`` (``SimConfig.n_devices``
        with ``n`` not a multiple of the device count): the rows must keep
        their users up under the engine's fill-1.0 padded draws, so a pad
        user parked in MODE_OFF stays there. ``None``: no recipe, and a
        padded run fails with instructions."""
        return None

    def jax_cache_key(self):
        """Hashable token of ``scan_step`` and the effect semantics (the
        dropout rule is always in it): ``(class, dropout)`` when the
        instance routes its knobs through ``scan_operands`` or has none,
        else the instance."""
        if not vars(self) or \
                type(self).scan_operands is not DeviceDynamics.scan_operands:
            return (type(self), self.dropout)
        return self

    def host_step(self, dyn, rng_key, mode, corun, t_d
                  ) -> Tuple[Any, Any, DynEffects]:
        """One slot's transition on host numpy. Must consume the rng
        unconditionally (or not at all) so the key chain is the same on
        every engine."""
        raise NotImplementedError(
            f"dynamics {self.name!r} implements no host_step()")

    def scan_step(self, dyn, dv):
        """The transition on the scan engine's tensors; reads and writes
        ``dv.rng_key``, returns ``(dyn, DynEffects)``. Only called when
        ``supports_jax``."""
        raise TypeError(
            f"dynamics {self.name!r} sets supports_jax but inherits the "
            "base scan_step; implement the hook or clear the flag to "
            "degrade to the numpy engine")

    def total_drops(self, dyn) -> int:
        """Mid-training drops recorded in ``dyn`` (0 when untracked)."""
        return 0


_REGISTRY: Dict[str, Type[DeviceDynamics]] = {}
_INSTANCES: Dict[str, DeviceDynamics] = {}      # singletons for strings


def register_dynamics(cls: Type[DeviceDynamics]) -> Type[DeviceDynamics]:
    """Class decorator: make ``cls`` resolvable as ``cls.name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a registry name")
    _REGISTRY[cls.name] = cls
    _INSTANCES.pop(cls.name, None)              # re-registration wins
    return cls


def registered_dynamics() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def resolve_dynamics(dyn) -> DeviceDynamics:
    """String -> registered singleton; DeviceDynamics instance -> itself."""
    if isinstance(dyn, DeviceDynamics):
        return dyn
    if isinstance(dyn, str):
        if dyn not in _REGISTRY:
            raise ValueError(
                f"unknown dynamics {dyn!r}; expected one of "
                f"{registered_dynamics()} or a DeviceDynamics instance")
        if dyn not in _INSTANCES:
            _INSTANCES[dyn] = _REGISTRY[dyn]()
        return _INSTANCES[dyn]
    raise ValueError(f"dynamics must be a name or DeviceDynamics instance, "
                     f"got {type(dyn).__name__}")


def dynamics_support(dyn: DeviceDynamics) -> Dict[str, bool]:
    """Which paths ``dyn`` genuinely implements (the flag set AND the
    base stub overridden): ``host`` and the scan engine's ``jax``.
    Inactive dynamics support both (there is nothing to run)."""
    cls = type(dyn)
    if not dyn.active:
        return {"host": True, "jax": True}
    return {
        "host": cls.host_step is not DeviceDynamics.host_step,
        "jax": (dyn.supports_jax and
                cls.scan_step is not DeviceDynamics.scan_step),
    }


@register_dynamics
class NoDynamics(DeviceDynamics):
    """The paper's always-on fleet (the default). Inactive: the engines
    skip the dynamics phase entirely."""

    name = "none"
    active = False


def _dyn_draw(rng_key, n):
    """One slot's dynamics uniforms: split the run key, draw ``(2, n)``
    f32 — row 0 drives the availability chain, row 1 the network chain.
    The JAX package's ``_dyn_draw`` bit for bit (``core/prng.py``)."""
    k2, sub = prng.split(rng_key)
    return k2, prng.uniform(sub, (2, n))


def _per_user(value, n, fleet, what) -> np.ndarray:
    """Broadcast a scalar to ``(n,)`` or gather a per-device-class vector
    (one entry per catalog row of the run's ``FleetSpec``) per user."""
    v = np.asarray(value, dtype=np.float64)
    if v.ndim == 0:
        return np.full(n, float(v))
    if fleet is None:
        raise ValueError(
            f"per-device-class {what} needs the run's FleetSpec to "
            "gather per-user values; engines pass it automatically")
    n_classes = len(fleet.tables.t_train)
    if v.shape != (n_classes,):
        raise ValueError(
            f"{what} must be a scalar or a ({n_classes},) per-device-"
            f"class vector for this fleet, got shape {v.shape}")
    return v[fleet.device_ids]


@register_dynamics
class MarkovChurnDynamics(DeviceDynamics):
    """Markov availability + battery trajectories + 2-state network churn.

    - **Availability**: a 2-state Markov chain; ``p_off``/``p_on`` are
      per-slot transition probabilities — scalars, or per-device-class
      vectors gathered per user at init.
    - **Battery**: drains while actually training (``drain_train``
      capacity-fractions/s, ``drain_corun`` while co-running) and charges
      otherwise (``charge_rate``), clipped to ``[0, capacity]``; a user
      takes part only while ``battery > battery_min``.
    - **Network**: a good/bad chain (``p_net_bad`` / ``p_net_recover``);
      in the bad state a re-arrival costs ``net_delay_slots`` extra
      cooldown slots.

    ``dropout`` picks the mid-training rule (``"lose"`` or ``"resume"``,
    the latter with ``resume_penalty_s`` extra seconds); ``drops`` counts
    mid-training down-edges either way.
    """

    name = "markov"

    def __init__(self, p_off=0.002, p_on=0.05, *,
                 battery_capacity: float = 1.0,
                 battery_init: float = 1.0,
                 drain_train: float = 2e-4, drain_corun: float = 3e-4,
                 charge_rate: float = 1e-4, battery_min: float = 0.0,
                 p_net_bad: float = 0.0, p_net_recover: float = 0.1,
                 net_delay_slots: int = 20,
                 dropout: str = "lose", resume_penalty_s: float = 0.0):
        for what, v in (("p_net_bad", p_net_bad),
                        ("p_net_recover", p_net_recover)):
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"{what} must be in [0, 1], got {v}")
        for what, v in (("p_off", p_off), ("p_on", p_on)):
            a = np.asarray(v, dtype=float)
            if a.size == 0 or not np.all((a >= 0.0) & (a <= 1.0)):
                raise ValueError(f"{what} must be in [0, 1], got {v}")
        if battery_capacity <= 0.0:
            raise ValueError(
                f"battery_capacity must be positive, got {battery_capacity}")
        if not 0.0 <= battery_init <= 1.0:
            raise ValueError(
                f"battery_init is a capacity fraction in [0, 1], "
                f"got {battery_init}")
        if not 0.0 <= battery_min < battery_capacity:
            raise ValueError(
                f"battery_min must be in [0, capacity), got {battery_min}")
        if min(drain_train, drain_corun, charge_rate) < 0.0:
            raise ValueError("drain/charge rates must be non-negative")
        if net_delay_slots < 0:
            raise ValueError(
                f"net_delay_slots must be >= 0, got {net_delay_slots}")
        if dropout not in DROPOUT_RULES:
            raise ValueError(f"unknown dropout rule {dropout!r}; expected "
                             f"one of {DROPOUT_RULES}")
        if resume_penalty_s < 0.0:
            raise ValueError(
                f"resume_penalty_s must be >= 0, got {resume_penalty_s}")
        self.p_off = p_off
        self.p_on = p_on
        self.capacity = float(battery_capacity)
        self.battery_init = float(battery_init)
        self.drain_train = float(drain_train)
        self.drain_corun = float(drain_corun)
        self.charge_rate = float(charge_rate)
        self.battery_min = float(battery_min)
        self.p_net_bad = float(p_net_bad)
        self.p_net_recover = float(p_net_recover)
        self.net_delay_slots = int(net_delay_slots)
        self.dropout = dropout
        self.resume_penalty_s = float(resume_penalty_s)

    def init_state(self, n, cfg=None, fleet=None):
        return {
            "on": np.ones(n, dtype=bool),
            "up": np.ones(n, dtype=bool),
            "battery": np.full(n, self.battery_init * self.capacity),
            "net_bad": np.zeros(n, dtype=bool),
            "drops": np.zeros(n, dtype=np.int64),
            "p_off": _per_user(self.p_off, n, fleet, "p_off"),
            "p_on": _per_user(self.p_on, n, fleet, "p_on"),
        }

    def scan_operands(self, cfg):
        return (self.capacity, self.drain_train, self.drain_corun,
                self.charge_rate, self.battery_min, self.p_net_bad,
                self.p_net_recover, self.net_delay_slots,
                self.resume_penalty_s)

    def pad_state(self, k):
        # always-up rows: full battery, p_off = 0 (a fill-1.0 draw keeps
        # the chain on), a network that never turns bad
        return {
            "on": np.ones(k, dtype=bool),
            "up": np.ones(k, dtype=bool),
            "battery": np.full(k, self.capacity),
            "net_bad": np.zeros(k, dtype=bool),
            "drops": np.zeros(k, dtype=np.int64),
            "p_off": np.zeros(k),
            "p_on": np.zeros(k),
        }

    def total_drops(self, dyn) -> int:
        return 0 if dyn is None else int(np.asarray(
            dyn["drops"].cpu() if torch.is_tensor(dyn["drops"])
            else dyn["drops"]).sum())

    def host_step(self, dyn, rng_key, mode, corun, t_d):
        rng_key, u = _dyn_draw(rng_key, len(dyn["battery"]))
        dyn, eff = self._transition(
            np, dyn, u[0], u[1], mode, corun, t_d,
            self.capacity, self.drain_train, self.drain_corun,
            self.charge_rate, self.battery_min, self.p_net_bad,
            self.p_net_recover, self.net_delay_slots,
            self.resume_penalty_s)
        return dyn, rng_key, eff

    def scan_step(self, dyn, dv):
        # one split and a (2, n) draw a slot, unconditionally, at the live
        # n: the host engines' key chain and bits (core/prng.py); padded
        # with 1.0, which keeps the pad rows' chains on and never bad
        keys = prng.split_t(dv.rng_key)
        dv.rng_key = keys[..., 0, :]
        u = prng.uniform_t(keys[..., 1, :], 2 * dv.n)
        u_avail = dv.pad_users(u[..., :dv.n], 1.0)
        u_net = dv.pad_users(u[..., dv.n:], 1.0)
        (capacity, drain_train, drain_corun, charge_rate, battery_min,
         p_net_bad, p_net_recover, net_delay_slots,
         resume_penalty_s) = dv.consts
        return self._transition(
            torch, dyn, u_avail, u_net, dv.mode, dv.corun,
            dv.t_d, capacity, drain_train, drain_corun, charge_rate,
            battery_min, p_net_bad, p_net_recover, net_delay_slots,
            resume_penalty_s, zero=dv.fp_zero)

    @staticmethod
    def _transition(xp, dyn, u_avail, u_net, mode, corun, t_d,
                    capacity, drain_train, drain_corun, charge_rate,
                    battery_min, p_net_bad, p_net_recover,
                    net_delay_slots, resume_penalty_s, zero=0.0):
        """One slot, elementwise, numpy or torch (``xp``), in the JAX
        package's operation order (bitwise parity in f64). ``zero`` is
        the reference's traced-zero slot (``+ zero`` after the
        ``delta * t_d`` product, which an fma would otherwise leave
        unrounded); it adds 0.0 on both of the port's paths, as eager
        torch contracts nothing."""
        up_prev = dyn["up"]
        training = mode == MODE_TRAIN
        # drain while ACTUALLY training (a paused trainer is off), charge
        # otherwise
        active_train = training & up_prev
        drain = xp.where(corun & active_train, drain_corun, drain_train)
        # the lower bound 0.0 in capacity's type: torch's clip takes two
        # numbers or two tensors (the scan's knobs are (B, 1) tensors)
        battery = xp.clip(
            dyn["battery"]
            + (xp.where(active_train, -drain, charge_rate) * t_d + zero),
            0.0 * capacity, capacity)
        on = xp.where(dyn["on"], u_avail >= dyn["p_off"],
                      u_avail < dyn["p_on"])
        net_bad = xp.where(dyn["net_bad"], u_net >= p_net_recover,
                           u_net < p_net_bad)
        up = on & (battery > battery_min)
        went_down = up_prev & ~up
        went_up = ~up_prev & up
        drops = dyn["drops"] + (went_down & training)
        net_extra = xp.where(net_bad, net_delay_slots, 0)
        dyn2 = {"on": on, "up": up, "battery": battery, "net_bad": net_bad,
                "drops": drops, "p_off": dyn["p_off"], "p_on": dyn["p_on"]}
        return dyn2, DynEffects(up=up, went_down=went_down,
                                went_up=went_up, net_extra=net_extra,
                                resume_penalty=resume_penalty_s)
