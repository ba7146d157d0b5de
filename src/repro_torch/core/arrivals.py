"""Pluggable app-arrival processes.

The paper's evaluation fixes one arrival model — i.i.d. Bernoulli per slot
at p = 0.001 (~1 app per 1000 s, Sec. VII.B). This module makes the
process a composable object: every ``ArrivalProcess`` pre-samples the full
``(T, n_users)`` arrival mask and app-choice schedule up front (the offline
policy needs oracle lookahead, and pre-sampling is what keeps all three
engines draw-for-draw identical), so any process drops into any engine.

Ships: ``bernoulli`` (paper-exact — the default consumes the rng stream in
the same order as the pre-registry simulator, keeping seeded runs
bit-for-bit reproducible), ``diurnal`` (sinusoidal time-of-day intensity),
``bursty`` (per-user two-state Markov-modulated on/off bursts), and
``trace`` (replay a recorded schedule).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np


class ArrivalProcess:
    """Base arrival process. ``sample`` returns the slot-indexed
    ``(sched, choice)`` pair the engines consume: ``sched[t, i]`` — does an
    app arrive for user i at slot t (ignored while one is running);
    ``choice[t, i]`` — which app (row of ``energy.APPS``) it would be."""

    name: str = ""

    def sample(self, rng: np.random.Generator, T: int, n_users: int,
               n_apps: int, t_d: float = 1.0
               ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


_REGISTRY: Dict[str, Type[ArrivalProcess]] = {}


def register_arrival(cls: Type[ArrivalProcess]) -> Type[ArrivalProcess]:
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a registry name")
    _REGISTRY[cls.name] = cls
    return cls


def registered_arrivals() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def resolve_arrival(arrivals) -> ArrivalProcess:
    """String -> default-constructed registered process; instance -> itself."""
    if isinstance(arrivals, ArrivalProcess):
        return arrivals
    if isinstance(arrivals, str):
        if arrivals not in _REGISTRY:
            raise ValueError(f"unknown arrival process {arrivals!r}; "
                             f"expected one of {registered_arrivals()} "
                             "or an ArrivalProcess instance")
        try:
            return _REGISTRY[arrivals]()
        except TypeError as e:
            raise ValueError(
                f"arrival process {arrivals!r} needs constructor arguments; "
                f"pass an instance instead ({e})") from None
    raise ValueError(f"arrivals must be a name or ArrivalProcess instance, "
                     f"got {type(arrivals).__name__}")


def resolve_arrival_or_default(arrivals, app_arrival_p) -> "ArrivalProcess":
    """The simulator-facing resolution rule, in ONE place: ``None`` or the
    name ``"bernoulli"`` mean the paper's process at the *configured*
    ``app_arrival_p`` — scalar or per-user ``(n_users,)`` rate vector
    (never bernoulli's stock 0.001); anything else resolves normally."""
    if arrivals is None or arrivals == "bernoulli":
        return BernoulliArrivals(app_arrival_p)
    return resolve_arrival(arrivals)


@register_arrival
class BernoulliArrivals(ArrivalProcess):
    """Paper-exact i.i.d. Bernoulli arrivals (Sec. VII.B, p = 0.001).

    ``p`` is a scalar rate or an ``(n_users,)`` vector giving every user
    its own rate (heterogeneous usage intensity — the AutoFL-style device
    heterogeneity axis). The same ``(T, n)`` uniform block feeds both
    forms, so a vector of identical entries is draw-for-draw the scalar
    process.

    Draw order is pinned: one ``(T, n)`` uniform block for the mask, then
    one ``(T, n)`` integer block for the choices — byte-identical to the
    pre-registry ``FederatedSim.__init__`` sampling, so existing seeded
    results reproduce exactly."""

    name = "bernoulli"

    def __init__(self, p=0.001):
        arr = np.asarray(p, dtype=float)
        if arr.ndim > 1:
            raise ValueError(
                f"arrival probability must be a scalar or an (n_users,) "
                f"vector, got shape {arr.shape}")
        if arr.size and not np.all((arr >= 0.0) & (arr <= 1.0)):
            # the conjunctive form also rejects NaN entries
            raise ValueError(f"arrival probability must be in [0, 1], got {p}")
        self.p = float(arr) if arr.ndim == 0 else arr

    def sample(self, rng, T, n_users, n_apps, t_d=1.0):
        p = self.p
        if np.ndim(p) == 1 and len(p) != n_users:
            raise ValueError(
                f"per-user arrival rates cover {len(p)} users, run has "
                f"{n_users}")
        # scalar p compares elementwise exactly as the historical code
        # did; a (n,) vector broadcasts across the same uniform block
        sched = rng.random((T, n_users)) < p
        choice = rng.integers(0, n_apps, (T, n_users))
        return sched, choice


@register_arrival
class DiurnalArrivals(ArrivalProcess):
    """Sinusoidal time-of-day intensity: p(t) = p_mean * (1 + depth *
    sin(2*pi*(t / period + phase))). Mobile app usage peaks in the evening
    and bottoms out overnight; ``period_s`` defaults to 24 h. ``phase`` in
    [0, 1) shifts where in the cycle the horizon starts."""

    name = "diurnal"

    def __init__(self, p_mean: float = 0.001, depth: float = 0.8,
                 period_s: float = 86400.0, phase: float = 0.0):
        if not 0.0 <= depth <= 1.0:
            raise ValueError(f"depth must be in [0, 1], got {depth}")
        if period_s <= 0:
            raise ValueError(f"period_s must be positive, got {period_s}")
        if not 0.0 <= p_mean <= 1.0:
            raise ValueError(f"p_mean must be in [0, 1], got {p_mean}")
        self.p_mean = float(p_mean)
        self.depth = float(depth)
        self.period_s = float(period_s)
        self.phase = float(phase)

    def rate(self, T: int, t_d: float = 1.0) -> np.ndarray:
        """The per-slot arrival probability profile (exposed for tests)."""
        t = np.arange(T) * t_d
        p = self.p_mean * (1.0 + self.depth *
                           np.sin(2.0 * np.pi * (t / self.period_s
                                                 + self.phase)))
        return np.clip(p, 0.0, 1.0)

    def sample(self, rng, T, n_users, n_apps, t_d=1.0):
        p_t = self.rate(T, t_d)[:, None]
        sched = rng.random((T, n_users)) < p_t
        choice = rng.integers(0, n_apps, (T, n_users))
        return sched, choice


@register_arrival
class MarkovModulatedArrivals(ArrivalProcess):
    """Per-user two-state Markov-modulated Bernoulli (bursty sessions).

    Each user independently alternates calm/burst phases: in a calm slot an
    app arrives w.p. ``p_calm`` and the user enters a burst w.p.
    ``burst_start``; bursts arrive at ``p_burst`` and end w.p.
    ``burst_stop`` per slot (mean burst length 1/burst_stop slots). Models
    the clumped app-usage sessions that i.i.d. Bernoulli cannot."""

    name = "bursty"

    def __init__(self, p_calm: float = 2e-4, p_burst: float = 5e-2,
                 burst_start: float = 1e-3, burst_stop: float = 1e-2):
        for nm, v in (("p_calm", p_calm), ("p_burst", p_burst),
                      ("burst_start", burst_start),
                      ("burst_stop", burst_stop)):
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{nm} must be in [0, 1], got {v}")
        self.p_calm = float(p_calm)
        self.p_burst = float(p_burst)
        self.burst_start = float(burst_start)
        self.burst_stop = float(burst_stop)

    def sample(self, rng, T, n_users, n_apps, t_d=1.0):
        arr_u = rng.random((T, n_users))
        flip_u = rng.random((T, n_users))
        burst = np.zeros(n_users, dtype=bool)
        sched = np.zeros((T, n_users), dtype=bool)
        for t in range(T):
            # state transition first, then the arrival draw in that state
            burst = np.where(burst, flip_u[t] >= self.burst_stop,
                             flip_u[t] < self.burst_start)
            sched[t] = arr_u[t] < np.where(burst, self.p_burst, self.p_calm)
        choice = rng.integers(0, n_apps, (T, n_users))
        return sched, choice


@register_arrival
class TraceArrivals(ArrivalProcess):
    """Replay a recorded ``(T', n_users)`` schedule.

    Shorter traces wrap around the horizon; the user axis must match the
    fleet exactly (silently recycling users would misattribute per-device
    behaviour). ``choice=None`` draws app choices from the run's rng."""

    name = "trace"

    def __init__(self, sched, choice=None):
        self.sched = np.asarray(sched).astype(bool)
        if self.sched.ndim != 2:
            raise ValueError(
                f"trace schedule must be (T, n_users), got shape "
                f"{self.sched.shape}")
        self.choice = None if choice is None \
            else np.asarray(choice, dtype=np.int64)
        if self.choice is not None and self.choice.shape != self.sched.shape:
            raise ValueError(
                f"choice shape {self.choice.shape} != schedule shape "
                f"{self.sched.shape}")

    @classmethod
    def from_sim(cls, sim) -> "TraceArrivals":
        """Snapshot a constructed FederatedSim's sampled schedule."""
        return cls(sim.app_sched.copy(), sim.app_choice.copy())

    def sample(self, rng, T, n_users, n_apps, t_d=1.0):
        Tr, nr = self.sched.shape
        if nr != n_users:
            raise ValueError(f"trace covers {nr} users, run has {n_users}")
        reps = -(-T // Tr) if Tr else 0          # ceil
        if Tr == 0 or reps == 0:
            raise ValueError("trace schedule has zero slots")
        sched = np.tile(self.sched, (reps, 1))[:T]
        if self.choice is not None:
            choice = np.tile(self.choice, (reps, 1))[:T]
            if np.any(choice >= n_apps) or np.any(choice < 0):
                raise ValueError(
                    f"trace app choices must be in [0, {n_apps})")
        else:
            choice = rng.integers(0, n_apps, (T, n_users))
        return sched, choice
