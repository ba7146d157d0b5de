"""Pluggable device fleets.

The paper's evaluation assigns every user a device from the frozen four-row
Table II testbed, round-robin then shuffled. This module turns fleet
composition into a composable object: a ``Fleet`` builds the per-user
device assignment AND the struct-of-arrays ``DeviceTables`` the batched
engines gather from — so fleets are no longer limited to the Table II
catalog.

Ships: ``paper`` (Table II round-robin, draw-for-draw identical to the
pre-registry simulator), ``synthetic`` (a scaled catalog of jittered
Table II variants for fleet-heterogeneity studies at any catalog size),
and ``custom`` (bring-your-own ``DeviceProfile`` catalog).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple, Type

import numpy as np

from .energy import (APPS, DEVICE_NAMES, TESTBED, AppProfile, DeviceProfile,
                     DeviceTables, build_tables, catalog_tables, device_ids)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """A built fleet: what FederatedSim and the batched engines consume.

    ``devices[i]`` is user i's profile (the loop oracle reads it);
    ``tables`` is this fleet's catalog flattened for the vectorized
    engines, and ``device_ids[i]`` the row of ``tables`` user i gathers.
    """
    devices: Tuple[DeviceProfile, ...]
    tables: DeviceTables
    device_ids: np.ndarray


class Fleet:
    name: str = ""

    def build(self, rng: np.random.Generator, n_users: int) -> FleetSpec:
        """Assign a device to each of ``n_users`` users. Draws (if any)
        must come from ``rng`` so runs stay seed-reproducible."""
        raise NotImplementedError


_REGISTRY: Dict[str, Type[Fleet]] = {}


def register_fleet(cls: Type[Fleet]) -> Type[Fleet]:
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a registry name")
    _REGISTRY[cls.name] = cls
    return cls


def registered_fleets() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def resolve_fleet(fleet) -> Fleet:
    """String -> default-constructed registered fleet; instance -> itself."""
    if isinstance(fleet, Fleet):
        return fleet
    if isinstance(fleet, str):
        if fleet not in _REGISTRY:
            raise ValueError(f"unknown fleet {fleet!r}; expected one of "
                             f"{registered_fleets()} or a Fleet instance")
        try:
            return _REGISTRY[fleet]()
        except TypeError as e:
            raise ValueError(f"fleet {fleet!r} needs constructor arguments; "
                             f"pass an instance instead ({e})") from None
    raise ValueError(f"fleet must be a name or Fleet instance, "
                     f"got {type(fleet).__name__}")


def _validate_catalog(devices: Sequence[DeviceProfile]):
    if not devices:
        raise ValueError("fleet catalog is empty")
    for d in devices:
        missing = [a for a in APPS if a not in d.apps]
        if missing:
            raise ValueError(
                f"device {d.name!r} lacks profiles for apps {missing}; "
                "every device must profile the full energy.APPS list")


@register_fleet
class PaperFleet(Fleet):
    """Table II testbed, round-robin across users then shuffled.

    Reproduces the pre-registry ``FederatedSim.__init__`` assignment
    draw-for-draw: the single ``rng.shuffle`` here is the first rng use of
    a run, exactly as before."""

    name = "paper"

    def build(self, rng, n_users):
        names = [DEVICE_NAMES[i % len(DEVICE_NAMES)]
                 for i in range(n_users)]
        rng.shuffle(names)
        return FleetSpec(devices=tuple(TESTBED[n] for n in names),
                         tables=catalog_tables(),
                         device_ids=device_ids(names))


@register_fleet
class CustomCatalogFleet(Fleet):
    """Bring-your-own catalog of ``DeviceProfile``s.

    ``assignment``: "round_robin" (deterministic, catalog order) or
    "random" (uniform per user, drawn from the run rng)."""

    name = "custom"

    def __init__(self, catalog: Sequence[DeviceProfile],
                 assignment: str = "round_robin"):
        devices = list(catalog.values()) \
            if isinstance(catalog, dict) else list(catalog)
        _validate_catalog(devices)
        if assignment not in ("round_robin", "random"):
            raise ValueError(f"unknown assignment {assignment!r}; expected "
                             "'round_robin' or 'random'")
        self.catalog = devices
        self.assignment = assignment
        self._tables = build_tables(devices)

    def build(self, rng, n_users):
        k = len(self.catalog)
        if self.assignment == "round_robin":
            ids = np.arange(n_users, dtype=np.int64) % k
        else:
            ids = rng.integers(0, k, n_users)
        return FleetSpec(devices=tuple(self.catalog[i] for i in ids),
                         tables=self._tables,
                         device_ids=ids)


@register_fleet
class SyntheticFleet(Fleet):
    """Scaled synthetic catalog: ``n_types`` device classes derived from
    Table II rows by jittering power draw and speed.

    Each synthetic class starts from a Table II device (round-robin) and
    applies an independent power factor and speed factor drawn uniformly
    from [1 - spread, 1 + spread]. Scaling all four power states by one
    factor preserves the paper's P^{a'} > P^a > P^b ordering per device and
    keeps co-run savings positive; the speed factor stretches both
    standalone and co-run durations. Users are assigned classes uniformly
    at random. The catalog itself is sampled from the run rng, so a fleet
    instance is reusable and every run stays seed-deterministic."""

    name = "synthetic"

    def __init__(self, n_types: int = 16, spread: float = 0.3):
        if n_types <= 0:
            raise ValueError(f"n_types must be positive, got {n_types}")
        if not 0.0 <= spread < 1.0:
            raise ValueError(f"spread must be in [0, 1), got {spread}")
        self.n_types = int(n_types)
        self.spread = float(spread)

    def _make_catalog(self, rng) -> List[DeviceProfile]:
        catalog = []
        for k in range(self.n_types):
            base = TESTBED[DEVICE_NAMES[k % len(DEVICE_NAMES)]]
            pf = 1.0 + self.spread * rng.uniform(-1.0, 1.0)
            sf = 1.0 + self.spread * rng.uniform(-1.0, 1.0)
            apps = {a: AppProfile(p_app=ap.p_app * pf,
                                  p_corun=ap.p_corun * pf,
                                  t_corun=ap.t_corun * sf)
                    for a, ap in base.apps.items()}
            catalog.append(DeviceProfile(
                name=f"{base.name}-synth{k}",
                p_train=base.p_train * pf,
                t_train=base.t_train * sf,
                p_idle=base.p_idle * pf,
                p_sched=base.p_sched * pf,
                apps=apps))
        return catalog

    def build(self, rng, n_users):
        catalog = self._make_catalog(rng)
        ids = rng.integers(0, self.n_types, n_users)
        return FleetSpec(devices=tuple(catalog[i] for i in ids),
                         tables=build_tables(catalog),
                         device_ids=ids)
