"""Device energy model — Table II / Table III of the paper, verbatim.

Power states per device i (Eq. 10):  P^{a'} (co-run) > P^a (app only)
> P^b (training only, background) > P^d (idle).

Energy-saving of co-running (Sec. IV):   s_i = P^b + P^a - P^{a'}
Percentage saving (Sec. VII.A):          1 - P^{a'} t_a / (P^b t_b + P^a t_a)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence, Tuple

import numpy as np

APPS = ["Map", "News", "Etrade", "Youtube", "Tiktok", "Zoom", "CandyCru", "Angrybird"]


@dataclasses.dataclass(frozen=True)
class AppProfile:
    p_app: float      # P^a  (W) app running alone
    p_corun: float    # P^{a'} (W) training co-running with the app
    t_corun: float    # (s) training execution time while co-running


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    p_train: float            # P^b (W) training alone in background
    t_train: float            # (s) standalone training duration (one local epoch)
    p_idle: float             # P^d (W)
    p_sched: float            # (W) while evaluating the online decision (Table III)
    apps: Dict[str, AppProfile]

    def energy_saving_rate(self, app: str) -> float:
        """s_i = P^b + P^a - P^{a'} (W): per-second saving of co-running."""
        a = self.apps[app]
        return self.p_train + a.p_app - a.p_corun

    def saving_percent(self, app: str) -> float:
        a = self.apps[app]
        separate = self.p_train * self.t_train + a.p_app * a.t_corun
        return 1.0 - (a.p_corun * a.t_corun) / separate

    def duration(self, corun: bool, app: str | None = None) -> float:
        return self.apps[app].t_corun if corun and app else self.t_train

    def power(self, training: bool, app_running: bool, app: str | None = None) -> float:
        """Eq. (10): power as a function of (control decision, app status)."""
        if training and app_running:
            return self.apps[app].p_corun        # P^{a'}
        if training:
            return self.p_train                  # P^b
        if app_running:
            return self.apps[app].p_app          # P^a
        return self.p_idle                       # P^d


def _dev(name, p_train, t_train, p_idle, p_sched, rows):
    apps = {app: AppProfile(*row) for app, row in zip(APPS, rows)}
    return DeviceProfile(name, p_train, t_train, p_idle, p_sched, apps)


# Table II (measured W / s) + Table III idle & scheduler powers.
# Hikey970 idle power is not in Table II/III (the paper's Table III covers
# only the Snapdragon phones); we calibrate 0.6 W — headless dev-board idle,
# consistent with the phone idle range and with the paper's Fig. 4a absolute
# energy scale (documented deviation, DESIGN.md §2).
TESTBED: Dict[str, DeviceProfile] = {
    "Nexus6": _dev("Nexus6", 1.8, 204, 0.238, 0.245, [
        (3.4, 3.5, 274), (1.7, 2.2, 239), (1.4, 2.4, 236), (0.5, 1.9, 284),
        (1.6, 2.3, 296), (1.2, 2.1, 370), (1.3, 2.3, 997), (2.5, 2.8, 400)]),
    "Nexus6P": _dev("Nexus6P", 0.9, 211, 0.486, 0.525, [
        (0.5, 1.3, 225), (0.44, 1.2, 362), (0.48, 0.96, 228), (0.53, 1.2, 220),
        (1.0, 1.1, 675), (1.4, 1.6, 340), (0.7, 1.3, 280), (1.1, 1.2, 620)]),
    "Hikey970": _dev("Hikey970", 7.87, 213, 0.6, 0.65, [
        (8.82, 9.42, 186), (9.17, 9.76, 210), (8.50, 9.15, 195), (9.15, 11.45, 210),
        (11.0, 11.2, 271), (7.89, 8.53, 209), (11.1, 11.26, 233), (10.1, 10.7, 200)]),
    "Pixel2": _dev("Pixel2", 1.35, 223, 0.689, 0.736, [
        (1.60, 2.20, 196), (1.82, 2.40, 197), (1.72, 2.23, 206), (2.04, 2.21, 226),
        (2.37, 2.52, 212), (2.57, 3.11, 206), (2.89, 2.92, 199), (2.86, 2.88, 285)]),
}

DEVICE_NAMES = list(TESTBED)


def table2_savings() -> Dict[str, Dict[str, float]]:
    """Reproduce the saving(%) column of Table II for every (device, app)."""
    return {d: {a: TESTBED[d].saving_percent(a) for a in APPS} for d in TESTBED}


# ---------------------------------------------------------------------------
# Struct-of-arrays view of the catalog, for the vectorized simulator engine.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """Table II/III flattened into dense lookup tables.

    Per-device vectors have shape ``(n_devices,)``; per-(device, app)
    tables have shape ``(n_devices, n_apps)`` with the app axis ordered as
    ``APPS``. ``saving_rate[d, a]`` is Sec. IV's s_i = P^b + P^a - P^{a'}.
    """
    names: Tuple[str, ...]
    p_train: np.ndarray
    t_train: np.ndarray
    p_idle: np.ndarray
    p_sched: np.ndarray
    p_app: np.ndarray
    p_corun: np.ndarray
    t_corun: np.ndarray
    saving_rate: np.ndarray


def build_tables(devices) -> DeviceTables:
    """Flatten any device catalog into ``DeviceTables`` (frozen arrays).

    ``devices``: sequence of ``DeviceProfile``; each must carry an
    ``AppProfile`` for every entry of ``APPS`` (the app axis is shared
    across fleets). This is what lets custom/synthetic fleets feed the
    vectorized engine without touching the Table II catalog.
    """
    devs = list(devices)
    names = tuple(d.name for d in devs)
    p_train = np.array([d.p_train for d in devs])
    p_app = np.array([[d.apps[a].p_app for a in APPS] for d in devs])
    p_corun = np.array([[d.apps[a].p_corun for a in APPS] for d in devs])
    tables = DeviceTables(
        names=names,
        p_train=p_train,
        t_train=np.array([d.t_train for d in devs]),
        p_idle=np.array([d.p_idle for d in devs]),
        p_sched=np.array([d.p_sched for d in devs]),
        p_app=p_app,
        p_corun=p_corun,
        t_corun=np.array([[d.apps[a].t_corun for a in APPS] for d in devs]),
        # same operation order as DeviceProfile.energy_saving_rate
        saving_rate=(p_train[:, None] + p_app) - p_corun,
    )
    # tables may be shared across runs (catalog_tables hands out one
    # process-wide instance); freeze the arrays so an accidental in-place
    # write can't corrupt every later run
    for f in dataclasses.fields(tables):
        v = getattr(tables, f.name)
        if isinstance(v, np.ndarray):
            v.setflags(write=False)
    return tables


@functools.lru_cache(maxsize=1)
def catalog_tables() -> DeviceTables:
    """The Table II/III testbed as ``DeviceTables`` (cached singleton)."""
    return build_tables(TESTBED.values())


def device_ids(names: Sequence[str]) -> np.ndarray:
    """Map device names onto row indices of ``catalog_tables()``."""
    order = {n: i for i, n in enumerate(catalog_tables().names)}
    return np.array([order[n] for n in names], dtype=np.int64)
