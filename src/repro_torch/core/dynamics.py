"""Device dynamics: availability, battery and network churn.

The counterpart of ``repro/core/dynamics.py``. The paper's simulator
assumes an always-on fleet, which is ``NoDynamics`` (the default): it is
INACTIVE — no state, no draws, no effect — so the engine skips the
dynamics phase entirely. Active dynamics (the JAX package's
``MarkovChurnDynamics``, whose draws come from jax's threefry) are still
to port (ROADMAP Queue 1 item 4); ``SimConfig`` refuses them.
"""
from __future__ import annotations

from typing import Dict, Tuple, Type

__all__ = ["DeviceDynamics", "NoDynamics", "register_dynamics",
           "registered_dynamics", "resolve_dynamics"]


class DeviceDynamics:
    """Base device-dynamics model. ``active`` False means the engine skips
    the dynamics phase (no state, no draws); only ``NoDynamics`` clears
    it."""

    name: str = ""
    active: bool = True


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


@register_dynamics
class NoDynamics(DeviceDynamics):
    """The paper's always-on fleet (the default). Inactive: the engine
    skips the dynamics phase entirely."""

    name = "none"
    active = False
