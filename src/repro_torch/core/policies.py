"""Pluggable scheduling policies: one registry, one carry protocol.

The counterpart of ``repro/core/policies.py``. A ``Policy`` is a
registered object; ``init_carry(n, cfg)`` returns its per-run state (which
the engine threads as ``EngineState.carry``), and ``decide_vectorized``
makes one slot's decisions on the struct-of-arrays numpy engine
(``core/vector_engine.py``).

Ships the online Lyapunov controller (Alg. 2, the paper's contribution)
and the immediate baseline the energy saving is measured against. The JAX
package's ``sync``, ``offline``, ``greedy`` and ``eps_greedy`` are still to
port (ROADMAP Queue 1 item 4). For a given seed the decisions equal the
JAX package's vectorized engine bit for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple, Type

import numpy as np

__all__ = ["Policy", "register_policy", "registered_policies",
           "resolve_policy", "ImmediatePolicy", "OnlinePolicy"]


class Policy:
    """Base scheduling policy. Subclass, set ``name``, implement
    ``decide_vectorized``, and decorate with ``@register_policy``.

    - ``sync_rounds``: lock-step rounds (FedAvg); the engine of this port
      runs asynchronous policies only, and ``SimConfig`` refuses the rest.
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
