"""Aggregation rules: how the server APPLIES a push.

The paper's Sec. VI server uses the plain "replace" rule. The rule is a
registry object (the counterpart of ``repro/core/aggregation.py``), so the
async server and the vectorized engine see one implementation.

An ``AggregationRule`` exposes the host path

``weight(lag, gap, v_norm, fleet=None, users=None)``
    The applied mixing weight in ``[0, 1]`` for a push (or a whole
    finisher cohort — ``lag``/``gap`` broadcast as arrays). The server
    applies ``theta <- w * theta_push + (1-w) * theta`` (``w == 1`` is
    the paper's replace rule).

and ``init_carry(n, cfg, fleet=None)``, the per-run rule state
(``EngineState.agg_carry``; ``None`` for stateless rules). ``needs_gap``
says whether the weight reads the Eq. (4) gap or momentum norm.

Ships ``replace`` (the paper, weight 1). The JAX package's
``fedasync_poly``, ``gap_aware`` and ``hetero_aware`` are still to port
(ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

from typing import Dict, Tuple, Type

import numpy as np

__all__ = ["AggregationRule", "ReplaceRule", "register_aggregation",
           "registered_aggregations", "resolve_aggregation"]


class AggregationRule:
    """Base aggregation rule. Subclass, set ``name``, implement
    ``weight``, and decorate with ``@register_aggregation``."""

    name: str = ""
    needs_gap: bool = False

    def weight(self, lag, gap, v_norm, fleet=None, users=None):
        """Applied mixing weight(s) in ``[0, 1]``; ``lag``/``gap``
        broadcast."""
        raise NotImplementedError(
            f"aggregation rule {self.name!r} implements no weight()")

    def init_carry(self, n: int, cfg=None, fleet=None):
        """Per-run rule state (``EngineState.agg_carry``); ``None`` for
        stateless rules."""
        return None


_REGISTRY: Dict[str, Type[AggregationRule]] = {}
_INSTANCES: Dict[str, AggregationRule] = {}     # singletons for strings


def register_aggregation(cls: Type[AggregationRule]) -> Type[AggregationRule]:
    """Class decorator: make ``cls`` resolvable as ``cls.name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a registry name")
    _REGISTRY[cls.name] = cls
    _INSTANCES.pop(cls.name, None)              # re-registration wins
    return cls


def registered_aggregations() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def resolve_aggregation(rule) -> AggregationRule:
    """String -> registered singleton; AggregationRule instance -> itself."""
    if isinstance(rule, AggregationRule):
        return rule
    if isinstance(rule, str):
        if rule not in _REGISTRY:
            raise ValueError(
                f"unknown aggregation {rule!r}; expected one of "
                f"{registered_aggregations()} or an AggregationRule "
                "instance")
        if rule not in _INSTANCES:
            _INSTANCES[rule] = _REGISTRY[rule]()
        return _INSTANCES[rule]
    raise ValueError(f"aggregation must be a name or AggregationRule "
                     f"instance, got {type(rule).__name__}")


@register_aggregation
class ReplaceRule(AggregationRule):
    """The paper's Sec. VI rule: every push lands at full weight."""

    name = "replace"

    def weight(self, lag, gap, v_norm, fleet=None, users=None):
        lag = np.asarray(lag)
        return np.ones(lag.shape) if lag.ndim else 1.0
