"""Aggregation rules: how the server APPLIES a push.

The paper's Sec. VI server uses the plain "replace" rule, but the
gradient-gap machinery (Eqs. 2-4) exists precisely because stale pushes
should not count at full weight. The rule is a registry object (the
counterpart of ``repro/core/aggregation.py``), so the async server, the
numpy engine and the real-ML finish see one implementation.

An ``AggregationRule`` exposes two paths:

``weight(lag, gap, v_norm, fleet=None, users=None)``
    The host (numpy) path: the applied mixing weight in ``[0, 1]`` for a
    push (or a whole finisher cohort — ``lag``/``gap`` broadcast as
    arrays). The server applies
    ``theta <- w * theta_push + (1-w) * theta`` (``w == 1`` is the
    paper's replace rule).
``scan_weight(carry, pv)``
    The tensor twin: ``pv`` is a push view (``lag``, ``gap``,
    ``v_norm``, ``users`` as torch tensors on one device, ``consts`` from
    ``scan_operands``, ``float_dtype``). Returns ``(carry, weight)``
    with the carry unchanged. The LeNet finish computes ``gap_aware``'s
    weights with it on the device, push by push (core/realml.py); the
    device scan engine (core/vector_engine.py) fills its push log's
    weight column with it every slot, on ``(B, n)`` tensors with a
    leading config axis (each knob of ``consts`` a ``(B, 1)`` tensor,
    ``users`` the ``(n,)`` user ids, carry leaves ``(B, n)``).

and ``init_carry(n, cfg, fleet=None)``, the per-run rule state
(``EngineState.agg_carry``; run-constant lookup state such as
``hetero_aware``'s per-user scales, ``None`` for stateless rules).
``needs_gap`` says whether the weight reads the Eq. (4) gap.

Ships ``replace`` (the paper, weight 1), ``fedasync_poly`` (Xie et al.
[30]: ``alpha * (1+lag)^-a``), ``gap_aware`` (``1 / (1 + gap/gap_ref)``)
and ``hetero_aware`` (the staleness polynomial scaled per device class by
relative training speed). For a given push the two paths give the same
weight (to f32 rounding on the tensor path).
"""
from __future__ import annotations

from typing import Dict, Tuple, Type

import numpy as np
import torch

__all__ = ["AggregationRule", "ReplaceRule", "FedAsyncPolyRule",
           "GapAwareRule", "HeteroAwareRule", "register_aggregation",
           "registered_aggregations", "resolve_aggregation",
           "configure_aggregation", "aggregation_support", "hetero_scales"]


class AggregationRule:
    """Base aggregation rule. Subclass, set ``name``, implement
    ``weight``, and decorate with ``@register_aggregation``.

    - ``supports_jax``: ``scan_weight`` exists, so a push log can be
      collected inside the device scan engine (``engine="jax"``);
      ``SimConfig`` checks the flag against the hook at construction,
      and a rule without it degrades that engine to the numpy engine.
    - ``supports_vmap``: ``scan_weight`` may run on a batched sweep's
      ``(B, n)`` tensors (``run_sweep``).
    - ``supports_shard``: ``scan_weight`` may run on a user axis padded
      past the live ``n`` (``SimConfig.n_devices``; its per-user carry
      leaves are zero-padded, and pad users never push).
    """

    name: str = ""
    needs_gap: bool = False
    supports_jax: bool = True
    supports_vmap: bool = True
    supports_shard: bool = True

    def weight(self, lag, gap, v_norm, fleet=None, users=None):
        """Applied mixing weight(s) in ``[0, 1]``; ``lag``/``gap``
        broadcast."""
        raise NotImplementedError(
            f"aggregation rule {self.name!r} implements no weight()")

    def init_carry(self, n: int, cfg=None, fleet=None):
        """Per-run rule state (``EngineState.agg_carry``); ``None`` for
        stateless rules."""
        return None

    def scan_operands(self, cfg=None) -> tuple:
        """Instance knobs the tensor twin reads, as a flat scalar tuple
        (``pv.consts``)."""
        return ()

    def jax_cache_key(self):
        """Hashable token of this rule's ``scan_weight`` behaviour (the
        JAX package's executable-cache key; here it joins the sweep
        bucket key): the class when the instance has no attributes or
        routes its knobs through ``scan_operands``, else the instance."""
        if not vars(self) or \
                type(self).scan_operands is not AggregationRule.scan_operands:
            return type(self)
        return self

    def scan_weight(self, carry, pv):
        """Tensor twin of ``weight``: ``(carry, weight)``, ``weight``
        broadcastable against ``pv.lag``, the carry unchanged. Only
        called when ``supports_jax``."""
        raise TypeError(
            f"aggregation rule {self.name!r} sets supports_jax but "
            "inherits the base scan_weight; implement the hook or clear "
            "the flag to degrade to the numpy engine")


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


def configure_aggregation(rule, *, fedasync_alpha: float = 0.6,
                          fedasync_a: float = 0.5,
                          gap_ref: float = 1.0) -> AggregationRule:
    """``resolve_aggregation`` plus the knob kwargs the servers accept: a
    registry NAME given with non-default knob values constructs the
    matching configured rule instead of the shared singleton. Rule
    instances pass through untouched (their own knobs win)."""
    if isinstance(rule, str) and rule == "fedasync_poly" \
            and (fedasync_alpha != 0.6 or fedasync_a != 0.5):
        return FedAsyncPolyRule(fedasync_alpha, fedasync_a)
    if isinstance(rule, str) and rule == "gap_aware" and gap_ref != 1.0:
        return GapAwareRule(gap_ref)
    return resolve_aggregation(rule)


def aggregation_support(rule: AggregationRule) -> Dict[str, bool]:
    """Which paths ``rule`` genuinely implements (the flag set AND the
    base stub overridden): ``host`` (``weight``) and ``jax`` (the scan
    engine's ``scan_weight``)."""
    cls = type(rule)
    return {
        "host": cls.weight is not AggregationRule.weight,
        "jax": (rule.supports_jax and
                cls.scan_weight is not AggregationRule.scan_weight),
    }


@register_aggregation
class ReplaceRule(AggregationRule):
    """The paper's Sec. VI rule: every push lands at full weight."""

    name = "replace"

    def weight(self, lag, gap, v_norm, fleet=None, users=None):
        lag = np.asarray(lag)
        return np.ones(lag.shape) if lag.ndim else 1.0

    def scan_weight(self, carry, pv):
        return carry, torch.ones(pv.lag.shape, dtype=pv.float_dtype,
                                 device=pv.lag.device)


@register_aggregation
class FedAsyncPolyRule(AggregationRule):
    """FedAsync polynomial staleness weighting (Xie et al. [30]):
    ``w = alpha * (1 + lag)^-a`` — monotone non-increasing in lag,
    bounded by ``alpha <= 1``."""

    name = "fedasync_poly"

    def __init__(self, alpha: float = 0.6, a: float = 0.5):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if a < 0.0:
            raise ValueError(f"a must be non-negative, got {a}")
        self.alpha = float(alpha)
        self.a = float(a)

    def scan_operands(self, cfg=None):
        return (self.alpha, self.a)

    def weight(self, lag, gap, v_norm, fleet=None, users=None):
        # np.power on the scalar path too: python ** disagrees with the
        # np.power ufunc by an ulp for some bases, and the server (scalar)
        # must produce the engine's (array) bits
        return self.alpha * np.power(1.0 + lag, -self.a)

    def scan_weight(self, carry, pv):
        alpha, a = pv.consts
        return carry, alpha * (1.0 + pv.lag.to(pv.float_dtype)) ** (-a)


@register_aggregation
class GapAwareRule(AggregationRule):
    """Dampen by the Eq. (4) gradient-gap estimate: a push predicted to
    land ``gap`` away from the current model mixes at
    ``w = 1 / (1 + gap / gap_ref)`` — fresh pushes (gap 0) at full
    weight, weight halved at ``gap == gap_ref``."""

    name = "gap_aware"
    needs_gap = True

    def __init__(self, gap_ref: float = 1.0):
        if gap_ref <= 0.0:
            raise ValueError(f"gap_ref must be positive, got {gap_ref}")
        self.gap_ref = float(gap_ref)

    def scan_operands(self, cfg=None):
        return (self.gap_ref,)

    def weight(self, lag, gap, v_norm, fleet=None, users=None):
        # no clamp: the constructor guarantees gap_ref > 0
        return 1.0 / (1.0 + gap / self.gap_ref)

    def scan_weight(self, carry, pv):
        (gap_ref,) = pv.consts
        return carry, 1.0 / (1.0 + pv.gap / gap_ref)


_SCALE_CACHE: dict = {}      # id(fleet) -> (fleet strong ref, scales)
_SCALE_CACHE_MAX = 8


def hetero_scales(fleet) -> np.ndarray:
    """Per-catalog-row device-class scale in ``(0, 1]``: relative
    training speed ``min(t_train) / t_train`` — the fastest class scores
    1.0, a class twice as slow 0.5. Slow classes hold the global model
    longest (Lemma 1 couples lag to training duration), so conditioning
    on it downweights exactly the stale-prone contributions.

    Fleet-constant but called per push on the server path, so a small
    keep-alive cache (the strong ref pins the id) makes repeat lookups
    O(1)."""
    hit = _SCALE_CACHE.pop(id(fleet), None)    # pop+reinsert = LRU order
    if hit is not None and hit[0] is fleet:
        _SCALE_CACHE[id(fleet)] = hit
        return hit[1]
    tt = np.asarray(fleet.tables.t_train, dtype=np.float64)
    scales = tt.min() / tt
    if len(_SCALE_CACHE) >= _SCALE_CACHE_MAX:
        _SCALE_CACHE.pop(next(iter(_SCALE_CACHE)))  # evict LRU
    _SCALE_CACHE[id(fleet)] = (fleet, scales)
    return scales


@register_aggregation
class HeteroAwareRule(AggregationRule):
    """Fleet-conditioned staleness weighting: the FedAsync polynomial
    scaled per device class by ``hetero_scales`` —
    ``w = scale(class(u)) * (1 + lag)^-a``.

    The per-user scale vector is the rule's carry (``init_carry`` gathers
    it once from the ``FleetSpec``); the host path reads it from the
    ``FleetSpec`` directly, so a bound fleet is REQUIRED — the rule
    refuses to silently ignore heterogeneity."""

    name = "hetero_aware"

    def __init__(self, a: float = 0.5):
        if a < 0.0:
            raise ValueError(f"a must be non-negative, got {a}")
        self.a = float(a)

    def scan_operands(self, cfg=None):
        return (self.a,)

    def init_carry(self, n, cfg=None, fleet=None):
        if fleet is None:
            raise ValueError(
                "hetero_aware needs the run's FleetSpec to derive "
                "device-class scales; engines pass it automatically")
        return {"scale": hetero_scales(fleet)[fleet.device_ids]}

    def weight(self, lag, gap, v_norm, fleet=None, users=None):
        if fleet is None or users is None:
            raise ValueError(
                "hetero_aware weights are fleet-conditioned: pass the "
                "run's FleetSpec and the pushing user id(s) (bind the "
                "server to a fleet, or run through an engine)")
        scale = hetero_scales(fleet)[fleet.device_ids[users]]
        # np.power for scalar-vs-array bit identity (see FedAsyncPolyRule)
        return scale * np.power(1.0 + lag, -self.a)

    def scan_weight(self, carry, pv):
        (a,) = pv.consts
        scale = torch.as_tensor(carry["scale"], device=pv.lag.device)
        scale = scale[..., pv.users].to(pv.float_dtype)
        return carry, scale * (1.0 + pv.lag.to(pv.float_dtype)) ** (-a)
