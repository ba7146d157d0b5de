"""Asynchronous parameter server (paper Sec. VI).

The counterpart of ``repro/core/server.py``'s ``AsyncParameterServer``:
clients pull the current global model, train locally with momentum SGD
(Eq. 1), and push; the server applies the push immediately and advances
the version counter. HOW a push is applied is delegated to an
``AggregationRule`` (core/aggregation.py).

The server keeps the global momentum-norm estimate that drives the Eq. (4)
gradient-gap predictions: v <- beta * v + (1-beta) * s with
s = (theta_old - theta_new) / eta, so only ||v||_2 (a scalar) ever travels
to clients. Every push is ONE launch of the K1 kernel
(``kernels/fused_update``), a chunk of one push: the weighted mix, the
momentum update and the new ``||v||`` in one pass. ``kernel`` picks how
K1 runs (see ``fused_apply_cohort``).

Parameters are a tree of tensors (a flat f32 tensor is a one-leaf tree,
which is how the LeNet backend keeps them). Each push allocates the new
parameters and momentum — nothing is updated in place — so parameters a
client pulled earlier stay unchanged, as in the JAX package.
``SyncServer`` (FedAvg) is still to port (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch

from ..device import resolve_device
from ..kernels.fused_update import check_kernel_mode, fused_weighted_apply
from ..kernels.fused_update.ops import tree_map
from .aggregation import AggregationRule, resolve_aggregation
from .staleness import LagTracker, gradient_gap


@dataclasses.dataclass
class PushResult:
    lag: int
    gap_estimate: float     # Eq. (4) gap at push ARRIVAL (pre-application)
    applied_weight: float   # the rule's mixing weight, 1.0 under replace
    version: int


class AsyncParameterServer:
    def __init__(self, params: Any, eta: float, beta: float,
                 aggregation: Union[str, AggregationRule] = "replace",
                 fleet=None, kernel: str = "auto", device="cuda"):
        """``params``: a tree of tensors, moved to ``device`` (CUDA unless
        the caller asks for the CPU; CUDA asked for and absent raises).
        ``aggregation`` is a registry name or ``AggregationRule``
        instance; ``fleet`` binds the run's ``FleetSpec`` for
        fleet-conditioned rules."""
        self.device = resolve_device(device)
        self.params = tree_map(lambda p: p.to(self.device), params)
        self.eta = eta
        self.beta = beta
        self.rule: AggregationRule = resolve_aggregation(aggregation)
        self.aggregation = self.rule.name
        self.fleet_spec = fleet
        self.kernel = check_kernel_mode(kernel)
        self.lag_tracker = LagTracker()
        self._v = tree_map(torch.zeros_like, self.params)
        # ||v||_2: a float, or a 0-d device tensor the fused finish leaves
        # behind (converted on demand by the backend's v_norm())
        self.v_norm = 0.0
        self.in_flight: set = set()

    def pull(self, client_id) -> tuple[Any, int]:
        self.lag_tracker.on_pull(client_id)
        self.in_flight.add(client_id)
        return self.params, self.lag_tracker.version

    def lag_estimate(self, client_id) -> int:
        """Alg. 2 line 4: server-side lag estimate = concurrent tasks."""
        return max(len(self.in_flight)
                   - (1 if client_id in self.in_flight else 0), 0)

    def push(self, client_id, new_params: Any) -> PushResult:
        lag = self.lag_tracker.on_push(client_id)
        self.in_flight.discard(client_id)
        # Eq. (4) gap at push arrival — the momentum norm BEFORE this push
        v_norm = float(self.v_norm)
        gap = gradient_gap(v_norm, lag, self.eta, self.beta)
        weight = float(self.rule.weight(lag, gap, v_norm,
                                        fleet=self.fleet_spec,
                                        users=client_id))
        self.params, self._v, vn = fused_weighted_apply(
            self.params, self._v, new_params, w=weight, eta=self.eta,
            beta=self.beta, kernel=self.kernel)
        self.v_norm = float(vn)
        return PushResult(lag=lag, gap_estimate=gap, applied_weight=weight,
                          version=self.lag_tracker.version)
