"""Staleness metrics: lag (Def. 1) and gradient gap (Def. 2, Eqs. 2-4).

The gradient gap between the model a client pulled at t and the global model
at push time t+tau is estimated with Linear Weight Prediction (Eq. 3):

    theta_{t+tau} = theta_t - eta * (1 - beta^l) / (1 - beta) * v_t
    g(t, t+tau)   = || eta * (1 - beta^l) / (1 - beta) * v_t ||_2      (Eq. 4)

Only the *norm* of the momentum vector and the lag l are needed: the server
ships two scalars, never the momentum tree. ``momentum_scale`` and
``gradient_gap`` are host float64 (numpy) exactly as in the JAX package,
so schedules and push logs match it bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..kernels.fused_update.ops import tree_leaves, tree_map


def momentum_scale(lag, eta: float, beta: float):
    """eta * (1 - beta^lag) / (1 - beta) — the LWP multiplier in Eq. (4).

    ``lag`` is a scalar or an ndarray (float64 array out). The scalar path
    uses the same np.power ufunc as the array path, so scalar and batched
    callers see bit-identical values."""
    if isinstance(lag, np.ndarray):
        if beta == 0.0:
            return np.where(lag > 0, float(eta), 0.0)
        return eta * (1.0 - np.power(beta, lag)) / (1.0 - beta)
    if beta == 0.0:
        return float(eta) if lag > 0 else 0.0
    return float(eta * (1.0 - np.power(beta, lag)) / (1.0 - beta))


def gradient_gap(v_norm, lag, eta: float, beta: float):
    """Eq. (4): predicted parameter-space L2 distance over `lag` updates.

    Accepts scalar or array ``lag`` / ``v_norm`` (broadcast elementwise)."""
    return momentum_scale(lag, eta, beta) * v_norm


def tree_l2_norm(tree: Any) -> float:
    """||v||_2 over a tree of tensors (f32 accumulation)."""
    sq = sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree))
    return float(torch.sqrt(sq))


def predict_weights(theta: Any, v: Any, lag: float, eta: float, beta: float):
    """Eq. (3): linear weight prediction of the future global parameters,
    leaf by leaf over a tree of torch tensors or numpy arrays."""
    s = momentum_scale(lag, eta, beta)
    return tree_map(lambda t, m: t - s * m, theta, v)


def true_gap(theta_t: Any, theta_tau: Any) -> float:
    """Eq. (2): the exact distance between two parameter trees (torch or
    numpy leaves; f32 accumulation), which validates the LWP estimate."""
    sq = sum(torch.sum(torch.square(torch.as_tensor(a - b).float()))
             for a, b in zip(tree_leaves(theta_t), tree_leaves(theta_tau)))
    return float(torch.sqrt(sq))


class LagTracker:
    """Server-side version counter implementing Def. 1.

    lag(client) = number of global updates applied between the client's pull
    and its push."""

    def __init__(self):
        self.version = 0
        self._pull_version: dict[Any, int] = {}

    def on_pull(self, client_id) -> int:
        self._pull_version[client_id] = self.version
        return self.version

    def lag(self, client_id) -> int:
        return self.version - self._pull_version.get(client_id, self.version)

    def on_push(self, client_id) -> int:
        l = self.lag(client_id)
        self.version += 1
        return l

    def estimate_lag_during(self, in_flight: int) -> int:
        """Server-supplied lag estimate for Alg. 2 line 4: the number of
        currently-running tasks expected to land within the client's window."""
        return in_flight
