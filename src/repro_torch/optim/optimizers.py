"""Optimizers built from scratch: momentum SGD (paper Eq. 1) and AdamW for
the LM-scale configs — the counterpart of ``repro/optim/optimizers.py``.
Functional, on trees of tensors: ``init(params) -> OptState`` and
``update(grads, state, params) -> (updates, state)``; nothing is updated
in place."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..kernels.fused_update.ops import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor       # 0-d int32
    mu: Any                  # first moment / momentum vector v_t
    nu: Any                  # second moment (None for SGD)


def _step0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def momentum_sgd(lr: float, beta: float = 0.9):
    """Paper Eq. (1): v = beta*v + (1-beta)*g ; theta -= lr*v."""

    def init(params):
        return OptState(_step0(params), tree_map(torch.zeros_like, params),
                        None)

    def update(grads, state, params=None):
        mu = tree_map(lambda v, g: beta * v + (1 - beta) * g, state.mu,
                      grads)
        updates = tree_map(lambda v: -lr * v, mu)
        return updates, OptState(state.step + 1, mu, None)

    return init, update


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1):
    def init(params):
        return OptState(_step0(params), tree_map(torch.zeros_like, params),
                        tree_map(torch.zeros_like, params))

    def update(grads, state, params):
        step = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * torch.square(g),
                      state.nu, grads)
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()

        def u(m, n, p):
            return -lr * ((m / c1) / (torch.sqrt(n / c2) + eps)
                          + weight_decay * p)

        return tree_map(u, mu, nu, params), OptState(step, mu, nu)

    return init, update


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda l: l * scale, tree), n
