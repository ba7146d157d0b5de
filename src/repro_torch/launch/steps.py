"""Step functions of the LM trainer — the counterpart of
``repro/launch/steps.py`` without shardings.

``make_train_step(cfg)`` -> (params, v, batch, lag) -> (params', v', metrics)
    One island-local update of the paper's system at LM scale:
    microbatched gradient accumulation (f32) + the fused momentum update
    (Eq. 1) with the gradient-gap norm (Eq. 4) — one K2 pass
    (``optim/gap.py``). ``metrics`` holds the loss and the gap as 0-d
    tensors (nothing is synced to the host).

``make_update_step(cfg)`` -> (params, v, grads, lag) -> (params', v', gap)
    The fused-update epilogue alone.

``kernel`` picks how K2 runs (``kernels.fused_update.fused_update_flat``).
The prefill/decode steps are still to port (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import torch

from ..kernels.fused_update.ops import (tree_leaves, tree_map,
                                        tree_unflatten)
from ..models import build_model
from ..optim.gap import fused_momentum_gap_update


def make_train_step(cfg, *, eta: float = 1e-2, beta: float = 0.9,
                    microbatches: int = 1, kernel: str = "auto"):
    """Momentum-SGD train step with the paper's gap norm. With
    ``microbatches > 1`` every batch leaf carries a leading microbatch
    dimension; the gradients are averaged in f32."""
    model = build_model(cfg)

    def loss_grads(params, mb):
        leaves = [l.detach().requires_grad_(True)
                  for l in tree_leaves(params)]
        loss, _ = model.loss(tree_unflatten(params, leaves), mb)
        grads = torch.autograd.grad(loss, leaves)
        return tree_unflatten(params, list(grads)), loss.detach()

    def train_step(params, v, batch, lag):
        if microbatches == 1:
            grads, loss = loss_grads(params, batch)
        else:
            accum = tree_map(lambda p: torch.zeros(p.shape, device=p.device),
                             params)
            losses = []
            for i in range(microbatches):
                grads, l = loss_grads(params,
                                      {k: t[i] for k, t in batch.items()})
                accum = tree_map(lambda a, g: a + g.float(), accum, grads)
                losses.append(l)
            grads = tree_map(lambda a: a / microbatches, accum)
            loss = torch.mean(torch.stack(losses))
        new_params, new_v, gap = fused_momentum_gap_update(
            params, v, grads, eta=eta, beta=beta, lag=lag, kernel=kernel)
        return new_params, new_v, {"loss": loss, "gap": gap}

    return train_step


def make_update_step(cfg, *, eta: float = 1e-2, beta: float = 0.9,
                     kernel: str = "auto"):
    """The fused-update epilogue alone."""

    def upd_step(params, v, grads, lag):
        return fused_momentum_gap_update(params, v, grads, eta=eta,
                                         beta=beta, lag=lag, kernel=kernel)

    return upd_step
