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

``make_prefill_step(cfg)`` -> (params, batch, cache) -> (logits, cache')
``make_decode_step(cfg)``  -> (params, cache, batch) -> (tokens or logits,
    cache'): the model's own prefill and decode, without gradients; the
    decode step returns the greedy argmax (int64) unless ``greedy=False``.

``kernel`` picks how K2 runs (``kernels.fused_update.fused_update_flat``)
in the train and update steps, and how K3/K4 run (``build_model``) in the
serving steps.
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


def make_prefill_step(cfg, *, kernel: str = "auto"):
    model = build_model(cfg, kernel=kernel)

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    return prefill_step


def make_decode_step(cfg, *, greedy: bool = True, kernel: str = "auto"):
    model = build_model(cfg, kernel=kernel)

    @torch.no_grad()
    def decode_step(params, cache, batch):
        logits, new_cache = model.decode_step(params, cache, batch)
        out = torch.argmax(logits, dim=-1) if greedy else logits
        return out, new_cache

    return decode_step
