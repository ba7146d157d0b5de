"""Client-side local training: momentum SGD per Eq. (1).

    v_t = beta * v_{t-1} + (1 - beta) * s_t
    theta_t = theta_{t-1} - eta * v_t

The counterpart of ``repro/core/client.py``. One ``local_train`` call =
one local epoch over the client's shard (the unit the paper schedules),
on flat f32 parameters (``models/lenet.py``, ``models/mlp.py``). It is
the loop oracle's per-user training path (``make_ml_hooks``); the batched
engine trains whole cohorts with ``realml._masked_epoch`` instead, the
same steps in the same order.

Each epoch's minibatch permutation comes from ``next_perm``: inside a
backend that is the backend's ``_next_perm(uid)``, which draws from the
client's own CPU ``torch.Generator`` — so a loop run and a batched run of
one backend draw the same minibatches, and one seam feeds another
source's permutations to both. A standalone client draws from its own
generator, seeded with ``hash(client_id) % 2**31`` (the JAX client's key
seed).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.func import grad_and_value


class Client:
    """A federated participant holding one data shard (tensors on the
    device it trains on)."""

    def __init__(self, client_id, images, labels, loss_fn: Callable,
                 batch_size: int = 20, eta: float = 0.01, beta: float = 0.9,
                 next_perm: Optional[Callable[[], np.ndarray]] = None):
        self.client_id = client_id
        self.images = images
        self.labels = labels
        self.loss_fn = loss_fn
        self.batch_size = batch_size
        self.eta = eta
        self.beta = beta
        if next_perm is None:
            gen = torch.Generator().manual_seed(hash(client_id) % (2 ** 31))
            n = images.shape[0]

            def next_perm():
                return torch.randperm(n, generator=gen).numpy()
        self.next_perm = next_perm

    def local_train(self, params):
        """One local epoch from ``params`` (left as it was). Returns
        (new_params, local_momentum, mean_loss), the loss a 0-d tensor on
        the parameters' device (no host copy)."""
        B = self.batch_size
        steps = self.images.shape[0] // B
        perm = self.next_perm()             # consumed even with 0 steps
        rows = torch.from_numpy(
            np.asarray(perm[:steps * B], np.int64).reshape(steps, B)
        ).to(self.images.device)
        step_fn = grad_and_value(self.loss_fn)
        p = params
        v = torch.zeros_like(params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=params.device)
        for s in range(steps):
            r = rows[s]
            g, loss = step_fn(p, self.images[r], self.labels[r])
            v = self.beta * v + (1 - self.beta) * g
            p = p - self.eta * v
            loss_sum = loss_sum + loss
        return p, v, loss_sum / max(steps, 1)
