"""The dense MLP of the transformer block — the part of
``repro/models/moe.py`` the dense family runs. The MoE layers (router,
dense and sorted dispatch) are still to port (ROADMAP Queue 1 item 7)."""
from __future__ import annotations

import torch

from .common import ACTS, dense_init


def init_mlp(generator, cfg, d_model=None, d_ff=None):
    D = d_model or cfg.d_model
    F = d_ff or cfg.d_ff
    if cfg.mlp_act == "silu":   # SwiGLU
        return {"w_gate": dense_init(generator, D, F),
                "w_up": dense_init(generator, D, F),
                "w_down": dense_init(generator, F, D)}
    return {"w_up": dense_init(generator, D, F), "b_up": torch.zeros(F),
            "w_down": dense_init(generator, F, D), "b_down": torch.zeros(D)}


def mlp(x, p, cfg):
    dt = x.dtype
    act = ACTS[cfg.mlp_act]
    if cfg.mlp_act == "silu":
        h = act(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return h @ p["w_down"].to(dt)
    h = act(x @ p["w_up"].to(dt) + p["b_up"].to(dt))
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)
