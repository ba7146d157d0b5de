"""The dense MLP and the Mixture-of-Experts layers — the counterpart of
``repro/models/moe.py``.

Two MoE dispatch implementations, as in the JAX package:
  * ``moe_dense``: a one-hot combine over ALL experts (every expert runs
    on every token); exact, used below ``S < 4 E`` tokens a row (decode
    steps, smoke shapes).
  * ``moe_sorted``: capacity-based dispatch per batch row. A row's
    (token, expert) slots are sorted by expert id with a STABLE sort (the
    JAX ``argsort(stable=True)``), each expert takes its first
    ``C = max(int(S k / E * moe_capacity_factor), 1)`` slots into an
    ``(E, C, D)`` buffer by a gather, the experts run as batched matmuls,
    and the combine inverts the sort permutation by a gather (no
    scatter). A slot past its expert's capacity is dropped, the same
    slots JAX drops.

``moe`` runs the sorted dispatch on every row at once (the JAX ``vmap``),
and over ``moe_dispatch_chunk`` tokens at a time when a row is longer
than that and a multiple of it (the JAX ``lax.scan`` over chunks). The
router's softmax and the combine weights are f32; the expert products
cast the f32 weights to the activation dtype. The JAX package computes
the expert products outside any Pallas kernel, and so does the port
(``torch.einsum`` batched matmuls). ``_pin_rows`` (a sharding constraint
on the rows) has no counterpart on one card and is not ported.

``DROPPED``: None, or a list to which every sorted dispatch appends the
number of (token, expert) slots its capacity dropped, as a 0-d int64
tensor on the device (nothing is read back while it runs).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ACTS, _trunc_normal, dense_init

DROPPED = None


# ------------------------------------------------------------------ dense MLP
def init_mlp(generator, cfg, d_model=None, d_ff=None):
    D = d_model or cfg.d_model
    F_ = d_ff or cfg.d_ff
    if cfg.mlp_act == "silu":   # SwiGLU
        return {"w_gate": dense_init(generator, D, F_),
                "w_up": dense_init(generator, D, F_),
                "w_down": dense_init(generator, F_, D)}
    return {"w_up": dense_init(generator, D, F_), "b_up": torch.zeros(F_),
            "w_down": dense_init(generator, F_, D), "b_down": torch.zeros(D)}


def mlp(x, p, cfg):
    dt = x.dtype
    act = ACTS[cfg.mlp_act]
    if cfg.mlp_act == "silu":
        h = act(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return h @ p["w_down"].to(dt)
    h = act(x @ p["w_up"].to(dt) + p["b_up"].to(dt))
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)


# ------------------------------------------------------------------------ MoE
def init_moe(generator, cfg):
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {"router": dense_init(generator, D, E),
            "w_gate": _trunc_normal(generator, (E, D, F_), D ** -0.5),
            "w_up": _trunc_normal(generator, (E, D, F_), D ** -0.5),
            "w_down": _trunc_normal(generator, (E, F_, D), F_ ** -0.5)}


def router_topk(x, w_router, cfg):
    """x: (..., T, D). Returns (weights (..., T, k) f32, indices (..., T,
    k) int64, aux_loss (...) f32), the Switch-style load-balancing loss
    averaged over each row's T tokens. Ties among the probabilities may
    order differently from ``lax.top_k``."""
    probs = torch.softmax(x.float() @ w_router.float(), dim=-1)
    weights, idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    if cfg.router_norm_topk:
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    E = cfg.num_experts
    me = torch.mean(probs, dim=-2)
    ce = torch.mean(F.one_hot(idx[..., 0], E).float(), dim=-2)
    aux = E * torch.sum(me * ce, dim=-1)
    return weights, idx, aux


def moe_dense(x, p, cfg):
    """One-hot combine over all experts. x: (T, D). Returns (out (T, D),
    aux)."""
    dt = x.dtype
    weights, idx, aux = router_topk(x, p["router"], cfg)
    comb = (F.one_hot(idx, cfg.num_experts).float()
            * weights[..., None]).sum(dim=1)                    # (T, E)
    act = ACTS[cfg.mlp_act]
    h = torch.einsum("td,edf->etf", x, p["w_gate"].to(dt))
    u = torch.einsum("td,edf->etf", x, p["w_up"].to(dt))
    y = torch.einsum("etf,efd->etd", act(h) * u, p["w_down"].to(dt))
    out = torch.einsum("etd,te->td", y.float(), comb)
    return out.to(dt), aux


def moe_sorted(x, p, cfg):
    """Capacity-based sort + gather dispatch, each row on its own. x: (T,
    D) or (R, T, D). Returns (out like x, aux: a scalar, or (R,))."""
    squeeze = x.dim() == 2
    x3 = x[None] if squeeze else x
    R, T, D = x3.shape
    dt = x3.dtype
    dev = x3.device
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    C = max(int(T * k / E * cfg.moe_capacity_factor), 1)

    weights, idx, aux = router_topk(x3, p["router"], cfg)     # (R, T, k)
    flat_e = idx.reshape(R, T * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)        # sorted -> flat
    tok_of_slot = order // k
    gate_of_slot = torch.gather(weights.reshape(R, T * k), 1, order)
    sizes = torch.zeros((R, E), dtype=torch.int64, device=dev)
    sizes.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(sizes, dim=-1) - sizes             # exclusive
    cs = torch.arange(C, device=dev)
    valid = cs[None, None, :] < sizes[..., None]              # (R, E, C)
    gidx = torch.where(valid, offsets[..., None] + cs, 0).reshape(R, E * C)
    tok = torch.where(valid, torch.gather(tok_of_slot, 1, gidx)
                      .reshape(R, E, C), 0)
    gates = torch.where(valid, torch.gather(gate_of_slot, 1, gidx)
                        .reshape(R, E, C), 0.0)
    if DROPPED is not None:
        DROPPED.append((sizes - C).clamp_min(0).sum())

    rows = torch.arange(R, device=dev)
    xg = x3[rows[:, None, None], tok] * valid[..., None].to(dt)  # (R,E,C,D)
    act = ACTS[cfg.mlp_act]
    h = act(torch.einsum("recd,edf->recf", xg, p["w_gate"].to(dt)))
    h = h * torch.einsum("recd,edf->recf", xg, p["w_up"].to(dt))
    y = torch.einsum("recf,efd->recd", h, p["w_down"].to(dt))
    y = (y.float() * gates[..., None]).to(dt)

    # the combine: flat slot j sits at sorted position inv[j], which is
    # position inv[j] - offsets[e_j] of expert e_j's buffer
    inv = torch.argsort(order, dim=-1)                        # flat -> sorted
    c_of_flat = inv - torch.gather(offsets, 1, flat_e)
    ok = c_of_flat < C
    vals = y[rows[:, None], flat_e, torch.where(ok, c_of_flat, 0)]
    vals = vals * ok[..., None].to(dt)                        # (R, T*k, D)
    out = vals.reshape(R, T, k, D).sum(dim=2)
    if squeeze:
        return out[0], aux[0]
    return out, aux


def moe(x3, p, cfg):
    """x3: (B, S, D) -> ((B, S, D), aux loss). The sorted dispatch at
    ``S >= 4 E`` (a row per batch row; ``moe_dispatch_chunk`` tokens at a
    time when ``S`` is a larger multiple of it), else the exact dense
    combine over all ``B S`` tokens."""
    B, S, D = x3.shape
    if cfg.moe_impl == "sorted" and S >= 4 * cfg.num_experts:
        C0 = cfg.moe_dispatch_chunk
        if S > C0 and S % C0 == 0:
            outs, auxs = [], []
            for i in range(S // C0):        # one chunk's buffers at a time
                o, a = moe_sorted(x3[:, i * C0:(i + 1) * C0], p, cfg)
                outs.append(o)
                auxs.append(a)
            return torch.cat(outs, dim=1), torch.mean(torch.stack(auxs))
        out, aux = moe_sorted(x3, p, cfg)
        return out, torch.mean(aux)
    out, aux = moe_dense(x3.reshape(B * S, D), p, cfg)
    return out.reshape(B, S, D), aux
