"""The Mamba2 (SSD, state-space duality) block — the counterpart of
``repro/models/ssm.py``.

Chunked SSD (arXiv:2405.21060): within a chunk the recurrence is a masked
quadratic, attention-like product; across chunks a cheap loop carries the
(heads, state, head_dim) state. The intra-chunk step is K3
(``kernels/ssd_scan``, the CUDA kernel on CUDA tensors), which the JAX
package documents as the drop-in for its XLA ``ssd_chunked``. It takes
the per-group B and C projections as they come out of the conv (views,
never repeated over a group's heads). In f32, K3 reads X, B and C as
f32, where the JAX XLA path forms ``C B^T`` in the activation dtype; the
two agree at f32 rounding in the f32 variant of a config. In bf16 the
CUDA kernel runs its products on the tensor cores and rounds G o M, dt X
and B exp(cum_Q - cum) to bf16 (``ref.ssd_intra_chunk_ref_bf16``). K3 has
no backward: a training step through it raises on CUDA.

Decode is the O(1)-per-token recurrence over the same state. Its conv
state is f32 (``init_ssm_state``), so, as in JAX, the decode conv and X
run in f32: ``jnp.concatenate`` and ``einsum`` promote mixed dtypes where
torch does not, so the casts are written out.

A state passed to ``ssm_block`` / ``ssm_decode_step`` is updated IN PLACE
and returned (JAX's functional update is donated, so it too keeps one
copy).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_chunked as ssd_chunked_kernel
from .common import dense_init, rms_norm


def init_ssm(generator, cfg):
    D, di = cfg.d_model, cfg.d_inner
    g, s, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    K = cfg.ssm_conv_kernel
    ch = di + 2 * g * s
    return {
        "w_z": dense_init(generator, D, di),
        "w_x": dense_init(generator, D, di),
        "w_B": dense_init(generator, D, g * s),
        "w_C": dense_init(generator, D, g * s),
        "w_dt": dense_init(generator, D, nh),
        "conv_w": (K ** -0.5) * torch.randn((K, ch), generator=generator,
                                            device=generator.device),
        "conv_b": torch.zeros(ch),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh)),  # A in [-16, -1]
        "D_skip": torch.ones(nh),
        "dt_bias": torch.full((nh,), math.log(math.expm1(0.01))),
        "norm": torch.zeros(di),
        "w_out": dense_init(generator, di, D),
    }


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d as the sum of K shifted, scaled copies in
    order, in the input dtype. xBC: (B, S, Ch), w: (K, Ch)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    return out + b[None, None, :].to(out.dtype)


def _project(x, p, cfg):
    dt_ = x.dtype
    return tuple(x @ p[k].to(dt_) for k in ("w_z", "w_x", "w_B", "w_C",
                                            "w_dt"))


def ssd_chunked(X, dtv, A, Bh, Ch, chunk: int, init_state=None, *,
                kernel: str = "auto"):
    """Chunked SSD scan of any length: pads S to a chunk multiple with
    dt = 0 steps (decay exp(0) = 1, increment 0: state-neutral), runs the
    K3 wrapper and slices the padding off.

    X: (B, S, nh, p); dtv: (B, S, nh) softplus'd; A: (nh,) negative;
    Bh/Ch: (B, S, g, s), shared by the nh / g heads of a group (g = nh:
    per head). Returns y (B, S, nh, p) in X's dtype and the
    final state (B, nh, s, p) f32."""
    S = X.shape[1]
    pad = (-S) % chunk
    if pad:
        X, dtv, Bh, Ch = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                          for t in (X, dtv, Bh, Ch))
    y, final = ssd_chunked_kernel(X, dtv, A, Bh, Ch, chunk, init_state,
                                  kernel=kernel)
    return y[:, :S], final


def ssm_block(x, p, cfg, state=None, *, kernel: str = "auto"):
    """Full Mamba2 block (no residual). x: (B, S, D).

    state: None for training; {"conv": (B, K-1, Ch), "ssd": (B, nh, s, p)}
    for prefill, updated in place. Returns (out, state or None)."""
    B_, S, _ = x.shape
    g, s, nh, ph = (cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                    cfg.ssm_head_dim)
    di = cfg.d_inner
    z, xin, Bp, Cp, dt_raw = _project(x, p, cfg)
    conv_in = torch.cat([xin, Bp, Cp], dim=-1)
    xBC = F.silu(_causal_conv(conv_in, p["conv_w"].to(x.dtype),
                              p["conv_b"]))
    xin, Bp, Cp = torch.split(xBC, [di, g * s, g * s], dim=-1)

    dtv = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    X = xin.reshape(B_, S, nh, ph)
    # the group projections as views (B, S, g, s): K3 reads each group's
    # B and C once for its nh / g heads
    Bg, Cg = Bp.reshape(B_, S, g, s), Cp.reshape(B_, S, g, s)

    init_state = state["ssd"] if state is not None else None
    y, final = ssd_chunked(X, dtv, A, Bg, Cg, cfg.ssm_chunk, init_state,
                           kernel=kernel)
    y = y + p["D_skip"].to(x.dtype)[None, None, :, None] * X
    y = y.reshape(B_, S, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["w_out"].to(x.dtype)

    if state is not None:
        # the new conv state: the last K-1 rows of the pre-activation
        # projections (the JAX block recomputes the same products)
        K = cfg.ssm_conv_kernel
        state["conv"].copy_(conv_in[:, -(K - 1):, :])
        state["ssd"].copy_(final)
    return out, state


def ssm_decode_step(x, p, cfg, state):
    """One-token recurrent decode. x: (B, 1, D); state {"conv", "ssd"},
    updated in place and returned with ``out``."""
    B_ = x.shape[0]
    g, s, nh, ph = (cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                    cfg.ssm_head_dim)
    di = cfg.d_inner
    dt_ = x.dtype
    z, xin, Bp, Cp, dt_raw = _project(x, p, cfg)
    new_in = torch.cat([xin, Bp, Cp], dim=-1)                    # (B,1,Ch)
    # the f32 conv state promotes the window (jnp.concatenate promotes)
    cdt = torch.promote_types(state["conv"].dtype, dt_)
    window = torch.cat([state["conv"].to(cdt), new_in.to(cdt)], dim=1)
    conv = torch.einsum("bkc,kc->bc", window,
                        p["conv_w"].to(dt_).to(cdt)) \
        + p["conv_b"].to(dt_).to(cdt)
    xBC = F.silu(conv)[:, None, :]                               # (B,1,Ch)
    xin, Bp, Cp = torch.split(xBC, [di, g * s, g * s], dim=-1)

    dtv = F.softplus(dt_raw[:, 0, :].float() + p["dt_bias"])     # (B,nh)
    A = -torch.exp(p["A_log"])
    dec = torch.exp(dtv * A)
    X = xin.reshape(B_, nh, ph).float()
    hpg = nh // g
    Bh = torch.repeat_interleave(Bp.reshape(B_, g, s), hpg, dim=1).float()
    Ch = torch.repeat_interleave(Cp.reshape(B_, g, s), hpg, dim=1).float()

    S_new = dec[:, :, None, None] * state["ssd"] + \
        torch.einsum("bns,bnp,bn->bnsp", Bh, X, dtv)
    y = torch.einsum("bns,bnsp->bnp", Ch, S_new) + \
        p["D_skip"][None, :, None] * X
    y = y.reshape(B_, 1, di).to(dt_)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["w_out"].to(dt_)
    state["conv"].copy_(window[:, 1:, :])
    state["ssd"].copy_(S_new)
    return out, state


def init_ssm_state(cfg, batch: int, dtype=torch.float32, device="cpu"):
    g, s = cfg.ssm_ngroups, cfg.ssm_state
    ch = cfg.d_inner + 2 * g * s
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_kernel - 1, ch),
                            dtype=dtype, device=device),
        "ssd": torch.zeros((batch, cfg.ssm_nheads, s, cfg.ssm_head_dim),
                           device=device),
    }
