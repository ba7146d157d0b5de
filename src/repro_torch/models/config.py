"""Model configuration for every architecture family in the zoo.

A copy of ``repro/models/config.py`` (plain Python, no JAX): one frozen
dataclass covers dense / MoE / SSM / hybrid / enc-dec / VLM families,
every one of which the port builds (``models/zoo.py``); family-specific
fields default to "off", and one config describes an architecture in both
packages. Exact assigned configs live in
``repro_torch.configs.<arch_id>``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0          # 0 => attention-free (pure SSM)
    num_kv_heads: int = 0
    d_ff: int = 0               # dense MLP hidden (per-expert hidden for MoE)
    vocab_size: int = 0
    head_dim: int = 0           # 0 => d_model // num_heads

    # --- attention options -------------------------------------------------
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    causal: bool = True
    attention_impl: str = "xla"   # xla (einsum) | chunked (blocked online-
                                  # softmax, fits 32k+) | flash (pallas, TPU)
    attn_q_block: int = 512       # q-block rows for the chunked impl

    # --- MLP / norm options -------------------------------------------------
    mlp_act: str = "silu"         # silu (SwiGLU) | gelu (plain GELU MLP)
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_impl: str = "dense"       # dense (one-hot einsum) | sorted (capacity gather)
    moe_dispatch_chunk: int = 4096  # sorted dispatch row length: long
                                  # sequences are split into chunks so the
                                  # (E, C, D) gather buffers stay bounded
    router_norm_topk: bool = True

    # --- SSM (Mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_kernel: int = 4
    ssm_ngroups: int = 1

    # --- hybrid (zamba2-style shared attention blocks) -----------------------
    hybrid_period: int = 0        # insert a shared attn block every k ssm layers
    num_shared_blocks: int = 0    # number of distinct shared blocks (alternating)

    # --- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500       # whisper mel-frame count after conv frontend
    encoder_causal: bool = False

    # --- VLM ------------------------------------------------------------------
    num_vision_tokens: int = 0    # stubbed ViT patch embeddings prepended

    # --- numerics --------------------------------------------------------------
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"

    # --- training-step options ---------------------------------------------------
    remat: str = "full"           # none | full  (activation checkpoint per layer)
    logits_softcap: float = 0.0
    scan_layers: bool = True      # False => python-unrolled stacks. Used by the
                                  # dry-run flop calibration (XLA CPU cost
                                  # analysis counts while bodies once) and by
                                  # hillclimb experiments; semantics identical.
    parallel_layout: str = "tp"   # tp: weights sharded over "model" (the
                                  # default); dp: weights replicated and the
                                  # batch sharded over EVERY mesh axis — the
                                  # winning layout for sub-1B archs whose TP
                                  # activation psums dominate the roofline.
    shard_activations: bool = False  # sequence parallelism: constrain the
                                  # residual stream's seq dim onto "model"
                                  # between layers (norms are free under SP;
                                  # GSPMD inserts the gather before attention)
                                  # — shrinks the per-device remat stack L x
                                  # (B,S,D) by the TP degree.

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family in ("ssm", "hybrid") and not self.ssm_state:
            raise ValueError(f"{self.name}: ssm family requires ssm_state")
        if self.family == "moe" and not self.num_experts:
            raise ValueError(f"{self.name}: moe family requires num_experts")

    # Derived quantities -----------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is O(1) in sequence length (SSM recurrence)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (exact for our zoo definitions)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.head_dim
        n = V * D  # embed
        if not self.tie_embeddings:
            n += D * V  # lm_head

        def attn_params() -> int:
            a = D * self.num_heads * hd + D * self.num_kv_heads * hd * 2
            a += self.num_heads * hd * D  # o_proj
            if self.qkv_bias:
                a += (self.num_heads + 2 * self.num_kv_heads) * hd
            if self.qk_norm:
                a += 2 * hd
            return a

        def mlp_params(f: int) -> int:
            if self.mlp_act == "silu":
                return 3 * D * f
            return 2 * D * f + f + D   # plain MLP carries biases

        norm = 2 * D if self.norm_type == "layernorm" else D

        def ssm_params() -> int:
            di, g, s, nh = self.d_inner, self.ssm_ngroups, self.ssm_state, self.ssm_nheads
            p = D * (2 * di + 2 * g * s + nh)            # in_proj (z,x,B,C,dt)
            p += (self.ssm_conv_kernel + 1) * (di + 2 * g * s)  # conv w + b
            p += nh * 3                                   # A_log, D_skip, dt_bias
            p += di                                       # gated norm
            p += di * D                                   # out_proj
            return p

        per_layer = 0
        if self.family in ("dense", "vlm"):
            per_layer = attn_params() + mlp_params(F) + 2 * norm
            n += L * per_layer
        elif self.family == "moe":
            expert = 3 * D * F  # SwiGLU experts
            per_layer = attn_params() + D * self.num_experts + self.num_experts * expert + 2 * norm
            n += L * per_layer
        elif self.family == "ssm":
            n += L * (ssm_params() + norm)
        elif self.family == "hybrid":
            n += L * (ssm_params() + norm)
            shared = attn_params() + mlp_params(F) + 2 * norm
            n += self.num_shared_blocks * shared
        elif self.family == "audio":
            enc_layer = attn_params() + mlp_params(F) + 2 * norm
            dec_layer = 2 * attn_params() + mlp_params(F) + 3 * norm  # self+cross
            n += self.encoder_layers * enc_layer + L * dec_layer
            n += self.encoder_seq * D  # learned encoder positions
            n += norm                  # encoder final norm
        n += norm  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        expert = 3 * self.d_model * self.d_ff
        inactive = self.num_layers * (self.num_experts - self.num_experts_per_tok) * expert
        return self.param_count() - inactive
