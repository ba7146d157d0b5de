"""zamba2-2.7b [hybrid] — arXiv:2411.15242 (Mamba2 backbone + shared attn).

54L d_model=2560 32H (kv=32, head_dim=80) d_ff=10240 vocab=32000,
ssm_state=64. d_inner=5120, ssd head_dim 64 -> 80 SSD heads. Two shared
transformer blocks cycled every 6 mamba layers (9 invocations).
As in the JAX package, the shared blocks use standard pre-norm residual
wiring (no concat-reproject / per-invocation LoRA of upstream zamba2).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_ngroups=1,
    hybrid_period=6,
    num_shared_blocks=2,
    rope_theta=1e4,
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-2.7b-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=8,
    ssm_ngroups=1,
    hybrid_period=2,
    num_shared_blocks=2,
    remat="none",
)
