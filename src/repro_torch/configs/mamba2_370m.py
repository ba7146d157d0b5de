"""mamba2-370m [ssm] — SSD (state-space duality), arXiv:2405.21060.

48L d_model=1024, attention-free, vocab=50280, ssm_state=128.
d_inner = 2*1024 = 2048, head_dim 64 -> 32 SSD heads, ngroups 1, tied embeds.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_ngroups=1,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=128,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=8,
    ssm_ngroups=1,
    tie_embeddings=True,
    remat="none",
)
