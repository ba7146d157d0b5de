"""phi4-mini-3.8b [dense] — arXiv:2412.08905 (RoPE, SwiGLU, GQA).

32L d_model=3072 24H (GQA kv=8, head_dim=128) d_ff=8192 vocab=200064.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,
    rope_theta=1e4,
)

SMOKE_CONFIG = ModelConfig(
    name="phi4-mini-3.8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    tie_embeddings=True,
    remat="none",
)
