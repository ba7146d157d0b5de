"""qwen3-0.6b [dense] — hf:Qwen/Qwen3 family (qk_norm, GQA).

28L d_model=1024 16H (GQA kv=8, head_dim=128) d_ff=3072 vocab=151936.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-0.6b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    qk_norm=True,
    tie_embeddings=True,
    remat="none",
)
