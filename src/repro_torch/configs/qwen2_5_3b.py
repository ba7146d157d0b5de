"""qwen2.5-3b [dense] — hf:Qwen/Qwen2.5 family (GQA, QKV bias).

36L d_model=2048 16H (GQA kv=2, head_dim=128) d_ff=11008 vocab=151936.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2.5-3b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    qkv_bias=True,
    tie_embeddings=True,
    remat="none",
)
