"""granite-moe-1b-a400m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base.

24L d_model=1024 16H (GQA kv=8) per-expert d_ff=512, vocab=49155,
MoE 32 experts top-8, tied embeddings.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=32,
    num_experts_per_tok=8,
    moe_impl="sorted",
    router_norm_topk=True,
    tie_embeddings=True,
    rope_theta=1e4,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-moe-1b-a400m-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=32,
    vocab_size=128,
    num_experts=4,
    num_experts_per_tok=2,
    moe_impl="sorted",
    router_norm_topk=True,
    tie_embeddings=True,
    remat="none",
)
