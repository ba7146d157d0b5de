"""internvl2-76b [vlm] — arXiv:2404.16821 (InternViT + LLM backbone).

80L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=28672 vocab=128256.
The InternViT vision frontend is a STUB: the caller supplies 256
precomputed patch embeddings (B, 256, 8192) (``batch["vision_embeds"]``),
prepended to the text sequence.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    num_vision_tokens=256,
    rope_theta=5e5,
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-76b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    num_vision_tokens=8,
    remat="none",
)
