"""internlm2-20b [dense] — arXiv:2403.17297 (GQA).

48L d_model=6144 48H (GQA kv=8, head_dim=128) d_ff=16384 vocab=92544.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="internlm2-20b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=128,
    remat="none",
)
