"""whisper-large-v3 [audio] — arXiv:2212.04356, enc-dec.

32L(enc)+32L(dec) d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866.
The conv mel frontend is a STUB: the caller supplies precomputed
(B, 1500, 1280) frame embeddings (``batch["audio_embeds"]``). LayerNorm +
GELU MLP; learned encoder positions; the decoder applies RoPE at the
default theta, as the JAX package's code does (upstream whisper uses
learned decoder positions capped at 448).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    is_encoder_decoder=True,
    encoder_layers=32,
    encoder_seq=1500,
    norm_type="layernorm",
    mlp_act="gelu",
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-large-v3-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    is_encoder_decoder=True,
    encoder_layers=2,
    encoder_seq=24,
    norm_type="layernorm",
    mlp_act="gelu",
    remat="none",
)
