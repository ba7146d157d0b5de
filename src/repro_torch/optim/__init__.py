"""The paper's optimizer mechanics at LM scale (``repro/optim``'s
counterpart): the optimizers, the fused K2/K1 updates with the gap
helpers, and push compression."""
from .optimizers import (OptState, adamw, momentum_sgd, apply_updates,
                         global_norm, clip_by_global_norm)
from .gap import (fused_momentum_gap_update, fused_weighted_apply,
                  gap_aware_scale, delay_compensate)
from .compression import (topk_compress, topk_decompress, int8_quantize,
                          int8_dequantize, ErrorFeedback)

__all__ = [
    "OptState", "adamw", "momentum_sgd", "apply_updates", "global_norm",
    "clip_by_global_norm",
    "fused_momentum_gap_update", "fused_weighted_apply", "gap_aware_scale",
    "delay_compensate",
    "topk_compress", "topk_decompress", "int8_quantize", "int8_dequantize",
    "ErrorFeedback",
]
