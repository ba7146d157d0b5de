"""The paper's optimizer mechanics at LM scale (``repro/optim``'s
counterpart); only ``gap.py``'s fused momentum update is ported so far."""
from .gap import fused_momentum_gap_update
