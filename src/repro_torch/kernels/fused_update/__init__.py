from .kernel import KMAX, fused_apply_triton, fused_update_triton
from .ops import (KERNEL_MODES, check_kernel_mode, fused_apply_cohort,
                  fused_apply_flat, fused_momentum_gap_update,
                  fused_update_flat, fused_weighted_apply)
from .ref import (fused_apply_cohort_ref, fused_apply_flat_ref,
                  fused_update_flat_ref)
