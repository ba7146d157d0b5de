from .kernel import ssd_intra_chunk_cuda
from .ops import ssd_chunked
from .ref import (bf16_bound, bf16_rounding_slack, ssd_chunked_ref,
                  ssd_intra_chunk_ref, ssd_intra_chunk_ref_bf16)
