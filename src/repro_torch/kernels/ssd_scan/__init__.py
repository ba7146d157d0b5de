from .kernel import ssd_intra_chunk_cuda
from .ops import ssd_chunked
from .ref import ssd_chunked_ref, ssd_intra_chunk_ref
