from .kernel import flash_attention_cuda
from .ops import flash_attention
from .ref import attention_ref
