from .config import ModelConfig
from .lenet import (LAYOUT, PARAM_COUNT, init_lenet, lenet_logits,
                    lenet_loss, params_from_jax, unflatten)
from .zoo import Model, build_model
