from .lenet import (LAYOUT, PARAM_COUNT, init_lenet, lenet_logits,
                    lenet_loss, params_from_jax, unflatten)
