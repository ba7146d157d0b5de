"""paper-lenet5 — the paper's own workload (LeNet-5 on CIFAR-10, Sec. VI).

Not an LM config (``build_model`` does not take it): the paper-faithful
federated simulation tier's workload (25 clients, local batch 20, momentum
SGD per Eq. 1). A copy of ``repro/configs/paper_lenet5.py``.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LeNetConfig:
    name: str = "paper-lenet5"
    family: str = "cnn"
    num_classes: int = 10
    in_channels: int = 3
    image_size: int = 32
    batch_size: int = 20          # paper Sec. VI: "retrieve in batch size of 20"
    learning_rate: float = 0.01
    momentum: float = 0.9         # beta in Eq. (1)


CONFIG = LeNetConfig()
SMOKE_CONFIG = LeNetConfig(name="paper-lenet5-smoke", image_size=32, batch_size=4)
