from .synthetic import (cifarlike_dataset, dirichlet_partition,
                        synthetic_tokens, token_batches)
from .loader import ShardedLoader

__all__ = ["cifarlike_dataset", "synthetic_tokens", "token_batches",
           "dirichlet_partition", "ShardedLoader"]
