"""Parameter partitioning for the serving tier — the counterpart of
``repro/serve/sharding.py``.

The sharded server stores the global model as ONE flat f32 vector split
into ``n_shards`` contiguous, near-equal slices — the classic parameter-
server layout (each shard worker owns a key range). ``ShardSpec`` is the
bijection between that layout and the model's tree: it remembers the
tree's structure, per-leaf shapes/dtypes, and the shard boundaries, so
``flatten``/``unflatten`` round-trip exactly and ``split``/``join`` move
between the flat vector and the per-shard slices.

On one card every shard lives on the same device, the device of the
parameters the spec was built from: ``split`` returns views of the flat
vector and ``join`` concatenates on that device. A serving mesh (the JAX
package's ``mesh=``) is not ported (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import math
from typing import Any, List, Sequence

import torch

from ..kernels.fused_update.ops import tree_leaves, tree_map, tree_unflatten

__all__ = ["ShardSpec"]


class ShardSpec:
    """Static description of one model's shard partition.

    ``boundaries[i] : boundaries[i+1]`` is shard ``i``'s slice of the
    flat vector; the first ``total % n_shards`` shards hold one element
    more, and shards may be empty when ``n_shards`` exceeds the parameter
    count (valid, applied as zero-size ops).
    """

    def __init__(self, params: Any, n_shards: int, *, mesh=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if mesh is not None:
            raise NotImplementedError(
                "a serving mesh (shards over several devices) is not ported: "
                "every shard lives on the one card (ROADMAP Queue 1 item 9)")
        leaves = tree_leaves(params)
        if not leaves:
            raise ValueError("cannot shard an empty parameter pytree")
        # the tree's structure without its tensors (keeps none alive)
        self.treedef = tree_map(lambda _: None, params)
        self.shapes = [tuple(l.shape) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.total = sum(self.sizes)
        self.n_shards = int(n_shards)
        self.device = leaves[0].device
        # near-equal contiguous split (np.array_split semantics)
        base, extra = divmod(self.total, self.n_shards)
        bounds = [0]
        for i in range(self.n_shards):
            bounds.append(bounds[-1] + base + (1 if i < extra else 0))
        self.boundaries = tuple(bounds)

    # ---------------------------------------------------------- tree <-> flat
    def flatten(self, params: Any) -> torch.Tensor:
        """Tree -> one new flat f32 vector (serving-tier wire layout)."""
        leaves = tree_leaves(params)
        if len(leaves) != len(self.shapes):
            raise ValueError(
                f"pytree has {len(leaves)} leaves, spec built for "
                f"{len(self.shapes)}")
        return torch.cat([l.reshape(-1).float() for l in leaves])

    def unflatten(self, flat: torch.Tensor) -> Any:
        """Flat f32 vector -> tree with the original shapes/dtypes (f32
        leaves are views of ``flat``)."""
        if tuple(flat.shape) != (self.total,):
            raise ValueError(
                f"flat vector has shape {tuple(flat.shape)}, expected "
                f"({self.total},)")
        leaves, off = [], 0
        for shape, dtype, size in zip(self.shapes, self.dtypes, self.sizes):
            leaves.append(flat[off:off + size].reshape(shape).to(dtype))
            off += size
        return tree_unflatten(self.treedef, leaves)

    # -------------------------------------------------------- flat <-> shards
    def shard_slice(self, i: int) -> slice:
        return slice(self.boundaries[i], self.boundaries[i + 1])

    def shard_size(self, i: int) -> int:
        return self.boundaries[i + 1] - self.boundaries[i]

    def split(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Flat vector -> per-shard slices (contiguous views of it)."""
        return [flat[self.shard_slice(i)] for i in range(self.n_shards)]

    def join(self, slices: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-shard slices -> one new flat vector (the reader-side
        reassembly cost: one copy of the model)."""
        if len(slices) != self.n_shards:
            raise ValueError(
                f"got {len(slices)} slices for {self.n_shards} shards")
        return torch.cat(list(slices))

    # ------------------------------------------------------------ convenience
    def zeros_shards(self) -> List[torch.Tensor]:
        return self.split(torch.zeros(self.total, dtype=torch.float32,
                                      device=self.device))

    def __repr__(self):
        return (f"ShardSpec(total={self.total}, n_shards={self.n_shards}, "
                f"boundaries={self.boundaries})")
