"""The simulator's device list for a padded user axis — the one-card part
of ``repro/launch/mesh.py``'s ``make_sim_mesh``.

The JAX package partitions the scan engine's per-user state over a 1-D
``("users",)`` mesh. The port's scan runs on one device: a ``SimMesh``
describes the devices a run of ``SimConfig.n_devices`` is sized to, and
the scan engine pads the user axis to a multiple of their count
(``core/engine_state.pad_to_devices``) and runs it on the first.
Partitioning the users over several GPUs waits for hardware that can
verify it (ROADMAP Queue 1 item 9). The reference's serving meshes,
``shard_placement`` and the ``set_mesh`` shims have no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class SimMesh(NamedTuple):
    """The devices of a user axis, in order; ``axis_names`` as the JAX
    mesh's."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("users",)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_sim_mesh(n_devices: int = 0, device="cuda") -> SimMesh:
    """``min(n_devices, available)`` devices of ``device``'s type, where
    available is ``torch.cuda.device_count()`` for CUDA and 1 for the CPU;
    ``n_devices=0`` means all of them (the JAX semantics). An explicit
    CUDA index starts the list there."""
    if n_devices < 0:
        raise ValueError(f"n_devices must be >= 0, got {n_devices}")
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "device='cuda' was asked for but no CUDA device is present; "
                "pass device='cpu' to run on the CPU")
        first = dev.index or 0
        avail = [torch.device("cuda", i) for i in range(first, count)]
    else:
        avail = [dev]
    d = len(avail) if n_devices == 0 else min(int(n_devices), len(avail))
    return SimMesh(tuple(avail[:d]))
