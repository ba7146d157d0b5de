"""Memory-aware auto-tuning of the device scan engine's shape knobs (the
counterpart of ``repro/core/autotune.py``, with the same arithmetic).

The scan (core/vector_engine.py) has two knobs:

- ``SimConfig.jax_chunk``: slots per chunk. The chunk-proportional
  device cost is the ``(chunk, rows)`` arrival slice, ``rows`` the users
  a device holds (``ceil(n / n_devices)``); ``jax_chunk=0`` resolves it
  here against the device's budget.
- the push buffer's capacity: pushes per chunk are bounded by the
  training cycle (a user trains at least ``min t_train`` seconds and sits
  out ``ready_delay`` + 1 slots between pushes), which at fleet scale is
  far tighter than the ``max(1024, 2 * n_users)`` default. An
  under-estimate stays safe: the engine re-runs an overflowing chunk
  with the buffer doubled.

The budget is a quarter of the card's memory (``torch.cuda.mem_get_info``'s
total) on CUDA, of the system RAM split over ``n_devices`` on the CPU (the
reference's forced host devices).
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from .simulator import n_slots

__all__ = ["autotune_scan_params", "device_memory_budget",
           "estimate_device_bytes"]

# Modeled per-user resident bytes of one scan row (f64/int64): 11
# EngineState leaves + 8 catalog gathers + up to 7 dynamics leaves at
# 8 B each — bool leaves round UP toward safety.
_STATE_BYTES_PER_USER = 26 * 8
# Arrival operands stay resident for the whole horizon: 1 B bool schedule
# + 4 B int32 app choice per user per slot.
_ARRIVAL_BYTES_PER_SLOT = 5
_PUSH_ROW_BYTES = 6 * 8           # (t, user, lag, gap, corun, weight) f64


def _next_pow2(k: int) -> int:
    c = 1
    while c < k:
        c <<= 1
    return c


def _prev_pow2(k: int) -> int:
    return _next_pow2(max(int(k), 1) + 1) >> 1 if k >= 1 else 1


def device_memory_budget(n_devices: int = 1, fraction: float = 0.25,
                         device="cuda") -> int:
    """Usable bytes a device for the scan's operands: ``fraction`` of the
    card's memory for a CUDA ``device``, else of the system RAM split over
    ``n_devices``. The fraction leaves room for the slot's temporaries and
    the rest of the process."""
    dev = torch.device(device)
    limit = None
    if dev.type == "cuda":
        limit = torch.cuda.mem_get_info(dev)[1]
    else:
        try:
            limit = (os.sysconf("SC_PAGE_SIZE")
                     * os.sysconf("SC_PHYS_PAGES")) // max(int(n_devices), 1)
        except (ValueError, OSError, AttributeError):
            limit = 4 << 30     # no sysconf (non-POSIX): assume 4 GiB
    return int(limit * fraction)


def estimate_device_bytes(n: int, T: int, chunk: int, capacity: int,
                          n_devices: int = 1, dyn_active: bool = False,
                          collect: bool = False) -> int:
    """Modeled peak bytes a device: its ``ceil(n / n_devices)`` resident
    state rows and whole-horizon arrival columns, the in-flight ``(chunk,
    rows)`` arrival slice, and the push buffer."""
    rows = -(-int(n) // max(int(n_devices), 1))
    per_user = _STATE_BYTES_PER_USER if dyn_active else 19 * 8
    per_slot = rows * _ARRIVAL_BYTES_PER_SLOT
    return int(rows * per_user + T * per_slot + chunk * per_slot
               + (capacity * _PUSH_ROW_BYTES if collect else 0))


def autotune_scan_params(sim, n_devices: int = 1, mem_bytes=None):
    """Pick ``(jax_chunk, push_capacity)`` for a built ``FederatedSim``
    from the memory budget of its device (``sim.device``), the users split
    over ``n_devices``; ``mem_bytes`` overrides the probed budget. Returns
    a namespace with the chosen knobs, the budget and the modeled
    footprint a device."""
    cfg = sim.cfg
    n, T = cfg.n_users, n_slots(cfg)
    D = max(int(n_devices), 1)
    rows = -(-n // D)
    budget = device_memory_budget(D, device=sim.device) \
        if mem_bytes is None else int(mem_bytes)
    # chunk: the in-flight (chunk, rows) arrival slice at most 1/8 of the
    # budget; at least 64 slots, at most 16384, never past the horizon
    per_slot = max(rows * _ARRIVAL_BYTES_PER_SLOT, 1)
    chunk = max(64, budget // (8 * per_slot))
    chunk = _prev_pow2(min(chunk, 16384))
    if T:
        chunk = min(chunk, T)
    # capacity: one push a training cycle per user, 2x safety, pow2, and
    # never more than half the budget
    tt = np.asarray(sim.fleet_spec.tables.t_train, dtype=float)
    cycle = max(float(tt.min()) / cfg.t_d + cfg.ready_delay + 1.0, 1.0) \
        if tt.size else 1.0
    per_chunk = n * min(chunk, T or chunk) / cycle
    cap = _next_pow2(max(int(2.0 * per_chunk) + 64, 1024))
    cap = min(cap, _next_pow2(max(budget // (2 * _PUSH_ROW_BYTES), 1024)))
    est = estimate_device_bytes(
        n, T, chunk, cap if cfg.collect_push_log else 0, D,
        dyn_active=sim.dynamics.active, collect=cfg.collect_push_log)
    return SimpleNamespace(jax_chunk=int(chunk), push_capacity=int(cap),
                           device_budget=int(budget),
                           est_bytes_per_device=int(est))
