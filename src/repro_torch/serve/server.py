"""Sharded async parameter server: the datacenter serving tier — the
counterpart of ``repro/serve/server.py``.

Semantically a twin of ``core/server.AsyncParameterServer`` — same pull /
push protocol, same ``AggregationRule`` application, same Eq. (4)
staleness bookkeeping — but the global model lives as ``n_shards``
contiguous slices of one flat f32 vector (``ShardSpec``), and a push is
applied SHARD-LOCAL: one K1 launch a shard
(``kernels/fused_update.fused_apply_flat`` on the shard's flat f32
slice) computes the weighted mix, the momentum update and the shard's
squared momentum norm in one pass. A push is ``n_shards`` K1 launches;
the cross-shard norm is reduced on the host. On one card every shard
lives on the same device.

Consistency contract (pinned by tests/test_torch_serve_tier.py):

- **Replicated bookkeeping.** The version counter, the Eq. (4) gap
  inputs (``v_norm``), and the lag table are scheduler state, not model
  state — every shard carries its own copy of the version and they must
  agree (``assert_consistent``). A reader's snapshot always pairs a
  version with exactly the shard tuple published at that version.
- **Atomic publish.** A push's shard applies are computed first, then
  committed under the publish lock as one swap of the shard tuple +
  version + ``v_norm``. Readers (``pull``/``snapshot_flat``) take the
  same lock for the duration of a tuple read, so no reader ever observes
  a partially applied push. Published shard tensors are shared by
  reference and never written again: K1 allocates its outputs, so a
  snapshot stays valid after the lock drops.
- **Version history ring.** The last ``history_depth`` published shard
  tuples are retained so delta-coded pushes (``serve/codecs.py``) can be
  reconstructed against the exact base the client pulled. A base that
  aged out falls back to the current params (counted, approximate). Each
  retained version holds a whole model: 2.22 GiB at Qwen3-0.6B's width.
- **One stream.** K1's ticket counter and partial sums are per-device
  scratch, so every launch runs on the current stream under the push
  lock.

The momentum bookkeeping matches the core server element for element:
``s = (theta_old - theta_new) / eta``, ``v <- beta v + (1-beta) s``,
``v_norm = ||v||_2`` — computed per shard and reduced, so p' and v' equal
the unsharded server's bit for bit and ``v_norm`` differs only by the
order of the sums.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.aggregation import AggregationRule, configure_aggregation
from ..core.server import PushResult
from ..core.staleness import LagTracker, gradient_gap
from ..device import resolve_device
from ..kernels.fused_update import check_kernel_mode, fused_apply_flat
from ..kernels.fused_update.ops import tree_map
from .sharding import ShardSpec

__all__ = ["ShardedAsyncParameterServer"]


class _ShardState:
    """One shard's replicated-bookkeeping cell: slice + momentum slice +
    its own copy of the version counter."""

    __slots__ = ("params", "momentum", "version")

    def __init__(self, params, momentum):
        self.params = params
        self.momentum = momentum
        self.version = 0


class ShardedAsyncParameterServer:
    """Drop-in async parameter server with a sharded parameter store.

    Implements the ``AsyncParameterServer`` surface (``pull``/``push``/
    ``lag_estimate``/``params``/``v_norm``/``in_flight``/``lag_tracker``)
    plus the flat serving-tier paths the ingestion pipeline uses
    (``pull_flat``/``push_flat``/``base_shard``/``snapshot_flat``).
    ``kernel`` picks how K1 runs (``auto``: Triton on CUDA tensors, the
    plain version on CPU tensors); ``device`` is CUDA unless the caller
    asks for the CPU.
    """

    def __init__(self, params: Any, eta: float, beta: float,
                 aggregation: Union[str, AggregationRule] = "replace",
                 n_shards: int = 1, *, mesh=None, history_depth: int = 64,
                 fedasync_alpha: float = 0.6, fedasync_a: float = 0.5,
                 gap_ref: float = 1.0, fleet=None, kernel: str = "auto",
                 device="cuda"):
        if history_depth < 1:
            raise ValueError(
                f"history_depth must be >= 1, got {history_depth}")
        self.eta = float(eta)
        self.beta = float(beta)
        self.rule: AggregationRule = configure_aggregation(
            aggregation, fedasync_alpha=fedasync_alpha,
            fedasync_a=fedasync_a, gap_ref=gap_ref)
        self.aggregation = self.rule.name
        self.fleet_spec = fleet
        self.kernel = check_kernel_mode(kernel)
        self.device = resolve_device(device)
        params = tree_map(lambda p: p.to(self.device), params)
        self.spec = ShardSpec(params, n_shards, mesh=mesh)
        self._shards: List[_ShardState] = [
            _ShardState(p, torch.zeros_like(p))
            for p in self.spec.split(self.spec.flatten(params))]
        self.lag_tracker = LagTracker()
        self.v_norm = 0.0
        self.in_flight: set = set()
        self.history_depth = int(history_depth)
        self._history: "OrderedDict[int, Tuple[torch.Tensor, ...]]" = \
            OrderedDict()
        self._push_lock = threading.Lock()   # serializes appliers
        self._pub_lock = threading.Lock()    # guards reader snapshots
        self.ring_misses = 0
        self._publish(bump=False)

    # ------------------------------------------------------------ publish
    def _publish(self, bump: bool) -> None:
        """Commit the current shard tuple as one atomic version step."""
        snap = tuple(s.params for s in self._shards)
        with self._pub_lock:
            if bump:
                for s in self._shards:
                    s.version += 1
            self._published = snap
            self._history[self.version] = snap
            while len(self._history) > self.history_depth:
                self._history.popitem(last=False)

    @property
    def version(self) -> int:
        return self.lag_tracker.version

    @property
    def n_shards(self) -> int:
        return self.spec.n_shards

    @property
    def params(self) -> Any:
        """Assembled tree view of the latest published snapshot (a new
        copy of the model)."""
        flat, _ = self.snapshot_flat()
        return self.spec.unflatten(self.spec.join(flat))

    @params.setter
    def params(self, value: Any) -> None:
        """Wholesale replacement (checkpoint restore): re-split over the
        shards and republish at the current version. Momentum is kept —
        restore-then-continue matches the core server, which also leaves
        its momentum untouched on assignment."""
        flat = self.spec.flatten(value).to(self.device)
        with self._push_lock:
            for st, piece in zip(self._shards, self.spec.split(flat)):
                st.params = piece
            self._publish(bump=False)

    def assert_consistent(self) -> None:
        """Replication invariant: every shard's version copy equals the
        lag tracker's global counter, and the published snapshot is the
        current shard tuple."""
        vs = {s.version for s in self._shards}
        if vs != {self.lag_tracker.version}:
            raise AssertionError(
                f"shard versions {sorted(vs)} diverged from global "
                f"version {self.lag_tracker.version}")
        with self._pub_lock:
            cur = tuple(s.params for s in self._shards)
            if any(a is not b for a, b in zip(cur, self._published)):
                raise AssertionError(
                    "published snapshot is not the current shard tuple")

    # ------------------------------------------------------------ readers
    def snapshot_flat(self) -> Tuple[Tuple[torch.Tensor, ...], int]:
        """(shard tuple, version) — atomic, zero-copy (published shard
        tensors are never written again)."""
        with self._pub_lock:
            return self._published, self.lag_tracker.version

    def pull(self, client_id) -> Tuple[Any, int]:
        shards, version = self.snapshot_flat()
        self.lag_tracker.on_pull(client_id)
        self.in_flight.add(client_id)
        return self.spec.unflatten(self.spec.join(shards)), version

    def pull_flat(self, client_id) -> Tuple[Tuple[torch.Tensor, ...], int]:
        """Serving-tier pull: the per-shard tuple, no reassembly."""
        shards, version = self.snapshot_flat()
        self.lag_tracker.on_pull(client_id)
        self.in_flight.add(client_id)
        return shards, version

    def base_shard(self, version: int,
                   shard: int) -> Optional[torch.Tensor]:
        """Shard slice as published at ``version``, or None when that
        version aged out of the history ring (the caller counts the miss
        and falls back to the current slice)."""
        with self._pub_lock:
            snap = self._history.get(int(version))
            if snap is None:
                self.ring_misses += 1
                return None
            return snap[shard]

    def lag_estimate(self, client_id) -> int:
        """Alg. 2 line 4: server-side lag estimate = concurrent tasks."""
        return max(len(self.in_flight)
                   - (1 if client_id in self.in_flight else 0), 0)

    # ------------------------------------------------------------ push
    def push(self, client_id, new_params: Any) -> PushResult:
        """Full-tree push (AsyncParameterServer-compatible path)."""
        flat = self.spec.flatten(new_params).to(self.device)
        return self.push_flat(client_id, self.spec.split(flat))

    def push_flat(self, client_id,
                  new_slices: Sequence[torch.Tensor]) -> PushResult:
        """Apply one complete push given per-shard slices: the ingestion
        pipeline's commit path. One K1 launch a shard; the version/
        bookkeeping commit is one atomic publish."""
        if len(new_slices) != self.spec.n_shards:
            raise ValueError(
                f"push carries {len(new_slices)} slices for "
                f"{self.spec.n_shards} shards")
        with self._push_lock:
            lag = self.lag_tracker.lag(client_id)
            # Eq. (4) gap at push arrival, shared by rule weight and result
            gap = gradient_gap(self.v_norm, lag, self.eta, self.beta)
            weight = float(self.rule.weight(lag, gap, self.v_norm,
                                            fleet=self.fleet_spec,
                                            users=client_id))
            inv_eta = 1.0 / max(self.eta, 1e-12)
            sqs = []
            for st, new in zip(self._shards, new_slices):
                new = new.to(device=self.device, dtype=torch.float32)
                st.params, st.momentum, sq = fused_apply_flat(
                    st.params, st.momentum, new.contiguous(), weight,
                    inv_eta, self.beta, kernel=self.kernel)
                sqs.append(sq)
            # cross-shard norm reduction on the host, in f32 as the JAX
            # server sums its per-shard scalars
            self.v_norm = float(np.sqrt(np.sum(
                torch.stack(sqs).cpu().numpy().astype(np.float32))))
            returned_lag = self.lag_tracker.on_push(client_id)
            self.in_flight.discard(client_id)
            self._publish(bump=True)
        return PushResult(lag=returned_lag, gap_estimate=gap,
                          applied_weight=weight,
                          version=self.lag_tracker.version)
