"""Fault tolerance for the async federation: heartbeats, straggler EWMAs,
elastic cohort membership — a copy of ``repro/fault/monitor.py`` (plain
Python): the LM trainer (``launch/train.py``) drives ``HeartbeatMonitor``
and ``StragglerDetector`` on its slot clock, and the serving tier's
ingestion pipeline (``serve/ingest.py``) a ``FleetMonitor``.

The paper's asynchronous design is itself the primary straggler mitigation —
no barrier means a slow island only stales, never stalls. These utilities
close the loop at datacenter scale: detect islands whose update cadence has
collapsed (failure or chronic straggle), evict them, re-queue their shard,
and let the Lyapunov queue re-absorb the arrival — membership is just A(t).

Both monitors take an injectable ``clock`` callable; ``SlotClock`` adapts
them to the simulator's slotted time (slot index * t_d seconds) so
``FleetMonitor`` can watch a simulated fleet's push stream — live or
replayed from a ``SimResult`` push log — and flag exactly the users the
device-dynamics layer (core/dynamics.py) churned off. Eviction is
non-final by design: an evicted user's next push re-registers it, the
server-side mirror of the simulator's recovered users re-entering the
arrival process.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set, Tuple


class SlotClock:
    """The simulator's slotted time as a monitor clock: ``advance()``/
    ``seek()`` move the slot cursor, calling the clock reads
    ``slot * t_d`` seconds. One instance shared by every monitor keeps
    heartbeat timeouts and straggler EWMAs on the same timeline."""

    def __init__(self, t_d: float = 1.0):
        if t_d <= 0:
            raise ValueError(f"t_d must be positive, got {t_d}")
        self.t_d = float(t_d)
        self.slot = 0

    def __call__(self) -> float:
        return self.slot * self.t_d

    def advance(self, slots: int = 1) -> None:
        self.slot += int(slots)

    def seek(self, slot: int) -> None:
        if slot < self.slot:
            raise ValueError(
                f"slot clock cannot rewind: at {self.slot}, asked for "
                f"{slot}")
        self.slot = int(slot)


@dataclasses.dataclass
class WorkerStats:
    last_seen: float
    ewma_interval: Optional[float] = None
    updates: int = 0


class HeartbeatMonitor:
    """Tracks last-seen times; a worker is dead after `timeout` seconds."""

    def __init__(self, timeout: float, clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.workers: Dict[str, WorkerStats] = {}

    def beat(self, worker_id: str):
        now = self.clock()
        w = self.workers.get(worker_id)
        if w is None:
            self.workers[worker_id] = WorkerStats(last_seen=now)
        else:
            w.last_seen = now

    def dead(self) -> Set[str]:
        now = self.clock()
        return {wid for wid, w in self.workers.items()
                if now - w.last_seen > self.timeout}

    def remove(self, worker_id: str):
        self.workers.pop(worker_id, None)


class StragglerDetector:
    """EWMA of per-worker update intervals; flags workers slower than
    `factor` x the cohort median."""

    def __init__(self, alpha: float = 0.3, factor: float = 3.0,
                 clock: Callable[[], float] = time.monotonic):
        self.alpha = alpha
        self.factor = factor
        self.clock = clock
        self.workers: Dict[str, WorkerStats] = {}

    def on_update(self, worker_id: str):
        now = self.clock()
        w = self.workers.setdefault(worker_id, WorkerStats(last_seen=now))
        if w.updates > 0:
            interval = now - w.last_seen
            w.ewma_interval = interval if w.ewma_interval is None else \
                self.alpha * interval + (1 - self.alpha) * w.ewma_interval
        w.last_seen = now
        w.updates += 1

    def median_interval(self) -> Optional[float]:
        xs = sorted(w.ewma_interval for w in self.workers.values()
                    if w.ewma_interval is not None)
        if not xs:
            return None
        return xs[len(xs) // 2]

    def stragglers(self) -> Set[str]:
        med = self.median_interval()
        if med is None:
            return set()
        return {wid for wid, w in self.workers.items()
                if w.ewma_interval is not None
                and w.ewma_interval > self.factor * med}

    def remove(self, worker_id: str):
        """Forget a worker (eviction): its stale EWMA must not skew the
        cohort median while it is gone; a later update re-registers it
        with a fresh history."""
        self.workers.pop(worker_id, None)


class FleetMonitor:
    """Heartbeat + straggler monitoring of a simulated fleet on ONE shared
    ``SlotClock``: every push in the simulator's push stream is a
    heartbeat and a cadence sample, ``sweep()`` evicts users whose last
    push is older than ``timeout_slots`` — exactly the users the
    device-dynamics layer churned off (or starved) — and an evicted
    user's next push re-registers it, mirroring the simulator's recovery
    path where a returned device re-enters the arrival process.

    Use it live (call ``observe_push``/``sweep`` from the serving tier)
    or post-hoc via ``replay(result.push_log, horizon)``.
    """

    def __init__(self, timeout_slots: int, t_d: float = 1.0, *,
                 alpha: float = 0.3, factor: float = 3.0):
        if timeout_slots <= 0:
            raise ValueError(
                f"timeout_slots must be positive, got {timeout_slots}")
        self.clock = SlotClock(t_d)
        self.heartbeat = HeartbeatMonitor(timeout_slots * t_d,
                                          clock=self.clock)
        self.straggler = StragglerDetector(alpha=alpha, factor=factor,
                                           clock=self.clock)
        self.evictions: List[Tuple[int, int]] = []   # (slot, user)

    def observe_push(self, slot: int, user: int) -> None:
        """One push event: heartbeat + cadence sample. Slots must be
        observed in nondecreasing order (the push stream's order)."""
        self.clock.seek(int(slot))
        self.heartbeat.beat(int(user))
        self.straggler.on_update(int(user))

    def observe_heartbeat(self, slot: int, user: int) -> None:
        """Liveness-only beat (no cadence sample): the serving tier calls
        this per shard PACKET, so a multi-shard push keeps its island
        alive while in flight without the burst of same-slot deliveries
        collapsing the straggler EWMA to zero intervals. Only completed
        pushes (``observe_push``) are cadence samples."""
        self.clock.seek(int(slot))
        self.heartbeat.beat(int(user))

    def sweep(self, slot: int) -> Set[int]:
        """Advance to ``slot`` and evict every user whose last push aged
        past the timeout. Eviction removes the user from BOTH monitors —
        its stale interval must not skew the straggler median — but is
        non-final: the next observed push re-registers it."""
        self.clock.seek(int(slot))
        dead = self.heartbeat.dead()
        for uid in sorted(dead):
            self.heartbeat.remove(uid)
            self.straggler.remove(uid)
            self.evictions.append((int(slot), uid))
        return dead

    def replay(self, push_log, horizon_slots: int,
               sweep_every: int = 1) -> List[Tuple[int, int]]:
        """Drive the monitor from a finished run's push log (a
        ``SimResult.push_log``): observe each slot's pushes, then sweep.
        Returns the eviction list ``[(slot, user), ...]``."""
        events = [(int(e["t"]), int(e["user"])) for e in push_log]
        k = 0
        for slot in range(int(horizon_slots)):
            while k < len(events) and events[k][0] == slot:
                self.observe_push(slot, events[k][1])
                k += 1
            if slot % max(int(sweep_every), 1) == 0:
                self.sweep(slot)
        return self.evictions

    @property
    def active(self) -> Set[int]:
        return set(self.heartbeat.workers)


class ElasticCohort:
    """Dynamic membership: join/leave/evict with shard reassignment. The
    training step itself never recompiles — only the arrival process A(t)
    changes (paper Def. 3)."""

    def __init__(self, shards: list):
        self.free_shards = list(shards)
        self.assignment: Dict[str, object] = {}

    def join(self, worker_id: str):
        if not self.free_shards:
            raise RuntimeError("no free shards; grow the shard pool")
        shard = self.free_shards.pop()
        self.assignment[worker_id] = shard
        return shard

    def leave(self, worker_id: str):
        shard = self.assignment.pop(worker_id, None)
        if shard is not None:
            self.free_shards.append(shard)
        return shard

    def evict(self, worker_ids) -> list:
        return [self.leave(w) for w in worker_ids]

    @property
    def active(self) -> Set[str]:
        return set(self.assignment)
