"""Fault tolerance for the async federation: heartbeats and straggler
EWMAs — a copy of ``repro/fault/monitor.py``'s ``HeartbeatMonitor`` and
``StragglerDetector`` (plain Python), which the LM trainer
(``launch/train.py``) drives on its slot clock.

The paper's asynchronous design is itself the primary straggler
mitigation — no barrier means a slow island only stales, never stalls.
These utilities detect islands whose update cadence has collapsed.
``SlotClock``, ``FleetMonitor`` and ``ElasticCohort`` are still to port
with the serving tier (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Set


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
