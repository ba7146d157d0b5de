"""Push ingestion pipeline: bounded queue, staging, faults, exactly-once —
the counterpart of ``repro/serve/ingest.py``.

The wire unit is a ``ShardPacket`` — one shard's payload of one client
push. Packets flow through a bounded ``PushQueue`` (backpressure: a full
queue REJECTS, the client retries — sheds load instead of buffering
unboundedly), are decoded per-shard by the configured codec, and staged
until every shard of the push has arrived; only then does the push commit
through ``ShardedAsyncParameterServer.push_flat`` as ONE atomic apply
(one K1 launch a shard).
Readers can never observe a partial push: incomplete pushes live in the
staging area, not in the published params.

Fault model (``fault/monitor.py`` wired in live):

- every packet is a liveness heartbeat (``FleetMonitor.observe_heartbeat``)
  and every COMMITTED push a cadence sample (``observe_push``);
- ``sweep(slot)`` evicts islands whose last packet aged past the monitor
  timeout — a death MID-PUSH leaves staged shards and maybe queued
  packets behind: both are parked under the island's id (the in-flight
  shards are re-queued on recovery, so no push is lost);
- an evicted island's next packet RE-REGISTERS it: parked packets go
  back on the queue (front — they are oldest), parked staging is
  restored, and the push completes and commits exactly once;
- exactly-once: per-client ``push_id``s are monotone; a packet whose
  push already committed is counted a duplicate and dropped, and a
  re-delivered shard of an in-flight push overwrites its staged twin.

``ServeClient`` is the client-side half used by tests and the benchmark:
it pulls a base snapshot, encodes per shard (stateful codecs key on
``(client, shard)``), and can deliberately send only a subset of shards —
the fault-injection hook for island-death-mid-push scenarios.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

import torch

from ..fault.monitor import FleetMonitor

from .codecs import ShardCodec, resolve_codec
from .server import ShardedAsyncParameterServer

__all__ = ["ShardPacket", "PushQueue", "IngestStats", "IngestPipeline",
           "ServeClient"]


@dataclasses.dataclass
class ShardPacket:
    client: int
    push_id: int
    shard: int
    n_shards: int
    base_version: int
    payload: Any
    slot: int


@dataclasses.dataclass
class IngestStats:
    enqueued: int = 0
    rejected: int = 0          # backpressure: queue full at offer
    applied: int = 0           # pushes committed (atomic, whole-push)
    duplicates: int = 0        # packets for already-committed pushes
    evicted: int = 0           # island evictions (monitor sweep)
    reregistered: int = 0      # evicted islands that came back
    parked_packets: int = 0    # queued packets parked by an eviction
    requeued_packets: int = 0  # parked packets put back on the queue
    ring_misses: int = 0       # delta decode against an aged-out base

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class PushQueue:
    """Bounded FIFO of ``ShardPacket``s with reject-on-full semantics."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def offer(self, pkt: ShardPacket) -> bool:
        if len(self._q) >= self.capacity:
            return False
        self._q.append(pkt)
        return True

    def pop(self) -> Optional[ShardPacket]:
        return self._q.popleft() if self._q else None

    def requeue_front(self, pkts: Sequence[ShardPacket]) -> None:
        """Parked packets return ahead of newer traffic (they are the
        oldest in-flight work)."""
        for pkt in reversed(list(pkts)):
            self._q.appendleft(pkt)

    def extract_client(self, client: int) -> List[ShardPacket]:
        """Remove and return every queued packet of ``client`` (eviction
        parking), preserving order."""
        mine = [p for p in self._q if p.client == client]
        if mine:
            self._q = deque(p for p in self._q if p.client != client)
        return mine


class IngestPipeline:
    """Server-side ingestion: queue -> decode -> stage -> atomic commit."""

    def __init__(self, server: ShardedAsyncParameterServer, *,
                 capacity: int = 4096,
                 codec: Union[str, ShardCodec, None] = None,
                 monitor: Optional[FleetMonitor] = None):
        self.server = server
        self.queue = PushQueue(capacity)
        self.codec = resolve_codec(codec)
        self.monitor = monitor
        self.stats = IngestStats()
        self.latencies: List[float] = []        # seconds, per committed push
        # (client, push_id) -> {shard -> decoded f32 slice}
        self._staging: "OrderedDict[Tuple[int, int], Dict[int, Any]]" = \
            OrderedDict()
        self._parked_staging: Dict[int, Dict[Tuple[int, int],
                                             Dict[int, Any]]] = {}
        self._parked_packets: Dict[int, List[ShardPacket]] = {}
        self._last_committed: Dict[int, int] = {}
        self._first_seen: Dict[Tuple[int, int], float] = {}

    # ------------------------------------------------------------ intake
    def submit(self, pkt: ShardPacket) -> bool:
        """Offer one packet; False = backpressure (client should retry)."""
        if not self.queue.offer(pkt):
            self.stats.rejected += 1
            return False
        self.stats.enqueued += 1
        self._first_seen.setdefault((pkt.client, pkt.push_id),
                                    time.perf_counter())
        return True

    # ------------------------------------------------------------ processing
    def step(self, max_packets: Optional[int] = None) -> int:
        """Process up to ``max_packets`` queued packets (all by default);
        returns the number processed."""
        done = 0
        while max_packets is None or done < max_packets:
            pkt = self.queue.pop()
            if pkt is None:
                break
            self._process(pkt)
            done += 1
        return done

    def drain(self) -> int:
        return self.step(None)

    def _obs_slot(self, slot: int) -> int:
        """Monitor time is forward-only; a re-queued packet minted before
        an eviction carries an old slot — it is observed NOW, at the
        clock's current position."""
        return max(int(slot), self.monitor.clock.slot)

    def _process(self, pkt: ShardPacket) -> None:
        if pkt.client in self._parked_packets or \
                pkt.client in self._parked_staging:
            self._reregister(pkt.client)
        if self.monitor is not None:
            self.monitor.observe_heartbeat(self._obs_slot(pkt.slot),
                                           pkt.client)
        if self._last_committed.get(pkt.client, -1) >= pkt.push_id:
            self.stats.duplicates += 1
            return
        base = None
        if self.codec.needs_base:
            base = self.server.base_shard(pkt.base_version, pkt.shard)
            if base is None:        # aged out of the ring: approximate
                self.stats.ring_misses += 1
                base = self.server.snapshot_flat()[0][pkt.shard]
        decoded = self.codec.decode(pkt.payload, base)
        key = (pkt.client, pkt.push_id)
        shards = self._staging.setdefault(key, {})
        if pkt.shard in shards:
            self.stats.duplicates += 1      # re-delivered shard: overwrite
        shards[pkt.shard] = decoded
        if len(shards) == pkt.n_shards:
            self._commit(key, shards, pkt.slot)

    def _commit(self, key: Tuple[int, int],
                shards: Dict[int, torch.Tensor], slot: int) -> None:
        client, push_id = key
        slices = [shards[i] for i in range(len(shards))]
        self.server.push_flat(client, slices)
        del self._staging[key]
        self._last_committed[client] = push_id
        self.stats.applied += 1
        t0 = self._first_seen.pop(key, None)
        if t0 is not None:
            self.latencies.append(time.perf_counter() - t0)
        if self.monitor is not None:
            self.monitor.observe_push(self._obs_slot(slot), client)

    # ------------------------------------------------------------ faults
    def sweep(self, slot: int) -> Set[int]:
        """Advance the monitor and evict dead islands: their staged
        partial pushes and queued packets are PARKED (not dropped) so the
        push survives the outage and completes on recovery."""
        if self.monitor is None:
            return set()
        dead = self.monitor.sweep(slot)
        for uid in dead:
            self.stats.evicted += 1
            mine = {k: v for k, v in self._staging.items() if k[0] == uid}
            for k in mine:
                del self._staging[k]
            if mine:
                self._parked_staging.setdefault(uid, {}).update(mine)
            pkts = self.queue.extract_client(uid)
            if pkts:
                self.stats.parked_packets += len(pkts)
                self._parked_packets.setdefault(uid, []).extend(pkts)
        return dead

    def _reregister(self, client: int) -> None:
        """An evicted island spoke again: restore its parked state. Its
        in-flight shards are re-queued ahead of new traffic; the next
        ``observe_heartbeat`` re-registers it with the monitor."""
        self.stats.reregistered += 1
        staged = self._parked_staging.pop(client, None)
        if staged:
            for k, v in staged.items():
                self._staging.setdefault(k, {}).update(v)
        pkts = self._parked_packets.pop(client, None)
        if pkts:
            self.stats.requeued_packets += len(pkts)
            self.queue.requeue_front(pkts)

    # ------------------------------------------------------------ inspection
    @property
    def pending_pushes(self) -> int:
        return len(self._staging)

    @property
    def parked_clients(self) -> Set[int]:
        return set(self._parked_staging) | set(self._parked_packets)


class ServeClient:
    """Client-side half of the wire: pull a base, encode per shard,
    submit packets. ``shards=`` restricts a push to a subset of shard
    packets — the island-death-mid-push fault hook; ``resume_push``
    sends the missing remainder after recovery."""

    def __init__(self, client_id: int, pipeline: IngestPipeline):
        self.client_id = int(client_id)
        self.pipeline = pipeline
        self.server = pipeline.server
        self.codec = pipeline.codec
        self._next_push_id = 0
        self.base: Optional[Tuple[torch.Tensor, ...]] = None
        self.base_version = 0
        self._sent: Dict[int, Set[int]] = {}    # push_id -> shards sent

    def pull(self) -> Tuple[torch.Tensor, int]:
        self.base, self.base_version = self.server.pull_flat(self.client_id)
        return self.server.spec.join(self.base), self.base_version

    def push(self, new_flat: torch.Tensor, slot: int,
             shards: Optional[Sequence[int]] = None) -> Tuple[int, int]:
        """Encode + submit one push; returns ``(push_id, n_accepted)``.
        Rejected (backpressured) packets are NOT retried here — the
        caller decides (the bench retries after a drain)."""
        if self.base is None:
            raise RuntimeError("push before pull: no base snapshot")
        push_id = self._next_push_id
        self._next_push_id += 1
        accepted = self._send(push_id, new_flat, slot, shards)
        return push_id, accepted

    def resume_push(self, push_id: int, new_flat: torch.Tensor,
                    slot: int) -> int:
        """Re-send the shards of ``push_id`` that were never submitted
        (recovery after dying mid-push)."""
        spec = self.server.spec
        missing = [i for i in range(spec.n_shards)
                   if i not in self._sent.get(push_id, set())]
        return self._send(push_id, new_flat, slot, missing)

    def _send(self, push_id: int, new_flat: torch.Tensor, slot: int,
              shards: Optional[Sequence[int]]) -> int:
        spec = self.server.spec
        todo = range(spec.n_shards) if shards is None else shards
        accepted = 0
        sent = self._sent.setdefault(push_id, set())
        new_flat = torch.as_tensor(new_flat, dtype=torch.float32,
                                   device=self.server.device)
        for i in todo:
            sl = spec.shard_slice(i)
            payload = self.codec.encode((self.client_id, i), new_flat[sl],
                                        self.base[i] if self.base is not None
                                        else None)
            pkt = ShardPacket(client=self.client_id, push_id=push_id,
                              shard=i, n_shards=spec.n_shards,
                              base_version=self.base_version,
                              payload=payload, slot=int(slot))
            if self.pipeline.submit(pkt):
                accepted += 1
                sent.add(i)
        return accepted
