"""Host-side loader with prefetch — the counterpart of
``repro/data/loader.py::ShardedLoader``.

``ShardedLoader(it, device, depth=2)`` wraps a host iterator of batches
(trees of dicts, lists and tuples over numpy arrays or tensors) and
places each batch on ``device``, ``depth`` batches ahead of the consumer,
on a worker thread, in order. On CUDA each batch is staged through pinned
host memory and copied on a side stream; an event recorded there after
the copies is what the consumer's current stream waits on before it is
handed the batch, so the copies overlap the consumer's work and never
race it. On the CPU a batch is a plain ``.to(device)`` (a copy: the
iterator may reuse its buffers).

The JAX loader places each batch with ``NamedSharding``s across a mesh;
the port runs on one card and has no mesh shardings, so it takes a
device where JAX takes the shardings.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.fused_update.ops import tree_leaves, tree_map

_DONE = object()


class ShardedLoader:
    """Wraps a host batch iterator; places each batch on ``device``;
    prefetches ``depth`` batches ahead on a worker thread. An exception
    raised by the iterator is raised again by ``next`` in its place."""

    def __init__(self, it: Iterator[Any], device="cuda", depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        self._it = it
        self._dev = resolve_device(device)
        self._cuda = self._dev.type == "cuda"
        self._stream = torch.cuda.Stream(self._dev) if self._cuda else None
        self._buf: queue.Queue = queue.Queue(maxsize=depth)
        self._finished = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _place(self, batch):
        host = tree_map(lambda x: torch.as_tensor(np.asarray(x))
                        if not isinstance(x, torch.Tensor) else x, batch)
        if not self._cuda:
            return tree_map(lambda t: t.to(self._dev, copy=True), host), None
        with torch.cuda.device(self._dev), torch.cuda.stream(self._stream):
            placed = tree_map(lambda t: t.pin_memory().to(
                self._dev, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(self._stream)
        return placed, done

    def _fill(self):
        try:
            for batch in self._it:
                self._buf.put(self._place(batch))
        except Exception as exc:     # handed to the consumer
            self._buf.put(exc)
        self._buf.put(_DONE)

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        item = self._buf.get()
        if item is _DONE or isinstance(item, Exception):
            self._finished = True
            if item is _DONE:
                raise StopIteration
            raise item
        placed, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self._dev)
            stream.wait_event(done)
            # allocated on the side stream: keep the allocator from
            # handing the memory out again while this stream reads it
            for t in tree_leaves(placed):
                t.record_stream(stream)
        return placed
