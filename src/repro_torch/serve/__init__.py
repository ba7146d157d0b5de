"""Serving tier: sharded async parameter server + push ingestion — the
counterpart of ``repro/serve``.

The simulator (core/) answers WHEN devices should train and push; this
package is the datacenter half that absorbs those pushes at fleet scale:
a ``ShardedAsyncParameterServer`` partitioning the global model into
shards (one K1 launch a shard a push, every shard on the one card), an
``IngestPipeline`` with a bounded backpressured queue, per-shard wire
codecs, and live ``fault/monitor.py`` membership so dead islands are
evicted mid-push and recovered without losing a push.
"""
from .codecs import (Int8Codec, NullCodec, ShardCodec, TopKDeltaCodec,
                     registered_codecs, resolve_codec)
from .ingest import (IngestPipeline, IngestStats, PushQueue, ServeClient,
                     ShardPacket)
from .server import ShardedAsyncParameterServer
from .sharding import ShardSpec

__all__ = [
    "ShardCodec", "NullCodec", "Int8Codec", "TopKDeltaCodec",
    "registered_codecs", "resolve_codec",
    "IngestPipeline", "IngestStats", "PushQueue", "ServeClient",
    "ShardPacket",
    "ShardedAsyncParameterServer", "ShardSpec",
]
