"""``repro_torch.store`` — sharded, chunked columnar track storage.

Port of ``repro/store`` (numpy only).  It stores *decoded* track
columns (time/lat/lon/alt + per-track offsets) in checksummed,
compressed shards with a manifest index that records per-track segment
shapes, so the fused pipeline's bucket planning happens from the index
and batches stream in through a double-buffered async prefetcher.

    uri.py     — the ``store://`` task-payload grammar
    codec.py   — canonical (byte-identical) shard encode/decode + CRCs
    format.py  — shard/track index records, the store manifest
    writer.py  — CSV/zip-tree -> shards ingest (standalone or run_job)
    reader.py  — TrackStore: planner, async prefetch
"""

from repro_torch.store.codec import (                 # noqa: F401
    ShardChecksumError, ShardFormatError, decode_shard, encode_shard,
    read_shard)
from repro_torch.store.format import (                # noqa: F401
    MANIFEST_NAME, STORE_FORMAT, ShardRecord, StoreManifest, TrackRecord)
from repro_torch.store.reader import (                # noqa: F401
    ReadPlan, ShardBatch, TrackStore)
from repro_torch.store.uri import (                   # noqa: F401
    is_store_uri, make_store_uri, parse_store_uri)
from repro_torch.store.writer import (                # noqa: F401
    ShardBuilder, ShardPlan, build_shard, build_store, discover_sources,
    finalize_store, plan_shards)

__all__ = [
    "ShardChecksumError", "ShardFormatError", "decode_shard",
    "encode_shard", "read_shard",
    "MANIFEST_NAME", "STORE_FORMAT", "ShardRecord", "StoreManifest",
    "TrackRecord",
    "ReadPlan", "ShardBatch", "TrackStore", "is_store_uri",
    "make_store_uri", "parse_store_uri",
    "ShardBuilder", "ShardPlan", "build_shard", "build_store",
    "discover_sources", "finalize_store", "plan_shards",
]
