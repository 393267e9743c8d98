"""Data pipeline: self-scheduled shard ingestion (the paper's technique
applied to the training input layer).  Port of ``repro/data``."""

from repro_torch.data.pipeline import (
    ShardManifest, SelfScheduledLoader, synthetic_token_shards)

__all__ = ["ShardManifest", "SelfScheduledLoader", "synthetic_token_shards"]
