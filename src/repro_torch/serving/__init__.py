"""Serving: batched decode requests and continuous-ingest store queries
(port of ``repro/serving``).

Two front ends share the fixed-slot admission discipline:

* :class:`BatchedServer` — prefill + cached decode with request
  batching (``server.py``), on the card unless told otherwise.
* :class:`StoreFrontEnd` — tiny ``latest``/``nearest`` lookups and
  generation-pinned bulk snapshot reads over a store that
  :class:`IngestService` is appending to live (``ingest.py`` /
  ``service.py``).  This path is numpy and file I/O: it takes no
  ``device`` and never touches CUDA.
"""

from repro_torch.serving.server import BatchedServer, Request
from repro_torch.serving.ingest import (
    FeedSpec, IngestService, ServiceKilled, SyntheticFeed)
from repro_torch.serving.service import Query, StoreFrontEnd, snapshot_digest

__all__ = ["BatchedServer", "FeedSpec", "IngestService", "Query",
           "Request", "ServiceKilled", "StoreFrontEnd", "SyntheticFeed",
           "snapshot_digest"]
