"""Serving: batched decode requests (port of ``repro/serving``).

:class:`BatchedServer` runs prefill + cached decode with fixed-slot
continuous batching (``server.py``).  The reference's continuous-ingest
store front end (``ingest.py``, ``service.py``) waits for a later slice.
"""

from repro_torch.serving.server import BatchedServer, Request

__all__ = ["BatchedServer", "Request"]
