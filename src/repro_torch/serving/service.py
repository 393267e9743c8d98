"""Slot-based query front end over a continuously-ingested track store.

:class:`repro_torch.serving.server.BatchedServer` taught this package the
fixed-slot admission discipline: a server owns a small number of slots,
``admit`` either claims one or returns ``False`` (the caller re-offers
later), and ``step`` advances every occupied slot by one bounded unit of
work.  :class:`StoreFrontEnd` generalizes that discipline from decode
requests to *store queries* against a live
:class:`~repro_torch.serving.ingest.IngestService`:

  * **tiny queries** (``latest`` / ``nearest``) read the retained
    latest-state-per-track snapshot — a dict lookup / small scan, one
    step, no I/O.  They get their own slot class so a burst of bulk
    reads can never starve them (the paper's operational motivation:
    controllers ask "where is this aircraft *now*" while analysts
    export history).
  * **bulk snapshot reads** decode committed shards.  At admission the
    query pins the manifest *generation* then in effect at the store
    root — a :class:`~repro_torch.store.reader.TrackStore` opened on that
    frozen manifest — and each ``step`` decodes exactly one shard, so a
    large export interleaves with tiny queries at shard granularity.
    Commits that land mid-read are invisible: the result is exactly the
    pinned generation's store, which is what "a consistent snapshot"
    means here (commit_shard only ever *adds* whole shards, so a pinned
    manifest's shard files are immutable).

The port's copy of the reference's ``serving/service.py``: host work
only, no tensor, no ``device``.

Determinism: the front end is synchronous (``admit``/``step`` on the
caller's thread, like ``BatchedServer``), so tests interleave queries
with ingest commits exactly, with zero sleeps.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional

from repro_torch.serving.ingest import IngestService
from repro_torch.store.format import StoreManifest
from repro_torch.store.reader import TrackStore

__all__ = ["Query", "StoreFrontEnd", "snapshot_digest"]

#: Query kinds by slot class.
TINY_KINDS = ("latest", "nearest")
BULK_KINDS = ("snapshot",)


@dataclasses.dataclass
class Query:
    """One in-flight query (compare
    :class:`repro_torch.serving.server.Request`).

    ``params`` by kind:

    * ``latest`` — ``{"track_id": ...}`` or ``{"icao24": ...}``
    * ``nearest`` — ``{"lat": ..., "lon": ...}``
    * ``snapshot`` — optional ``{"digest": True}`` to return the
      canonical content digest instead of the decoded payload (what the
      bench's byte-identity gate compares).
    """

    query_id: int
    kind: str
    params: dict = dataclasses.field(default_factory=dict)
    result: Any = None
    #: Manifest generation the query executed against (pinned at
    #: admission for snapshots, observed at completion for tiny reads).
    generation: Optional[int] = None
    done: bool = False

    def __post_init__(self) -> None:
        if self.kind not in TINY_KINDS + BULK_KINDS:
            raise ValueError(f"unknown query kind {self.kind!r}")


def snapshot_digest(items: list[tuple[str, dict]]) -> str:
    """Canonical content digest of a snapshot read: sha256 over
    (track_id, column bytes) in track order.  Two stores whose *reads*
    are byte-identical — regardless of shard layout on disk — digest
    equal."""
    h = hashlib.sha256()
    for track_id, obs in items:
        h.update(track_id.encode())
        for col in ("time", "lat", "lon", "alt"):
            h.update(obs[col].tobytes())
    return h.hexdigest()


class _BulkRead:
    """One admitted snapshot read: a pinned-manifest store plus a plan
    cursor; ``step_one`` decodes the next shard."""

    def __init__(self, store: TrackStore, digest_only: bool):
        self.store = store
        self.plans = store.plan()
        self.cursor = 0
        self.digest_only = digest_only
        self.items: list[tuple[str, dict]] = []

    @property
    def exhausted(self) -> bool:
        return self.cursor >= len(self.plans)

    def step_one(self) -> None:
        plan = self.plans[self.cursor]
        self.cursor += 1
        batch = self.store.read_shard_batch(plan.shard.shard_id)
        for tid, (obs, _segs) in zip(batch.track_ids, batch.items):
            self.items.append((tid, obs))

    def finish(self) -> Any:
        if self.digest_only:
            return {"digest": snapshot_digest(self.items),
                    "n_tracks": len(self.items)}
        return self.items


class StoreFrontEnd:
    """Two slot classes over one live store (see module docstring)."""

    def __init__(self, service: IngestService, *,
                 tiny_slots: int = 2, bulk_slots: int = 2,
                 tracer=None):
        if tiny_slots < 1 or bulk_slots < 1:
            raise ValueError("need at least one slot per class")
        self.service = service
        self.tiny: list[Optional[Query]] = [None] * tiny_slots
        self.bulk: list[Optional[Query]] = [None] * bulk_slots
        self._bulk_reads: dict[int, _BulkRead] = {}
        self.stats = {"admitted": 0, "rejected": 0, "completed": 0,
                      "shard_decodes": 0}
        #: Optional :class:`repro_torch.obs.Tracer` (defaults to the ingest
        #: service's): admissions/rejections become ``serving``-category
        #: instants on the ``frontend`` lane, and each completed query
        #: becomes one admit→done span.
        self.tracer = tracer if tracer is not None else service.tracer
        self._admit_ts: dict[int, float] = {}

    # -- admission ---------------------------------------------------------

    def _slots(self, kind: str) -> list[Optional[Query]]:
        return self.tiny if kind in TINY_KINDS else self.bulk

    def admit(self, query: Query) -> bool:
        """Claim a slot of the query's class; ``False`` when that class
        is full (the caller re-offers after a ``step``).  A rejected
        admission leaves no trace — no pinned manifest, no partial
        state."""
        slots = self._slots(query.kind)
        free = [i for i, q in enumerate(slots) if q is None]
        tr = self.tracer
        if not free:
            self.stats["rejected"] += 1
            if tr is not None:
                tr.emit(tr.now(), -1.0, "query_reject", "serving",
                        "frontend", f"{query.kind}:{query.query_id}")
            return False
        if query.kind == "snapshot":
            # Pin the committed-manifest generation NOW: everything this
            # query returns comes from this frozen index, no matter how
            # many commits land while it steps.
            try:
                manifest = StoreManifest.load(self.service.store_root)
            except FileNotFoundError:
                manifest = StoreManifest()
            query.generation = manifest.generation
            self._bulk_reads[query.query_id] = _BulkRead(
                TrackStore(self.service.store_root, manifest=manifest,
                           prefetch=0, tracer=tr),
                digest_only=bool(query.params.get("digest")))
        slots[free[0]] = query
        self.stats["admitted"] += 1
        if tr is not None:
            self._admit_ts[query.query_id] = tr.now()
            tr.emit(self._admit_ts[query.query_id], -1.0, "query_admit",
                    "serving", "frontend",
                    f"{query.kind}:{query.query_id}")
        return True

    # -- stepping ----------------------------------------------------------

    def step(self) -> list[Query]:
        """Advance every occupied slot by one unit of work; returns the
        queries completed by this step.  Tiny queries complete in one
        step; a snapshot read decodes exactly one shard per step."""
        finished: list[Query] = []
        for i, q in enumerate(self.tiny):
            if q is None:
                continue
            if q.kind == "latest":
                q.result = self.service.latest(**q.params)
            else:
                q.result = self.service.nearest(**q.params)
            q.generation = self.service.generation
            q.done = True
            self.tiny[i] = None
            finished.append(q)
        for i, q in enumerate(self.bulk):
            if q is None:
                continue
            rd = self._bulk_reads[q.query_id]
            if not rd.exhausted:
                rd.step_one()
                self.stats["shard_decodes"] += 1
            if rd.exhausted:
                q.result = rd.finish()
                q.done = True
                self.bulk[i] = None
                del self._bulk_reads[q.query_id]
                finished.append(q)
        self.stats["completed"] += len(finished)
        tr = self.tracer
        if tr is not None:
            now = tr.now()
            for q in finished:
                t0 = self._admit_ts.pop(q.query_id, now)
                tr.emit(t0, now - t0, "query", "serving", "frontend",
                        f"{q.kind}:{q.query_id}")
        return finished

    @property
    def busy(self) -> bool:
        return any(q is not None for q in self.tiny + self.bulk)

    def serve(self, queries: list[Query]) -> list[Query]:
        """Admit-and-step until every query completes (offline helper,
        mirrors ``BatchedServer.serve``)."""
        waiting = list(queries)
        out: list[Query] = []
        while waiting or self.busy:
            waiting = [q for q in waiting if not self.admit(q)]
            out.extend(self.step())
        return out
