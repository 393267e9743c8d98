"""`TrackStore`: index-driven reads + double-buffered async prefetch.

The read side of the store.  A :class:`TrackStore` opens a store root,
loads the manifest index, and serves three access patterns:

  * random access — ``read_track(track_id)`` reconstructs one track's
    observation dict bitwise-identically to what the CSV parse produced
    at ingest;
  * planned batches — ``plan()`` turns the index into per-shard
    :class:`ReadPlan` s (fused-pipeline bucket histograms included,
    computed without touching payload bytes);
  * streaming — ``iter_batches()`` yields :class:`ShardBatch` es whose
    ``items`` are exactly the ``(obs, segs)`` pairs
    ``SegmentProcessor._process_many`` consumes.  With ``prefetch >= 1``
    a background thread reads + decompresses shard N+1 while the caller
    (the fused device pipeline) is busy with shard N, so the host decode
    hides behind device compute instead of serializing with it.

Store URIs (:mod:`repro_torch.store.uri`, re-exported here) name read
selections inside ``run_job`` task payloads::

    store://<root>                          # whole store
    store://<root>#track=<track_id>         # one track
    store://<root>#shard=<shard_id>         # one shard (all rows)
    store://<root>#shard=<shard_id>&rows=<a>:<b>   # row range in a shard

They are plain strings, so they survive every execution backend's
message path (threads, pickled process messages, JSON checkpoints).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Iterator, Optional, Sequence

import numpy as np

from repro_torch.store import codec
from repro_torch.store.format import ShardRecord, StoreManifest, TrackRecord
from repro_torch.store.uri import (  # noqa: F401  (re-exported)
    STORE_URI_PREFIX, is_store_uri, make_store_uri, parse_store_uri)

__all__ = ["STORE_URI_PREFIX", "is_store_uri", "make_store_uri",
           "parse_store_uri", "ReadPlan", "ShardBatch", "TrackStore"]

def _parse_rows(spec: str, n: int) -> range:
    a, _, b = spec.partition(":")
    lo = int(a) if a else 0
    hi = int(b) if b else n
    if not (0 <= lo <= hi <= n):
        raise ValueError(f"row range {spec!r} out of bounds for {n} rows")
    return range(lo, hi)


@dataclasses.dataclass(frozen=True)
class ReadPlan:
    """One shard's planned read, derived from the index alone."""

    shard: ShardRecord
    tracks: tuple[TrackRecord, ...]          # rows to materialize
    bucket_histogram: dict[int, int]         # fused bucket width -> segs

    @property
    def n_points(self) -> int:
        return sum(t.n_obs for t in self.tracks)


@dataclasses.dataclass
class ShardBatch:
    """One decoded shard, ready to feed the fused pipeline."""

    shard_id: str
    track_ids: list[str]
    items: list[tuple[dict, list[slice]]]    # _process_many input shape

    @property
    def n_points(self) -> int:
        return sum(len(obs["time"]) for obs, _ in self.items)


class TrackStore:
    """Columnar store reader with an index-driven planner."""

    def __init__(self, root: str, *,
                 manifest: Optional[StoreManifest] = None,
                 prefetch: int = 1,
                 clock=None,
                 tracer=None):
        self.root = root
        self.manifest = manifest or StoreManifest.load(root)
        self.prefetch = prefetch
        #: Monotonic time source for the ``decode_s``/``wait_s`` stats.
        #: Injectable so tests assert exact attribution instead of
        #: flaky wall-time ratios.
        self._clock = clock if clock is not None else time.perf_counter
        #: Optional :class:`repro_torch.obs.Tracer`: shard decodes become
        #: ``store``-category spans (track = shard id), consumer blocking
        #: becomes ``store_wait`` spans, and prefetch handoffs become
        #: instants.  Spans use the *tracer's* clock — not ``clock`` —
        #: so they share one timeline with scheduler/serving events.
        self.tracer = tracer
        #: Optional test/service instrumentation for the prefetch
        #: thread: ``{"queued": fn(kind, shard_id), "blocked": fn(kind)}``
        #: — ``queued`` fires after an event lands in the queue,
        #: ``blocked`` every time a put finds the queue full.  Lets a
        #: deterministic test drive producer/consumer interleavings with
        #: events instead of sleeps.
        self.prefetch_hooks: Optional[dict] = None
        self._reindex()
        self.stats = {"shards_read": 0, "bytes_read": 0,
                      "decode_s": 0.0, "wait_s": 0.0, "stale_drops": 0}

    @classmethod
    def open(cls, root: str, **kw) -> "TrackStore":
        return cls(root, **kw)

    @property
    def generation(self) -> int:
        """The loaded manifest's append generation (invalidation key)."""
        return self.manifest.generation

    def _reindex(self) -> None:
        self._tracks_by_id = {t.track_id: t for t in self.manifest.tracks}
        self._shards_by_id = {s.shard_id: s for s in self.manifest.shards}
        self._rows_by_shard: dict[str, list[TrackRecord]] = {}
        for t in self.manifest.tracks:
            self._rows_by_shard.setdefault(t.shard_id, []).append(t)
        for rows in self._rows_by_shard.values():
            rows.sort(key=lambda t: t.row)

    def reload(self) -> bool:
        """Re-read the manifest and rebuild the index maps.

        A streaming-DAG store grows while it is being read: shards are
        committed to the manifest (:func:`repro_torch.store.writer.commit_shard`)
        while earlier shards are already being processed.  A reader that
        opened the store mid-stream calls this when it misses a
        track/shard that was committed after its manifest snapshot; the
        continuous-ingest service calls it after every commit.  Returns
        True when the manifest generation actually advanced — a live
        ``iter_batches`` iteration observes that through
        :attr:`generation` and invalidates its warm prefetch.
        """
        old_gen = self.manifest.generation
        self.manifest = StoreManifest.load(self.root)
        self._reindex()
        return self.manifest.generation != old_gen

    def __len__(self) -> int:
        return len(self.manifest.tracks)

    # -- planning (index only) -------------------------------------------

    def plan(self, selectors: Optional[Sequence[dict]] = None
             ) -> list[ReadPlan]:
        """Selectors -> per-shard read plans, in manifest shard order.

        Each selector is a ``parse_store_uri`` dict; ``None`` plans the
        whole store.  Tracks from multiple selectors that land in the
        same shard coalesce into one plan (one read, one decode).
        """
        wanted: dict[str, dict[int, TrackRecord]] = {}
        for sel in (selectors if selectors is not None else [{}]):
            for t in self._select(sel):
                wanted.setdefault(t.shard_id, {})[t.row] = t
        plans = []
        for s in self.manifest.shards:
            rows = wanted.get(s.shard_id)
            if not rows:
                continue
            tracks = tuple(rows[r] for r in sorted(rows))
            plans.append(ReadPlan(
                shard=s, tracks=tracks,
                bucket_histogram=self.manifest.bucket_histogram(
                    list(tracks))))
        return plans

    def _select(self, sel: dict[str, str]) -> list[TrackRecord]:
        if "track" in sel:
            return [self._track(sel["track"])]
        if "shard" in sel:
            rows = self._shard_rows(sel["shard"])
            if "rows" in sel:
                rng = _parse_rows(sel["rows"], len(rows))
                rows = [rows[i] for i in rng]
            return list(rows)
        return list(self.manifest.tracks)

    def _track(self, track_id: str) -> TrackRecord:
        try:
            return self._tracks_by_id[track_id]
        except KeyError:
            raise KeyError(f"unknown track {track_id!r} in store "
                           f"{self.root}") from None

    def _shard_rows(self, shard_id: str) -> list[TrackRecord]:
        if shard_id not in self._shards_by_id:
            raise KeyError(f"unknown shard {shard_id!r} in store "
                           f"{self.root}")
        return self._rows_by_shard.get(shard_id, [])

    # -- decoding ---------------------------------------------------------

    def _decode_shard(self, plan: ReadPlan) -> ShardBatch:
        from repro_torch.tracks.segments import split_segments

        rec = plan.shard
        t0 = self._clock()
        tr = self.tracer
        tt0 = tr.now() if tr is not None else 0.0
        path = os.path.join(self.root, rec.filename)
        cols, meta = codec.read_shard(path)
        offsets = cols["offsets"]
        values = meta.get("icao_values", [])
        items: list[tuple[dict, list[slice]]] = []
        track_ids: list[str] = []
        value_arr = (np.asarray(values) if values
                     else np.zeros(0, dtype="U1"))
        for t in plan.tracks:
            lo, hi = int(offsets[t.row]), int(offsets[t.row + 1])
            codes = cols["icao_codes"][lo:hi]
            names = (value_arr[codes] if len(codes)
                     else np.zeros(0, dtype="U1"))
            obs = {
                "time": cols["time"][lo:hi],
                "lat": cols["lat"][lo:hi],
                "lon": cols["lon"][lo:hi],
                "alt": cols["alt"][lo:hi],
                "icao24": names,
            }
            items.append((obs, split_segments(obs["time"])))
            track_ids.append(t.track_id)
        self.stats["shards_read"] += 1
        self.stats["bytes_read"] += rec.size_bytes
        self.stats["decode_s"] += self._clock() - t0
        if tr is not None:
            tr.emit(tt0, tr.now() - tt0, "store_decode", "store",
                    rec.shard_id, extra=rec.size_bytes)
        return ShardBatch(shard_id=rec.shard_id, track_ids=track_ids,
                          items=items)

    # -- access patterns ---------------------------------------------------

    def read_track(self, track_id: str) -> dict[str, np.ndarray]:
        """One track's observation dict (bitwise equal to ingest input)."""
        t = self._track(track_id)
        plan = self.plan([{"track": track_id}])[0]
        batch = self._decode_shard(plan)
        assert batch.track_ids == [t.track_id]
        return batch.items[0][0]

    def read_shard_batch(self, shard_id: str) -> ShardBatch:
        """Decode ONE whole shard into a :class:`ShardBatch` (items in
        row order, so ``items[a:b]`` is the ``rows=a:b`` selection).

        This is the decode a shard-affinity consumer caches: serve every
        row-range task of the shard from one decoded batch, re-decoding
        only when the scheduler moves the worker to another shard.
        """
        rows = self._shard_rows(shard_id)
        if not rows:
            raise KeyError(f"shard {shard_id!r} has no rows in store "
                           f"{self.root}")
        plan = ReadPlan(
            shard=self._shards_by_id[shard_id], tracks=tuple(rows),
            bucket_histogram=self.manifest.bucket_histogram(list(rows)))
        return self._decode_shard(plan)

    def read_selection(self, sel: dict[str, str]
                       ) -> list[tuple[str, dict, list[slice]]]:
        """One selector -> [(track_id, obs, segs)] in plan order."""
        out = []
        for plan in self.plan([sel]):
            batch = self._decode_shard(plan)
            for tid, (obs, segs) in zip(batch.track_ids, batch.items):
                out.append((tid, obs, segs))
        return out

    def iter_batches(self, plans: Optional[Sequence[ReadPlan]] = None, *,
                     prefetch: Optional[int] = None
                     ) -> Iterator[ShardBatch]:
        """Stream decoded shard batches, optionally prefetched.

        ``prefetch=0`` decodes synchronously in the caller's thread.
        ``prefetch=k`` runs a daemon decode thread that stays up to
        ``k`` shards ahead (``k=1`` is classic double buffering: one
        batch in hand, one being decoded).  ``stats['wait_s']``
        accumulates how long the consumer actually blocked — the number
        the storage bench uses to show the decode hiding behind the
        fused pipeline's device time.

        With explicit ``plans`` the selection is pinned: exactly those
        plans stream, in order, regardless of appends.  With
        ``plans=None`` the iteration is *live*: it follows the loaded
        manifest, so when :meth:`reload` advances the generation
        mid-stream (a :func:`~repro_torch.store.writer.commit_shard` append),
        warm in-flight prefetch buffers planned under the old generation
        are dropped (counted in ``stats['stale_drops']``), the remainder
        is re-planned from the fresh index, and newly committed shards
        stream out before the iterator finishes.  Each shard is yielded
        at most once.
        """
        k = self.prefetch if prefetch is None else prefetch
        if plans is not None:
            yield from self._iter_round(plans, k, gen=None)
            return
        delivered: set[str] = set()
        while True:
            gen = self.manifest.generation
            round_plans = [p for p in self.plan()
                           if p.shard.shard_id not in delivered]
            for batch in self._iter_round(round_plans, k, gen=gen):
                delivered.add(batch.shard_id)
                yield batch
            if self.manifest.generation == gen:
                return

    def _iter_round(self, plans: Sequence[ReadPlan], k: int, *,
                    gen: Optional[int]) -> Iterator[ShardBatch]:
        """One streaming pass over ``plans``.  When ``gen`` is given the
        round is generation-pinned: it aborts as soon as the loaded
        manifest's generation moves past ``gen`` — the producer stops
        decoding and the consumer drops (instead of yields) any buffer
        already decoded under the stale generation."""
        if k <= 0:
            for plan in plans:
                if gen is not None and self.manifest.generation != gen:
                    return
                yield self._decode_shard(plan)
            return

        q: queue.Queue = queue.Queue(maxsize=k)
        stop = threading.Event()
        hooks = self.prefetch_hooks or {}

        def put(event: tuple) -> bool:
            """Blocking put that gives up only when the consumer left.
            Every event — including the terminal "err"/"end" — must
            retry indefinitely, or the consumer deadlocks on q.get()."""
            blocked = hooks.get("blocked")
            while not stop.is_set():
                try:
                    q.put(event, timeout=0.1)
                except queue.Full:
                    if blocked is not None:
                        blocked(event[0])
                    continue
                queued = hooks.get("queued")
                if queued is not None:
                    batch = event[1]
                    queued(event[0], getattr(batch, "shard_id", None))
                return True
            return False

        def produce() -> None:
            try:
                for plan in plans:
                    if gen is not None and self.manifest.generation != gen:
                        break               # rest of the round is stale
                    batch = self._decode_shard(plan)
                    if not put(("ok", batch)):
                        return
                    if self.tracer is not None:
                        # Emitted from the prefetch thread; Tracer.emit
                        # is a single deque append, safe cross-thread.
                        self.tracer.emit(self.tracer.now(), -1.0,
                                         "store_prefetch", "store",
                                         batch.shard_id)
                put(("end", None))
            except Exception as e:              # surfaced to the consumer
                put(("err", e))

        worker = threading.Thread(target=produce, daemon=True,
                                  name="trackstore-prefetch")
        worker.start()
        try:
            while True:
                t0 = self._clock()
                tr = self.tracer
                tt0 = tr.now() if tr is not None else 0.0
                kind, val = q.get()
                self.stats["wait_s"] += self._clock() - t0
                if tr is not None:
                    tr.emit(tt0, tr.now() - tt0, "store_wait", "store",
                            "consumer")
                if kind == "end":
                    break
                if kind == "err":
                    raise val
                if gen is not None and self.manifest.generation != gen:
                    # Decoded under a superseded manifest: invalidate.
                    self.stats["stale_drops"] += 1
                    continue
                yield val
        finally:
            stop.set()
            worker.join(timeout=5.0)
