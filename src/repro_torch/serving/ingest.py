"""Continuous ingest: tail an observation directory into the track store.

The batch workflow (``tracks/workflow.py``) processes a finished dataset;
the systems the paper feeds are continuous — crowdsourced observations
arrive as a stream and must become queryable products without a
start-the-job boundary.  :class:`IngestService` closes that gap:

  * it *tails* a source directory (or a :class:`SyntheticFeed` driven by
    the ``datasets`` generators) for new per-track observation files;
  * accepted files accumulate into the SAME greedy shard cuts as
    :func:`repro_torch.store.writer.plan_shards` — the cut rule is
    replayed incrementally, so a sealed live-ingested store is
    **byte-identical** to a batch
    :func:`~repro_torch.store.writer.build_store` over the same files
    (provided files arrive in sorted-id order, which the feed
    guarantees);
  * each cut shard is built
    (:func:`~repro_torch.store.writer.build_shard`) and appended through
    :func:`~repro_torch.store.writer.commit_shard` — the atomic,
    idempotent, generation-bumping manifest path the streaming DAG
    already uses — so a reader NEVER observes a partially-committed
    shard: the shard file is fsynced+renamed before the manifest names
    it, and the manifest itself is replaced atomically;
  * after every commit the service folds the shard's payload into a
    *retained* latest-state-per-track snapshot (last position/altitude/
    time per track and per transponder) — the in-memory product the
    tiny ``latest``/``nearest`` queries of
    :class:`repro_torch.serving.service.StoreFrontEnd` read.

Crash safety: all durable state lives in the store manifest.  A killed
service restarts by reloading the manifest — committed shards are never
re-ingested (their track ids are known), files of any in-flight cut are
re-accepted in sorted order, and the cut replay produces the same shard
boundaries and ids, so kill + restart + seal converges to the same
bytes as an uninterrupted run.

Determinism harness: the service is *synchronously drivable* —
:meth:`IngestService.poll_once` performs one scan→cut→build→commit
cycle on the caller's thread, and every lifecycle point fires a named
hook (``scan``, ``cut``, ``pre_build``, ``post_build``, ``pre_commit``,
``post_commit``, ``seal``).  Tests script exact interleavings (and
kills, by raising from a hook) with zero sleeps.

For fleet execution, :meth:`IngestService.run_service` runs the build
phase through the streaming-DAG coordinator
(:func:`repro_torch.runtime.dag.run_service`) with an *open* source node:
scans admit build tasks mid-run, workers build shard files in parallel,
and a manager-side edge emitter commits results **in shard order** so
the manifest always holds a contiguous prefix of the planned shards
(the invariant the restart replay relies on).

The port's copy of the reference's ``serving/ingest.py``.  Ingest is
numpy and file I/O: it takes no ``device`` and never touches CUDA.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.core.messages import Task
from repro_torch.store import codec
from repro_torch.store.format import StoreManifest, write_atomic
from repro_torch.store.writer import (
    DEFAULT_TARGET_POINTS, EST_BYTES_PER_OBS, ShardBuilder, ShardPlan,
    build_shard, commit_shard, finalize_manifest)

__all__ = ["FeedSpec", "SyntheticFeed", "IngestService", "ServiceKilled"]


class ServiceKilled(RuntimeError):
    """Raised by test hooks to simulate a mid-cycle kill; the service
    object must be abandoned and a fresh one constructed to resume."""


# ---------------------------------------------------------------------------
# Synthetic live feed.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FeedSpec:
    """A deterministic synthetic observation feed.

    ``n_files`` single-track CSV files are pre-generated from ``seed``
    (same generators as :mod:`repro_torch.tracks.datasets`), then materialized
    into the watch directory in sorted-name order as :meth:`emit` is
    called — a reproducible stand-in for crowdsourced arrival."""

    n_files: int = 16
    obs_per_file: int = 64
    seed: int = 0
    update_period_s: float = 10.0


class SyntheticFeed:
    """Materializes a :class:`FeedSpec` into ``root`` step by step.

    File contents are fixed at construction (pure function of the spec),
    so every interleaving of :meth:`emit` calls yields the same final
    directory — and :func:`~repro_torch.store.format.write_atomic` publishes
    each file, so a concurrent scanner never sees a torn CSV."""

    def __init__(self, root: str, spec: FeedSpec = FeedSpec()):
        from repro_torch.tracks.datasets import _synth_track_points
        self.root = root
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        self._files: list[tuple[str, bytes]] = []
        for i in range(spec.n_files):
            icao24 = f"{rng.integers(0xA00000, 0xB00000):06x}"
            n = int(rng.integers(max(spec.obs_per_file // 2, 4),
                                 spec.obs_per_file + 1))
            rows = _synth_track_points(rng, n, icao24,
                                       t0=float(i) * 3600.0,
                                       period_s=spec.update_period_s)
            header = ("time,icao24,lat,lon,velocity,heading,vertrate,"
                      "baroaltitude,geoaltitude,onground")
            body = header + "\n" + "\n".join(rows) + "\n"
            self._files.append((f"f{i:05d}.csv", body.encode()))
        self._emitted = 0

    @property
    def total(self) -> int:
        return len(self._files)

    @property
    def emitted(self) -> int:
        return self._emitted

    @property
    def exhausted(self) -> bool:
        return self._emitted >= len(self._files)

    def emit(self, k: int = 1) -> list[str]:
        """Publish the next ``k`` files; returns their paths."""
        out = []
        while k > 0 and not self.exhausted:
            name, data = self._files[self._emitted]
            path = os.path.join(self.root, name)
            write_atomic(path, data)
            out.append(path)
            self._emitted += 1
            k -= 1
        return out

    def emit_all(self) -> list[str]:
        return self.emit(len(self._files))


# ---------------------------------------------------------------------------
# The ingest service.
# ---------------------------------------------------------------------------

def _scan_sources(src_root: str) -> list[tuple[str, str, int]]:
    """Like :func:`repro_torch.store.writer.discover_sources` but tolerates an
    empty / not-yet-created tree (a live feed starts empty)."""
    out = []
    if os.path.isdir(src_root):
        for dirpath, _dirs, files in os.walk(src_root):
            for f in files:
                if f.endswith(".zip") or f.endswith(".csv"):
                    p = os.path.join(dirpath, f)
                    rel = os.path.relpath(p, src_root).replace(os.sep, "/")
                    out.append((rel, p, os.path.getsize(p)))
    out.sort(key=lambda s: s[0])
    return out


class IngestService:
    """Long-running ingest: directory tail -> incremental store appends
    -> retained latest-state snapshot (see module docstring).

    ``hooks`` maps lifecycle-point names to callables invoked as
    ``hook(**info)``; unknown names are ignored.  All state needed to
    resume after a kill is rebuilt from the store manifest in
    ``__init__``.
    """

    def __init__(self, src_root: str, store_root: str, *,
                 target_points: int = DEFAULT_TARGET_POINTS,
                 compression: str = "zlib",
                 hooks: Optional[dict[str, Callable[..., Any]]] = None,
                 clock=None,
                 tracer=None):
        self.src_root = src_root
        self.store_root = store_root
        self.target_points = target_points
        self.compression = compression
        self.hooks = dict(hooks or {})
        self._clock = clock if clock is not None else time.monotonic
        #: Optional :class:`repro_torch.obs.Tracer`: lifecycle points become
        #: ``serving``-category events on the ``ingest`` lane — scan/cut/
        #: seal instants, build and commit spans (timed on the tracer's
        #: clock, one timeline with the scheduler's task events).
        self.tracer = tracer
        #: Track ids already committed to the manifest (never re-ingested).
        self._known: set[str] = set()
        #: Accepted-but-uncut sources, in acceptance order.
        self._pending: list[tuple[str, str, int]] = []
        self._pending_points = 0
        #: Track ids cut into a plan but not yet committed (in-flight on
        #: DAG workers).  Scans must skip these too, or a slow build
        #: would get its files re-accepted into a duplicate shard.
        #: Deliberately NOT persisted: after a kill these files are
        #: re-accepted and re-cut identically from the manifest alone.
        self._planned: set[str] = set()
        self._n_planned = 0          # next shard index to cut
        self.sealed = False
        #: track_id -> latest-state doc (see :meth:`_retain_shard`).
        self.retained: dict[str, dict] = {}
        #: icao24 -> track_id of its most recent retained state.
        self.retained_by_icao: dict[str, str] = {}
        self.stats = {"scans": 0, "files_accepted": 0,
                      "shards_committed": 0, "points_ingested": 0,
                      "last_commit_at": 0.0}
        try:
            manifest = StoreManifest.load(store_root)
        except FileNotFoundError:
            manifest = None
        if manifest is not None:
            self._known = {t.track_id for t in manifest.tracks}
            self._n_planned = (
                max((int(s.shard_id[1:]) for s in manifest.shards),
                    default=-1) + 1)
            self.sealed = bool(manifest.shards) and \
                manifest.meta.get("partial") is None
            for s in manifest.shards:
                self._retain_shard(s.shard_id, s.filename)

    # -- hooks -------------------------------------------------------------

    def _hook(self, name: str, **info) -> None:
        fn = self.hooks.get(name)
        if fn is not None:
            fn(**info)

    def _instant(self, name: str, extra=None) -> None:
        tr = self.tracer
        if tr is not None:
            tr.emit(tr.now(), -1.0, name, "serving", "ingest", extra=extra)

    # -- snapshot maintenance ----------------------------------------------

    def _retain_shard(self, shard_id: str, filename: str) -> None:
        """Fold one committed shard's payload into the retained
        latest-state snapshot (one decode per shard, commit-time only)."""
        cols, meta = codec.read_shard(os.path.join(self.store_root,
                                                   filename))
        offsets = cols["offsets"]
        values = meta.get("icao_values", [])
        for row, track_id in enumerate(meta.get("track_ids", [])):
            lo, hi = int(offsets[row]), int(offsets[row + 1])
            if hi <= lo:
                continue
            icao = (str(values[int(cols["icao_codes"][hi - 1])])
                    if values else "")
            state = {"track_id": track_id, "icao24": icao,
                     "time": float(cols["time"][hi - 1]),
                     "lat": float(cols["lat"][hi - 1]),
                     "lon": float(cols["lon"][hi - 1]),
                     "alt": float(cols["alt"][hi - 1]),
                     "n_obs": hi - lo, "shard_id": shard_id}
            self.retained[track_id] = state
            cur = self.retained_by_icao.get(icao)
            if cur is None or self.retained[cur]["time"] <= state["time"]:
                self.retained_by_icao[icao] = track_id

    # -- queries (served through serving.service.StoreFrontEnd) ------------

    def latest(self, *, track_id: Optional[str] = None,
               icao24: Optional[str] = None) -> Optional[dict]:
        """Latest retained state for a track (or a transponder)."""
        if track_id is not None:
            return self.retained.get(track_id)
        if icao24 is not None:
            tid = self.retained_by_icao.get(icao24)
            return None if tid is None else self.retained.get(tid)
        raise ValueError("latest() needs track_id= or icao24=")

    def nearest(self, lat: float, lon: float) -> Optional[dict]:
        """Retained state nearest to (lat, lon) — equirectangular
        squared distance, ties broken by track id for determinism."""
        best, best_key = None, None
        coslat = np.cos(np.deg2rad(lat))
        for tid in sorted(self.retained):
            st = self.retained[tid]
            d2 = ((st["lat"] - lat) ** 2
                  + ((st["lon"] - lon) * coslat) ** 2)
            if best_key is None or d2 < best_key:
                best, best_key = st, d2
        return best

    @property
    def generation(self) -> int:
        """Committed manifest generation (0 when no manifest yet)."""
        try:
            return StoreManifest.load(self.store_root).generation
        except FileNotFoundError:
            return 0

    # -- ingest cycle ------------------------------------------------------

    def scan(self) -> list[tuple[str, str, int]]:
        """One directory scan; returns fresh (track_id, path, size)
        sources in sorted-id order."""
        self.stats["scans"] += 1
        pending_ids = {t for t, _, _ in self._pending}
        new = [s for s in _scan_sources(self.src_root)
               if s[0] not in self._known and s[0] not in pending_ids
               and s[0] not in self._planned]
        self._hook("scan", new=[s[0] for s in new])
        if new:
            self._instant("ingest_scan", extra=len(new))
        return new

    def accept(self, sources: Sequence[tuple[str, str, int]]
               ) -> list[ShardPlan]:
        """Fold fresh sources into the pending buffer, replaying
        :func:`~repro_torch.store.writer.plan_shards`' greedy cut rule
        incrementally; returns the shard plans cut by this acceptance
        (the remainder stays pending until more arrive or
        :meth:`seal`)."""
        if self.sealed:
            raise RuntimeError(f"store {self.store_root} is sealed")
        plans: list[ShardPlan] = []
        for track_id, path, size_bytes in sources:
            est = max(size_bytes // EST_BYTES_PER_OBS, 1)
            if self._pending and self._pending_points + est \
                    > self.target_points:
                plans.append(self._cut())
            self._pending.append((track_id, path, size_bytes))
            self._pending_points += est
            self.stats["files_accepted"] += 1
        return plans

    def _cut(self) -> ShardPlan:
        plan = ShardPlan(
            f"s{self._n_planned:05d}",
            tuple((t, p) for t, p, _ in self._pending))
        self._n_planned += 1
        self._planned |= {t for t, _, _ in self._pending}
        self._pending, self._pending_points = [], 0
        self._hook("cut", plan=plan)
        self._instant("ingest_cut", extra=plan.shard_id)
        return plan

    def build_and_commit(self, plan: ShardPlan) -> None:
        """Build one cut shard and append it to the manifest (the
        inline, single-threaded execution path; the DAG path builds on
        workers and funnels results through :meth:`commit_result`)."""
        self._hook("pre_build", plan=plan)
        tr = self.tracer
        tt0 = tr.now() if tr is not None else 0.0
        rec, tracks = build_shard(self.store_root, plan,
                                  compression=self.compression)
        if tr is not None:
            tr.emit(tt0, tr.now() - tt0, "ingest_build", "serving",
                    "ingest", extra=rec.shard_id)
        self._hook("post_build", shard_id=rec.shard_id)
        self.commit_result({"shard": rec.to_doc(),
                            "tracks": [t.to_doc() for t in tracks]})

    def commit_result(self, result: dict) -> None:
        """Atomically append one built shard (idempotent by shard id)
        and fold it into the retained snapshot."""
        shard_id = result["shard"]["shard_id"]
        self._hook("pre_commit", shard_id=shard_id)
        tr = self.tracer
        tt0 = tr.now() if tr is not None else 0.0
        rec = commit_shard(self.store_root, result,
                           compression=self.compression,
                           target_points=self.target_points)
        if tr is not None:
            tr.emit(tt0, tr.now() - tt0, "ingest_commit", "serving",
                    "ingest", extra=shard_id)
        ids = {d["track_id"] for d in result["tracks"]}
        self._known |= ids
        self._planned -= ids
        self._retain_shard(rec.shard_id, rec.filename)
        self.stats["shards_committed"] += 1
        self.stats["points_ingested"] += rec.n_points
        self.stats["last_commit_at"] = self._clock()
        self._hook("post_commit", shard_id=shard_id,
                   generation=self.generation)

    def poll_once(self) -> int:
        """One full scan -> cut -> build -> commit cycle on the caller's
        thread; returns the number of shards committed."""
        plans = self.accept(self.scan())
        for plan in plans:
            self.build_and_commit(plan)
        return len(plans)

    def ingest_lag(self) -> int:
        """Accepted-but-uncommitted observation points (estimate) — the
        bench's bounded-lag gate watches this between commits."""
        return self._pending_points

    def seal(self, meta: Optional[dict] = None) -> StoreManifest:
        """Flush the pending remainder as a final shard and finalize the
        manifest — byte-identical to a batch build of the same files."""
        if self._pending:
            self.build_and_commit(self._cut())
        manifest = finalize_manifest(
            self.store_root, compression=self.compression,
            target_points=self.target_points,
            meta=(meta if meta is not None
                  else {"source_root": os.path.abspath(self.src_root)}))
        self.sealed = True
        self._hook("seal", generation=manifest.generation)
        self._instant("ingest_seal", extra=manifest.generation)
        return manifest

    # -- fleet execution over the streaming DAG ----------------------------

    def run_service(self, *, backend: str = "threads",
                    n_workers: int = 2,
                    poll_interval: float = 0.005,
                    stop_when: Optional[Callable[[], bool]] = None,
                    seal_on_stop: bool = True,
                    max_ticks: Optional[int] = None,
                    **run_kw):
        """Drive ingest through :func:`repro_torch.runtime.dag.run_service`:
        an *open* ``build`` node receives shard tasks as scans cut them,
        workers build shard files in parallel, and a manager-side edge
        emitter commits results in shard order (contiguous manifest
        prefix — the restart-replay invariant).  Stops when
        ``stop_when()`` is true (default: the source tree is fully
        ingested and nothing is pending), then seals the store.
        """
        from repro_torch.runtime.dag import StreamingDAG, run_service

        dag = StreamingDAG()
        dag.add_node("build", fn=ShardBuilder(self.store_root,
                                              self.compression),
                     open=True)
        dag.add_node("retain")
        dag.add_edge("build", "retain", emitter=_OrderedCommitEmitter(self))
        ticks = 0

        def tick(coord) -> bool:
            nonlocal ticks
            ticks += 1
            for plan in self.accept(self.scan()):
                est = sum(max(os.path.getsize(p) // EST_BYTES_PER_OBS, 1)
                          for _tid, p in plan.sources)
                coord.admit_node("build", [Task(
                    task_id=plan.shard_id, payload=plan.dumps(),
                    size_bytes=est)])
            if max_ticks is not None and ticks >= max_ticks:
                return False
            if stop_when is not None:
                return not stop_when()
            return True

        run_kw.setdefault("tracer", self.tracer)
        result = run_service(dag, tick=tick, backend=backend,
                             n_workers=n_workers,
                             poll_interval=poll_interval, **run_kw)
        if seal_on_stop and not self.sealed:
            self.seal()
        return result


class _OrderedCommitEmitter:
    """Streaming-DAG edge emitter that funnels built-shard results into
    :meth:`IngestService.commit_result` **in shard-id order**: a result
    completing out of order is buffered until its predecessors commit,
    so the manifest always holds a contiguous prefix of the planned
    shards (what makes kill/restart replay deterministic).  Emits no
    downstream tasks — the ``retain`` node is a sink."""

    def __init__(self, service: IngestService):
        self.service = service
        self._buffer: dict[str, dict] = {}

    def prime(self, src_task_ids) -> None:
        pass

    def feed(self, task: Task, result: Any) -> list[Task]:
        if result is not None:
            self._buffer[task.task_id] = result
        self._drain()
        return []

    def _drain(self) -> None:
        while True:
            nxt = f"s{self._next_index():05d}"
            res = self._buffer.pop(nxt, None)
            if res is None:
                return
            self.service.commit_result(res)

    def _next_index(self) -> int:
        try:
            manifest = StoreManifest.load(self.service.store_root)
        except FileNotFoundError:
            return 0
        return len(manifest.shards)

    def finish(self) -> list[Task]:
        self._drain()
        return []

    def state(self) -> Optional[dict]:
        return {"buffer": self._buffer} if self._buffer else None

    def restore(self, state: dict) -> None:
        self._buffer.update(state.get("buffer", {}))
