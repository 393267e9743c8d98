"""End-to-end track-processing workflow driver (paper §III.A).

Port of ``repro/tracks/workflow.py``: the phases organize -> archive
[-> store-build] -> process [-> screen] run on the self-scheduling
runtime (:func:`repro_torch.runtime.run_job`), with a JSON phase
checkpoint so a killed job resumes where it left off, and periodic
mid-phase manager checkpoints so it resumes inside a phase.  The process
and screen phases run on the card (``device=None``) unless the caller
names another device.

With ``input="store"`` a ``store-build`` phase (one self-scheduled task
per shard, :class:`repro_torch.store.ShardBuilder` as the worker fn)
ingests the zip archives into the columnar track store, and the process
phase reads ``store://`` shard tasks instead of re-parsing CSV text.

``mode="dag"`` (``--pipeline dag``) replaces the barrier sequence with
the streaming phase DAG (:func:`repro_torch.runtime.run_dag`): each
completed archive feeds the shard planner (:class:`_ShardPlanEmitter`),
which cuts a store-build task the moment enough consecutive archives
exist; each committed shard (:class:`_ShardCommitEmitter` appends it to
the manifest) immediately emits its process task; each processed shard
admits the screen cells it completes (:class:`_CellBinEmitter`).  The
final store and ``candidates.json`` are byte-identical to a barrier
run's.  ``n_manager_shards`` > 1 splits the coordinator into that many
shard queues (paper §V's message-rate wall).

``screen=True`` (which needs ``input="store"``) appends an
encounter-screen phase: processed segment rows are binned into a
halo-padded spatial hash (:mod:`repro_torch.geometry.gridhash`) and every
multi-row cell becomes a self-scheduled task running the pairwise
miss-distance kernel (:mod:`repro_torch.kernels.encounter_screen`), with
the deduplicated candidate encounters written to ``candidates.json``.

``--serve`` (:func:`run_serve`) runs the continuous-ingest serving
mode instead: a synthetic live feed tailed into the store through the
service DAG (:class:`repro_torch.serving.IngestService`), then queries
through :class:`repro_torch.serving.StoreFrontEnd`.  It is host work
and runs without a card and without ``--device``.

CLI:  PYTHONPATH=src python -m repro_torch.tracks.workflow
      PYTHONPATH=src python -m repro_torch.tracks.workflow --serve --files 12
      PYTHONPATH=src python -m repro_torch.tracks.workflow --device cpu \\
          --backend processes --input store --screen
      PYTHONPATH=src python -m repro_torch.tracks.workflow --device cpu \\
          --input store --screen --pipeline dag --manager-shards 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
import time
from typing import Optional

from repro_torch.core.messages import Task
from repro_torch.core.triples import TriplesConfig
from repro_torch.geometry.aerodromes import synthetic_aerodromes
from repro_torch.geometry.dem import SyntheticGlobeDEM
from repro_torch.geometry.gridhash import GridSpec, cell_cost, cell_id
from repro_torch.kernels import ops
from repro_torch.kernels.encounter_screen import (
    ScreenConfig, bin_screen_rows, dedup_candidates, rows_from_track,
    screen_cells)
from repro_torch.runtime import (
    EdgeEmitter, ManagerCheckpoint, RunResult, StreamingDAG, run_dag,
    run_job)
from repro_torch.store import writer as store_writer
from repro_torch.store.format import MANIFEST_NAME
from repro_torch.store.uri import make_store_uri
from repro_torch.tracks.archive import Archiver, archive_tasks_from_tree
from repro_torch.tracks.datasets import (
    SCREEN_ROW_BYTES, ScaledDatasetSpec, write_scaled_dataset)
from repro_torch.tracks.organize import Organizer, organize_tasks_from_dir
from repro_torch.tracks.registry import synthetic_registry
from repro_torch.tracks.segments import (
    _STORE_BYTES_PER_POINT, SegmentProcessor,
    segment_tasks_from_archive_tree, segment_tasks_from_store,
    split_segments)

@dataclasses.dataclass
class PhaseReport:
    phase: str
    job_seconds: float
    tasks: int
    workers: int
    messages: int

    @classmethod
    def from_job(cls, phase: str, r: RunResult, tasks: int,
                 workers: int) -> "PhaseReport":
        return cls(phase=phase, job_seconds=r.job_seconds, tasks=tasks,
                   workers=workers, messages=r.messages_sent)


class _ShardPlanEmitter(EdgeEmitter):
    """archive -> store-build streaming edge: cut shard plans as soon as
    enough *consecutive* archives exist.

    :func:`repro_torch.store.writer.plan_shards` assigns tracks to shards
    in sorted-id order, so the plan for shard k depends only on the sizes
    of the first tracks in that order.  The emitter is primed with the
    archive node's task ids (the expected zip set), buffers sizes as
    archives complete out of order, and consumes the contiguous sorted
    prefix through the same greedy cut — the resulting partition (and
    shard numbering) is identical to the barrier build's, it just
    doesn't wait for the last archive before planning the first shard.
    """

    def __init__(self, archive_root: str, target_points: int):
        self.archive_root = archive_root
        self.target_points = target_points
        self.expected: list[str] = []       # sorted zip ids, set by prime
        self.idx = 0                        # consumed contiguous prefix
        self.sizes: dict[str, int] = {}     # zip id -> bytes (fed)
        self.cur: list[str] = []            # open shard's zip ids
        self.cur_points = 0
        self.n_shards = 0

    def prime(self, src_task_ids) -> None:
        # Archive task id '<y>/<t>/<s>/<b>/<icao>' -> zip id '<...>.zip',
        # the same root-relative id discover_sources would assign.
        self.expected = sorted(f"{tid}.zip" for tid in src_task_ids)

    def _cut(self) -> Task:
        plan = store_writer.ShardPlan(
            f"s{self.n_shards:05d}",
            tuple((rel, os.path.join(self.archive_root, rel))
                  for rel in self.cur))
        self.n_shards += 1
        size = sum(self.sizes.pop(rel) for rel in self.cur)
        self.cur, self.cur_points = [], 0
        return Task(task_id=f"store/{plan.shard_id}", size_bytes=size,
                    payload=plan.dumps())

    def _drain(self, skip_missing: bool = False) -> list[Task]:
        out: list[Task] = []
        while self.idx < len(self.expected):
            rel = self.expected[self.idx]
            if rel not in self.sizes:
                if not skip_missing:
                    break
                # Failed archive: leave the hole, store what exists.
                self.idx += 1
                continue
            est = max(self.sizes[rel] // store_writer.EST_BYTES_PER_OBS, 1)
            if self.cur and self.cur_points + est > self.target_points:
                out.append(self._cut())
            self.cur.append(rel)
            self.cur_points += est
            self.idx += 1
        return out

    def feed(self, task: Task, result) -> list[Task]:
        rel = f"{task.task_id}.zip"
        size = getattr(result, "bytes_out", None)
        if size is None and isinstance(result, dict):
            size = result.get("bytes_out")
        if size is None:
            # Resumed/sim completion without a live result doc: the zip
            # is on disk (archives commit atomically), measure it.
            path = os.path.join(self.archive_root, rel)
            try:
                size = os.path.getsize(path)
            except OSError:
                size = max(task.size_bytes, 1)
        self.sizes[rel] = int(size)
        return self._drain()

    def finish(self) -> list[Task]:
        out = self._drain(skip_missing=True)
        if self.cur:
            out.append(self._cut())
        return out

    def state(self) -> dict:
        return {"expected": self.expected, "idx": self.idx,
                "sizes": self.sizes, "cur": self.cur,
                "cur_points": self.cur_points, "n_shards": self.n_shards}

    def restore(self, state: dict) -> None:
        self.expected = list(state["expected"])
        self.idx = int(state["idx"])
        self.sizes = {k: int(v) for k, v in state["sizes"].items()}
        self.cur = list(state["cur"])
        self.cur_points = int(state["cur_points"])
        self.n_shards = int(state["n_shards"])


class _ShardCommitEmitter(EdgeEmitter):
    """store-build -> process streaming edge: append each built shard to
    the manifest (:func:`repro_torch.store.writer.commit_shard`,
    idempotent by shard id) and immediately emit its process task — the
    same id / size / ``store://`` payload :func:`segment_tasks_from_store`
    would produce, so processing starts while later shards are still
    building.
    Stateless: the manifest on disk IS the commit ledger, and a kill
    between manifest append and manager checkpoint just re-commits
    (no-op) on the re-run.
    """

    def __init__(self, store_dir: str, target_points: int):
        self.store_dir = store_dir
        self.target_points = target_points

    def feed(self, task: Task, result) -> list[Task]:
        if result is None:
            # DONE without a result doc (e.g. resumed completion whose
            # records died with a worker): shard builds are
            # deterministic and atomically committed — redo it here.
            result = store_writer.ShardBuilder(self.store_dir)(task)
        rec = store_writer.commit_shard(self.store_dir, result,
                                        target_points=self.target_points)
        return [Task(task_id=f"store/{rec.shard_id}",
                     size_bytes=rec.n_points * _STORE_BYTES_PER_POINT,
                     payload=make_store_uri(self.store_dir,
                                            shard=rec.shard_id))]


def _screen_rows_for_uri(proc: SegmentProcessor, uri: str) -> list:
    """Multi-track ``store://`` selection -> ScreenRows, via the same
    fused segment pipeline the process phase runs (so screening sees
    the process phase's resampled planes)."""
    items = proc._store_items(uri)
    procd = proc._process_triples(items)
    rows = []
    for tid, obs, segs in items:
        if segs:
            rows.extend(rows_from_track(tid, obs, segs, procd[tid]))
    return rows


class ScreenWorker:
    """Self-scheduled encounter-screen task: one spatial-hash cell.

    The task payload is a JSON doc ``{"cell", "all", "new"}`` naming the
    cell and its member row ids.  The worker re-reads each member track
    from the columnar store (``store://...#track=<id>``), re-derives its
    ScreenRows through the fused segment pipeline (deterministic, so
    recomputation after a checkpoint kill is exact), screens the single
    cell with the kernel, and returns the candidate dicts.  With
    ``new != all`` only pairs touching a new row are emitted.

    ``device=None`` means the card.  The device is kept as a string and
    the SegmentProcessor is built lazily, once per process, so the
    worker pickles into a processes-backend worker without touching
    CUDA, and each process opens the card itself.
    """

    def __init__(self, store_dir: str, *, h_thresh_m: float,
                 v_thresh_m: float, device=None, backend: str = "kernel",
                 pipeline: str = "fused"):
        self.store_dir = store_dir
        self.h_thresh_m = h_thresh_m
        self.v_thresh_m = v_thresh_m
        self.device = str(ops.resolve_device(device))
        self.backend = backend
        self.pipeline = pipeline
        self._proc: Optional[SegmentProcessor] = None
        self._lock = threading.Lock()

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        state["_proc"] = None
        state["_lock"] = None
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _processor(self) -> SegmentProcessor:
        with self._lock:
            if self._proc is None:
                self._proc = SegmentProcessor(
                    dem=SyntheticGlobeDEM(),
                    aerodromes=synthetic_aerodromes(n=64),
                    device=self.device, backend=self.backend,
                    pipeline=self.pipeline)
            return self._proc

    def _config(self) -> ScreenConfig:
        return ScreenConfig(h_thresh_m=self.h_thresh_m,
                            v_thresh_m=self.v_thresh_m,
                            backend=self.backend, device=self.device)

    def __call__(self, task: Task) -> dict:
        doc = json.loads(task.payload)
        wanted = set(doc["all"])
        tracks = sorted({rid.rsplit("#", 1)[0] for rid in wanted})
        proc = self._processor()
        rows = []
        for tid in tracks:
            uri = make_store_uri(self.store_dir, track=tid)
            obs = proc.read_observations(uri)
            segs = split_segments(obs["time"])
            if not segs:
                continue
            ps = proc.process_arrays(obs, segs)
            rows.extend(r for r in rows_from_track(tid, obs, segs, ps)
                        if r.row_id in wanted)
        new = set(doc["new"])
        cands, stats = screen_cells(
            {doc["cell"]: rows}, config=self._config(),
            new_ids=None if new >= wanted else {doc["cell"]: new})
        return {"candidates": cands, "stats": stats}


class _CellBinEmitter(EdgeEmitter):
    """process -> screen streaming edge: admit screen cells as upstream
    shards commit.

    Each completed process task covers one committed store shard; the
    emitter re-derives that shard's ScreenRows from the store (never
    from the in-flight result object, so live runs, sim runs, and
    post-checkpoint resumes all emit identical tasks), bins them into
    the halo-padded spatial hash, and — whenever a cell holds >= 2 rows
    with unscreened members — cuts a *generation* task
    ``screen/<cell>/g<n>`` carrying the cell's full membership plus the
    newly-arrived rows.  Workers screen only pairs touching a new row,
    so the union over generations is exactly the barrier run's pair set
    (each track lives in exactly one shard, so a row arrives once).
    ``cpu_cost_hint`` uses the incremental quadratic cost
    :func:`repro_torch.geometry.gridhash.cell_cost`, giving sized_lpt /
    adaptive_chunk real occupancy skew to schedule against.

    The emitter runs in the manager, on the workflow's device and kernel
    backend, so it bins by the same resampled positions the screen
    workers derive (a row near a cell edge lands in the same cell).  Its
    SegmentProcessor is built at the first ``feed``: a fresh run touches
    the card in the parent only after the transport has started its
    workers.  ``state()`` is plain JSON.
    """

    def __init__(self, store_dir: str, grid: GridSpec,
                 config: ScreenConfig, *, device: str,
                 backend: str = "kernel", pipeline: str = "fused"):
        self.store_dir = store_dir
        self.grid = grid
        self.config = config
        self.device = device
        self.backend = backend
        self.pipeline = pipeline
        self.members: dict[str, list[str]] = {}   # cell -> all row ids
        self.pending: dict[str, list[str]] = {}   # cell -> unscreened ids
        self.gen: dict[str, int] = {}             # cell -> generations cut
        self._proc: Optional[SegmentProcessor] = None

    def _processor(self) -> SegmentProcessor:
        if self._proc is None:
            self._proc = SegmentProcessor(
                dem=SyntheticGlobeDEM(),
                aerodromes=synthetic_aerodromes(n=64),
                device=self.device, backend=self.backend,
                pipeline=self.pipeline)
        return self._proc

    def feed(self, task: Task, result) -> list[Task]:
        rows = _screen_rows_for_uri(self._processor(), task.payload)
        bins = bin_screen_rows(rows, grid=self.grid, config=self.config)
        out: list[Task] = []
        for key in sorted(bins):
            cid = cell_id(key)
            arrived = sorted(bins[key])
            self.members.setdefault(cid, []).extend(arrived)
            self.pending.setdefault(cid, []).extend(arrived)
            if len(self.members[cid]) < 2 or not self.pending[cid]:
                continue
            g = self.gen.get(cid, 0) + 1
            self.gen[cid] = g
            all_ids = sorted(self.members[cid])
            new_ids = sorted(self.pending[cid])
            self.pending[cid] = []
            out.append(Task(
                task_id=f"screen/{cid}/g{g}",
                size_bytes=len(all_ids) * SCREEN_ROW_BYTES,
                payload=json.dumps({"cell": cid, "all": all_ids,
                                    "new": new_ids}, sort_keys=True),
                cpu_cost_hint=cell_cost(len(all_ids), len(new_ids))))
        return out

    def state(self) -> dict:
        return {"members": self.members, "pending": self.pending,
                "gen": self.gen}

    def restore(self, state: dict) -> None:
        self.members = {k: list(v) for k, v in state["members"].items()}
        self.pending = {k: list(v) for k, v in state["pending"].items()}
        self.gen = {k: int(v) for k, v in state["gen"].items()}


class TrackWorkflow:
    """organize -> archive [-> store-build] -> process [-> screen] with
    self-scheduling + checkpoints, as barrier phases or one streaming
    DAG (``mode``)."""

    def __init__(self, root: str, n_workers: int = 8,
                 organization: str = "largest_first",
                 poll_interval: float = 0.01,
                 backend: str = "kernel",
                 pipeline: str = "fused",
                 exec_backend: str = "threads",
                 tasks_per_message: int = 1,
                 policy: str = "static",
                 checkpoint_interval_s: float = 0.5,
                 triple: Optional[TriplesConfig] = None,
                 input: str = "zip",
                 store_target_points: Optional[int] = None,
                 mode: str = "barrier",
                 n_manager_shards: int = 1,
                 screen: bool = False,
                 screen_h_m: float = 926.0,
                 screen_v_m: float = 152.4,
                 screen_cell_deg: float = 0.25,
                 speculative: bool = False,
                 elastic: bool = False,
                 seed: int = 0,
                 device=None,
                 tracer=None):
        if exec_backend not in ("threads", "processes"):
            raise ValueError(
                "workflow phases do real work; exec_backend must be "
                "'threads' or 'processes'")
        if input not in ("zip", "store"):
            raise ValueError(f"unknown input {input!r}; 'zip' processes "
                             f"archives directly, 'store' inserts a "
                             f"store-build phase")
        if mode not in ("barrier", "dag"):
            raise ValueError(f"unknown pipeline mode {mode!r}; 'barrier' "
                             f"runs the phases sequentially, 'dag' "
                             f"streams tasks between them")
        if n_manager_shards < 1:
            raise ValueError("n_manager_shards must be >= 1")
        if screen and input != "store":
            raise ValueError("--screen needs --input store: screening "
                             "re-reads segment rows from the columnar "
                             "store (store:// track selections)")
        from repro_torch.runtime.policies import POLICY_NAMES
        if policy not in POLICY_NAMES:
            raise ValueError(f"unknown scheduling policy {policy!r}; "
                             f"choose from {list(POLICY_NAMES)}")
        if elastic:
            if exec_backend != "threads":
                raise ValueError("--elastic needs exec_backend='threads' "
                                 "(processes cannot spawn workers mid-run)")
            if n_manager_shards > 1:
                raise ValueError("--elastic needs n_manager_shards=1")
        self.device = ops.resolve_device(device)
        self.root = root
        self.raw_dir = os.path.join(root, "raw")
        self.organized_dir = os.path.join(root, "organized")
        self.archive_dir = os.path.join(root, "archived")
        self.store_dir = os.path.join(root, "store")
        self.input = input
        self.store_target_points = store_target_points
        self.mode = mode
        self.n_manager_shards = n_manager_shards
        self.ckpt_path = os.path.join(root, "workflow_ckpt.json")
        self.screen = screen
        self.screen_grid = GridSpec(cell_deg=screen_cell_deg)
        self.screen_config = ScreenConfig(h_thresh_m=screen_h_m,
                                          v_thresh_m=screen_v_m,
                                          backend=backend,
                                          device=str(self.device))
        self.candidates_path = os.path.join(root, "candidates.json")
        self.n_workers = (max(triple.worker_processes, 1)
                          if triple is not None else n_workers)
        self.organization = organization
        self.poll_interval = poll_interval
        self.backend = backend
        self.pipeline = pipeline
        self.exec_backend = exec_backend
        self.tasks_per_message = tasks_per_message
        self.policy = policy
        self.speculative = speculative
        self.elastic = elastic
        self.checkpoint_interval_s = checkpoint_interval_s
        self.seed = seed
        #: Optional :class:`repro_torch.obs.Tracer`, threaded through
        #: every phase run (barrier and dag): one trace covers the whole
        #: workflow, with task ids namespaced per phase.
        self.tracer = tracer
        self.registry = synthetic_registry(n=2000, seed=seed + 13)
        self.reports: list[PhaseReport] = []

    # -- checkpointing ----------------------------------------------------

    def _load_ckpt(self) -> dict:
        if os.path.exists(self.ckpt_path):
            with open(self.ckpt_path) as f:
                return json.load(f)
        return {"phases_done": [], "manager": None}

    def _save_ckpt(self, state: dict) -> None:
        tmp = self.ckpt_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.ckpt_path)

    # -- phases -----------------------------------------------------------

    def generate_raw(self, n_files: int = 12, scale: float = 1e4) -> int:
        spec = ScaledDatasetSpec(name="monday-scaled", n_files=n_files,
                                 scale=scale, seed=self.seed)
        paths = write_scaled_dataset(self.raw_dir, spec)
        return len(paths)

    def _run_phase(self, phase: str, tasks, fn,
                   organization: Optional[str] = None) -> RunResult:
        state = self._load_ckpt()
        ck = None
        if state.get("manager") and state.get("manager_phase") == phase:
            ck = ManagerCheckpoint.loads(state["manager"])

        def save_mid_phase(c: ManagerCheckpoint) -> None:
            # Persist the manager's ledger periodically so a kill mid-phase
            # resumes from the last checkpoint instead of re-running the
            # whole phase.
            mid = dict(state)
            mid["manager"] = c.dumps()
            mid["manager_phase"] = phase
            self._save_ckpt(mid)

        result = run_job(
            tasks, fn,
            backend=self.exec_backend,
            n_workers=self.n_workers,
            organization=organization or self.organization,
            tasks_per_message=self.tasks_per_message,
            policy=self.policy,
            speculative=self.speculative,
            elastic=self.elastic,
            poll_interval=self.poll_interval,
            checkpoint=ck,
            on_checkpoint=save_mid_phase,
            checkpoint_interval_s=self.checkpoint_interval_s,
            tracer=self.tracer)
        state["phases_done"].append(phase)
        state["manager"] = None
        state["manager_phase"] = None
        self._save_ckpt(state)
        self.reports.append(PhaseReport.from_job(
            phase, result, len(tasks), self.n_workers))
        return result

    def _run_store_build(self) -> None:
        """Self-scheduled shard ingest: archives -> columnar store."""
        sources = store_writer.discover_sources(self.archive_dir)
        sizes = {track_id: size for track_id, _p, size in sources}
        target = (self.store_target_points
                  or store_writer.DEFAULT_TARGET_POINTS)
        plans = store_writer.plan_shards(sources, target_points=target)
        tasks = [Task(task_id=f"store/{p.shard_id}",
                      size_bytes=sum(sizes[t] for t, _ in p.sources),
                      payload=p.dumps())
                 for p in plans]
        builder = store_writer.ShardBuilder(self.store_dir)
        result = self._run_phase("store-build", tasks, builder)
        results = []
        for task in tasks:
            doc = result.results.get(task.task_id)
            if doc is None:
                # Completed before a mid-phase checkpoint kill: the
                # restored manager never re-dispatches the task, so its
                # records died with the worker.  Shard builds are
                # deterministic and atomically committed: redo it.
                doc = builder(task)
            results.append(doc)
        store_writer.finalize_store(
            self.store_dir, results, target_points=target,
            meta={"source_root": os.path.abspath(self.archive_dir)})

    # -- encounter screening ---------------------------------------------

    def _screen_worker(self) -> ScreenWorker:
        return ScreenWorker(self.store_dir,
                            h_thresh_m=self.screen_config.h_thresh_m,
                            v_thresh_m=self.screen_config.v_thresh_m,
                            device=self.screen_config.device,
                            backend=self.backend, pipeline=self.pipeline)

    def _screen_tasks_full(self) -> list[Task]:
        """One task per multi-row cell over the finished store (every
        pair screened: ``new == all``).  The rows come from the segment
        pipeline on this workflow's device, here in the parent."""
        proc = SegmentProcessor(
            dem=SyntheticGlobeDEM(),
            aerodromes=synthetic_aerodromes(n=64),
            device=self.device, backend=self.backend,
            pipeline=self.pipeline)
        rows = []
        for t in segment_tasks_from_store(self.store_dir,
                                          granularity="shard"):
            rows.extend(_screen_rows_for_uri(proc, t.payload))
        bins = bin_screen_rows(rows, grid=self.screen_grid,
                               config=self.screen_config)
        tasks = []
        for key in sorted(bins):
            ids = sorted(bins[key])
            if len(ids) < 2:
                continue
            cid = cell_id(key)
            tasks.append(Task(
                task_id=f"screen/{cid}/g1",
                size_bytes=len(ids) * SCREEN_ROW_BYTES,
                payload=json.dumps({"cell": cid, "all": ids, "new": ids},
                                   sort_keys=True),
                cpu_cost_hint=cell_cost(len(ids))))
        return tasks

    def _write_candidates(self, cands) -> str:
        """Canonical candidate file: deduped, (a, b)-sorted, sorted
        keys, in the reference's schema."""
        doc = {
            "schema": "repro.encounters/v1",
            "thresholds": {"h_m": self.screen_config.h_thresh_m,
                           "v_m": self.screen_config.v_thresh_m},
            "grid": {"cell_deg": self.screen_grid.cell_deg,
                     "cell_alt_m": self.screen_grid.cell_alt_m,
                     "cell_t_s": self.screen_grid.cell_t_s},
            "candidates": dedup_candidates(cands),
        }
        tmp = self.candidates_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True, indent=1)
            f.write("\n")
        os.replace(tmp, self.candidates_path)
        return self.candidates_path

    def _run_screen_barrier(self) -> None:
        tasks = self._screen_tasks_full()
        worker = self._screen_worker()
        cands: list = []
        if tasks:
            result = self._run_phase("screen", tasks, worker)
            for task in tasks:
                doc = result.results.get(task.task_id)
                if doc is None:
                    # Completed before a mid-phase checkpoint kill;
                    # screening is deterministic: redo the cell.
                    doc = worker(task)
                cands.extend(doc["candidates"])
        else:
            state = self._load_ckpt()
            state["phases_done"].append("screen")
            self._save_ckpt(state)
        self._write_candidates(cands)

    def _run_dag(self) -> None:
        """Streaming-DAG pipeline (``mode='dag'``): one coordinator, no
        phase barriers — archive completions cut shard plans, shard
        commits emit process tasks (see the emitters above).  The DAG
        frontier rides the same workflow checkpoint as the barrier
        phases, so a mid-stream kill resumes mid-stream."""
        state = self._load_ckpt()
        ck = None
        if state.get("manager") and state.get("manager_phase") == "dag":
            ck = ManagerCheckpoint.loads(state["manager"])

        # Phases a previous run (barrier OR dag) already completed stay
        # done: re-running the append-mode Organizer over an organized
        # tree would double every track, so completed phases are simply
        # absent from the node graph.
        done = set(state["phases_done"])
        if self.input == "store" and "store-build" in done and \
                not os.path.exists(os.path.join(self.store_dir,
                                                MANIFEST_NAME)):
            done.discard("store-build")
        if self.screen and "screen" in done and \
                not os.path.exists(self.candidates_path):
            done.discard("screen")
        run_organize = "organize" not in done
        run_archive = "archive" not in done
        run_store = self.input == "store" and "store-build" not in done
        run_process = "process" not in done
        run_screen = self.screen and "screen" not in done

        target = (self.store_target_points
                  or store_writer.DEFAULT_TARGET_POINTS)
        dag = StreamingDAG()
        if run_organize:
            dag.add_node("organize",
                         fn=Organizer(self.organized_dir, self.registry),
                         tasks=organize_tasks_from_dir(self.raw_dir))
        if run_archive:
            arch = Archiver(self.organized_dir, self.archive_dir)
            if run_organize:
                dag.add_node("archive", fn=arch)
                # Barrier edge: archive-task discovery scans the
                # organized tree, which is only final once every
                # organize task has landed.
                dag.add_edge("organize", "archive",
                             on_complete=lambda: archive_tasks_from_tree(
                                 self.organized_dir))
            else:
                dag.add_node("archive", fn=arch,
                             tasks=archive_tasks_from_tree(
                                 self.organized_dir))
        if run_process:
            process_tasks = None
            if not run_store and not run_archive:
                process_tasks = (
                    segment_tasks_from_store(self.store_dir,
                                             granularity="shard")
                    if self.input == "store" else
                    segment_tasks_from_archive_tree(self.archive_dir))
            # The process node keeps the DAG's organization (the barrier
            # phase dispatches it under "random"), so per-worker launch
            # shapes differ from a barrier run's; results do not.
            dag.add_node("process", fn=SegmentProcessor(
                dem=SyntheticGlobeDEM(),
                aerodromes=synthetic_aerodromes(n=64),
                device=self.device, backend=self.backend,
                pipeline=self.pipeline),
                tasks=process_tasks)
        store_tasks = None
        if run_store:
            if run_archive:
                dag.add_node("store-build",
                             fn=store_writer.ShardBuilder(self.store_dir))
                dag.add_edge("archive", "store-build",
                             emitter=_ShardPlanEmitter(self.archive_dir,
                                                       target))
            else:
                # Archives already on disk — plan the shards up front,
                # exactly like the barrier store-build phase.
                sources = store_writer.discover_sources(self.archive_dir)
                sizes = {tid: size for tid, _p, size in sources}
                plans = store_writer.plan_shards(sources,
                                                 target_points=target)
                store_tasks = [
                    Task(task_id=f"store/{p.shard_id}",
                         size_bytes=sum(sizes[t] for t, _ in p.sources),
                         payload=p.dumps())
                    for p in plans]
                dag.add_node(
                    "store-build",
                    fn=store_writer.ShardBuilder(self.store_dir),
                    tasks=store_tasks)
            if run_process:
                dag.add_edge("store-build", "process",
                             emitter=_ShardCommitEmitter(self.store_dir,
                                                         target))
        screen_tasks = None
        screen_emitter = None
        if run_screen:
            if run_process:
                # Streaming edge: cells admit generations as the shards
                # feeding them commit and process.
                screen_emitter = _CellBinEmitter(
                    self.store_dir, self.screen_grid, self.screen_config,
                    device=str(self.device), backend=self.backend,
                    pipeline=self.pipeline)
                dag.add_node("screen", fn=self._screen_worker())
                dag.add_edge("process", "screen", emitter=screen_emitter)
            else:
                # Store already processed by a prior run: plan the cells
                # up front, exactly like the barrier screen phase (on the
                # card in the parent, so processes workers are spawned).
                screen_tasks = self._screen_tasks_full()
                dag.add_node("screen", fn=self._screen_worker(),
                             tasks=screen_tasks)
        if self.input != "store" and run_process and run_archive:
            archive_root = self.archive_dir

            def zip_process_task(task: Task, result) -> list[Task]:
                # 1:1 expansion matching segment_tasks_from_archive_tree.
                rel = f"{task.task_id}.zip"
                path = os.path.join(archive_root, rel)
                size = getattr(result, "bytes_out", None)
                if size is None:
                    size = (os.path.getsize(path)
                            if os.path.exists(path) else task.size_bytes)
                return [Task(task_id=rel, size_bytes=int(size),
                             payload=path)]

            dag.add_edge("archive", "process", expand=zip_process_task)

        if not dag.nodes:
            state["phases_done"].append("dag")
            self._save_ckpt(state)
            return

        def save_mid_stream(c: ManagerCheckpoint) -> None:
            mid = dict(state)
            mid["manager"] = c.dumps()
            mid["manager_phase"] = "dag"
            self._save_ckpt(mid)

        result = run_dag(
            dag,
            backend=self.exec_backend,
            n_workers=self.n_workers,
            n_manager_shards=self.n_manager_shards,
            organization=self.organization,
            tasks_per_message=self.tasks_per_message,
            policy=self.policy,
            poll_interval=self.poll_interval,
            checkpoint=ck,
            on_checkpoint=save_mid_stream,
            checkpoint_interval_s=self.checkpoint_interval_s,
            speculative=self.speculative,
            elastic=self.elastic,
            tracer=self.tracer)
        if run_store:
            if store_tasks is not None:
                # No process edge to stream commits through (a prior run
                # already processed): commit the built shards here.
                # commit_shard is idempotent, and builds completed before
                # a checkpoint kill are deterministic — just redo them.
                builder = store_writer.ShardBuilder(self.store_dir)
                docs = result.node_results.get("store-build", {})
                for task in store_tasks:
                    doc = docs.get(task.task_id)
                    if doc is None:
                        doc = builder(task)
                    store_writer.commit_shard(self.store_dir, doc,
                                              target_points=target)
            # Seal the incrementally-committed manifest; byte-identical
            # to the barrier build's finalize_store output.
            store_writer.finalize_manifest(
                self.store_dir, target_points=target,
                meta={"source_root": os.path.abspath(self.archive_dir)})
        if run_screen:
            worker = self._screen_worker()
            docs = result.node_results.get("screen", {})
            by_id = {t.task_id: t for t in (screen_tasks or [])}
            cands: list = []
            for tid in sorted(result.node_completed.get("screen", [])):
                doc = docs.get(tid)
                if doc is None:
                    # Completed before a checkpoint kill: rebuild the
                    # task and screen it here, in the parent, on the
                    # workflow's device.  Emitter-cut generations
                    # rebuild from the (restored + re-fed) full cell
                    # membership — a superset of the lost generation's
                    # pairs, which the canonical dedup collapses back
                    # exactly.
                    task = by_id.get(tid)
                    if task is None:
                        cid = tid.split("/")[1]
                        ids = sorted(screen_emitter.members.get(cid, []))
                        task = Task(task_id=tid,
                                    payload=json.dumps(
                                        {"cell": cid, "all": ids,
                                         "new": ids}, sort_keys=True))
                    doc = worker(task)
                cands.extend(doc["candidates"])
            self._write_candidates(cands)
        # Node names double as the barrier-phase names: record them so
        # switching back to mode="barrier" later never re-runs them.
        state["phases_done"].extend(dag.nodes)
        state["phases_done"].append("dag")
        state["manager"] = None
        state["manager_phase"] = None
        self._save_ckpt(state)
        n_tasks = sum(len(c) for c in result.node_completed.values())
        self.reports.append(PhaseReport(
            phase="dag", job_seconds=result.job_seconds, tasks=n_tasks,
            workers=self.n_workers, messages=result.run.messages_sent))

    def run(self) -> list[PhaseReport]:
        if self.mode == "dag":
            done = set(self._load_ckpt()["phases_done"])
            if "dag" not in done or (self.screen and (
                    "screen" not in done
                    or not os.path.exists(self.candidates_path))):
                self._run_dag()
            return self.reports
        done = set(self._load_ckpt()["phases_done"])
        if self.input == "store" and "store-build" in done and \
                not os.path.exists(os.path.join(self.store_dir,
                                                MANIFEST_NAME)):
            # Killed between phase completion and the manifest commit:
            # shard builds are idempotent, so just redo the phase.
            done.discard("store-build")
        if self.screen and "screen" in done and \
                not os.path.exists(self.candidates_path):
            # Killed between phase completion and the candidate write:
            # cell screens are deterministic, so just redo the phase.
            done.discard("screen")
        if "organize" not in done:
            org = Organizer(self.organized_dir, self.registry)
            tasks = organize_tasks_from_dir(self.raw_dir)
            self._run_phase("organize", tasks, org)
        if "archive" not in done:
            arch = Archiver(self.organized_dir, self.archive_dir)
            tasks = archive_tasks_from_tree(self.organized_dir)
            # §IV.B: cyclic beats block for this phase; self-scheduling
            # subsumes both — keep largest_first.
            self._run_phase("archive", tasks, arch)
        if self.input == "store" and "store-build" not in done:
            self._run_store_build()
        if "process" not in done:
            proc = SegmentProcessor(
                dem=SyntheticGlobeDEM(),
                aerodromes=synthetic_aerodromes(n=64),
                device=self.device, backend=self.backend,
                pipeline=self.pipeline)
            if self.input == "store":
                tasks = segment_tasks_from_store(self.store_dir,
                                                 granularity="shard")
            else:
                tasks = segment_tasks_from_archive_tree(self.archive_dir)
            # §IV.C: random organization for processing.  A multi-task
            # ASSIGN executes as bucketed pipeline calls via
            # SegmentProcessor.process_batch (store:// shard payloads
            # stream through the TrackStore reader).
            self._run_phase("process", tasks, proc, organization="random")
        if self.screen and "screen" not in done:
            self._run_screen_barrier()
        return self.reports


def run_serve(root: str, *, n_files: int = 12, obs_per_file: int = 64,
              seed: int = 0, n_workers: int = 4,
              target_points: int = 2048, backend: str = "threads",
              feed_batch: int = 3, tracer=None) -> dict:
    """Continuous-ingest serving demo: live feed -> service DAG ->
    queries -> sealed store.  Returns a JSON-able summary (also the CI
    smoke surface).  ``tracer`` captures the full serving telemetry:
    ingest lifecycle, DAG admissions, build/commit spans, and front-end
    query spans on one timeline.  Host work only: no ``device``, and
    CUDA is never touched."""
    from repro_torch.serving import (
        FeedSpec, IngestService, Query, StoreFrontEnd, SyntheticFeed)

    feed_dir = os.path.join(root, "feed")
    store_dir = os.path.join(root, "store_live")
    os.makedirs(feed_dir, exist_ok=True)
    feed = SyntheticFeed(feed_dir, FeedSpec(
        n_files=n_files, obs_per_file=obs_per_file, seed=seed))
    svc = IngestService(feed_dir, store_dir, target_points=target_points,
                        tracer=tracer)

    def stop_when() -> bool:
        if not feed.exhausted:
            feed.emit(feed_batch)
            return False
        return not svc.scan()

    result = svc.run_service(backend=backend, n_workers=n_workers,
                             stop_when=stop_when)
    front = StoreFrontEnd(svc)
    queries = [Query(1, "nearest", {"lat": 39.0, "lon": -98.0}),
               Query(2, "snapshot", {"digest": True})]
    done = {q.query_id: q for q in front.serve(queries)}
    return {
        "files_ingested": svc.stats["files_accepted"],
        "shards_committed": svc.stats["shards_committed"],
        "points_ingested": svc.stats["points_ingested"],
        "generation": svc.generation,
        "retained_tracks": len(svc.retained),
        "nearest_track": (done[1].result or {}).get("track_id"),
        "snapshot": done[2].result,
        "job_seconds": result.job_seconds,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Run the organize->archive->process track workflow "
                    "on a chosen execution backend.")
    ap.add_argument("--root", default="experiments/trackwf_torch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the process and screen phases run (cpu: "
                         "the plain PyTorch versions of the kernels)")
    ap.add_argument("--backend", default="threads",
                    choices=["threads", "processes"],
                    help="execution backend for the self-scheduled phases")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--nodes", type=int, default=None,
                    help="triples-mode nodes (overrides --workers)")
    ap.add_argument("--nppn", type=int, default=None,
                    help="triples-mode processes per node")
    ap.add_argument("--files", type=int, default=8)
    ap.add_argument("--scale", type=float, default=2e4)
    ap.add_argument("--tasks-per-message", type=int, default=4)
    ap.add_argument("--policy", default="static",
                    help="scheduling policy for every self-scheduled "
                         "phase (static | fifo_selfsched | sized_lpt | "
                         "adaptive_chunk | shard_affinity)")
    ap.add_argument("--pipeline", default="barrier",
                    choices=["barrier", "dag"],
                    help="phase pipelining: 'barrier' runs organize/"
                         "archive/store-build/process/screen as sequential "
                         "self-scheduled phases; 'dag' streams tasks "
                         "between phases as dependencies resolve "
                         "(run_dag)")
    ap.add_argument("--manager-shards", type=int, default=1,
                    help="coordinator shards for --pipeline dag (>1 "
                         "splits the pending queue by locality and "
                         "work-steals at the tail)")
    ap.add_argument("--kernel-pipeline", default="fused",
                    choices=["fused", "unfused"],
                    help="segment hot path: fused device-resident "
                         "bucketed pipeline, or the three-launch baseline")
    ap.add_argument("--speculative", action="store_true",
                    help="re-issue the longest-running in-flight task to "
                         "idle workers at the tail (first DONE wins)")
    ap.add_argument("--elastic", action="store_true",
                    help="threshold-driven fleet autoscaler (threads "
                         "backend)")
    ap.add_argument("--input", default="zip", choices=["zip", "store"],
                    help="process-phase input: re-parse CSV text from "
                         "zip archives, or insert a store-build phase "
                         "and stream shards from the columnar store")
    ap.add_argument("--store-target-points", type=int, default=None,
                    help="observation points per store shard (store "
                         "input only)")
    ap.add_argument("--screen", action="store_true",
                    help="append an encounter-screen phase (requires "
                         "--input store): spatial-hash cell tasks over "
                         "the processed segment rows, pairwise "
                         "miss-distance kernel, candidates.json output")
    ap.add_argument("--screen-h-m", type=float, default=926.0,
                    help="horizontal candidate threshold (meters)")
    ap.add_argument("--screen-v-m", type=float, default=152.4,
                    help="vertical candidate threshold (meters)")
    ap.add_argument("--screen-cell-deg", type=float, default=0.25,
                    help="spatial-hash cell width (degrees; must divide "
                         "360)")
    ap.add_argument("--serve", action="store_true",
                    help="continuous-ingest mode: tail a synthetic live "
                         "feed into the store via the service DAG and "
                         "answer queries against the growing store "
                         "(host work; --device does not apply)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write observability artifacts to DIR: "
                         "trace.json (Chrome/Perfetto trace of every "
                         "phase, store read, and serving event) and "
                         "TRACE_summary.json (canonical repro.obs/v1 "
                         "summary; feed either file to "
                         "`python -m repro_torch.obs.report`)")
    args = ap.parse_args(argv)
    if args.manager_shards < 1:
        ap.error("--manager-shards must be >= 1")

    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer()

    def _write_trace(label: str) -> None:
        if tracer is None:
            return
        from repro_torch.obs import write_trace_files
        paths = write_trace_files(tracer, args.trace, label=label)
        print(f"trace: {len(tracer)} events -> {paths['trace']}, "
              f"summary -> {paths['summary']}")

    if args.serve:
        summary = run_serve(args.root, n_files=args.files,
                            n_workers=args.workers,
                            backend=args.backend,
                            target_points=(args.store_target_points
                                           or 2048),
                            tracer=tracer)
        print(f"serve: ingested {summary['files_ingested']} files into "
              f"{summary['shards_committed']} shards "
              f"({summary['points_ingested']} points, generation "
              f"{summary['generation']}) in "
              f"{summary['job_seconds']:.2f}s; "
              f"{summary['retained_tracks']} tracks retained")
        print(f"serve: nearest(39,-98) -> {summary['nearest_track']}, "
              f"snapshot digest {summary['snapshot']['digest'][:16]}... "
              f"({summary['snapshot']['n_tracks']} tracks)")
        _write_trace("serve")
        return

    triple = None
    if args.nodes is not None:
        triple = TriplesConfig(nodes=args.nodes, nppn=args.nppn or 8)
    wf = TrackWorkflow(args.root, n_workers=args.workers,
                       exec_backend=args.backend,
                       pipeline=args.kernel_pipeline,
                       tasks_per_message=args.tasks_per_message,
                       policy=args.policy,
                       poll_interval=0.005, triple=triple,
                       input=args.input,
                       store_target_points=args.store_target_points,
                       mode=args.pipeline,
                       n_manager_shards=args.manager_shards,
                       screen=args.screen,
                       screen_h_m=args.screen_h_m,
                       screen_v_m=args.screen_v_m,
                       screen_cell_deg=args.screen_cell_deg,
                       speculative=args.speculative,
                       elastic=args.elastic,
                       device=args.device,
                       tracer=tracer)
    if not os.path.isdir(wf.raw_dir):
        t0 = time.perf_counter()
        n = wf.generate_raw(n_files=args.files, scale=args.scale)
        print(f"generated {n} raw files under {wf.raw_dir} in "
              f"{time.perf_counter() - t0:.2f}s")
    for r in wf.run():
        print(f"{r.phase:10s}: {r.tasks:5d} tasks on {r.workers} "
              f"{args.backend} workers in {r.job_seconds:.2f}s "
              f"({r.messages} messages)")
    if args.screen and os.path.exists(wf.candidates_path):
        with open(wf.candidates_path) as f:
            n = len(json.load(f)["candidates"])
        print(f"screen    : {n} candidate encounters -> "
              f"{wf.candidates_path}")
    _write_trace(args.pipeline)


if __name__ == "__main__":
    main()
