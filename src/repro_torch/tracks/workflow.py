"""End-to-end track-processing workflow driver (paper §III.A).

Port of ``repro/tracks/workflow.py`` in barrier mode: the phases
organize -> archive [-> store-build] -> process [-> screen] run one
after another on the self-scheduling runtime
(:func:`repro_torch.runtime.run_job`), with a JSON phase checkpoint so a
killed job resumes where it left off, and periodic mid-phase manager
checkpoints so it resumes inside a phase.  The process and screen
phases run on the card (``device=None``) unless the caller names
another device.

With ``input="store"`` a ``store-build`` phase (one self-scheduled task
per shard, :class:`repro_torch.store.ShardBuilder` as the worker fn)
ingests the zip archives into the columnar track store, and the process
phase reads ``store://`` shard tasks instead of re-parsing CSV text.

``screen=True`` (which needs ``input="store"``) appends an
encounter-screen phase: processed segment rows are binned into a
halo-padded spatial hash (:mod:`repro_torch.geometry.gridhash`) and every
multi-row cell becomes a self-scheduled task running the pairwise
miss-distance kernel (:mod:`repro_torch.kernels.encounter_screen`), with
the deduplicated candidate encounters written to ``candidates.json``.

CLI:  PYTHONPATH=src python -m repro_torch.tracks.workflow
      PYTHONPATH=src python -m repro_torch.tracks.workflow --device cpu \\
          --backend processes --input store --screen
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
from repro_torch.runtime import ManagerCheckpoint, RunResult, run_job
from repro_torch.store import writer as store_writer
from repro_torch.store.format import MANIFEST_NAME
from repro_torch.store.uri import make_store_uri
from repro_torch.tracks.archive import Archiver, archive_tasks_from_tree
from repro_torch.tracks.datasets import (
    SCREEN_ROW_BYTES, ScaledDatasetSpec, write_scaled_dataset)
from repro_torch.tracks.organize import Organizer, organize_tasks_from_dir
from repro_torch.tracks.registry import synthetic_registry
from repro_torch.tracks.segments import (
    SegmentProcessor, segment_tasks_from_archive_tree,
    segment_tasks_from_store, split_segments)

#: Workflow modes of the reference that later slices of the port bring.
NOT_PORTED = {
    "--pipeline dag": "the DAG slice (runtime/dag.py)",
    "--serve": "the serving slice (repro.serving)",
    "--trace": "the observability slice (repro.obs)",
}


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


class TrackWorkflow:
    """organize -> archive [-> store-build] -> process [-> screen] with
    self-scheduling + checkpoints."""

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
                 screen: bool = False,
                 screen_h_m: float = 926.0,
                 screen_v_m: float = 152.4,
                 screen_cell_deg: float = 0.25,
                 speculative: bool = False,
                 elastic: bool = False,
                 seed: int = 0,
                 device=None):
        if exec_backend not in ("threads", "processes"):
            raise ValueError(
                "workflow phases do real work; exec_backend must be "
                "'threads' or 'processes'")
        if input not in ("zip", "store"):
            raise ValueError(f"unknown input {input!r}; 'zip' processes "
                             f"archives directly, 'store' inserts a "
                             f"store-build phase")
        if screen and input != "store":
            raise ValueError("--screen needs --input store: screening "
                             "re-reads segment rows from the columnar "
                             "store (store:// track selections)")
        from repro_torch.runtime.policies import POLICY_NAMES
        if policy not in POLICY_NAMES:
            raise ValueError(f"unknown scheduling policy {policy!r}; "
                             f"choose from {list(POLICY_NAMES)}")
        if elastic and exec_backend != "threads":
            raise ValueError("--elastic needs exec_backend='threads' "
                             "(processes cannot spawn workers mid-run)")
        self.device = ops.resolve_device(device)
        self.root = root
        self.raw_dir = os.path.join(root, "raw")
        self.organized_dir = os.path.join(root, "organized")
        self.archive_dir = os.path.join(root, "archived")
        self.store_dir = os.path.join(root, "store")
        self.input = input
        self.store_target_points = store_target_points
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
            checkpoint_interval_s=self.checkpoint_interval_s)
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

    def run(self) -> list[PhaseReport]:
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
    # Reference modes that later slices bring; accepted only to be
    # rejected with the slice's name.
    ap.add_argument("--pipeline", default="barrier",
                    choices=["barrier", "dag"],
                    help="not ported yet: " + NOT_PORTED["--pipeline dag"])
    ap.add_argument("--serve", action="store_true",
                    help="not ported yet: " + NOT_PORTED["--serve"])
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="not ported yet: " + NOT_PORTED["--trace"])
    args = ap.parse_args(argv)

    asked = {"--pipeline dag": args.pipeline == "dag",
             "--serve": args.serve, "--trace": args.trace is not None}
    for flag, on in asked.items():
        if on:
            ap.error(f"{flag} is not ported yet: it waits for "
                     f"{NOT_PORTED[flag]}")

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
                       screen=args.screen,
                       screen_h_m=args.screen_h_m,
                       screen_v_m=args.screen_v_m,
                       screen_cell_deg=args.screen_cell_deg,
                       speculative=args.speculative,
                       elastic=args.elastic,
                       device=args.device)
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


if __name__ == "__main__":
    main()
