"""End-to-end track-processing workflow driver (paper §III.A).

Port of ``repro/tracks/workflow.py`` in barrier mode on zip input: the
phases organize -> archive -> process run one after another on the
self-scheduling runtime (:func:`repro_torch.runtime.run_job`), with a
JSON phase checkpoint so a killed job resumes where it left off, and
periodic mid-phase manager checkpoints so it resumes inside a phase.
The process phase runs on the card (``device=None``) unless the caller
names another device.

CLI:  PYTHONPATH=src python -m repro_torch.tracks.workflow
      PYTHONPATH=src python -m repro_torch.tracks.workflow --device cpu \\
          --backend processes
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

from repro_torch.core.triples import TriplesConfig
from repro_torch.geometry.aerodromes import synthetic_aerodromes
from repro_torch.geometry.dem import SyntheticGlobeDEM
from repro_torch.kernels import ops
from repro_torch.runtime import ManagerCheckpoint, RunResult, run_job
from repro_torch.tracks.archive import Archiver, archive_tasks_from_tree
from repro_torch.tracks.datasets import ScaledDatasetSpec, write_scaled_dataset
from repro_torch.tracks.organize import Organizer, organize_tasks_from_dir
from repro_torch.tracks.registry import synthetic_registry
from repro_torch.tracks.segments import (
    SegmentProcessor, segment_tasks_from_archive_tree)

#: Workflow modes of the reference that later slices of the port bring.
NOT_PORTED = {
    "--input store": "the store slice (repro.store and the store branches "
                     "of tracks/segments.py)",
    "--pipeline dag": "the DAG slice (runtime/dag.py)",
    "--screen": "the encounter-screen slice (kernels/encounter_screen.py)",
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


class TrackWorkflow:
    """organize -> archive -> process with self-scheduling + checkpoints."""

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
                 speculative: bool = False,
                 elastic: bool = False,
                 seed: int = 0,
                 device=None):
        if exec_backend not in ("threads", "processes"):
            raise ValueError(
                "workflow phases do real work; exec_backend must be "
                "'threads' or 'processes'")
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
        self.ckpt_path = os.path.join(root, "workflow_ckpt.json")
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

    def run(self) -> list[PhaseReport]:
        done = set(self._load_ckpt()["phases_done"])
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
        if "process" not in done:
            proc = SegmentProcessor(
                dem=SyntheticGlobeDEM(),
                aerodromes=synthetic_aerodromes(n=64),
                device=self.device, backend=self.backend,
                pipeline=self.pipeline)
            tasks = segment_tasks_from_archive_tree(self.archive_dir)
            # §IV.C: random organization for processing.  A multi-task
            # ASSIGN executes as bucketed pipeline calls via
            # SegmentProcessor.process_batch.
            self._run_phase("process", tasks, proc, organization="random")
        return self.reports


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Run the organize->archive->process track workflow "
                    "on a chosen execution backend.")
    ap.add_argument("--root", default="experiments/trackwf_torch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the process phase runs (cpu: the plain "
                         "PyTorch versions of the kernels)")
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
    # Reference modes that later slices bring; accepted only to be
    # rejected with the slice's name.
    ap.add_argument("--input", default="zip", choices=["zip", "store"])
    ap.add_argument("--pipeline", default="barrier",
                    choices=["barrier", "dag"])
    ap.add_argument("--screen", action="store_true")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--trace", default=None, metavar="DIR")
    args = ap.parse_args(argv)

    asked = {"--input store": args.input == "store",
             "--pipeline dag": args.pipeline == "dag",
             "--screen": args.screen, "--serve": args.serve,
             "--trace": args.trace is not None}
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


if __name__ == "__main__":
    main()
