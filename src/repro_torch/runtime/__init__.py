"""Unified execution-backend runtime for the paper's §II.D protocol.

One self-scheduling core (protocol.SchedulerCore) over three backends:

  * threads    — in-process worker threads (transports.ThreadTransport)
  * processes  — multiprocessing workers, real NPPN-style process
                 isolation (transports.ProcessTransport)
  * sim        — the calibrated discrete-event engine at full LLSC scale
                 (sim.simulate_self_scheduling)

Entry point: :func:`run_job`.  Dispatch order and batch size come from a
pluggable :class:`~repro_torch.runtime.policies.SchedulingPolicy`
(``run_job(..., policy=...)``; see
:data:`~repro_torch.runtime.policies.POLICY_NAMES`).  The streaming
phase DAG (:func:`run_dag`, :func:`run_service`) runs on the same core.
The legacy modules ``repro_torch.core.selfsched`` and
``repro_torch.core.simulator`` are thin wrappers over this package.
"""

from repro_torch.runtime.result import RunResult, SimTaskRecord, WorkerStats
from repro_torch.runtime.fleet import FleetController
from repro_torch.runtime.speed import WorkerSpeedModel
from repro_torch.runtime.policies import (
    POLICIES, POLICY_NAMES, SchedulingPolicy, get_policy)
from repro_torch.runtime.protocol import (
    DEFAULT_POLL_INTERVAL_S, ManagerCheckpoint, SchedulerCore, ShardedCore,
    drive, manager_shard, partition_tasks_by_locality)
from repro_torch.runtime.transports import (
    ProcessTransport, ThreadTransport, Transport, worker_loop)
from repro_torch.runtime.sim import (
    DEFAULT_POLL_S, merge_tasks_per_message, simulate_self_scheduling,
    simulate_static)
from repro_torch.runtime.api import BACKENDS, run_job
from repro_torch.runtime.dag import (
    DagCoordinator, DagResult, EdgeEmitter, PhaseNode, StreamingDAG,
    run_dag, run_service)

__all__ = [
    "BACKENDS", "DEFAULT_POLL_INTERVAL_S", "DEFAULT_POLL_S",
    "DagCoordinator", "DagResult", "EdgeEmitter", "FleetController",
    "ManagerCheckpoint",
    "POLICIES", "POLICY_NAMES", "PhaseNode", "ProcessTransport",
    "RunResult", "SchedulerCore", "SchedulingPolicy", "ShardedCore",
    "SimTaskRecord", "StreamingDAG", "ThreadTransport", "Transport",
    "WorkerSpeedModel",
    "WorkerStats", "drive", "get_policy", "manager_shard",
    "merge_tasks_per_message", "partition_tasks_by_locality", "run_dag",
    "run_job", "run_service", "simulate_self_scheduling",
    "simulate_static", "worker_loop",
]
