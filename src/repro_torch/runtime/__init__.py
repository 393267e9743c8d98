"""Self-scheduling runtime for the paper's §II.D protocol.

One self-scheduling core (protocol.SchedulerCore) over two live
backends:

  * threads    — in-process worker threads (transports.ThreadTransport)
  * processes  — multiprocessing workers, real NPPN-style process
                 isolation (transports.ProcessTransport)

Entry point: :func:`run_job`.  Dispatch order and batch size come from a
pluggable :class:`~repro_torch.runtime.policies.SchedulingPolicy`.
"""

from repro_torch.runtime.result import RunResult, WorkerStats
from repro_torch.runtime.fleet import FleetController
from repro_torch.runtime.speed import WorkerSpeedModel
from repro_torch.runtime.policies import (
    POLICIES, POLICY_NAMES, SchedulingPolicy, get_policy)
from repro_torch.runtime.protocol import (
    DEFAULT_POLL_INTERVAL_S, ManagerCheckpoint, SchedulerCore, ShardedCore,
    drive)
from repro_torch.runtime.transports import (
    ProcessTransport, ThreadTransport, Transport, worker_loop)
from repro_torch.runtime.api import BACKENDS, run_job

__all__ = [
    "BACKENDS", "DEFAULT_POLL_INTERVAL_S", "FleetController",
    "ManagerCheckpoint", "POLICIES", "POLICY_NAMES", "ProcessTransport",
    "RunResult", "SchedulerCore", "SchedulingPolicy", "ShardedCore",
    "ThreadTransport", "Transport", "WorkerSpeedModel", "WorkerStats",
    "drive", "get_policy", "run_job", "worker_loop",
]
