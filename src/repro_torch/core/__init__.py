"""Paper core: triples-mode launch + self-scheduling task distribution.

The runtime itself (manager/worker protocol, thread/process/sim backends)
lives in :mod:`repro_torch.runtime`; the names below from the old
``core.selfsched`` / ``core.simulator`` modules are loaded lazily (PEP
562) so that ``repro_torch.runtime`` can import the task/message/cost models
from this package without a circular import.
"""

import importlib

from repro_torch.core.cost_model import (
    ARCHIVE_PHASE, ORGANIZE_PHASE, PHASES, PROCESS_PHASE, RADAR_PHASE,
    PhaseCostModel)
from repro_torch.core.distribution import (
    DistributionPolicy, assignment_imbalance, block_distribution,
    cyclic_distribution, distribute)
from repro_torch.core.messages import (
    Message, MessageKind, ORGANIZERS, Task, get_organizer,
    organize_by_filename, organize_chronological, organize_largest_first,
    organize_random)
from repro_torch.core.triples import (
    DEFAULT_ALLOCATION_CORES, NodeType, TriplesConfig, TriplesError,
    UPGRADED_ALLOCATION_CORES, feasible_table_cells, paper_configs)

# Names backed by repro_torch.runtime (resolved on first access).
_LAZY = {
    "JobResult": "repro_torch.core.selfsched",
    "Manager": "repro_torch.core.selfsched",
    "ManagerCheckpoint": "repro_torch.core.selfsched",
    "WorkerStats": "repro_torch.core.selfsched",
    "run_self_scheduled": "repro_torch.core.selfsched",
    "SimResult": "repro_torch.core.simulator",
    "SimTaskRecord": "repro_torch.core.simulator",
    "merge_tasks_per_message": "repro_torch.core.simulator",
    "simulate_self_scheduling": "repro_torch.core.simulator",
    "simulate_static": "repro_torch.core.simulator",
    "RunResult": "repro_torch.runtime",
    "SchedulerCore": "repro_torch.runtime",
    "run_job": "repro_torch.runtime",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


__all__ = [
    "ARCHIVE_PHASE", "ORGANIZE_PHASE", "PHASES", "PROCESS_PHASE",
    "RADAR_PHASE", "PhaseCostModel",
    "DistributionPolicy", "assignment_imbalance", "block_distribution",
    "cyclic_distribution", "distribute",
    "Message", "MessageKind", "ORGANIZERS", "Task", "get_organizer",
    "organize_by_filename", "organize_chronological",
    "organize_largest_first", "organize_random",
    "DEFAULT_ALLOCATION_CORES", "NodeType", "TriplesConfig", "TriplesError",
    "UPGRADED_ALLOCATION_CORES", "feasible_table_cells", "paper_configs",
    "JobResult", "Manager", "ManagerCheckpoint", "WorkerStats",
    "run_self_scheduled",
    "SimResult", "SimTaskRecord", "merge_tasks_per_message",
    "simulate_self_scheduling", "simulate_static",
    "RunResult", "SchedulerCore", "run_job",
]
