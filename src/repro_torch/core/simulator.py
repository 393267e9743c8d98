"""Back-compat wrapper: the discrete-event engine moved to
``repro_torch.runtime.sim``, where it shares one SchedulerCore with the live
threads/processes backends.  ``SimResult`` is now an alias of the unified
:class:`~repro_torch.runtime.result.RunResult` (same fields + properties).

New code should call ``repro_torch.runtime.run_job(..., backend="sim")`` or the
re-exported functions below.
"""

from repro_torch.runtime.result import RunResult, SimTaskRecord
from repro_torch.runtime.sim import (
    DEFAULT_POLL_S, merge_tasks_per_message, simulate_self_scheduling,
    simulate_static)

SimResult = RunResult

__all__ = ["DEFAULT_POLL_S", "SimResult", "SimTaskRecord",
           "merge_tasks_per_message", "simulate_self_scheduling",
           "simulate_static"]
