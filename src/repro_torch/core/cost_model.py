"""Per-task cost model of the process phase (paper §IV.C).

The cost-aware scheduling policies (``sized_lpt``, ``adaptive_chunk``)
estimate each task's seconds from a :class:`PhaseCostModel`; ``run_job``
defaults to :data:`PROCESS_PHASE`.  The simulator's other phase models
are not needed by the live backends.
"""

from __future__ import annotations

import dataclasses

MB = 1_000_000
GB = 1_000_000_000


@dataclasses.dataclass(frozen=True)
class PhaseCostModel:
    """Cost constants for one workflow phase."""

    name: str
    # I/O hierarchy (bytes/second, effective for this access pattern).
    r_process: float          # per-process cap (small-file random I/O)
    b_node: float             # per-node cap (NIC / local I/O stack)
    b_global: float           # global Lustre asymptotic aggregate
    n_sat: float = 0.0        # half-saturation population for b_global
    io_contention_alpha: float = 0.0  # per-process I/O loss per extra NPPN
    # CPU.
    cpu_rate: float = 1.0     # bytes/second/core parse-or-compute rate
    contention_alpha: float = 0.0  # per-extra-process-on-node CPU slowdown
    # Multipliers from file size to phase demand.
    io_multiplier: float = 2.0    # read input + write output
    cpu_multiplier: float = 1.0
    # Sublinear I/O demand: per-byte effective cost falls with file size
    # (open/metadata overhead amortizes over big files). demand =
    # io_multiplier * io_size_ref**beta * size**(1-beta). beta=0 is linear.
    io_size_beta: float = 0.0
    io_size_ref: float = 294 * 1_000_000.0
    # Fixed per-task overheads (seconds).
    task_overhead_s: float = 0.05
    # Messaging.
    msg_overhead_s: float = 0.002  # manager serial per-message send cost

    def io_bytes(self, size_bytes: int) -> float:
        if self.io_size_beta == 0.0:
            return self.io_multiplier * size_bytes
        b = self.io_size_beta
        return (self.io_multiplier * (self.io_size_ref ** b)
                * (max(size_bytes, 1.0) ** (1.0 - b)))

    def cpu_seconds(self, size_bytes: int, nppn: int,
                    cpu_cost_hint: float | None = None) -> float:
        base = (cpu_cost_hint if cpu_cost_hint is not None
                else self.cpu_multiplier * size_bytes / self.cpu_rate)
        return self.task_overhead_s + base * (1.0 + self.contention_alpha
                                              * (nppn - 1))

    def task_seconds(self, size_bytes: int, nppn: int = 1,
                     cpu_cost_hint: float | None = None,
                     nodes: int = 1) -> float:
        """Isolated-task wall estimate: I/O demand at the *uncontended*
        per-process rate plus the CPU phase.

        This is the scheduling-heuristic view of a task (sized_lpt /
        adaptive_chunk ordering keys — see repro.runtime.policies), not
        a simulation: contention with other active tasks is exactly
        what the discrete-event engine models and a dispatch-time
        estimate cannot know.  Monotone in ``size_bytes`` for a fixed
        model, so cost ordering agrees with largest-first when no
        explicit ``cpu_cost_hint`` s are present.
        """
        rate = self.io_rate(1, max(nodes, 1), nppn)
        io_s = self.io_bytes(size_bytes) / rate if rate > 0 else 0.0
        return io_s + self.cpu_seconds(size_bytes, nppn, cpu_cost_hint)

    def io_rate(self, n_active: int, nodes: int, nppn: int = 1) -> float:
        """Equal-share instantaneous per-task I/O rate."""
        r_p = self.r_process / (1.0 + self.io_contention_alpha * (nppn - 1))
        if n_active <= 0:
            return r_p
        return min(r_p,
                   self.b_node * nodes / n_active,
                   self.b_global / (n_active + self.n_sat))


# §IV.C — process + interpolate into track segments. CPU-dominant: dynamics
# estimation, AGL (DEM loads — the paper blames wide-area tracks for large
# DEM working sets), airspace lookup. cpu_multiplier >> 1 relative to bytes.
PROCESS_PHASE = PhaseCostModel(
    name="process",
    r_process=3 * MB,
    b_node=40 * MB,
    b_global=900 * MB,
    cpu_rate=1.2 * MB,          # heavy per-byte compute
    contention_alpha=0.0024,
    io_multiplier=1.2,
    cpu_multiplier=1.0,
    task_overhead_s=0.5,        # archive open + DEM tile mmap
)
