"""Per-task cost models for the discrete-event simulator.

The paper reports job times on the LLSC TX-Green Xeon-Phi cluster with a
Lustre filesystem. We model each task (one file / aircraft / shard) as an
I/O phase followed by a CPU phase:

  * I/O phase: ``io_bytes`` streamed against a THREE-LEVEL bandwidth
    hierarchy — per-process effective rate ``r_process`` (small-file random
    I/O is metadata-bound, so this is far below streaming bandwidth; mildly
    degraded by NPPN via ``io_contention_alpha``), per-node rate ``b_node``
    shared by the node's active processes, and a *saturating* global Lustre
    aggregate ``b_global * n / (n + n_sat)`` shared by all active
    processes. The instantaneous per-task rate is::

        min(r_process / (1 + io_contention_alpha * (nppn - 1)),
            b_node * nodes / n_active,
            b_global / (n_active + n_sat))

  * CPU phase: ``cpu_bytes / cpu_rate * (1 + contention_alpha * (nppn-1))``
    — the contention term models xeon64c per-core memory-bandwidth loss as
    more processes share a node (the paper's "minimizing NPPN improved
    performance").

Calibration (analytic, against Tables I & II for the organize phase of
dataset #1: 2425 files, 714 GB => 1.43 TB read+write):

  * 256 workers are per-process-bound:  1.43 TB / 10428 s / 255
    => r_process ~= 0.54 MB/s effective (small-file random I/O).
  * 512 -> 1024 -> 2048 workers show *sublinear* aggregate gains
    (231 -> 257 -> 268 MB/s observed): solving the saturating form gives
    b_global ~= 287 MB/s and n_sat ~= 119.
  * The NPPN=32 penalty at 256-512 cores pins b_node ~= 14 MB/s; the
    residual NPPN=16 vs 8 gap pins the contention alphas.

These constants make the simulator land within ~10 % of every non-dash
cell of Tables I & II while preserving ALL the paper's qualitative
relations (see tests/test_simulator_paper.py). The point is not the
absolute seconds — it is that a three-level bandwidth hierarchy + eager
self-scheduling reproduces the paper's measured behavior.
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
        adaptive_chunk ordering keys — see repro_torch.runtime.policies), not
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


# ---------------------------------------------------------------------------
# Phase presets (see module docstring for the calibration story).
# ---------------------------------------------------------------------------

# §IV.A — parse + organize raw hourly files into the 4-tier hierarchy.
ORGANIZE_PHASE = PhaseCostModel(
    name="organize",
    r_process=0.54 * MB,
    b_node=14 * MB,
    b_global=287 * MB,
    n_sat=119.0,
    io_contention_alpha=0.0015,
    cpu_rate=150 * MB,
    contention_alpha=0.0024,
    io_multiplier=2.0,
    cpu_multiplier=1.0,
    io_size_beta=0.5,          # metadata overhead amortizes over big files
    io_size_ref=306 * MB,      # keeps total demand == 2 x total bytes
)

# §IV.B — zip-archive each leaf directory. Streaming-friendlier I/O (fewer,
# larger sequential accesses after organization), cheaper CPU (deflate-0).
ARCHIVE_PHASE = PhaseCostModel(
    name="archive",
    r_process=4 * MB,
    b_node=40 * MB,
    b_global=900 * MB,
    cpu_rate=60 * MB,
    contention_alpha=0.0024,
    io_multiplier=2.0,
    cpu_multiplier=1.0,
)

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

# §V — radar dataset: SQL query + organize + process per deidentified id.
# Tasks are tiny and uniform; per-task overhead dominates, which is why 300
# tasks/message was needed (13.2 M messages at 1/msg would serialize on the
# manager).
RADAR_PHASE = PhaseCostModel(
    name="radar",
    r_process=3 * MB,
    b_node=40 * MB,
    b_global=900 * MB,
    cpu_rate=1.2 * MB,
    contention_alpha=0.0024,
    io_multiplier=1.2,
    cpu_multiplier=1.0,
    task_overhead_s=0.4,
    msg_overhead_s=0.002,
)

# Encounter screening — pairwise miss distances within spatial-hash
# cells.  Input bytes are small (segment rows re-read from the columnar
# store) but CPU demand is *quadratic in cell occupancy*: the task
# generator (tracks/workflow.py, bench/encounters.py) sets
# ``cpu_cost_hint = geometry.gridhash.cell_cost(occupancy)``, so
# ``task_seconds`` exposes the genuine quadratic skew that sized_lpt /
# adaptive_chunk exist to handle.  The preset's own rates only cover
# the hint-less fallback and the (cheap) store re-read I/O.
SCREEN_PHASE = PhaseCostModel(
    name="screen",
    r_process=3 * MB,
    b_node=40 * MB,
    b_global=900 * MB,
    cpu_rate=2.4 * MB,
    contention_alpha=0.0024,
    io_multiplier=1.0,
    cpu_multiplier=1.0,
    task_overhead_s=0.02,       # kernel dispatch; no archive open
    msg_overhead_s=0.002,
)

PHASES = {m.name: m for m in
          (ORGANIZE_PHASE, ARCHIVE_PHASE, PROCESS_PHASE, RADAR_PHASE,
           SCREEN_PHASE)}

# Slowdown of the pre-triples launcher (no EPPAC placement/affinity on the
# xeon64c core mesh). Calibrated so that self-scheduling + triples-mode
# median worker time is ~14 % below the legacy block/batch baseline
# (§IV.A: "the median worker time decreasing by 14%").
LEGACY_LAUNCH_PENALTY = 1.18
