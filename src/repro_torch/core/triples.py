"""Triples-mode job launch: the paper's 3-parameter resource-shape abstraction.

The LLSC triples-mode job launch (Reuther et al. [10]) is governed by three
parameters: (1) number of requested compute nodes, (2) number of processes
per node (NPPN), and (3) number of threads per process.  It implements
explicit process placement and affinity control (EPPAC) and allocates nodes
in *exclusive mode*: a job owns every slot of every node it requests, and
the scheduler charges ``nodes * slots_per_node`` cores against the user's
allocation regardless of how many processes actually run.

This module models that arithmetic exactly as described in §II.C of the
paper, and adapts it to a TPU fleet: the same triple also derives the
``(pod, data, model)`` device mesh used by the training/serving layers
(see :func:`TriplesConfig.mesh_shape`).

Paper facts encoded here:
  * xeon64c nodes have 64 slots, 3 GB per slot.
  * Default user allocation was 4096 cores (8192 after the upgrade in §V).
  * Recommended NPPN <= 32 and a multiple of 8.
  * A job may request multiple slots per process (the paper used 2 slots
    per process for 6 GB memory ceilings), which halves the worker count:
    2048 workers * 2 slots = the full 4096-core allocation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# LLSC constants from the paper (§II.B, §II.C).
XEON64C_SLOTS_PER_NODE = 64
XEON64C_GB_PER_SLOT = 3
DEFAULT_ALLOCATION_CORES = 4096      # at benchmarking time
UPGRADED_ALLOCATION_CORES = 8192     # "As of publication" (§II.C, §V)
RECOMMENDED_MAX_NPPN = 32
NPPN_MULTIPLE = 8

# Paper: workers poll every 0.3 s; the manager polls every 0.3 s (§II.D).
DEFAULT_POLL_INTERVAL_S = 0.3


class TriplesError(ValueError):
    """A triples-mode request that exclusive mode would reject."""


@dataclasses.dataclass(frozen=True)
class NodeType:
    """A compute-node hardware description (exclusive-mode unit)."""

    name: str = "xeon64c"
    slots_per_node: int = XEON64C_SLOTS_PER_NODE
    gb_per_slot: float = XEON64C_GB_PER_SLOT

    @property
    def gb_per_node(self) -> float:
        return self.slots_per_node * self.gb_per_slot


@dataclasses.dataclass(frozen=True)
class TriplesConfig:
    """A validated (nodes, NPPN, threads) triple under exclusive mode.

    Attributes:
      nodes: requested compute nodes.
      nppn: processes per node.
      threads_per_process: threads per process (fixed in the paper's
        experiments; varied in §V follow-up to 2).
      slots_per_process: memory slots charged per process (paper used 2
        for 6 GB processes).
      allocation_cores: the user's exclusive-mode core allocation cap.
      node_type: hardware description.
    """

    nodes: int
    nppn: int
    threads_per_process: int = 1
    slots_per_process: int = 1
    allocation_cores: int = DEFAULT_ALLOCATION_CORES
    node_type: NodeType = NodeType()

    def __post_init__(self) -> None:
        if self.nodes < 1:
            raise TriplesError(f"nodes must be >= 1, got {self.nodes}")
        if self.nppn < 1:
            raise TriplesError(f"nppn must be >= 1, got {self.nppn}")
        if self.threads_per_process < 1:
            raise TriplesError(
                f"threads_per_process must be >= 1, got {self.threads_per_process}")
        if self.slots_per_process < 1:
            raise TriplesError(
                f"slots_per_process must be >= 1, got {self.slots_per_process}")
        # Exclusive mode: the job is charged every slot of every node.
        if self.allocated_cores > self.allocation_cores:
            raise TriplesError(
                f"exclusive mode charges {self.allocated_cores} cores "
                f"({self.nodes} nodes x {self.node_type.slots_per_node} slots) "
                f"> allocation {self.allocation_cores}")
        # Processes must physically fit on the node's slots.
        if self.nppn * self.slots_per_process > self.node_type.slots_per_node:
            raise TriplesError(
                f"nppn={self.nppn} x slots_per_process={self.slots_per_process} "
                f"exceeds {self.node_type.slots_per_node} slots/node")

    # ---- exclusive-mode accounting (§II.C) ----

    @property
    def allocated_cores(self) -> int:
        """Cores charged against the allocation (exclusive mode)."""
        return self.nodes * self.node_type.slots_per_node

    @property
    def total_processes(self) -> int:
        return self.nodes * self.nppn

    @property
    def gb_per_process(self) -> float:
        return self.slots_per_process * self.node_type.gb_per_slot

    @property
    def worker_processes(self) -> int:
        """Processes available as self-scheduling workers (one is manager)."""
        return max(self.total_processes - 1, 0)

    def validate_recommended(self) -> list[str]:
        """Return LLSC-recommendation violations (warnings, not errors)."""
        warnings = []
        if self.nppn > RECOMMENDED_MAX_NPPN:
            warnings.append(
                f"NPPN={self.nppn} exceeds recommended max {RECOMMENDED_MAX_NPPN}")
        if self.nppn % NPPN_MULTIPLE != 0 and self.nppn != 1:
            warnings.append(
                f"NPPN={self.nppn} is not a multiple of {NPPN_MULTIPLE}")
        return warnings

    # ---- TPU adaptation: derive the device mesh from the triple ----

    def mesh_shape(self, chips_per_node: int = 4) -> Tuple[int, ...]:
        """Map the triple onto a (pod, data, model) style mesh shape.

        Adaptation note (DESIGN.md §2): on LLSC a triple places processes on
        CPU nodes; on a TPU fleet the natural analogue is
        ``pod = nodes grouped per pod``, ``data = processes``, ``model =
        threads``-like intra-process parallelism. We expose the direct
        product decomposition and let launch/mesh.py choose axis names.
        """
        return (self.nodes, self.nppn, self.threads_per_process * chips_per_node)

    @staticmethod
    def max_nodes(allocation_cores: int = DEFAULT_ALLOCATION_CORES,
                  node_type: NodeType = NodeType()) -> int:
        """Max requestable nodes under exclusive mode (paper: 64)."""
        return allocation_cores // node_type.slots_per_node


def paper_configs() -> dict[str, TriplesConfig]:
    """The triples-mode configurations benchmarked in the paper.

    Tables I & II sweep (cores, NPPN); §IV.C fixes 64 nodes / NPPN=16 /
    1 thread; §V uses 128 nodes / NPPN=8 / 2 threads on the upgraded
    allocation with single 3 GB slots.
    """
    cfgs: dict[str, TriplesConfig] = {}
    # Tables I/II: allocated cores in {2048,1024,512,256}, NPPN in {32,16,8}.
    # "Allocated Compute Cores" in the tables counts worker processes
    # (2 slots each); nodes = cores / nppn.
    for cores in (2048, 1024, 512, 256):
        for nppn in (32, 16, 8):
            nodes = cores // nppn
            # Exclusive-mode cap: nodes*64 <= 4096 => nodes <= 64. The dashes
            # in the tables are exactly the (cores,nppn) cells with nodes>64.
            if nodes > TriplesConfig.max_nodes():
                continue
            cfgs[f"organize_c{cores}_n{nppn}"] = TriplesConfig(
                nodes=nodes, nppn=nppn, threads_per_process=1,
                slots_per_process=2)
    # §IV.C processing benchmark: 64 nodes, NPPN=16, single thread.
    cfgs["process_64n_nppn16"] = TriplesConfig(
        nodes=64, nppn=16, threads_per_process=1, slots_per_process=2)
    # §V radar follow-up: upgraded allocation, 128 nodes, NPPN=8, 2 threads,
    # single 3 GB slot per worker.
    cfgs["radar_128n_nppn8"] = TriplesConfig(
        nodes=128, nppn=8, threads_per_process=2, slots_per_process=1,
        allocation_cores=UPGRADED_ALLOCATION_CORES)
    return cfgs


def feasible_table_cells() -> list[tuple[int, int]]:
    """(cores, nppn) cells that exclusive mode permits — the non-dash
    entries of Tables I & II."""
    cells = []
    for cores in (2048, 1024, 512, 256):
        for nppn in (32, 16, 8):
            if cores // nppn <= TriplesConfig.max_nodes():
                cells.append((cores, nppn))
    return cells
