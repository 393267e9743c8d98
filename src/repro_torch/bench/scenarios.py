"""Declarative benchmark scenarios — the campaign engine's input language.

A :class:`Scenario` names one benchmarkable configuration: a dataset
manifest x resource triple (workers/nodes/NPPN) x task organization x
tasks-per-message x fault/heterogeneity profile x execution backend,
optionally paired with a ``baseline`` run (for the paper's comparative
claims: block vs cyclic, self-scheduling vs legacy batch) and a tuple of
:class:`Check` s against published reference values.

Scenarios are pure data — no clocks, no execution.  The engine
(:mod:`repro_torch.bench.engine`) expands each one into
:func:`repro_torch.runtime.run_job` / ``simulate_static`` invocations
and serializes the outcome into BENCH records
(:mod:`repro_torch.bench.schema`).

:func:`expand` is the matrix helper: any :class:`RunSpec` field given as a
list/tuple becomes a swept axis, and the cartesian product becomes one
scenario per cell — that is how the Table I/II grids and the beyond-paper
sweeps are declared in a few lines each.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Sequence, Union

__all__ = ["Check", "FaultProfile", "FAULT_PROFILES", "RunSpec", "Scenario",
           "expand"]


# ---------------------------------------------------------------------------
# Fault / heterogeneity profiles (one matrix axis).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """Deterministic fault/heterogeneity injection for one scenario.

    Sim backends: ``death_frac`` of the workers die at staggered sim times
    (``death_at_s + i * death_stride_s``); ``straggler_frac`` run at
    ``straggler_speed`` x nominal.  Live backends: the first worker exits
    without a DONE after ``live_fail_after`` completed tasks, and
    ``live_slow_factor`` makes the first worker run that many times
    slower (the threads mirror of the sim's straggler injection —
    see ``worker_slow_factor`` in :func:`repro_torch.runtime.run_job`).
    """

    death_frac: float = 0.0
    death_at_s: float = 1000.0
    death_stride_s: float = 7.0
    straggler_frac: float = 0.0
    straggler_speed: float = 0.25
    live_fail_after: Optional[int] = None
    live_slow_factor: Optional[float] = None

    @property
    def is_none(self) -> bool:
        return (self.death_frac == 0.0 and self.straggler_frac == 0.0
                and self.live_fail_after is None
                and self.live_slow_factor is None)

    def materialize(self, n_workers: int, seed: int):
        """-> (worker_death, worker_speed, worker_fail_after,
        worker_slow_factor), all seeded."""
        worker_death = None
        if self.death_frac > 0.0:
            worker_death = {i: self.death_at_s + self.death_stride_s * i
                            for i in range(int(n_workers * self.death_frac))}
        worker_speed = None
        if self.straggler_frac > 0.0:
            import numpy as np
            rng = np.random.default_rng(seed)
            speed = np.ones(n_workers)
            slow = rng.choice(n_workers, int(n_workers * self.straggler_frac),
                              replace=False)
            speed[slow] = self.straggler_speed
            worker_speed = speed.tolist()
        worker_fail_after = None
        if self.live_fail_after is not None:
            worker_fail_after = {"w0": self.live_fail_after}
        worker_slow_factor = None
        if self.live_slow_factor is not None:
            worker_slow_factor = {"w0": float(self.live_slow_factor)}
        return (worker_death, worker_speed, worker_fail_after,
                worker_slow_factor)


FAULT_PROFILES: dict[str, FaultProfile] = {
    "none": FaultProfile(),
    "deaths_5pct": FaultProfile(death_frac=0.05),
    "deaths_20pct": FaultProfile(death_frac=0.20),
    "stragglers_10pct": FaultProfile(straggler_frac=0.10),
    # The elastic fleet's acceptance regime: a fifth of the fleet dies AND a
    # tenth of the survivors-by-lottery run 4x slow — the combined
    # attrition+heterogeneity storm the elastic/speculative stack is
    # gated against.
    "deaths20_stragglers10": FaultProfile(death_frac=0.20,
                                          straggler_frac=0.10,
                                          straggler_speed=0.25),
    "live_one_death": FaultProfile(live_fail_after=3),
    # Live straggler: worker w0 runs 4x slow on the threads backend.
    "live_slow4": FaultProfile(live_slow_factor=4.0),
}


# ---------------------------------------------------------------------------
# One execution configuration.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Everything needed to launch one job — JSON-able, hashable.

    ``mode='self_sched'`` runs through :func:`repro_torch.runtime.run_job`
    on the chosen ``backend``; ``mode='static'`` runs the LLMapReduce-style
    pre-assigned distribution through ``simulate_static`` (sim only).
    ``nodes``/``nppn`` default to run_job's triples derivation when None.
    """

    dataset: str
    phase: str = "organize"             # cost-model name (core.PHASES)
    backend: str = "sim"                # sim | threads | processes
    mode: str = "self_sched"            # self_sched | static
    policy: str = "cyclic"              # static mode only: block | cyclic
    sched_policy: str = "static"        # self_sched: runtime.policies name
    n_workers: int = 4
    nodes: Optional[int] = None
    nppn: Optional[int] = None
    organization: str = "largest_first"
    tasks_per_message: int = 1
    poll_interval: Optional[float] = None
    failure_timeout: Optional[float] = None
    legacy_launch_penalty: float = 1.0
    cpu_rate_scale: float = 1.0         # threads-per-process modelling
    fault_profile: str = "none"
    speculative: bool = False
    speculation_max_copies: int = 2
    speed_feedback: bool = False
    elastic: bool = False
    dataset_limit: Optional[int] = None
    seed: int = 0                       # organize_seed + fault seeding

    def __post_init__(self) -> None:
        if self.mode not in ("self_sched", "static"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.mode == "static" and self.backend != "sim":
            raise ValueError("static distribution is sim-only")
        from repro_torch.runtime.policies import POLICY_NAMES
        if self.sched_policy not in POLICY_NAMES:
            raise ValueError(
                f"unknown scheduling policy {self.sched_policy!r}; "
                f"choose from {list(POLICY_NAMES)}")
        if self.mode == "static" and self.sched_policy != "static":
            raise ValueError("mode='static' pre-assigns all tasks; "
                             "sched_policy applies to self_sched only")
        if self.fault_profile not in FAULT_PROFILES:
            raise ValueError(f"unknown fault profile {self.fault_profile!r}; "
                             f"choose from {sorted(FAULT_PROFILES)}")
        # A fault profile whose knobs the chosen backend cannot honor must
        # be rejected at declaration time — otherwise the scenario would
        # run fault-free while claiming to measure fault recovery.
        profile = FAULT_PROFILES[self.fault_profile]
        if self.backend == "sim":
            if profile.live_fail_after is not None \
                    or profile.live_slow_factor is not None:
                raise ValueError(
                    f"fault profile {self.fault_profile!r} "
                    f"(live_fail_after/live_slow_factor) needs a live "
                    f"backend")
        elif profile.death_frac > 0.0 or profile.straggler_frac > 0.0:
            raise ValueError(
                f"fault profile {self.fault_profile!r} (timed deaths/"
                f"stragglers) needs the sim backend")
        if self.elastic:
            if self.mode != "self_sched":
                raise ValueError("elastic fleets need mode='self_sched'")
            if self.backend == "processes":
                raise ValueError("elastic fleets run on the sim and "
                                 "threads backends only")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RunSpec":
        return cls(**d)

    @classmethod
    def from_table_cell(cls, cores: int, nppn: int, organization: str,
                        **kw) -> "RunSpec":
        """A Tables I/II cell: 'Allocated Compute Cores' counts worker
        processes (2 slots each); one process is the manager."""
        return cls(dataset="monday", phase="organize",
                   n_workers=cores - 1, nodes=cores // nppn, nppn=nppn,
                   organization=organization, **kw)


# ---------------------------------------------------------------------------
# Reference checks against published values.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Check:
    """One assertion against a scenario metric.

    kinds: ``within_rel`` (|actual/expect - 1| <= tol), ``within_abs``
    (|actual - expect| <= tol), ``min`` (actual >= expect), ``max``
    (actual <= expect).
    """

    metric: str
    kind: str
    expect: float
    tol: float = 0.0
    source: str = ""

    _KINDS = ("within_rel", "within_abs", "min", "max")

    def __post_init__(self) -> None:
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown check kind {self.kind!r}")

    def evaluate(self, metrics: dict) -> dict:
        actual = metrics.get(self.metric)
        if actual is None:
            passed = False
        elif self.kind == "within_rel":
            passed = bool(self.expect != 0
                          and abs(actual / self.expect - 1.0) <= self.tol)
        elif self.kind == "within_abs":
            passed = bool(abs(actual - self.expect) <= self.tol)
        elif self.kind == "min":
            passed = bool(actual >= self.expect)
        else:                                     # "max"
            passed = bool(actual <= self.expect)
        delta_pct = ((actual / self.expect - 1.0) * 100.0
                     if actual is not None and self.expect else None)
        return {"metric": self.metric, "kind": self.kind,
                "expect": self.expect, "tol": self.tol,
                "source": self.source, "actual": actual,
                "delta_pct": delta_pct, "passed": passed}


# ---------------------------------------------------------------------------
# Scenario + matrix expansion.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named cell of the campaign matrix."""

    name: str
    group: str
    run: RunSpec
    baseline: Optional[RunSpec] = None
    checks: tuple[Check, ...] = ()
    tier: str = "full"                  # "quick" scenarios also run in CI
    notes: str = ""

    def matches(self, patterns: Sequence[str]) -> bool:
        """Substring filter over name/group (OR across patterns)."""
        if not patterns:
            return True
        return any(p in self.name or p in self.group for p in patterns)


ChecksFor = Callable[[dict], tuple[Check, ...]]

# Swept-axis abbreviations used in expanded scenario names.
_ABBREV = {"tasks_per_message": "k", "poll_interval": "poll",
           "organization": "org", "fault_profile": "", "backend": "",
           "n_workers": "w", "cpu_rate_scale": "cpu", "dataset": "",
           "sched_policy": ""}


def expand(group: str, *, tier: str = "full",
           checks: Union[tuple[Check, ...], ChecksFor] = (),
           baseline: Optional[Callable[[dict], Optional[RunSpec]]] = None,
           notes: str = "", **axes) -> list[Scenario]:
    """Expand a scenario matrix: list-valued RunSpec fields are swept.

    ``checks`` (and ``baseline``) may be callables receiving the swept-axis
    dict of each cell, so reference values can vary across the grid::

        expand("beyond_poll", dataset="monday", n_workers=511,
               nodes=64, nppn=8, poll_interval=[0.05, 0.3, 2.0, 10.0])

    Scenario names are ``{group}_{axis}{value}...`` over the swept axes,
    in declaration order.
    """
    swept = {k: v for k, v in axes.items()
             if isinstance(v, (list, tuple))}
    fixed = {k: v for k, v in axes.items() if k not in swept}
    out: list[Scenario] = []
    for combo in itertools.product(*swept.values()) if swept else [()]:
        cell = dict(zip(swept.keys(), combo))
        spec = RunSpec(**fixed, **cell)
        suffix = "".join(f"_{_ABBREV.get(k, k)}{v}"
                         for k, v in cell.items())
        cell_checks = checks(cell) if callable(checks) else tuple(checks)
        cell_base = baseline(cell) if baseline is not None else None
        out.append(Scenario(
            name=f"{group}{suffix}" if suffix else group,
            group=group, run=spec, baseline=cell_base,
            checks=cell_checks, tier=tier, notes=notes))
    return out
