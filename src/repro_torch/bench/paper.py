"""Paper-reference scenarios: Tables I/II, Figs 4-9, §IV.A-C, §V.

A copy of the JAX reference package's declarations (``repro.bench.paper``,
which replaced the bespoke loops of its ``benchmarks/paper_tables.py``):
each published cell/claim is one
:class:`~repro_torch.bench.scenarios.Scenario` with explicit reference
checks, so the campaign artifact records the delta against the paper for
every run.  All of them run on the sim and threads backends (virtual
seconds of the cost model), so the port's records equal the
reference's.

``TABLE_TOLERANCE`` is the documented reproduction tolerance for the
Table I/II job-time cells: the calibrated simulator lands within ~10 % of
most cells (see core/cost_model.py's calibration story); 20 % is the gate
so that cost-model recalibration can't silently drift a cell further than
the tier-1 suite (tests/test_simulator_paper.py) allows.
"""

from __future__ import annotations

import dataclasses

from repro_torch.bench.scenarios import Check, RunSpec, Scenario, expand
from repro_torch.core.cost_model import LEGACY_LAUNCH_PENALTY
from repro_torch.core.triples import feasible_table_cells

__all__ = ["PAPER_TABLE1", "PAPER_TABLE2", "TABLE_TOLERANCE",
           "paper_scenarios", "smoke_scenarios"]

# Job seconds, Tables I & II (chronological / largest-first organization).
PAPER_TABLE1 = {(2048, 32): 5640, (1024, 32): 5944, (512, 32): 7493,
                (256, 32): 11944, (1024, 16): 5963, (512, 16): 7157,
                (256, 16): 11860, (512, 8): 6989, (256, 8): 11860}
PAPER_TABLE2 = {(2048, 32): 5456, (1024, 32): 5704, (512, 32): 6608,
                (256, 32): 11015, (1024, 16): 5568, (512, 16): 6330,
                (256, 16): 10428, (512, 8): 6171, (256, 8): 10428}

TABLE_TOLERANCE = 0.20


def _table_scenarios() -> list[Scenario]:
    out = []
    for group, organization, table, src in (
            ("table1", "chronological", PAPER_TABLE1, "Table I"),
            ("table2", "largest_first", PAPER_TABLE2, "Table II")):
        for cores, nppn in feasible_table_cells():
            out.append(Scenario(
                name=f"{group}_c{cores}_n{nppn}", group=group, tier="quick",
                run=RunSpec.from_table_cell(cores, nppn, organization),
                checks=(Check("job_seconds", "within_rel",
                              table[(cores, nppn)], TABLE_TOLERANCE,
                              f"{src} ({cores} cores, NPPN {nppn})"),)))
    return out


def paper_scenarios() -> list[Scenario]:
    """Every published cell/claim the simulator reproduces."""
    scens = _table_scenarios()

    # Fig 4 headline: 1024 cores/NPPN=16/size-order beats 2048
    # cores/NPPN=32/chronological => same perf from 50 % fewer nodes.
    scens.append(Scenario(
        name="fig4_1024c16_size_beats_2048c32_chrono", group="fig4",
        tier="quick",
        run=RunSpec.from_table_cell(1024, 16, "largest_first"),
        baseline=RunSpec.from_table_cell(2048, 32, "chronological"),
        checks=(Check("job_seconds_reduction_pct", "min", 0.0,
                      source="Fig 4 (half the nodes, same performance)"),)))

    # Figs 5-6: worker-time distribution shift/shape (observational; the
    # shape assertions live in tests/test_simulator_paper.py).
    scens.extend(expand(
        "fig56", dataset="monday", phase="organize",
        n_workers=255, nodes=32, nppn=8,
        organization=["chronological", "largest_first"]))

    # Fig 7: job time degrades as tasks-per-message grows (dataset #1).
    scens.extend(expand(
        "fig7", dataset="monday", phase="organize",
        n_workers=511, nodes=64, nppn=8, organization="largest_first",
        tasks_per_message=[1, 2, 4, 8, 16]))

    # §IV.A: median worker time -14 % vs the legacy batch/block launcher.
    scens.append(Scenario(
        name="sec4a_median_worker_vs_legacy", group="sec4a", tier="quick",
        run=RunSpec(dataset="monday", phase="organize",
                    n_workers=255, nodes=32, nppn=8,
                    organization="largest_first"),
        baseline=RunSpec(dataset="monday", phase="organize", mode="static",
                         policy="block", n_workers=255, nodes=32, nppn=8,
                         organization="chronological",
                         legacy_launch_penalty=LEGACY_LAUNCH_PENALTY),
        checks=(Check("median_busy_delta_pct", "within_abs", -14.0, 4.0,
                      "§IV.A (median worker time -14%)"),)))

    # §IV.B: block -> cyclic archive distribution cuts job time >90 %.
    scens.append(Scenario(
        name="sec4b_archive_block_to_cyclic", group="sec4b", tier="quick",
        run=RunSpec(dataset="archive", phase="archive", mode="static",
                    policy="cyclic", n_workers=1023, nodes=64, nppn=16),
        baseline=RunSpec(dataset="archive", phase="archive", mode="static",
                         policy="block", n_workers=1023, nodes=64, nppn=16),
        checks=(Check("job_seconds_reduction_pct", "min", 90.0,
                      source="§IV.B (>90% reduction)"),)))

    # §IV.C / Fig 8: processing worker-time distribution.
    scens.append(Scenario(
        name="fig8_processing", group="fig8",
        run=RunSpec(dataset="processing", phase="process",
                    n_workers=1023, nodes=64, nppn=16,
                    organization="random"),
        checks=(Check("median_busy_hours", "within_rel", 13.1, 0.10,
                      "§IV.C (median 13.1 h)"),
                Check("max_busy_hours", "max", 32.0,
                      source="§IV.C (all done within 29.6 h)"))))
    scens.append(Scenario(
        name="fig8_legacy_batch_block", group="fig8",
        run=RunSpec(dataset="processing", phase="process", mode="static",
                    policy="block", n_workers=1023, nodes=32, nppn=32,
                    organization="filename",
                    legacy_launch_penalty=LEGACY_LAUNCH_PENALTY),
        checks=(Check("job_seconds", "min", 7 * 86400.0,
                      source="§IV.C (legacy batch/block needed >7 days)"),)))

    # §V / Fig 9: radar dataset, 300 tasks/message, tight span.
    scens.append(Scenario(
        name="fig9_radar", group="fig9", tier="quick",
        run=RunSpec(dataset="radar_messages", phase="radar",
                    n_workers=1023, nodes=128, nppn=8,
                    organization="random"),
        checks=(Check("median_busy_hours", "within_rel", 24.34, 0.05,
                      "§V (median worker busy 24.34 h)"),
                Check("span_hours", "max", 2.5,
                      "§V (worker span 1.12 h; tight by construction)"))))
    return scens


def smoke_scenarios() -> list[Scenario]:
    """Scaled live-backend smokes: the same protocol on real workers.

    The threads smoke is quick-tier (CI runs it on every push); the
    processes smoke and the fault-injected variant stay full-tier.
    """

    def completes_all(_cell: dict) -> tuple[Check, ...]:
        return (Check("tasks_completed", "within_abs", 200.0, 0.0,
                      "engine invariant (exactly-once completion)"),)

    scens = expand(
        "smoke", dataset="smoke", phase="organize",
        backend=["threads", "processes"],
        n_workers=7, nppn=8, nodes=1, tasks_per_message=5,
        checks=completes_all)
    for i, sc in enumerate(scens):
        if sc.run.backend == "threads":
            scens[i] = dataclasses.replace(sc, tier="quick")
    scens.extend(expand(
        "smoke_faults", dataset="smoke", phase="organize",
        backend=["threads"], n_workers=4, tasks_per_message=2,
        fault_profile="live_one_death", failure_timeout=5.0,
        checks=completes_all))
    return scens
