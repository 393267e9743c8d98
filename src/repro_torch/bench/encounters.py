"""Encounter-screening benchmark matrix: density x backend x policy.

The kernels matrix benchmarks the segment hot path; this module
benchmarks the *screening* stage built on top of it: the
spatial-hash binning (:mod:`repro_torch.geometry.gridhash`) plus the fused
pairwise miss-distance kernel (:mod:`repro_torch.kernels.encounter_screen`)
against the brute-force all-pairs reference, and the scheduling
policies against the genuinely *quadratic* per-cell cost skew the
screening workload produces.  Two cell kinds share one artifact
(``BENCH_encounters.json``, schema ``repro.bench.encounters/v1``):

  * ``screen`` cells — LIVE screening of synthetic density trails
    (:func:`repro_torch.tracks.datasets.screen_density_trails`): bin, batch,
    screen, then brute-force the same rows and require the candidate
    sets to be *exactly* equal (ids and values — the halo-padded hash
    guarantees no pair inside the thresholds can be missed).  The
    deterministic gating metric is ``screen_seconds_per_candidate``
    (modeled SCREEN_PHASE cost over the screened cells per emitted
    candidate); the live ``kernel_speedup_x`` (brute wall / grid wall)
    lands in ``measured`` and is gated by the scenario check, not by
    ``bench.compare``.
  * ``policy_sim`` cells — the discrete-event backend over the
    ``aerodrome_dense`` screen-cell manifest, whose
    ``cpu_cost_hint = cell_cost(occupancy)`` is quadratic in
    occupancy: a handful of hotspot cells dominate total cost, which
    is precisely the skew ``sized_lpt`` / ``adaptive_chunk`` exist to
    handle.  Deterministic per seed, so everything gates byte-stably.

The quick tier is the acceptance cell set: candidate-set exactness on
two tiny manifests, >= 5x fused-kernel speedup over the numpy brute
force at aerodrome density, sparse cells skipping the kernel, and
``sized_lpt``/``adaptive_chunk`` each >= 1.3x lower makespan than
``static`` on the quadratic skew.

Note on backends: screen cells take the port's backend names.
``kernel`` is the production path — the CUDA kernel on the card, its
plain version on the CPU — and ``ref`` composes the plain version
directly.  Both of the reference's ``jit`` and ``pallas`` cells become
``kernel`` cells; their names stay the reference's, so
``bench.compare`` pairs a reference artifact with a port artifact
scenario by scenario.  ``device`` is a campaign-level argument, not a
spec field.  The grid screen's timed window ends when every cell
batch's result has been copied to the host, so no card work is left
queued when its clock stops.

CLI::

    PYTHONPATH=src python -m repro_torch.bench.encounters --quick --device cpu
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.bench.engine import environment
from repro_torch.bench.scenarios import FAULT_PROFILES, Check
from repro_torch.bench.schema import (
    ENCOUNTERS_SCHEMA, SCHEMA_VERSION, validate_encounters)
from repro_torch.kernels.ops import resolve_device
from repro_torch.runtime.policies import POLICY_NAMES

__all__ = ["EncounterSpec", "EncounterScenario", "encounter_scenarios",
           "run_encounter_scenario", "run_encounter_campaign",
           "encounter_summary_lines", "main"]


@dataclasses.dataclass(frozen=True)
class EncounterSpec:
    """One encounter-bench configuration — JSON-able, hashable."""

    kind: str = "screen"            # screen | policy_sim
    dataset: str = "dense"          # trail kind (screen) / manifest name
    n_aircraft: int = 3000          # screen cells: trail population
    backend: str = "kernel"         # kernel | ref (screen); sim
    policy: str = "static"
    phase: str = "screen"
    n_workers: int = 32
    organization: str = "chronological"
    tasks_per_message: int = 1
    fault_profile: str = "none"
    h_thresh_m: float = 926.0
    v_thresh_m: float = 152.4
    cell_deg: float = 0.25
    cell_t_s: float = 300.0
    seed: int = 11

    def __post_init__(self) -> None:
        if self.kind not in ("screen", "policy_sim"):
            raise ValueError(f"unknown cell kind {self.kind!r}")
        if self.kind == "screen":
            if self.backend not in ("kernel", "ref"):
                raise ValueError(f"screen cells need a kernel backend, "
                                 f"not {self.backend!r}")
            if self.dataset not in ("dense", "sparse"):
                raise ValueError(f"unknown trail kind {self.dataset!r}")
        else:
            if self.backend != "sim":
                raise ValueError("policy_sim cells run on the sim backend")
            if self.policy not in POLICY_NAMES:
                raise ValueError(f"unknown policy {self.policy!r}")
        if self.fault_profile not in FAULT_PROFILES:
            raise ValueError(f"unknown fault profile "
                             f"{self.fault_profile!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class EncounterScenario:
    """One named encounter-bench cell."""

    name: str
    group: str
    run: EncounterSpec
    baseline: Optional[EncounterSpec] = None
    checks: tuple[Check, ...] = ()
    tier: str = "full"
    notes: str = ""

    def matches(self, patterns: Sequence[str]) -> bool:
        if not patterns:
            return True
        return any(p in self.name or p in self.group for p in patterns)


# ---------------------------------------------------------------------------
# screen cells.
# ---------------------------------------------------------------------------

def _screen_rows(spec: EncounterSpec) -> list:
    """Density trails -> ScreenRows (one per aircraft)."""
    from repro_torch.kernels.encounter_screen import ScreenRow
    from repro_torch.tracks.datasets import (
        SCREEN_TRAIL_DT_S, screen_density_trails)

    rows = []
    for aid, ts, la, lo, al in screen_density_trails(
            spec.dataset, spec.n_aircraft, spec.seed):
        rows.append(ScreenRow(
            row_id=f"{aid}#s000", group=aid, t0=float(ts[0]),
            lat=np.asarray(la, np.float32),
            lon=np.asarray(lo, np.float32),
            alt=np.asarray(al, np.float32),
            dt_s=SCREEN_TRAIL_DT_S))
    return rows


def _pair_key(c: dict) -> tuple:
    return (c["a"], c["b"])


def _execute_screen(spec: EncounterSpec, device) -> dict:
    from repro_torch.core.cost_model import SCREEN_PHASE
    from repro_torch.geometry.gridhash import GridSpec, cell_cost
    from repro_torch.kernels.encounter_screen import (
        ScreenConfig, bin_screen_rows, brute_force_screen,
        get_screen_stats, reset_screen_stats, screen_rows_grid)
    from repro_torch.tracks.datasets import SCREEN_ROW_BYTES, SCREEN_TRAIL_DT_S

    rows = _screen_rows(spec)
    # The 4-D hash prunes along TIME as much as space: density trails
    # span ~2 min inside a 30-min feed, so an hour-scale window (the
    # workflow default, sized for hourly track files) would co-bin
    # pairs that never temporally overlap.  Exactness is window-
    # independent — every co-cell pair is screened over its rows' FULL
    # joint span (see ``_pack_cell``), the window only selects which
    # pairs meet — so the bench grid matches the window to the feed.
    grid = GridSpec(cell_deg=spec.cell_deg, cell_t_s=spec.cell_t_s)
    config = ScreenConfig(h_thresh_m=spec.h_thresh_m,
                          v_thresh_m=spec.v_thresh_m,
                          dt_s=SCREEN_TRAIL_DT_S, backend=spec.backend,
                          device=device)

    # Warm-up pass: on the card it builds the kernel library and meets
    # every bucket shape, so the measured pass times steady-state
    # screening.
    screen_rows_grid(rows, grid=grid, config=config)
    reset_screen_stats()
    t0 = time.perf_counter()
    cands, stats = screen_rows_grid(rows, grid=grid, config=config)
    grid_wall = time.perf_counter() - t0
    kstats = get_screen_stats()

    t0 = time.perf_counter()
    brute = brute_force_screen(rows, config=config)
    brute_wall = time.perf_counter() - t0

    set_equal = int([_pair_key(c) for c in cands]
                    == [_pair_key(c) for c in brute])
    # Minima may differ by float32 ULPs (the kernel and its plain version
    # order the distance trace differently from numpy); anything beyond
    # centimetres is a bug.
    values_equal = int(set_equal and all(
        g["t_s"] == b["t_s"] and abs(g["h_m"] - b["h_m"]) <= 1e-2
        and abs(g["v_m"] - b["v_m"]) <= 1e-2
        for g, b in zip(cands, brute)))

    # Modeled (deterministic) screen cost: the SCREEN_PHASE estimate of
    # every multi-row cell at its quadratic cpu_cost_hint — the same
    # numbers the workflow's screen tasks carry.
    bins = bin_screen_rows(rows, grid=grid, config=config)
    occs = [len(ids) for ids in bins.values() if len(ids) >= 2]
    modeled = sum(SCREEN_PHASE.task_seconds(occ * SCREEN_ROW_BYTES,
                                            cpu_cost_hint=cell_cost(occ))
                  for occ in occs)
    metrics = {
        "n_rows": len(rows),
        "cells": stats["cells"],
        "cells_screened": stats["cells_screened"],
        "cells_skipped": stats["cells_skipped"],
        "pairs_screened": stats["pairs_screened"],
        "max_cell_occupancy": stats["max_occupancy"],
        "candidates": stats["candidates"],
        "candidates_raw": stats["candidates_raw"],
        "candidate_set_equal": set_equal,
        "candidate_values_equal": values_equal,
        "kernel_calls": kstats["kernel_calls"],
        "modeled_screen_seconds": modeled,
        "screen_seconds_per_candidate": (
            modeled / max(stats["candidates"], 1)),
    }
    measured = {
        "grid_wall_s": grid_wall,
        "brute_wall_s": brute_wall,
        "kernel_speedup_x": (brute_wall / grid_wall if grid_wall > 0
                             else 0.0),
    }
    return {"metrics": metrics, "measured": measured}


# ---------------------------------------------------------------------------
# policy_sim cells.
# ---------------------------------------------------------------------------

def _execute_policy_sim(spec: EncounterSpec) -> dict:
    from repro_torch.core.cost_model import PHASES
    from repro_torch.runtime import run_job
    from repro_torch.tracks.datasets import SCREEN_ROW_BYTES, get_manifest

    tasks = get_manifest(spec.dataset)
    model = PHASES[spec.phase]
    worker_death, worker_speed, _, _ = FAULT_PROFILES[
        spec.fault_profile].materialize(spec.n_workers, spec.seed)
    result = run_job(
        tasks, None, backend="sim", n_workers=spec.n_workers,
        organization=spec.organization,
        tasks_per_message=spec.tasks_per_message,
        policy=spec.policy, cost_model=model,
        worker_death=worker_death, worker_speed=worker_speed,
        organize_seed=spec.seed, raise_on_failure=False)
    bq = result.busy_quantiles()
    metrics = {
        "cells": len(tasks),
        "max_cell_occupancy": max(
            t.size_bytes // SCREEN_ROW_BYTES for t in tasks),
        "tasks_completed": len(result.completed_ids),
        "messages_sent": result.messages_sent,
        "makespan_seconds": result.job_seconds,
        "busy_p50_s": bq["p50"],
        "busy_p90_s": bq["p90"],
        "busy_total_s": sum(result.worker_busy),
        "dispatch_digest": result.dispatch_digest,
    }
    return {"metrics": metrics, "measured": {}}


# ---------------------------------------------------------------------------
# Record assembly.
# ---------------------------------------------------------------------------

def _execute(spec: EncounterSpec, device,
             cache: Optional[dict] = None) -> dict:
    if cache is not None and spec in cache:
        return cache[spec]
    out = (_execute_screen(spec, device) if spec.kind == "screen"
           else _execute_policy_sim(spec))
    if cache is not None:
        cache[spec] = out
    return out


def run_encounter_scenario(sc: EncounterScenario,
                           cache: Optional[dict] = None, *,
                           device=None) -> dict:
    """Execute one scenario (plus baseline) into a BENCH record, its
    screen cells on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    spec_doc = {"run": sc.run.to_dict(),
                "baseline": sc.baseline.to_dict() if sc.baseline else None}
    try:
        run = _execute(sc.run, device, cache)
        base = (_execute(sc.baseline, device, cache) if sc.baseline
                else None)
    except Exception as e:                 # keep the campaign going
        return {"name": sc.name, "group": sc.group, "tier": sc.tier,
                "status": "error", "spec": spec_doc,
                "metrics": {}, "measured": {}, "checks": [],
                "timing": {"wall_s": time.perf_counter() - t0},
                "error": f"{type(e).__name__}: {e}"}

    metrics = dict(run["metrics"])
    measured = dict(run["measured"])
    if base is not None:
        bm = base["metrics"]
        if "makespan_seconds" in bm:          # sim vs sim: deterministic
            metrics["baseline_makespan_seconds"] = bm["makespan_seconds"]
            if metrics.get("makespan_seconds"):
                metrics["makespan_speedup_x"] = (
                    bm["makespan_seconds"] / metrics["makespan_seconds"])

    merged = {**measured, **metrics}
    checks = [c.evaluate(merged) for c in sc.checks]
    status = ("ran" if not checks
              else "pass" if all(c["passed"] for c in checks) else "fail")
    return {"name": sc.name, "group": sc.group, "tier": sc.tier,
            "status": status, "spec": spec_doc,
            "metrics": metrics, "measured": measured, "checks": checks,
            "timing": {"wall_s": time.perf_counter() - t0}, "error": None}


# ---------------------------------------------------------------------------
# The declared matrix.
# ---------------------------------------------------------------------------

#: The policy acceptance regime: the aerodrome-dense screen-cell
#: manifest (quadratic cpu_cost_hint skew: max cell ~7 s of a ~90 s
#: total over 585 cells) on 32 fault-free sim workers — enough fleet
#: that the giant hotspot cells dominate the static-chunk makespan,
#: not so much that any order saturates.
_POLICY_BASE = EncounterSpec(kind="policy_sim", dataset="aerodrome_dense",
                             n_aircraft=3000, backend="sim",
                             phase="screen", n_workers=32,
                             organization="chronological",
                             tasks_per_message=1, fault_profile="none")

_TINY = EncounterSpec(kind="screen", dataset="dense", n_aircraft=500,
                      backend="kernel")


def encounter_scenarios() -> list[EncounterScenario]:
    """screen exactness/speedup cells + policy cells on quadratic skew."""
    static_base = dataclasses.replace(_POLICY_BASE, policy="static")
    exact_checks = (
        Check("candidate_set_equal", "min", 1,
              source="grid+kernel candidates exactly equal "
                     "brute-force all-pairs"),
        Check("candidate_values_equal", "min", 1,
              source="pair minima/time bitwise equal to brute force"),
        Check("cells_skipped", "min", 1,
              source="empty/singleton cells never reach the kernel"),
    )
    out = [
        EncounterScenario(
            name="enc_exact_tiny_dense_jit",
            group="enc_exact",
            run=_TINY,
            checks=exact_checks + (
                Check("candidates", "min", 1,
                      source="tiny dense manifest produces a non-empty "
                             "candidate set (the equality gate is not "
                             "vacuous)"),),
            tier="quick", notes="exactness cell (kernel backend)"),
        EncounterScenario(
            name="enc_exact_tiny_dense_pallas",
            group="enc_exact",
            run=dataclasses.replace(_TINY, n_aircraft=150),
            checks=exact_checks,
            tier="quick",
            notes="the reference's kernel exactness cell, kept under "
                  "its name: the kernel backend at 150 aircraft"),
        EncounterScenario(
            name="enc_dense_kernel_speedup",
            group="enc_speedup",
            run=dataclasses.replace(_TINY, n_aircraft=3000),
            checks=exact_checks + (
                Check("candidates", "min", 100,
                      source="full aerodrome density yields a dense "
                             "candidate set"),
                Check("kernel_speedup_x", "min", 5.0,
                      source="fused within-cell screen >= 5x "
                             "over numpy brute force at aerodrome "
                             "density"),),
            tier="quick",
            notes="kernel backend (the production path) at the full "
                  "aerodrome-dense population; the warm-up pass keeps "
                  "the kernel build out of the measured wall"),
        EncounterScenario(
            name="enc_sparse_density",
            group="enc_density",
            run=dataclasses.replace(_TINY, dataset="sparse",
                                    n_aircraft=900, seed=12),
            checks=(
                Check("candidate_set_equal", "min", 1,
                      source="exactness holds on the sparse regime too"),
                Check("max_cell_occupancy", "max", 8,
                      source="en-route-sparse cells stay an order of "
                             "magnitude below aerodrome density"),
                Check("cells_skipped", "min", 1,
                      source="sparse binning is dominated by "
                             "singleton cells"),),
            tier="quick", notes="paper dataset #1 regime"),
    ]
    for policy in ("sized_lpt", "adaptive_chunk"):
        out.append(EncounterScenario(
            name=f"enc_policy_quadratic_{policy}",
            group="enc_policy",
            run=dataclasses.replace(_POLICY_BASE, policy=policy),
            baseline=static_base,
            checks=(
                Check("makespan_speedup_x", "min", 1.3,
                      source=f"{policy} >= 1.3x vs static on "
                             f"quadratic-skew screen cells"),
                Check("tasks_completed", "min", 585,
                      source="every screen cell completes"),),
            tier="quick", notes="policy acceptance cell"))
    # Full tier: the whole policy sweep plus the sparse policy control
    # (near-uniform tiny cells: policies must not lose to static).
    for policy in POLICY_NAMES:
        if policy in ("sized_lpt", "adaptive_chunk"):
            continue
        out.append(EncounterScenario(
            name=f"enc_policy_sweep_{policy}",
            group="enc_policy",
            run=dataclasses.replace(_POLICY_BASE, policy=policy),
            baseline=(static_base if policy != "static" else None)))
    out.append(EncounterScenario(
        name="enc_policy_sparse_control_sized_lpt",
        group="enc_policy",
        run=dataclasses.replace(_POLICY_BASE, dataset="enroute_sparse",
                                policy="sized_lpt"),
        baseline=dataclasses.replace(static_base,
                                     dataset="enroute_sparse"),
        notes="near-uniform cells: nothing for LPT to exploit"))
    out.append(EncounterScenario(
        name="enc_dense_mid_scale",
        group="enc_speedup",
        run=dataclasses.replace(_TINY, n_aircraft=2000),
        checks=exact_checks,
        notes="mid-density point on the scaling curve"))
    return out


def run_encounter_campaign(*, quick: bool = False,
                           filters: Sequence[str] = (),
                           seed: Optional[int] = None,
                           progress=None, device=None) -> dict:
    """Run the screening matrix into a schema-valid BENCH doc, its screen
    cells on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    selected = [sc for sc in encounter_scenarios()
                if (not quick or sc.tier == "quick")
                and sc.matches(filters)]
    if not selected:
        raise ValueError("no encounter scenarios match the quick/filter "
                         "selection")
    if seed is not None:
        selected = [dataclasses.replace(
            sc, run=dataclasses.replace(sc.run, seed=seed),
            baseline=(dataclasses.replace(sc.baseline, seed=seed)
                      if sc.baseline else None))
            for sc in selected]
    t0 = time.perf_counter()
    records = []
    cache: dict = {}     # one execution per distinct spec per campaign
    for sc in selected:
        rec = run_encounter_scenario(sc, cache, device=device)
        records.append(rec)
        if progress is not None:
            progress(rec)
    counts = {s: 0 for s in ("pass", "fail", "ran", "error")}
    for rec in records:
        counts[rec["status"]] += 1
    doc = {
        "schema": ENCOUNTERS_SCHEMA,
        "schema_version": SCHEMA_VERSION,
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "config": {"quick": quick, "filters": list(filters),
                   "seed": seed, "n_selected": len(selected)},
        "environment": environment(device),
        "scenarios": records,
        "summary": {"total": len(records), **counts,
                    "checked": sum(1 for r in records if r["checks"])},
        "timing": {"wall_s": time.perf_counter() - t0},
    }
    problems = validate_encounters(doc)
    if problems:      # a bug in this module, not in the scenarios
        raise RuntimeError("encounters bench produced a schema-invalid "
                           "artifact: " + "; ".join(problems[:5]))
    return doc


def encounter_summary_lines(doc: dict) -> list[str]:
    """Human-readable summary for the CLI."""
    s = doc["summary"]
    lines = [f"{s['total']} encounter scenarios: {s['pass']} pass, "
             f"{s['fail']} fail, {s['ran']} ran, {s['error']} error "
             f"[{doc['timing']['wall_s']:.1f}s]"]
    for rec in doc["scenarios"]:
        if rec["status"] == "error":
            lines.append(f"  ERROR {rec['name']}: {rec['error']}")
            continue
        m = {**rec["measured"], **rec["metrics"]}
        bits = []
        if "candidates" in m:
            bits.append(f"cells={m['cells']}")
            bits.append(f"occ_max={m['max_cell_occupancy']}")
            bits.append(f"cands={m['candidates']}")
            bits.append(f"exact={m['candidate_set_equal']}")
        if "kernel_speedup_x" in m:
            bits.append(f"kernel={m['kernel_speedup_x']:.1f}x")
        if "makespan_seconds" in m:
            bits.append(f"makespan={m['makespan_seconds']:.3g}s")
        if "makespan_speedup_x" in m:
            bits.append(f"speedup={m['makespan_speedup_x']:.2f}x")
        lines.append(f"  {rec['status']:5s} {rec['name']}: "
                     + " ".join(bits))
        for c in rec["checks"]:
            if not c["passed"]:
                lines.append(f"        FAIL {c['metric']}="
                             f"{c['actual']} vs {c['kind']} {c['expect']}")
    return lines


def main(argv=None) -> int:
    """CLI: ``python -m repro_torch.bench.encounters [--quick] [--out PATH]``."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.encounters",
        description="Benchmark the encounter-screening matrix (candidate "
                    "exactness, kernel speedup, policy makespan on "
                    "quadratic skew); write BENCH_encounters.json.")
    ap.add_argument("--quick", action="store_true",
                    help="run only the quick tier (the CI acceptance "
                         "cells)")
    ap.add_argument("--filter", action="append", default=[],
                    metavar="SUBSTR")
    ap.add_argument("--out", default="BENCH_encounters.json",
                    help="artifact path ('-' for stdout only)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the screen cells run (default: the "
                         "card; 'cpu' runs the plain version)")
    args = ap.parse_args(argv)

    if args.list:
        for sc in encounter_scenarios():
            if sc.matches(args.filter) and (not args.quick
                                            or sc.tier == "quick"):
                print(f"{sc.tier:5s} {sc.group:14s} {sc.name} "
                      f"[{len(sc.checks)} checks]")
        return 0

    if not any(sc.matches(args.filter) and (not args.quick
                                            or sc.tier == "quick")
               for sc in encounter_scenarios()):
        print("no encounter scenarios match", file=sys.stderr)
        return 1

    def progress(rec):
        print(f"  {rec['status']:5s} {rec['name']} "
              f"({rec['timing']['wall_s']:.2f}s)", flush=True)

    doc = run_encounter_campaign(quick=args.quick, filters=args.filter,
                                 seed=args.seed, progress=progress,
                                 device=args.device)
    if args.out != "-":
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")
    for line in encounter_summary_lines(doc):
        print(line)
    return 1 if (doc["summary"]["fail"] or doc["summary"]["error"]) else 0


if __name__ == "__main__":
    sys.exit(main())
