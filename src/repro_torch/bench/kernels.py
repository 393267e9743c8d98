"""Kernel-level benchmark scenarios: fused vs unfused segment pipeline.

The campaign (:mod:`repro_torch.bench.campaign`) benchmarks the *scheduler*;
this module benchmarks the *per-task hot path* it schedules — the
segment pipeline of :mod:`repro_torch.tracks.segments` — and emits the same
structured record shape into a ``BENCH_kernels.json`` artifact
(``repro.bench.kernels/v1``, validated by
:func:`repro_torch.bench.schema.validate_kernels`).

Each scenario runs the fused, length-bucketed pipeline over a synthetic
segment-length workload and measures it against the unfused
three-launch baseline (``SegmentProcessor(pipeline='unfused')``) built
from the SAME observations:

  * ``padded_fraction`` — padded output elements per valid element (the
    padding-to-payload ratio; multiplies wasted kernel compute);
    ``padded_share`` is the companion share-of-tile number in [0, 1).
  * ``intermediate_transfers`` — mid-pipeline host<->device hops per
    batch, counted by :mod:`repro_torch.kernels.ops` instrumentation (the
    unfused path makes 4; the fused path must make 0).
  * ``compile_hits`` / ``compile_misses`` — the per-bucket-shape cache
    behavior across repeated batches (the port counts a bucket shape's
    first pipeline call as a miss, as the reference counts a jit
    compile).
  * ``max_abs_diff_vs_baseline`` — fused-vs-unfused output agreement.
  * ``segments_per_s`` / ``points_per_s`` / ``speedup_x`` — steady-state
    wall-clock throughput (in ``measured``: the only nondeterministic
    fields, so ``metrics`` and ``checks`` on deterministic metrics stay
    reproducible for a fixed seed).

Deterministic/measured split note: unlike the campaign artifact, the
kernels artifact gates wall-clock throughput (``speedup_x``), so its
``checks`` list is not byte-reproducible — only ``metrics`` is.

``device`` (a campaign-level argument, not a spec field) is where the
pipelines run: on the card the fused path launches the track_interp,
agl_lookup and dynamic_rates kernels once per bucket and the unfused
path once each per batch; on the CPU both run the plain versions.  A
timed window ends when ``_process_many`` has copied every plane to the
host, so no card work is left queued when its clock stops.

CLI::

    PYTHONPATH=src python -m repro_torch.bench.kernels --quick --device cpu
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
import zlib
from typing import Optional, Sequence

import numpy as np

from repro_torch.bench.engine import environment
from repro_torch.bench.scenarios import Check
from repro_torch.bench.schema import (
    KERNELS_SCHEMA, SCHEMA_VERSION, validate_kernels)
from repro_torch.kernels import ops

__all__ = ["KernelSpec", "KernelScenario", "WORKLOADS",
           "kernel_scenarios", "synth_items", "run_kernel_scenario",
           "run_kernel_campaign", "kernel_summary_lines", "main"]

#: Segment-duration distributions (seconds on the 1 Hz grid, so a
#: duration of d seconds is d+1 output points).  ``heavy_tail`` mirrors
#: the paper's Fig 3 aerodrome case: mostly short segments, a long tail.
WORKLOADS: dict[str, dict] = {
    "heavy_tail": {"kind": "lognormal", "median_s": 100.0, "sigma": 0.6},
    "uniform_mix": {"kind": "uniform", "low_s": 40.0, "high_s": 900.0},
    "long_cruise": {"kind": "lognormal", "median_s": 700.0, "sigma": 0.25},
}

_DUR_CLIP = (15.0, 1023.0)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One hot-path configuration — JSON-able, hashable."""

    workload: str = "heavy_tail"
    pipeline: str = "fused"             # fused | unfused
    backend: str = "kernel"             # kernel | ref
    n_archives: int = 10
    segments_per_archive: int = 8
    repeats: int = 3                    # timed steady-state batches
    seed: int = 0

    def __post_init__(self) -> None:
        if self.workload not in WORKLOADS:
            raise ValueError(f"unknown workload {self.workload!r}; "
                             f"choose from {sorted(WORKLOADS)}")
        if self.pipeline not in ("fused", "unfused"):
            raise ValueError(f"unknown pipeline {self.pipeline!r}")
        if self.backend not in ops.BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; choose "
                             f"from {ops.BACKENDS}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class KernelScenario:
    """One named kernel-bench cell (same role as bench.Scenario)."""

    name: str
    group: str
    run: KernelSpec
    baseline: Optional[KernelSpec] = None
    checks: tuple[Check, ...] = ()
    tier: str = "full"
    notes: str = ""

    def matches(self, patterns: Sequence[str]) -> bool:
        if not patterns:
            return True
        return any(p in self.name or p in self.group for p in patterns)


def synth_items(spec: KernelSpec) -> list[tuple[dict, list[slice]]]:
    """Deterministic synthetic archives for one workload spec.

    Returns ``(obs, segs)`` pairs shaped exactly like
    ``SegmentProcessor.read_observations`` + ``split_segments`` output,
    so the bench exercises the real ``_process_many`` entry point
    without touching the filesystem."""
    from repro_torch.tracks.segments import split_segments

    w = WORKLOADS[spec.workload]
    rng = np.random.default_rng(
        spec.seed * 7919 + zlib.crc32(spec.workload.encode()) % 100003)
    items = []
    for a in range(spec.n_archives):
        ts, lats, lons, alts = [], [], [], []
        t = 0.0
        for _ in range(spec.segments_per_archive):
            if w["kind"] == "lognormal":
                dur = rng.lognormal(np.log(w["median_s"]), w["sigma"])
            else:
                dur = rng.uniform(w["low_s"], w["high_s"])
            dur = float(np.clip(dur, *_DUR_CLIP))
            dt_obs = rng.uniform(3.0, 8.0)
            n = max(10, int(dur / dt_obs) + 1)
            gaps = rng.uniform(0.5, 1.5, n - 1)
            gaps *= dur / gaps.sum()
            seg_t = t + np.concatenate([[0.0], np.cumsum(gaps)])
            ts.append(seg_t)
            lat0 = rng.uniform(28.0, 47.0)
            lon0 = rng.uniform(-120.0, -70.0)
            lats.append(lat0 + np.cumsum(rng.normal(0, 1e-4, n)))
            lons.append(lon0 + np.cumsum(rng.normal(0, 1e-4, n)))
            alts.append(1500.0 + np.cumsum(rng.normal(0, 2.0, n)))
            t = seg_t[-1] + 600.0           # force a segment break
        obs = {
            "time": np.concatenate(ts),
            "lat": np.concatenate(lats),
            "lon": np.concatenate(lons),
            "alt": np.concatenate(alts),
            "icao24": np.array([f"bench{a:02d}"]
                               * sum(len(x) for x in ts)),
        }
        items.append((obs, split_segments(obs["time"])))
    return items


def _execute(spec: KernelSpec, device) -> dict:
    """Run one spec on ``device``: a warm-up batch (on the card it builds
    the kernel library and meets every bucket shape) + timed steady
    batches."""
    from repro_torch.geometry.aerodromes import synthetic_aerodromes
    from repro_torch.tracks.segments import SegmentProcessor

    items = synth_items(spec)
    proc = SegmentProcessor(aerodromes=synthetic_aerodromes(n=48),
                            device=device, backend=spec.backend,
                            pipeline=spec.pipeline)
    ops.reset_pipeline_stats()
    outs = proc._process_many(items)
    compile_stats = ops.get_pipeline_stats()

    ops.reset_pipeline_stats(forget_shapes=False)
    t0 = time.perf_counter()
    for _ in range(spec.repeats):
        outs = proc._process_many(items)
    wall = (time.perf_counter() - t0) / spec.repeats
    steady = ops.get_pipeline_stats()
    stats = proc.last_stats

    return {
        "outputs": outs,
        "metrics": {
            "n_segments": stats["n_segments"],
            "valid_points": stats["valid_points"],
            "allocated_points": stats["allocated_points"],
            "padded_fraction": stats["padded_fraction"],
            "padded_share": stats["padded_share"],
            "bucket_rows": {str(k): v
                            for k, v in stats["bucket_rows"].items()},
            "pipeline_calls": stats["pipeline_calls"],
            "intermediate_transfers":
                steady["intermediate_transfers"] / spec.repeats,
            "compile_misses_first_batch": compile_stats["compile_misses"],
            "compile_hits_steady": steady["compile_hits"],
            "compile_misses_steady": steady["compile_misses"],
        },
        "measured": {
            "wall_s_per_batch": wall,
            "segments_per_s": stats["n_segments"] / wall if wall else 0.0,
            "points_per_s": stats["valid_points"] / wall if wall else 0.0,
        },
    }


def _max_abs_diff(run_outs, base_outs) -> float:
    """Fused outputs vs the (wider) unfused planes, padding included."""
    fields = ("times", "lat", "lon", "alt_msl_m", "alt_agl_m",
              "vrate_ms", "gspeed_ms", "heading_rad", "turn_rad_s")
    worst = 0.0
    for r, b in zip(run_outs, base_outs):
        w = r.times.shape[1]
        for f in fields:
            a, c = getattr(r, f), getattr(b, f)
            if a.size:
                worst = max(worst, float(np.abs(a - c[:, :w]).max()))
            if c.shape[1] > w and c.size:
                worst = max(worst, float(np.abs(c[:, w:]).max()))
    return worst


def run_kernel_scenario(sc: KernelScenario, *, device=None) -> dict:
    """Execute one kernel scenario (plus baseline) into a BENCH record,
    on ``device`` (``None``: the card)."""
    device = ops.resolve_device(device)
    t0 = time.perf_counter()
    spec_doc = {"run": sc.run.to_dict(),
                "baseline": sc.baseline.to_dict() if sc.baseline else None}
    try:
        run = _execute(sc.run, device)
        base = _execute(sc.baseline, device) if sc.baseline else None
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
        metrics["baseline_padded_fraction"] = bm["padded_fraction"]
        metrics["baseline_intermediate_transfers"] = \
            bm["intermediate_transfers"]
        # floor the denominator: zero fused padding (the best outcome)
        # must report a huge reduction, not a missing metric that the
        # min-5x check would score as failed
        metrics["padded_fraction_reduction_x"] = \
            bm["padded_fraction"] / max(metrics["padded_fraction"], 1e-9)
        metrics["max_abs_diff_vs_baseline"] = _max_abs_diff(
            run["outputs"], base["outputs"])
        bw = base["measured"]["wall_s_per_batch"]
        rw = measured["wall_s_per_batch"]
        measured["baseline_wall_s_per_batch"] = bw
        measured["speedup_x"] = bw / rw if rw else float("inf")

    merged = {**measured, **metrics}
    checks = [c.evaluate(merged) for c in sc.checks]
    status = ("ran" if not checks
              else "pass" if all(c["passed"] for c in checks) else "fail")
    return {"name": sc.name, "group": sc.group, "tier": sc.tier,
            "status": status, "spec": spec_doc,
            "metrics": metrics, "measured": measured, "checks": checks,
            "timing": {"wall_s": time.perf_counter() - t0}, "error": None}


def kernel_scenarios() -> list[KernelScenario]:
    """The declared kernel-bench matrix.

    The quick tier is the acceptance cell: the fused pipeline on
    the heavy-tail segment-length distribution vs the unfused baseline —
    padding reduced >= 5x, zero intermediate transfers (baseline makes
    4), >= 2x throughput, outputs equal within 1e-5."""
    acceptance = (
        Check("padded_fraction_reduction_x", "min", 5.0,
              source="padding waste vs fixed 1024 tile"),
        Check("intermediate_transfers", "max", 0.0,
              source="fused path is device-resident"),
        Check("baseline_intermediate_transfers", "min", 4.0,
              source="unfused path: interp/fi+fj/agl/rates hops"),
        Check("speedup_x", "min", 2.0,
              source="segment-pipeline microbenchmark"),
        Check("max_abs_diff_vs_baseline", "max", 1e-5,
              source="fused == unfused on golden archives"),
    )
    equivalence = (
        Check("intermediate_transfers", "max", 0.0,
              source="fused path is device-resident"),
        Check("max_abs_diff_vs_baseline", "max", 1e-5,
              source="fused == unfused"),
    )
    out = []
    for workload, tier, checks in (
            ("heavy_tail", "quick", acceptance),
            ("uniform_mix", "full", equivalence),
            ("long_cruise", "full", equivalence)):
        run = KernelSpec(workload=workload, pipeline="fused")
        out.append(KernelScenario(
            name=f"segment_pipeline_{workload}",
            group="segment_pipeline", run=run,
            baseline=dataclasses.replace(run, pipeline="unfused"),
            checks=checks, tier=tier))
    # No backend='ref' fused-vs-unfused cell: the matrix is the
    # reference's, whose ref compositions differ at ulp level between
    # jit and eager execution (arctan2 branch cuts amplify that into
    # +-2pi heading flips).  On the CPU backend='kernel' runs the plain
    # versions already.
    return out


def run_kernel_campaign(*, quick: bool = False,
                        filters: Sequence[str] = (),
                        seed: Optional[int] = None,
                        progress=None, device=None) -> dict:
    """Run the kernel matrix into a schema-valid BENCH_kernels doc, on
    ``device`` (``None``: the card)."""
    device = ops.resolve_device(device)
    selected = [sc for sc in kernel_scenarios()
                if (not quick or sc.tier == "quick")
                and sc.matches(filters)]
    if not selected:
        raise ValueError("no kernel scenarios match the quick/filter "
                         "selection")
    if seed is not None:
        selected = [dataclasses.replace(
            sc, run=dataclasses.replace(sc.run, seed=seed),
            baseline=(dataclasses.replace(sc.baseline, seed=seed)
                      if sc.baseline else None))
            for sc in selected]
    t0 = time.perf_counter()
    records = []
    for sc in selected:
        rec = run_kernel_scenario(sc, device=device)
        records.append(rec)
        if progress is not None:
            progress(rec)
    counts = {s: 0 for s in ("pass", "fail", "ran", "error")}
    for rec in records:
        counts[rec["status"]] += 1
    doc = {
        "schema": KERNELS_SCHEMA,
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
    problems = validate_kernels(doc)
    if problems:      # a bug in this module, not in the scenarios
        raise RuntimeError("kernel bench produced a schema-invalid "
                           "artifact: " + "; ".join(problems[:5]))
    return doc


def kernel_summary_lines(doc: dict) -> list[str]:
    """Human-readable summary for the CLI."""
    s = doc["summary"]
    lines = [f"{s['total']} kernel scenarios: {s['pass']} pass, "
             f"{s['fail']} fail, {s['ran']} ran, {s['error']} error "
             f"[{doc['timing']['wall_s']:.1f}s]"]
    for rec in doc["scenarios"]:
        if rec["status"] == "error":
            lines.append(f"  ERROR {rec['name']}: {rec['error']}")
            continue
        m = {**rec["measured"], **rec["metrics"]}
        bits = [f"padded_fraction={m['padded_fraction']:.3f}"]
        if "padded_fraction_reduction_x" in m:
            bits.append(f"padding_cut={m['padded_fraction_reduction_x']:.1f}x")
        if "speedup_x" in m:
            bits.append(f"speedup={m['speedup_x']:.2f}x")
        bits.append(f"transfers={m['intermediate_transfers']:.0f}"
                    f"(base {m.get('baseline_intermediate_transfers', 0):.0f})")
        bits.append(f"compile={m['compile_misses_first_batch']}miss/"
                    f"{m['compile_hits_steady']}hit")
        lines.append(f"  {rec['status']:5s} {rec['name']}: "
                     + " ".join(bits))
        for c in rec["checks"]:
            if not c["passed"]:
                lines.append(f"        FAIL {c['metric']}="
                             f"{c['actual']} vs {c['kind']} {c['expect']}")
    return lines


def main(argv=None) -> int:
    """CLI: ``python -m repro_torch.bench.kernels [--quick] [--out PATH]``."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.kernels",
        description="Benchmark the fused segment pipeline against the "
                    "unfused baseline; write BENCH_kernels.json.")
    ap.add_argument("--quick", action="store_true",
                    help="run only the quick tier (the CI acceptance "
                         "cells)")
    ap.add_argument("--filter", action="append", default=[],
                    metavar="SUBSTR")
    ap.add_argument("--out", default="BENCH_kernels.json",
                    help="artifact path ('-' for stdout only)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the pipelines run (default: the card; "
                         "'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    if args.list:
        for sc in kernel_scenarios():
            if sc.matches(args.filter) and (not args.quick
                                            or sc.tier == "quick"):
                print(f"{sc.tier:5s} {sc.group:20s} {sc.name} "
                      f"[{len(sc.checks)} checks]")
        return 0

    if not any(sc.matches(args.filter) and (not args.quick
                                            or sc.tier == "quick")
               for sc in kernel_scenarios()):
        print("no kernel scenarios match", file=sys.stderr)
        return 1

    def progress(rec):
        print(f"  {rec['status']:5s} {rec['name']} "
              f"({rec['timing']['wall_s']:.2f}s)", flush=True)

    doc = run_kernel_campaign(quick=args.quick, filters=args.filter,
                              seed=args.seed, progress=progress,
                              device=args.device)
    if args.out != "-":
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")
    for line in kernel_summary_lines(doc):
        print(line)
    return 1 if (doc["summary"]["fail"] or doc["summary"]["error"]) else 0


if __name__ == "__main__":
    sys.exit(main())
