"""Campaign CLI: ``python -m repro_torch.bench.campaign``.

Runs the declared scenario matrix (paper reproductions + live smokes +
beyond-paper sweeps) and writes one structured ``BENCH_campaign.json``
artifact.  Exit codes: 0 — every check passed; 1 — at least one scenario
failed a reference check, errored, or regressed against ``--baseline``.

Examples::

    # CI quick tier -> BENCH_campaign.json, non-zero on any failed check
    python -m repro_torch.bench.campaign --quick

    # one group, custom output path
    python -m repro_torch.bench.campaign --filter table1 --out /tmp/t1.json

    # regression-gate against a previous artifact
    python -m repro_torch.bench.campaign --quick --baseline old.json --threshold 0.1
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.bench.beyond import beyond_scenarios
from repro_torch.bench.engine import run_campaign, summary_lines
from repro_torch.bench.paper import paper_scenarios, smoke_scenarios
from repro_torch.bench.scenarios import Scenario

__all__ = ["all_scenarios", "main"]

DEFAULT_OUT = "BENCH_campaign.json"


def all_scenarios() -> list[Scenario]:
    """The full declared matrix, in campaign order."""
    return paper_scenarios() + smoke_scenarios() + beyond_scenarios()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.campaign",
        description="Run the scenario-matrix benchmark campaign and write "
                    "a structured BENCH_campaign.json artifact.")
    ap.add_argument("--quick", action="store_true",
                    help="run only the quick tier (CI: paper table cells, "
                         "headline claims, threads smoke)")
    ap.add_argument("--filter", action="append", default=[],
                    metavar="SUBSTR",
                    help="keep scenarios whose name/group contains SUBSTR "
                         "(repeatable; OR)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"artifact path (default {DEFAULT_OUT}; '-' for "
                         f"stdout only)")
    ap.add_argument("--seed", type=int, default=None,
                    help="override every scenario's organize/fault seed")
    ap.add_argument("--list", action="store_true",
                    help="list matching scenarios and exit")
    ap.add_argument("--baseline", default=None, metavar="JSON",
                    help="previous BENCH_campaign.json to regression-gate "
                         "against")
    ap.add_argument("--kernels", action="store_true",
                    help="also run the kernel-level matrix "
                         "(repro_torch.bench.kernels) and write a second "
                         "artifact next to --out")
    ap.add_argument("--kernels-out", default="BENCH_kernels.json",
                    metavar="JSON",
                    help="artifact path for --kernels "
                         "(default BENCH_kernels.json)")
    ap.add_argument("--storage", action="store_true",
                    help="also run the storage-layer matrix "
                         "(repro_torch.bench.storage: columnar store vs "
                         "CSV-zip) and write a third artifact")
    ap.add_argument("--storage-out", default="BENCH_storage.json",
                    metavar="JSON",
                    help="artifact path for --storage "
                         "(default BENCH_storage.json)")
    ap.add_argument("--scheduling", action="store_true",
                    help="also run the scheduling-policy matrix "
                         "(repro_torch.bench.scheduling: makespan + prefetch "
                         "wait per policy) and write another artifact")
    ap.add_argument("--scheduling-out", default="BENCH_scheduling.json",
                    metavar="JSON",
                    help="artifact path for --scheduling "
                         "(default BENCH_scheduling.json)")
    ap.add_argument("--threshold", type=float, default=0.10,
                    help="max allowed relative job_seconds regression vs "
                         "--baseline (default 0.10)")
    ap.add_argument("--device", default=None,
                    help="where the kernel, storage and encounter cells "
                         "run and the device every artifact records "
                         "(default: the card; 'cpu' runs the plain "
                         "versions)")
    args = ap.parse_args(argv)

    scenarios = [sc for sc in all_scenarios()
                 if (not args.quick or sc.tier == "quick")
                 and sc.matches(args.filter)]
    if args.list:
        for sc in scenarios:
            marks = f" [{len(sc.checks)} checks]" if sc.checks else ""
            print(f"{sc.tier:5s} {sc.group:18s} {sc.name}{marks}")
        print(f"{len(scenarios)} scenarios")
        return 0
    if not scenarios:
        print("no scenarios match", file=sys.stderr)
        return 1

    def progress(rec):
        print(f"  {rec['status']:5s} {rec['name']} "
              f"({rec['timing']['wall_s']:.2f}s)", flush=True)

    doc = run_campaign(scenarios, quick=args.quick, filters=args.filter,
                       seed=args.seed, progress=progress,
                       device=args.device)
    if args.out != "-":
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")
    for line in summary_lines(doc):
        print(line)

    rc = 0
    if doc["summary"]["fail"] or doc["summary"]["error"]:
        rc = 1
    if args.kernels:
        from repro_torch.bench.kernels import (
            kernel_scenarios, kernel_summary_lines, run_kernel_campaign)
        if not any(sc.matches(args.filter)
                   and (not args.quick or sc.tier == "quick")
                   for sc in kernel_scenarios()):
            # campaign-group filters legitimately may not name any
            # kernel cell; skip rather than fail the whole run
            print("no kernel scenarios match --filter; skipping "
                  "--kernels artifact")
        else:
            kdoc = run_kernel_campaign(quick=args.quick,
                                       filters=args.filter,
                                       seed=args.seed, progress=progress,
                                       device=args.device)
            if args.kernels_out != "-":
                with open(args.kernels_out, "w") as f:
                    json.dump(kdoc, f, indent=1, sort_keys=True)
                    f.write("\n")
                print(f"wrote {args.kernels_out}")
            for line in kernel_summary_lines(kdoc):
                print(line)
            if kdoc["summary"]["fail"] or kdoc["summary"]["error"]:
                rc = 1
    if args.storage:
        from repro_torch.bench.storage import (
            run_storage_campaign, storage_scenarios,
            storage_summary_lines)
        if not any(sc.matches(args.filter)
                   and (not args.quick or sc.tier == "quick")
                   for sc in storage_scenarios()):
            print("no storage scenarios match --filter; skipping "
                  "--storage artifact")
        else:
            sdoc = run_storage_campaign(quick=args.quick,
                                        filters=args.filter,
                                        seed=args.seed,
                                        progress=progress,
                                        device=args.device)
            if args.storage_out != "-":
                with open(args.storage_out, "w") as f:
                    json.dump(sdoc, f, indent=1, sort_keys=True)
                    f.write("\n")
                print(f"wrote {args.storage_out}")
            for line in storage_summary_lines(sdoc):
                print(line)
            if sdoc["summary"]["fail"] or sdoc["summary"]["error"]:
                rc = 1
    if args.scheduling:
        from repro_torch.bench.scheduling import (
            run_scheduling_campaign, scheduling_scenarios,
            scheduling_summary_lines)
        if not any(sc.matches(args.filter)
                   and (not args.quick or sc.tier == "quick")
                   for sc in scheduling_scenarios()):
            print("no scheduling scenarios match --filter; skipping "
                  "--scheduling artifact")
        else:
            pdoc = run_scheduling_campaign(quick=args.quick,
                                           filters=args.filter,
                                           seed=args.seed,
                                           progress=progress,
                                           device=args.device)
            if args.scheduling_out != "-":
                with open(args.scheduling_out, "w") as f:
                    json.dump(pdoc, f, indent=1, sort_keys=True)
                    f.write("\n")
                print(f"wrote {args.scheduling_out}")
            for line in scheduling_summary_lines(pdoc):
                print(line)
            if pdoc["summary"]["fail"] or pdoc["summary"]["error"]:
                rc = 1
    if args.baseline:
        from repro_torch.bench.compare import compare_docs, render_rows
        with open(args.baseline) as f:
            old = json.load(f)
        rows, regressions = compare_docs(old, doc,
                                         threshold=args.threshold)
        for line in render_rows(rows):
            print(line)
        if regressions:
            print(f"{len(regressions)} scenario(s) regressed beyond "
                  f"{args.threshold:.0%}: "
                  + ", ".join(r["name"] for r in regressions))
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
