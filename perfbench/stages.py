"""Where a cell's traced forward spends the card's time, by the
program's own stages, and what its ranges and counters cost.

    python3 perfbench/stages.py --workload <cell> --seed <n> --pairs 3

Runs the cell as ``run.py --trace 1`` does (``harness.run_cell``), with
a window of ``--seconds``, but its traced stretch profiles ``--pairs``
pairs of calls: the first of a pair with the program's ranges and
counters silenced (the profiler alone), the second with them recording.
The last recorded call is the one the harness reduces and the readers
read.  Prints one JSON line: each call's host seconds to enqueue it and
its wall seconds; of the last recorded call the result's metrics,
``trace.reduce``'s kernel kinds, the device seconds under each stage's
range (``stage_s``, taken as ``reduce`` takes ``moe_s``: the kernels of
the aten operations inside the range, so not flash's, which no aten
operation launches) and their share of busy time (``covered``), the
idle gaps named by the innermost range open when each began, and the
program's counters.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pb import harness, lm, trace  # noqa: E402


def traced_call(fn, record: bool):
    """(profiler, enqueue seconds, wall seconds) of ``fn()`` under the
    profiler, the program's ranges and counters recording or silenced."""
    import torch
    prog = lm.program()
    cuda = torch.cuda.is_initialized()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    prog.reset()
    on = prog.on
    if not record:
        prog.on = lambda: False
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            enqueue = time.perf_counter() - t0
            sync()
            wall = time.perf_counter() - t0
    finally:
        prog.on = on
    return prof, enqueue, wall


def stage_seconds(prof) -> dict:
    """Device seconds under each stage's range in a profile."""
    import torch
    out = dict.fromkeys(lm.STAGES, 0.0)
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.key_averages():
        if e.key in out and e.device_type == cpu:
            out[e.key] += getattr(e, "device_time_total", 0.0) / 1e6
    return out


def attribute(fn, pairs: int) -> tuple:
    """(profiler, wall seconds, what it read) of the last recorded of
    ``pairs`` pairs of calls of ``fn``."""
    calls = []
    for _ in range(pairs):
        for record in (False, True):
            prof, enqueue, wall = traced_call(fn, record)
            calls.append({"recording": record, "enqueue_s": enqueue,
                          "wall_s": wall})
    red = trace.reduce(prof, wall)
    stage_s = stage_seconds(prof)
    busy = red["busy_s"]
    return prof, wall, {
        "calls": calls, "busy_s": busy, "by_kind": red["by_kind"],
        "stage_s": stage_s,
        "covered": sum(stage_s.values()) / busy if busy else None,
        "idle_gaps": lm.gaps_by_stage(prof, top=20),
        "counters": lm.snapshot()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    a = ap.parse_args()
    found = {}

    def profile(fn):
        prof, wall, found_ = attribute(fn, a.pairs)
        found.update(found_)
        return prof, wall

    trace.profile = profile          # the harness's traced stretch
    out = harness.run_cell(a.workload, a.seed, a.seconds, True)
    print(json.dumps({"workload": a.workload, "seed": a.seed,
                      "correct": out["correct"], "device": out["device"],
                      "metrics": out["metrics"], **found}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
