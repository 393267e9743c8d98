"""Readings that set a cell's limits: the program's, and the control's.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2 --seconds 20 --out readings.jsonl

Runs the cell as ``run.py`` does, once a seed, in one process (the
kernels built once), and appends one JSON line a seed: the program's
reading of each compared number, and for the control seeds the control's
(the reference computed in float8 e4m3 in the program's place).  The
benchmark's own runs never run the control.
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pb import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    import torch
    from reference import decoder as ref
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        out = harness.run_cell(a.workload, seed, a.seconds, False, t_start=t)
        drv = out.pop("_work")
        line = {"workload": a.workload, "seed": seed,
                "program": out.pop("_readings"),
                "metrics": {k: m["value"] for k, m in out["metrics"].items()},
                "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                "window": out["window"]}
        if seed in ctl:
            sizes = ref.Sizes.from_arch(drv.run.arch)
            with torch.inference_mode():
                line["control"] = drv.control(
                    ref.Decoder(sizes, drv.run.params),
                    ref.Decoder(sizes, drv.run.params, precision="fp8"))
        line["seconds"] = time.perf_counter() - t
        with open(a.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
        del out, drv
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
