"""Time the small-K regime of ``csrc/encounter_screen.cu`` against the
large-K one at the K where :func:`encounter_screen.plan` switches
between them (K = 16, 24 and 32 at C = 4 and 64, T = 1024).

Run from the repository root on a machine with a card and ``nvcc``::

    PYTHONPATH=src python -m repro_torch.kernels.screen_ab

This script is the only caller of ``encounter_screen._launch``'s
``split=`` argument, which forces a regime, and the only user of the
small kernel's rows 25 to 32 (``kSmallMaxK``), which ``plan`` never
sends there.  Every result is held bitwise to the plain version before
it is timed with CUDA events.  Prints one JSON line of median ms per
case, after the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess

from repro_torch.kernels import encounter_screen as screen

H_M, V_M = 926.0, 152.4
SHAPES = tuple((C, K, 1024) for K in (16, 24, 32) for C in (4, 64))
RUNS = 10


def _cells(rng, C, K, T):
    """Clustered 1 Hz trails, each row valid over a random span (the
    shapes chip_smoke.py's phase 2 builds)."""
    import numpy as np
    lat = (40.0 + rng.normal(0, 0.005, (C, K, 1))
           + np.cumsum(rng.normal(0, 1e-4, (C, K, T)), axis=2))
    lon = (-100.0 + rng.normal(0, 0.005, (C, K, 1))
           + np.cumsum(rng.normal(0, 1e-4, (C, K, T)), axis=2))
    alt = rng.uniform(400, 900, (C, K, 1)) + rng.normal(0, 5, (C, K, T))
    t = np.arange(T)[None, None, :]
    val = ((t >= rng.integers(0, T // 2, (C, K, 1)))
           & (t < rng.integers(T // 2, T + 1, (C, K, 1))))
    return [x.astype(np.float32) for x in (lat, lon, alt, val)]


def _ms(fn) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(RUNS + 1)]
    ev[0].record()
    for i in range(RUNS):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(RUNS))


def _timed(args, want, split) -> float:
    import torch

    def run():
        return screen._launch(*args, h_m=H_M, v_m=V_M, split=split)

    if not torch.equal(run(), want):
        raise AssertionError(f"not bitwise the plain version: {split}")
    return _ms(run)


def main() -> None:
    import numpy as np
    import torch

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    rows = []
    for C, K, T in SHAPES:
        args = [torch.from_numpy(x).cuda() for x in _cells(rng, C, K, T)]
        want = torch.stack(screen._screen_batch_plain(*args, h_m=H_M,
                                                      v_m=V_M))
        row = {"shape": f"C={C} K={K} T={T}"}
        for name, rule in (("small", screen._plan_small),
                           ("large", screen._plan_large)):
            split = rule(C, K, T, n_sm)
            row[f"{name}_ms"] = statistics.median(
                _timed(args, want, split) for _ in range(2))
            row[f"{name}_strips"] = split.strips
        row["plan"] = screen.plan(C, K, T, n_sm).regime
        rows.append(row)
        print(row, flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    print(json.dumps({"screen_ab": rows}))


if __name__ == "__main__":
    main()
