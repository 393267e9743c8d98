"""One run of one cell: set-up, the measured window, the optional traced
stretch, the comparison with the reference, and the result line.

The order is fixed: set-up (weights drawn on the device from the seed,
the program built, the cell's own shapes warmed up) ends where the
window starts; ``memory_peak_bytes`` is read when the window (and the
traced stretch) has closed; then the program's state is freed and the
reference recomputes a sample of what the window produced.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time

from pb import manifest as mf

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SRC = mf.ROOT / "src"
BUILD = mf.ROOT / "build"


def set_environment() -> None:
    """Caches inside the checkout at fixed paths, and no JAX pulled in by
    a library the program uses."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(BUILD / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_reader(name: str):
    path = mf.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pb_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What the generator of a traffic kind is handed."""
    cell_name: str
    seed: int
    device: object
    arch: dict                 # the configuration's ``arch`` table
    arch_cfg: object           # the program's ArchConfig of it
    traffic: dict
    cell: dict
    params: dict
    M: object                  # repro_torch.models.model

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Context:
    """What a per-layer reader is handed."""

    def __init__(self, kind, arch, work, trace, window_s):
        self.kind, self.arch, self.work = kind, arch, work
        self.trace, self.window_s = trace, window_s


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None, hooks=None) -> dict:
    """The result of one run (the dict printed as the last line), with
    ``_compared`` (name -> (reading, limit)) beside it.

    ``overrides`` replaces the configuration's ``arch``, the traffic
    mix's or the cell's entries (``{"arch": {...}, "traffic": {...},
    "cell": {...}}``): the CPU tests run a cell at a small size with it.
    ``hooks(run)``, where given, is called once the program is loaded and
    before set-up (the tests break the program with it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    set_environment()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import model as M
    from pb import weights
    from reference import decoder as ref

    man = mf.manifest()
    overrides = overrides or {}
    wl = mf.workload(man, cell_name)
    conf = mf.config(wl["config"])
    traffic = mf.traffic(wl["traffic"])
    cell = mf.cell_file(cell_name)
    arch = {**conf["arch"], **overrides.get("arch", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    cell = {**cell, **overrides.get("cell", {})}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = weights.draw(arch, seed, dev)
    run = Run(cell_name, seed, dev, arch, ArchConfig(**arch), traffic, cell,
              params, M)
    if hooks is not None:
        hooks(run)
    gen = importlib.import_module(f"pb.{traffic['kind']}")
    drv = getattr(gen, traffic["kind"].capitalize())(run)
    drv.warm_up()
    run.sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    drv.window(seconds)
    red = None
    if trace:
        from pb import trace as tr
        prof, wall = tr.profile(drv.traced) if dev.type == "cuda" else (
            None, 0.0)
        if prof is not None:
            red = tr.reduce(prof, wall)
            del prof
    run.sync()
    # the program's peak: the rows the harness keeps for its comparison
    # were allocated before the warm-up and held through every call
    peak = (torch.cuda.max_memory_allocated(dev) - drv.held_bytes
            if dev.type == "cuda" else 0)
    kind_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu")

    # -- metrics from the window -------------------------------------------
    e2e = drv.end_to_end()
    if trace:
        ctx = Context(traffic["kind"], arch, drv, red, drv.window_s)
        metrics = {}
        for m in mf.metrics_for(man, cell_name, "per_layer"):
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {}
        for m in mf.metrics_for(man, cell_name, "end_to_end"):
            v = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # -- correctness, once the program's state is freed ----------------------
    drv.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with torch.inference_mode():
        readings = drv.compare(ref.Decoder(ref.Sizes.from_arch(arch), params))
    limits = cell.get("limits", {})
    compared = {k: (readings[k], lim) for k, lim in limits.items()}
    correct = bool(compared) and all(v <= lim for v, lim in compared.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind_name, "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": drv.attempted(), "failed": 0,
           "metrics": metrics, "device": device_info}
    if red is not None:
        device_info["busy_s"] = red["busy_s"]
        device_info["window_s"] = red["window_s"]
        out["breakdown"] = {"device_ops": red["device_ops"],
                            "idle_gaps": red["idle_gaps"]}
    out["window"] = {"seconds": drv.window_s,
                     **{k: v for k, v in e2e.items() if k.startswith("_")}}
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in compared.items()}
    out["_compared"] = compared
    out["_readings"] = readings
    out["_work"] = drv
    return out


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    import torch
    man = mf.manifest()
    chips = mf.workload(man, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    compared = out.pop("_compared")
    for k, v in out["_readings"].items():
        if k not in compared:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, (v, lim) in compared.items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    out.pop("_work")
    out.pop("_readings")
    print(json.dumps(out))
    return 0
