"""What a run reads: ``BENCHMARK.json`` and the files it names.

A cell (``workloads`` entry) names a configuration and a traffic mix;
each is a file found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json``, and the cell's own ``cells/<cell>.json``
(its batch, where the mix leaves it open, and the limits its
comparisons are held to).  Per-layer metrics are readers,
``metrics/<metric>.py``.
"""

from __future__ import annotations

import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _load(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return _load(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _load(BENCH_DIR / "traffic" / f"{name}.json")


def cell_file(name: str) -> dict:
    return _load(BENCH_DIR / "cells" / f"{name}.json")


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; choose from "
                   f"{[w['name'] for w in man['workloads']]}")


def metrics_for(man: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` ('end_to_end' or 'per_layer') that
    ``cell`` reports: those with no ``workloads`` key and those that
    list it."""
    return [m for m in man[section]
            if "workloads" not in m or cell in m["workloads"]]
