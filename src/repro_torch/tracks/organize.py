"""Workflow step 1: parse + organize raw observation files (paper §III.A).

Each task parses one raw hourly/query CSV, groups rows by ICAO 24-bit
address, and appends them to per-aircraft CSVs inside the 4-tier
hierarchy. This creates many small files — which is why step 2 (archive)
exists.

Designed to run as the ``fn`` of a self-scheduled Manager: one Task per
raw file, task.payload = the file path.
"""

from __future__ import annotations

import dataclasses
import os
from collections import defaultdict
from typing import Optional

from repro_torch.core.messages import Task
from repro_torch.tracks.registry import HierarchySpec, RegistryEntry


@dataclasses.dataclass
class OrganizeResult:
    raw_file: str
    rows: int
    aircraft: int
    files_written: int
    bytes_written: int


class Organizer:
    """Parses raw state CSVs into the per-aircraft hierarchy."""

    def __init__(self, out_root: str,
                 registry: dict[str, RegistryEntry],
                 hierarchy: Optional[HierarchySpec] = None,
                 year: int = 2019):
        self.out_root = out_root
        self.registry = registry
        self.hierarchy = hierarchy or HierarchySpec()
        self.year = year

    def __call__(self, task: Task) -> OrganizeResult:
        return self.organize_file(task.payload or task.task_id)

    def organize_file(self, raw_path: str) -> OrganizeResult:
        by_aircraft: dict[str, list[str]] = defaultdict(list)
        rows = 0
        with open(raw_path) as f:
            header = f.readline().rstrip("\n")
            icao_col = header.split(",").index("icao24")
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                icao = line.split(",", icao_col + 2)[icao_col]
                by_aircraft[icao].append(line)
                rows += 1
        files = 0
        nbytes = 0
        for icao, lines in by_aircraft.items():
            entry = self.registry.get(icao)
            d = os.path.join(
                self.out_root,
                self.hierarchy.aircraft_dir(self.year, entry, icao))
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{icao}.csv")
            is_new = not os.path.exists(path)
            with open(path, "a") as f:
                if is_new:
                    f.write(header + "\n")
                    nbytes += len(header) + 1
                payload = "\n".join(lines) + "\n"
                f.write(payload)
                nbytes += len(payload)
            files += 1
        return OrganizeResult(
            raw_file=raw_path, rows=rows, aircraft=len(by_aircraft),
            files_written=files, bytes_written=nbytes)


def organize_tasks_from_dir(raw_dir: str) -> list[Task]:
    """One Task per raw file; size = file size, timestamp = mtime order."""
    tasks = []
    for name in sorted(os.listdir(raw_dir)):
        if not name.endswith(".csv"):
            continue
        p = os.path.join(raw_dir, name)
        st = os.stat(p)
        tasks.append(Task(task_id=name, size_bytes=st.st_size,
                          timestamp=st.st_mtime, payload=p))
    return tasks
