"""Synthetic aircraft registries + the 4-tier directory hierarchy.

Paper §III.A: national aircraft registries give each aircraft's type,
registration expiration, and ICAO 24-bit address. The hierarchy is::

    <year>/<aircraft type>/<number of seats>/<icao24 bucket>/

with no more than 1000 directories per level (LLSC recommendation), deep
and wide enough for efficient parallel I/O across the whole structure.

The radar dataset (§V) uses year/radar/month-range/unique-id instead; both
layouts share HierarchySpec.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

AIRCRAFT_TYPES = [
    "FixedWingSingleEngine", "FixedWingMultiEngine", "Rotorcraft",
    "Glider", "Balloon", "Unknown",
]
# Seat buckets keep tier 3 under 1000 dirs.
SEAT_BUCKETS = ["1-4", "5-9", "10-19", "20-99", "100+", "NA"]


@dataclasses.dataclass(frozen=True)
class RegistryEntry:
    icao24: str            # 6-hex-digit transponder address
    aircraft_type: str
    seats: int
    expiration_year: int

    @property
    def seat_bucket(self) -> str:
        if self.seats <= 0:
            return "NA"
        if self.seats <= 4:
            return "1-4"
        if self.seats <= 9:
            return "5-9"
        if self.seats <= 19:
            return "10-19"
        if self.seats <= 99:
            return "20-99"
        return "100+"


def synthetic_registry(n: int = 5000, seed: int = 13) -> dict[str, RegistryEntry]:
    """Synthetic union of national registries keyed by icao24."""
    rng = np.random.default_rng(seed)
    out: dict[str, RegistryEntry] = {}
    type_p = [0.45, 0.25, 0.12, 0.08, 0.02, 0.08]
    while len(out) < n:
        icao = f"{rng.integers(0xA00000, 0xAFFFFF):06x}"  # US block
        if icao in out:
            continue
        at = AIRCRAFT_TYPES[int(rng.choice(len(AIRCRAFT_TYPES), p=type_p))]
        seats = {
            "FixedWingSingleEngine": int(rng.integers(1, 7)),
            "FixedWingMultiEngine": int(rng.choice(
                [6, 9, 19, 50, 150, 220], p=[.2, .2, .2, .15, .15, .1])),
            "Rotorcraft": int(rng.integers(1, 15)),
            "Glider": int(rng.integers(1, 3)),
            "Balloon": int(rng.integers(1, 9)),
            "Unknown": 0,
        }[at]
        out[icao] = RegistryEntry(
            icao24=icao, aircraft_type=at, seats=seats,
            expiration_year=int(rng.integers(2019, 2026)))
    return out


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """4-tier hierarchy with <=1000 dirs per level."""
    max_dirs_per_level: int = 1000
    icao_bucket_hex_digits: int = 2   # 256 buckets at the icao24 level

    def leaf_dir(self, year: int, entry: Optional[RegistryEntry],
                 icao24: str) -> str:
        at = entry.aircraft_type if entry else "Unknown"
        sb = entry.seat_bucket if entry else "NA"
        bucket = icao24[: self.icao_bucket_hex_digits]
        return f"{year}/{at}/{sb}/{bucket}"

    def aircraft_dir(self, year: int, entry: Optional[RegistryEntry],
                     icao24: str) -> str:
        return f"{self.leaf_dir(year, entry, icao24)}/{icao24}"

    def radar_dir(self, year: int, radar: str, month_range: str,
                  unique_id: str) -> str:
        """§V layout: year/radar/month-range/unique-id."""
        return f"{year}/{radar}/{month_range}/{unique_id}"

    def validate_fanout(self, paths: list[str]) -> bool:
        """No level exceeds max_dirs_per_level children."""
        children: dict[str, set[str]] = {}
        for p in paths:
            parts = p.split("/")
            for i in range(len(parts)):
                parent = "/".join(parts[:i])
                children.setdefault(parent, set()).add(parts[i])
        return all(len(v) <= self.max_dirs_per_level
                   for v in children.values())
