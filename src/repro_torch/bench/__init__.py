"""Benchmark scenarios, artifact schema and the observability bench.

The port's copy of the reference's ``repro.bench`` holds, so far:

  * :mod:`repro_torch.bench.scenarios` — the input language:
    RunSpec/Scenario/Check/FaultProfile plus the :func:`expand` matrix
    helper;
  * :mod:`repro_torch.bench.schema` — artifact validation + deterministic
    canonical serialization;
  * :mod:`repro_torch.bench.obs` — the observability layer's own gates
    (tracing overhead, summary determinism, straggler attribution;
    ``python -m repro_torch.bench.obs``).  As in the reference, it is
    imported by its own name: it imports :mod:`repro_torch.obs`, which
    imports this package's schema.

The reference's campaign engine, paper and beyond-paper matrices,
kernel and storage benches, CLI and compare tool (``engine``, ``paper``,
``beyond``, ``kernels``, ``storage``, ``campaign``, ``compare``) are not
ported yet; this package exports nothing of them.
"""

from repro_torch.bench.scenarios import (
    Check, FAULT_PROFILES, FaultProfile, RunSpec, Scenario, expand)
from repro_torch.bench.schema import (
    CAMPAIGN_SCHEMA, KERNELS_SCHEMA, SMOKE_SCHEMA, STORAGE_SCHEMA,
    canonical_bytes, validate_campaign, validate_kernels,
    validate_record, validate_storage)

__all__ = [
    "Check", "FAULT_PROFILES", "FaultProfile", "RunSpec", "Scenario",
    "expand",
    "CAMPAIGN_SCHEMA", "KERNELS_SCHEMA", "SMOKE_SCHEMA",
    "STORAGE_SCHEMA",
    "canonical_bytes", "validate_campaign", "validate_kernels",
    "validate_record", "validate_storage",
]
