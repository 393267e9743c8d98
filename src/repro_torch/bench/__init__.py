"""Scenario-matrix benchmark campaigns with structured BENCH artifacts.

The port's copy of the JAX reference package's ``repro.bench``; the
paper *is* a benchmark, and this package makes its reproduction — and
every beyond-paper claim — declarative, diffable and regression-gated:

  * :mod:`repro_torch.bench.scenarios` — the input language: RunSpec/
    Scenario/Check/FaultProfile plus the :func:`expand` matrix helper;
  * :mod:`repro_torch.bench.paper` / :mod:`repro_torch.bench.beyond` —
    the declared matrix (Tables I/II cells, §IV/§V claims, live smokes,
    future-work sweeps);
  * :mod:`repro_torch.bench.engine` — expands scenarios into
    :func:`repro_torch.runtime.run_job` invocations and emits BENCH
    records;
  * :mod:`repro_torch.bench.schema` — artifact validation + deterministic
    canonical serialization;
  * :mod:`repro_torch.bench.campaign` — the ``python -m
    repro_torch.bench.campaign`` CLI (``--quick`` is the CI tier);
  * :mod:`repro_torch.bench.kernels` — kernel-level matrix: the fused
    segment pipeline vs its unfused baseline (``BENCH_kernels.json``;
    on the card it launches track_interp, agl_lookup and dynamic_rates);
  * :mod:`repro_torch.bench.storage` — storage-layer matrix: the
    columnar track store vs the CSV-zip path (``BENCH_storage.json``);
  * :mod:`repro_torch.bench.encounters` — encounter-screening matrix
    (``BENCH_encounters.json``; on the card its screen cells launch the
    encounter_screen kernel);
  * :mod:`repro_torch.bench.scheduling` — scheduling-policy matrix
    (``BENCH_scheduling.json``; host work);
  * :mod:`repro_torch.bench.serving` — continuous-ingest serving matrix
    (``BENCH_serving.json``, ``python -m repro_torch.bench.serving``;
    host work: the live store and its query front end);
  * :mod:`repro_torch.bench.compare` — regression-diff two artifacts
    (dispatches on the ``schema`` field; a reference artifact and a port
    artifact of one kind diff against each other);
  * :mod:`repro_torch.bench.obs` — the observability layer's own gates
    (``python -m repro_torch.bench.obs``).  As in the reference, it is
    imported by its own name: it imports :mod:`repro_torch.obs`, which
    imports this package's schema.

Every runner that reaches a kernel takes a campaign-level ``device``
(``None`` is the card and raises without one; ``'cpu'`` runs the
kernels' plain versions) and records it in the artifact's
``environment``.  The serving bench does no tensor work: it takes no
``device`` and records the host (python, platform) as the reference
does.
"""

from repro_torch.bench.beyond import beyond_scenarios
from repro_torch.bench.engine import (
    csv_rows, execute_spec, run_campaign, run_scenario, summary_lines)
from repro_torch.bench.paper import (
    PAPER_TABLE1, PAPER_TABLE2, TABLE_TOLERANCE, paper_scenarios,
    smoke_scenarios)
from repro_torch.bench.kernels import (
    KernelScenario, KernelSpec, kernel_scenarios, run_kernel_campaign,
    run_kernel_scenario)
from repro_torch.bench.scenarios import (
    Check, FAULT_PROFILES, FaultProfile, RunSpec, Scenario, expand)
from repro_torch.bench.schema import (
    CAMPAIGN_SCHEMA, KERNELS_SCHEMA, SMOKE_SCHEMA, STORAGE_SCHEMA,
    canonical_bytes, validate_campaign, validate_kernels,
    validate_record, validate_storage)
from repro_torch.bench.serving import (
    ServingScenario, ServingSpec, run_serving_campaign,
    run_serving_scenario, serving_scenarios)
from repro_torch.bench.storage import (
    StorageScenario, StorageSpec, run_storage_campaign,
    run_storage_scenario, storage_scenarios)

__all__ = [
    "Check", "FAULT_PROFILES", "FaultProfile", "RunSpec", "Scenario",
    "expand",
    "PAPER_TABLE1", "PAPER_TABLE2", "TABLE_TOLERANCE",
    "paper_scenarios", "smoke_scenarios", "beyond_scenarios",
    "csv_rows", "execute_spec", "run_campaign", "run_scenario",
    "summary_lines",
    "KernelScenario", "KernelSpec", "kernel_scenarios",
    "run_kernel_campaign", "run_kernel_scenario",
    "StorageScenario", "StorageSpec", "storage_scenarios",
    "run_storage_campaign", "run_storage_scenario",
    "ServingScenario", "ServingSpec", "serving_scenarios",
    "run_serving_campaign", "run_serving_scenario",
    "CAMPAIGN_SCHEMA", "KERNELS_SCHEMA", "SMOKE_SCHEMA",
    "STORAGE_SCHEMA",
    "canonical_bytes", "validate_campaign", "validate_kernels",
    "validate_record", "validate_storage",
]


def all_scenarios():
    """The full declared matrix (paper + smokes + beyond), campaign order."""
    from repro_torch.bench.campaign import all_scenarios as _all
    return _all()
