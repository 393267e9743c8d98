"""Beyond-paper scenarios — the paper's own declared future work.

§VI: "Additional benchmarking is possible future work, as we did not vary
the number of threads" — plus the knobs the paper fixed on LLSC advice
(0.3 s poll) or abandoned after one data point (tasks/message), and the
failure/heterogeneity story the paper doesn't have at all.  A copy of
the JAX reference package's ``repro.bench.beyond``: plain matrix
declarations over the campaign engine.
"""

from __future__ import annotations

import dataclasses

from repro_torch.bench.scenarios import Check, RunSpec, Scenario, expand

__all__ = ["beyond_scenarios"]


def beyond_scenarios() -> list[Scenario]:
    scens: list[Scenario] = []

    # Threads-per-process: more threads at fixed total cores means fewer
    # processes sharing the node's I/O path (lower effective NPPN) but
    # fewer concurrent workers; per-task CPU scales as threads**0.7
    # (imperfect intra-task scaling).
    for threads in (1, 2, 4):
        scens.append(Scenario(
            name=f"beyond_threads_{threads}", group="beyond_threads",
            run=RunSpec(dataset="monday", phase="organize",
                        n_workers=1024 // threads - 1, nodes=64,
                        nppn=max(16 // threads, 1),
                        organization="largest_first",
                        cpu_rate_scale=threads ** 0.7),
            notes=f"{threads} threads/process at 1024 fixed cores"))

    # The 0.3 s poll was an LLSC recommendation, never benchmarked.
    scens.extend(expand(
        "beyond_poll", dataset="monday", phase="organize",
        n_workers=511, nodes=64, nppn=8, organization="largest_first",
        poll_interval=[0.05, 0.3, 2.0, 10.0]))

    # tasks/message x task-size regime: a load-balancing tax on big-task
    # jobs, a manager-serialization rescue on tiny-task jobs (why §V
    # needed 300 tasks/message).
    scens.extend(expand(
        "beyond_batch_bigtasks", dataset="monday", phase="organize",
        n_workers=511, nodes=64, nppn=8, organization="largest_first",
        tasks_per_message=[1, 8]))
    scens.extend(expand(
        "beyond_batch_tinytasks", dataset="tiny", phase="radar",
        n_workers=1023, nodes=128, nppn=8, organization="random",
        tasks_per_message=[1, 30, 300]))

    # Worker deaths at increasing rates: self-scheduling re-queues the
    # lost work; makespan grows ~linearly with lost capacity, no cliff.
    scens.extend(expand(
        "beyond_failures", dataset="monday", phase="organize",
        n_workers=511, nodes=64, nppn=8, organization="largest_first",
        failure_timeout=30.0,
        fault_profile=["none", "deaths_5pct", "deaths_20pct"]))

    # Persistent 4x-slow stragglers: the quantitative version of the
    # paper's central qualitative claim — static distribution is hostage
    # to its slowest assignee, self-scheduling routes around it.
    straggler = RunSpec(dataset="monday", phase="organize",
                        n_workers=511, nodes=64, nppn=8,
                        organization="largest_first",
                        fault_profile="stragglers_10pct")
    scens.append(Scenario(
        name="beyond_stragglers10_selfsched_vs_static",
        group="beyond_stragglers",
        run=straggler,
        baseline=dataclasses.replace(
            straggler, mode="static", policy="cyclic",
            organization="chronological"),
        checks=(Check("job_seconds_reduction_pct", "min", 0.0,
                      source="self-scheduling routes around stragglers"),)))
    scens.append(Scenario(
        name="beyond_stragglers10_speculative",
        group="beyond_stragglers",
        run=dataclasses.replace(straggler, speculative=True),
        baseline=straggler,
        notes="MapReduce-style backup tasks on top of self-scheduling"))
    return scens
