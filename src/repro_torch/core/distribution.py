"""Static distribution rules: block and cyclic (LLMapReduce-style).

§II.D of the paper:

  * Block distribution hands each process an equal-sized block of
    *consecutive* tasks (LLSC default; used by the prior work [3]).
  * Cyclic distribution deals tasks round-robin.

§IV.B: because LLMapReduce sorts tasks by filename and the hierarchy
clusters a well-observed aircraft's files consecutively, block distribution
gave one worker many huge tasks (2 % of processes accounted for >95 % of
job time); switching to cyclic cut the archive job time by >90 %.

These are *static* policies — the full assignment is computed up front.
Self-scheduling (selfsched.py / simulator.py) is the dynamic alternative.
"""

from __future__ import annotations

import enum
from typing import Sequence, TypeVar

T = TypeVar("T")


class DistributionPolicy(enum.Enum):
    BLOCK = "block"
    CYCLIC = "cyclic"
    SELF_SCHEDULING = "self_scheduling"


def block_distribution(tasks: Sequence[T], n_workers: int) -> list[list[T]]:
    """Equal-sized blocks of consecutive tasks.

    With 4 tasks and 2 workers: worker 0 gets tasks [0,1], worker 1 gets
    [2,3] (the paper's example). When len(tasks) does not divide evenly the
    first ``len(tasks) % n_workers`` workers get one extra task, keeping
    blocks consecutive.
    """
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    n = len(tasks)
    base, extra = divmod(n, n_workers)
    out: list[list[T]] = []
    start = 0
    for w in range(n_workers):
        count = base + (1 if w < extra else 0)
        out.append(list(tasks[start:start + count]))
        start += count
    return out


def cyclic_distribution(tasks: Sequence[T], n_workers: int) -> list[list[T]]:
    """Round-robin deal: worker w gets tasks w, w+n_workers, w+2n, ...

    With 4 tasks and 2 workers: worker 0 gets [0,2], worker 1 gets [1,3]
    (the paper's example).
    """
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    out: list[list[T]] = [[] for _ in range(n_workers)]
    for i, t in enumerate(tasks):
        out[i % n_workers].append(t)
    return out


def distribute(tasks: Sequence[T], n_workers: int,
               policy: DistributionPolicy | str) -> list[list[T]]:
    """Dispatch to a static policy. SELF_SCHEDULING has no static split."""
    if isinstance(policy, str):
        policy = DistributionPolicy(policy)
    if policy is DistributionPolicy.BLOCK:
        return block_distribution(tasks, n_workers)
    if policy is DistributionPolicy.CYCLIC:
        return cyclic_distribution(tasks, n_workers)
    raise ValueError(
        f"{policy} is dynamic; use selfsched.Manager or simulator.simulate")


def assignment_imbalance(assignment: Sequence[Sequence["object"]],
                         size_of=lambda t: getattr(t, "size_bytes", 1)) -> float:
    """max-worker-load / mean-worker-load — 1.0 is perfectly balanced.

    This is the metric behind the paper's '2 % of processes account for
    >95 % of job time' observation for block distribution.
    """
    loads = [sum(size_of(t) for t in w) for w in assignment]
    total = sum(loads)
    if total == 0:
        return 1.0
    mean = total / len(loads)
    return max(loads) / mean
