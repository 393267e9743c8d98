"""Online per-worker speed estimation feeding chunk sizing.

The paper's §V tail is dominated by heterogeneity: a 0.25x-speed worker
holding an equal share of the queue stretches the makespan 4x past the
fleet median.  PR 9's observability layer *measures* per-worker speed
(the JAX package's obs summary derives ``speed_est = est_s / busy_s`` from exec
spans on every backend) but nothing consumed it.  This module closes the
loop: a :class:`WorkerSpeedModel` is fed the same signal online — the
policy's own cost estimate for a finished batch over the seconds the
worker actually spent — and the cost-aware policies consult
:meth:`relative_speed` so a slow worker receives proportionally smaller
chunks (``sized_lpt`` shrinks its batch count, ``adaptive_chunk``
shrinks its per-ASSIGN cost budget).

Units cancel by construction: a worker's raw rate is *estimated cost
units per actual second*, and :meth:`relative_speed` normalizes by the
fleet median rate — so whether the cost estimate is bytes, hinted CPU
units, or modeled seconds, a worker running 4x slow converges to a
relative speed near 0.25.

Feeding the model makes batch sizes depend on measured timing, so it is
opt-in (``run_job(..., speed_feedback=True)``): the cross-backend
bit-identical dispatch contract holds for every run that does not enable
it, and sim-backend runs that do stay per-seed deterministic (the sim
observes virtual time).  The model's state serializes into
:class:`~repro_torch.runtime.protocol.ManagerCheckpoint`, so a kill/resume
keeps the learned fleet profile instead of re-learning it from scratch.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

__all__ = ["WorkerSpeedModel"]


class WorkerSpeedModel:
    """EWMA estimate of each worker's work rate (cost units / second).

    ``ewma_alpha`` weights the newest observation (1.0 = last batch
    only); ``floor``/``ceil`` clamp :meth:`relative_speed` so one noisy
    batch can never starve a worker or hand it the whole queue.
    """

    def __init__(self, *, ewma_alpha: float = 0.5,
                 floor: float = 0.05, ceil: float = 8.0):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if floor <= 0 or ceil < floor:
            raise ValueError("need 0 < floor <= ceil")
        self.ewma_alpha = ewma_alpha
        self.floor = floor
        self.ceil = ceil
        self._rate: dict[str, float] = {}
        self._count: dict[str, int] = {}

    @staticmethod
    def _key(worker: Any) -> str:
        return str(worker)

    # -- feeding -----------------------------------------------------------

    def observe(self, worker: Any, est_cost: float, actual_s: float) -> None:
        """One finished batch: the policy's summed cost estimate for its
        tasks and the seconds the worker reported busy on them."""
        if est_cost <= 0.0 or actual_s <= 0.0:
            return
        rate = float(est_cost) / float(actual_s)
        key = self._key(worker)
        prev = self._rate.get(key)
        if prev is None:
            self._rate[key] = rate
        else:
            a = self.ewma_alpha
            self._rate[key] = (1.0 - a) * prev + a * rate
        self._count[key] = self._count.get(key, 0) + 1

    # -- queries -----------------------------------------------------------

    def rate(self, worker: Any) -> Optional[float]:
        """Raw smoothed rate (cost units / s); None until observed."""
        return self._rate.get(self._key(worker))

    def observations(self, worker: Any) -> int:
        return self._count.get(self._key(worker), 0)

    def _median_rate(self) -> float:
        xs = sorted(self._rate.values())
        if not xs:
            return 0.0
        n = len(xs)
        return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])

    def relative_speed(self, worker: Any) -> float:
        """Worker rate / fleet median rate, clamped to [floor, ceil].

        1.0 for an unobserved worker (a fresh elastic spawn receives a
        median-sized chunk until it reports), and 1.0 while fewer than
        two workers have reported (no median to normalize against).
        """
        rate = self._rate.get(self._key(worker))
        if rate is None or len(self._rate) < 2:
            return 1.0
        med = self._median_rate()
        if med <= 0.0:
            return 1.0
        return min(max(rate / med, self.floor), self.ceil)

    def snapshot(self) -> dict[str, float]:
        """worker -> relative speed for every observed worker."""
        return {k: self.relative_speed(k) for k in sorted(self._rate)}

    # -- checkpoint --------------------------------------------------------

    def state(self) -> Optional[dict]:
        """JSON-able model state (None while nothing was observed)."""
        if not self._rate:
            return None
        return {"rate": dict(self._rate), "count": dict(self._count)}

    def restore(self, state: dict) -> None:
        self._rate = {str(k): float(v)
                      for k, v in state.get("rate", {}).items()}
        self._count = {str(k): int(v)
                       for k, v in state.get("count", {}).items()}

    # -- seeding -----------------------------------------------------------

    @classmethod
    def from_summary(cls, doc: dict, **kw) -> "WorkerSpeedModel":
        """Seed a model from a ``TRACE_summary.json`` document
        (the JAX package's ``build_summary``): each worker's
        ``speed_est`` there is already est-seconds per busy-second —
        exactly this model's rate unit with the cost function fixed to
        the summary's fitted per-phase estimate."""
        model = cls(**kw)
        for wid, rec in (doc.get("workers") or {}).items():
            est = rec.get("speed_est") if isinstance(rec, dict) else None
            if isinstance(est, (int, float)) and est > 0:
                model._rate[str(wid)] = float(est)
                model._count[str(wid)] = 1
        return model
