"""Training steps of the LM's arms, the port against the JAX package, on
the CPU: ``launch.steps.make_train_step`` against the reference's for
the f32 variants of reduced qwen3-moe (MoE routing with drops), jamba
(Mamba's scan, attention and MoE), rwkv6 and musicgen (``embeds``),
three AdamW steps at T = 64 (two of RWKV-6's 32-token chunks), held as
tests/test_torch_train.py holds minicpm-2b: the loss within 1e-6
relative, the grad norm within 1e-5, ||Δparams|| / ||params|| within
1e-5, or within a pinned limit (jamba's loss, RWKV-6's three) that stays
under the distance the reference's own steps move under half an ulp of
rounding.  The arms' gradients across carried state and
chip_smoke.py's phase 10b on the CPU are in tests/test_torch_train_arms.py
(apart, so that each file stays near a minute).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch import steps as JST
from repro.train import optimizer as JO
from repro_torch.launch import steps as ST
from repro_torch.train import optimizer as O

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_train import (_batch, _configs, _jb, _params,  # noqa: E402
                              _rel_param_diff, _tb)

ARMS = ["qwen3-moe-30b-a3b", "jamba-v0.1-52b", "rwkv6-3b", "musicgen-medium"]
STEP_T = 64
STEP_TOL = dict(loss=1e-6, grad_norm=1e-5, params=1e-5)
# Where an arm's port misses STEP_TOL, its own limit, pinned: the port's
# reading against the reference's (the largest over the three steps)
# and the reference's own half-ulp spread (``_half_ulp``; the largest
# over SPREAD_SEEDS) are beside it.  Each limit sits below that spread:
# the reference moves further under half an ulp of its weights than the
# port sits from it.  jamba's loss: read 1.20e-6, spread 1.88e-6.
# rwkv6's loss: read 1.75e-6, spread 5.47e-5; grad norm: read 1.36e-4,
# spread 5.29e-4; params: read 1.97e-5, spread 8.66e-5.  (qwen3-moe read
# 9.2e-7, 5.9e-6, 7.8e-6 and musicgen 1.6e-7, 4.5e-7, 1.0e-6, within
# STEP_TOL.)
STEP_LIMITS = {
    "jamba-v0.1-52b": dict(STEP_TOL, loss=1.8e-6),
    "rwkv6-3b": dict(loss=4e-6, grad_norm=3e-4, params=4e-5),
}
SPREAD_SEEDS = (5, 6)


def _reference_steps(jstep, jcfg, jp, jopt, n: int = 3) -> tuple:
    """The reference's ``n`` steps from ``jp``: (params, [(loss, grad
    norm)])."""
    js = JO.init_opt_state(jp, jopt)
    out = []
    for i in range(n):
        jp, js, jm = jstep(jp, js, _jb(_batch(jcfg, T=STEP_T, seed=10 + i)))
        out.append((float(jm["loss"]), float(jm["grad_norm"])))
    return jp, out


def _half_ulp(jp, seed: int):
    """``jp`` with every element times 1 +- 2^-24 (seeded signs)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a * (1 + jnp.asarray(
        rng.choice([-1.0, 1.0], size=a.shape) * 2.0 ** -24, a.dtype)), jp)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("name", ARMS)
def test_make_train_step_matches_reference(name):
    """Three steps from the same weights: the loss, the grad norm and
    ||Δparams|| / ||params|| within STEP_TOL of the reference's, or
    within the arm's pinned STEP_LIMITS.  Each pinned limit must stay
    under the distance that the reference's own steps move when its
    weights move by half an ulp, measured here: RWKV-6's chunked
    recurrence divides by decays of up to e^87 and multiplies them
    back, and jamba's MoE routing turns a rounding into another expert
    choice or drop, in the reference as in the port."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg, cfg, seed=1)
    jopt, opt = JO.OptimizerConfig(lr=1e-3), O.OptimizerConfig(lr=1e-3)
    jstep = jax.jit(JST.make_train_step(jcfg, jopt, remat=False))
    want_p, want = _reference_steps(jstep, jcfg, jp, jopt)
    tol = STEP_LIMITS.get(name, STEP_TOL)
    if tol is not STEP_TOL:
        spread = dict.fromkeys(STEP_TOL, 0.0)
        for seed in SPREAD_SEEDS:
            p, got = _reference_steps(jstep, jcfg, _half_ulp(jp, seed), jopt)
            spread["loss"] = max(spread["loss"], *(
                _rel(a[0], b[0]) for a, b in zip(got, want)))
            spread["grad_norm"] = max(spread["grad_norm"], *(
                _rel(a[1], b[1]) for a, b in zip(got, want)))
            spread["params"] = max(spread["params"], _rel_tree(p, want_p))
        for k in STEP_TOL:
            assert tol[k] <= max(STEP_TOL[k], spread[k]), (k, spread)
    step = ST.make_train_step(cfg, opt, remat=True)
    ts = O.init_opt_state(tp, opt)
    for i, (loss, gnorm) in enumerate(want):
        tp2, ts2, m = step(tp, ts, _tb(_batch(cfg, T=STEP_T, seed=10 + i)))
        assert tp2 is tp and ts2 is ts
        assert _rel(m["loss"].item(), loss) <= tol["loss"], i
        assert _rel(m["grad_norm"].item(), gnorm) <= tol["grad_norm"], i
    assert _rel_param_diff(tp, want_p) <= tol["params"]
    assert int(ts["count"]) == 3


def _rel_tree(got, want) -> float:
    """||got - want|| / ||want|| over two reference trees."""
    num = sum(float(np.sum((np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)) ** 2))
              for a, b in zip(jax.tree_util.tree_leaves(got),
                              jax.tree_util.tree_leaves(want)))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2))
              for b in jax.tree_util.tree_leaves(want))
    return (num / den) ** 0.5
