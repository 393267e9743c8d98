"""The port's ``layers.moe`` vs the JAX package's, on the CPU.

Both get the same seeded numpy inputs in f32: outputs agree within rtol
1e-5 / atol 1e-6, and the routing (gate indices and keep masks) is
exact.  The port-side tests mirror tests/test_moe_grouping.py's four
properties: group-size invariance with ample capacity, the dense
per-token reference, deterministic bounded drops, and the sort rank's
cumsum semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L


def _params(rng, E, D, F, gated=True):
    z = 2 if gated else 1
    return {"router": rng.normal(0, 0.1, (D, E)).astype(np.float32),
            "wi": rng.normal(0, 0.05, (E, D, z, F)).astype(np.float32),
            "wo": rng.normal(0, 0.05, (E, F, D)).astype(np.float32)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _ref_route(x, router, top_k, cap):
    """The reference's routing, step for step in JAX (top-k of the f32
    softmax) with the classic cumsum rank as the queue position."""
    G, gs, _ = x.shape
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", jnp.asarray(x),
                                      jnp.asarray(router)), axis=-1)
    vals, idx = jax.lax.top_k(probs, top_k)
    idx = np.asarray(idx)
    pos = np.zeros((G, gs * top_k), np.int64)
    for g in range(G):
        counts = {}
        for i, e in enumerate(idx[g].reshape(-1)):
            pos[g, i] = counts.get(e, 0)
            counts[e] = pos[g, i] + 1
    pos = pos.reshape(G, gs, top_k)
    return np.asarray(probs), idx, pos, pos < cap


def _margin(probs, top_k):
    """Smallest gap between the k-th and (k+1)-th router probability."""
    s = -np.sort(-probs, axis=-1)
    return float((s[..., top_k - 1] - s[..., top_k]).min())


MOE_CASES = [(gated, gs, cf) for gated in (True, False)
             for gs in (8, 16, 64) for cf in ("ample", 0.05)]


@pytest.mark.parametrize("gated,gs,cf", MOE_CASES)
def test_moe_matches_reference(gated, gs, cf):
    rng = np.random.default_rng(gs + 100 * gated)
    B, T, D, F, E, K = 2, 32, 16, 24, 8, 2
    capacity_factor = float(E) if cf == "ample" else cf
    jp, tp = _both(_params(rng, E, D, F, gated))
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    kw = dict(n_experts=E, top_k=K, activation="silu",
              capacity_factor=capacity_factor, group_size=gs)
    want = np.asarray(JL.moe(jnp.asarray(x), jp, **kw))
    got = L.moe(torch.from_numpy(x), tp, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    # The routing itself: gate indices, queue ranks and keep masks exact.
    g = L._largest_divisor_leq(B * T, gs)
    xg = x.reshape(B * T // g, g, D)
    cap = max(int(capacity_factor * K * g / E), 1)
    probs, idx, pos, keep = _ref_route(xg, jp["router"], K, cap)
    vals, gidx, gpos, gkeep = L._route(torch.from_numpy(xg), tp["router"],
                                       K, cap)
    margin = _margin(probs, K)
    assert np.array_equal(gidx.numpy(), idx), \
        f"gate indices differ; smallest top-{K} margin {margin:.3g}"
    np.testing.assert_array_equal(gpos.numpy(), pos)
    np.testing.assert_array_equal(gkeep.numpy(), keep)
    if cf != "ample":
        assert not keep.all()            # the small capacity drops tokens


def test_router_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability:
    jax.lax.top_k then picks experts 0..K-1, and so does the port."""
    rng = np.random.default_rng(7)
    E, K, D = 8, 3, 16
    x = rng.normal(size=(1, 12, D)).astype(np.float32)
    router = np.zeros((D, E), np.float32)
    _, idx, _, _ = _ref_route(x, router, K, cap=12)
    _, gidx, _, _ = L._route(torch.from_numpy(x), torch.from_numpy(router),
                             K, 12)
    assert np.array_equal(gidx.numpy(), idx)
    assert (gidx.numpy() == np.arange(K)).all()


@pytest.mark.parametrize("gated", [True, False])
def test_group_size_invariance_with_ample_capacity(gated):
    rng = np.random.default_rng(0)
    B, T, D, F, E, K = 2, 32, 16, 24, 8, 2
    _, p = _both(_params(rng, E, D, F, gated))
    x = torch.from_numpy(rng.normal(size=(B, T, D)).astype(np.float32))
    outs = [L.moe(x, p, n_experts=E, top_k=K, activation="silu",
                  capacity_factor=float(E), group_size=gs).numpy()
            for gs in (8, 16, 64)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(outs[0], outs[2], rtol=2e-4, atol=2e-5)


def test_moe_matches_dense_reference():
    """Ample-capacity MoE == explicit per-token expert sum (numpy)."""
    rng = np.random.default_rng(2)
    B, T, D, F, E, K = 1, 16, 8, 12, 4, 2
    p = _params(rng, E, D, F)
    _, tp = _both(p)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    got = L.moe(torch.from_numpy(x), tp, n_experts=E, top_k=K,
                activation="silu", capacity_factor=float(E),
                group_size=16).numpy()
    xf = x.reshape(-1, D).astype(np.float64)
    logits = xf @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = np.argsort(-probs, axis=-1, kind="stable")[:, :K]
    ref = np.zeros((T, D))
    for s in range(T):
        for k in range(K):
            e = top[s, k]
            h = np.einsum("d,dzf->zf", xf[s], p["wi"][e])
            act = h[0] / (1.0 + np.exp(-h[0])) * h[1]
            ref[s] += probs[s, e] * (act @ p["wo"][e])
    np.testing.assert_allclose(got[0], ref, rtol=2e-3, atol=2e-4)


def test_capacity_drops_are_deterministic_and_bounded():
    rng = np.random.default_rng(4)
    B, T, D, F, E, K = 2, 64, 8, 12, 4, 2
    _, p = _both(_params(rng, E, D, F))
    x = torch.from_numpy(rng.normal(size=(B, T, D)).astype(np.float32))
    kw = dict(n_experts=E, top_k=K, activation="silu",
              capacity_factor=0.25, group_size=32)
    lo, lo2 = L.moe(x, p, **kw), L.moe(x, p, **kw)
    assert torch.equal(lo, lo2)
    assert bool(torch.isfinite(lo).all())
    hi = L.moe(x, p, **dict(kw, capacity_factor=float(E)))
    assert not torch.allclose(lo, hi)
    # Every expert takes at most cap tokens of each group.
    cap = max(int(0.25 * K * 32 / E), 1)
    xg = x.reshape(B * T // 32, 32, D)
    _, idx, _, keep = L._route(xg, p["router"], K, cap)
    for g in range(idx.shape[0]):
        kept = idx[g][keep[g]]
        assert torch.bincount(kept, minlength=E).max() <= cap


def test_sort_rank_matches_cumsum_semantics():
    rng = np.random.default_rng(0)
    SK, E = 256, 8
    eid = rng.integers(0, E, (3, SK))
    want = np.zeros_like(eid)
    for g in range(3):
        counts = np.zeros(E, np.int64)
        for i, e in enumerate(eid[g]):
            want[g, i] = counts[e]
            counts[e] += 1
    got = L._rank_in_expert(torch.from_numpy(eid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
