"""The port's optimizer, schedules and gradient compression vs the JAX
package's, on the CPU, from numpy-seeded inputs.

Tolerances:
- int8 quantizers (blockwise and row-wise): ``q`` and ``scale`` bitwise
  (both round half to even), their dequantized values bitwise;
- ``apply_updates``, every ``kind`` and ``state_dtype``, three steps:
  f32 parameters and moments within rtol 2e-6 / atol 1e-7 (the global
  norm's sums and ``b ** count`` may differ in the last ulp between XLA
  and torch); bf16 parameters and moments within one bf16 rounding
  (rtol 2^-8); int8 moments compared dequantized, within the same
  f32 tolerance plus one quantization step where a value sits on a
  rounding boundary (at most 0.5 % of elements);
- schedules at steps 0..N: rtol 1e-6 plus atol 2e-7 * peak (f32
  cos/pow in two libraries may differ by an ulp of 1, which near the
  cosine's end is more than 1e-6 of the small lr);
- ``quantize_stochastic`` and the pod mean of ``compressed_psum_leaf``
  exact where every scaled value is an integer (no draw can round);
  elsewhere unbiased (4096 draws' mean within 0.003 of 0.3; 64 pod
  means' average within half a quantization step of the estimator's
  expectation) and within one step of the reference's draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as JC
from repro.train import optimizer as JO
from repro.train import schedules as JS
from repro_torch.train import compression as C
from repro_torch.train import optimizer as O
from repro_torch.train import schedules as S

F32_TOL = dict(rtol=2e-6, atol=1e-7)
BF16_RTOL = 2.0 ** -8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)
                      if x.dtype == jnp.bfloat16 else x)


def _samples(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(5, 7, 300)) * rng.uniform(0.01, 100)
    x[1, 2] = 0.0                                 # an all-zero block
    x[0, 0, :10] = [0.5, -0.5, 1.5, 2.5, -2.5, 0, 1e-9, -1e-9, 3, -3]
    return x.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(5, 7, 300), (2100,), (35, 60)])
def test_int8_quantizers_are_bitwise(seed, shape):
    x = _samples(seed).reshape(-1)[: int(np.prod(shape))].reshape(shape)
    for comp in ("sqrt", "linear"):
        got = O.quantize_blockwise(torch.from_numpy(x), companding=comp)
        want = JO.quantize_blockwise(jnp.asarray(x), companding=comp)
        for k in ("q", "scale"):
            assert got[k].dtype == getattr(torch, str(want[k].dtype))
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(
            O.dequantize_blockwise(got, shape, companding=comp).numpy(),
            np.asarray(JO.dequantize_blockwise(want, shape,
                                               companding=comp)))
    got = O.quantize_rowwise(torch.from_numpy(x))
    want = JO.quantize_rowwise(jnp.asarray(x))
    for k in ("q", "scale"):
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(
        O.dequantize_rowwise(got, shape).numpy(),
        np.asarray(JO.dequantize_rowwise(want, shape)))


def _problem(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"w": (100,), "b": (7, 3), "nested": {"k": (4, 2, 96)}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.normal(size=s).astype(np.float32)
    params, g1, g2 = make(shapes), make(shapes), make(shapes)
    to_j = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)
    to_t = lambda t: jax.tree.map(
        lambda a: torch.from_numpy(a).to(getattr(torch, dtype)), t)
    return (to_j(params), [to_j(g1), to_j(g2)],
            to_t(params), [to_t(g1), to_t(g2)])


def _leaves(tree):
    return O.tree_leaves(tree)


def _close(got, want, what, dtype):
    got, want = _np(got), _np(want)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-30,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **F32_TOL)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["adamw", "sgd"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(kind, state_dtype, param_dtype):
    cfg = O.OptimizerConfig(kind=kind, lr=1e-2, state_dtype=state_dtype,
                            qblock=64)
    jcfg = JO.OptimizerConfig(kind=kind, lr=1e-2, state_dtype=state_dtype,
                              qblock=64)
    jp, jgs, tp, tgs = _problem(3, param_dtype)
    js = JO.init_opt_state(jp, jcfg)
    ts = O.init_opt_state(tp, cfg)
    assert [tuple(x.shape) for x in _leaves(ts)] == \
        [x.shape for x in jax.tree_util.tree_leaves(js)]
    assert [str(x.dtype).split(".")[-1] for x in _leaves(ts)] == \
        [str(x.dtype) for x in jax.tree_util.tree_leaves(js)]
    for step in range(3):
        lr = None if step == 0 else S.cosine(step, peak=1e-2,
                                             warmup_steps=1, total_steps=5)
        jlr = None if step == 0 else JS.cosine(jnp.asarray(step), peak=1e-2,
                                               warmup_steps=1, total_steps=5)
        g = step % 2
        jp, js, jm = JO.apply_updates(jp, jgs[g], js, jcfg, lr=jlr)
        out = O.apply_updates(tp, tgs[g], ts, cfg, lr=lr)
        assert out[0] is tp and out[1] is ts        # updated in place
        np.testing.assert_allclose(out[2]["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 3
    for got, want in zip(_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert got.dtype == getattr(torch, str(want.dtype))
        _close(got, want, "params", param_dtype)
    moments = ("m",) if kind == "sgd" else ("m", "v")
    for name in moments:
        if state_dtype == "int8":
            flat_p = _leaves(tp)
            got = O._flatten_up_to(tp, ts[name])
            want = JO.jax.tree_util.tree_structure(jp).flatten_up_to(
                js[name])
            for p, g_, w in zip(flat_p, got, want):
                gd = O.dequantize_rowwise(g_, p.shape, 64).numpy()
                wd = np.asarray(JO.dequantize_rowwise(w, p.shape, 64))
                step_ = np.abs(wd).max() / 127.0
                bad = ~np.isclose(gd, wd, **F32_TOL)
                assert bad.mean() <= 0.005, (name, bad.mean())
                assert np.abs(gd - wd).max() <= 2 * step_ + 1e-7
        else:
            for got, want in zip(_leaves(ts[name]),
                                 jax.tree_util.tree_leaves(js[name])):
                _close(got, want, name, state_dtype)


def test_global_norm_sums_leaves_in_reference_order():
    rng = np.random.default_rng(5)
    tree = {"z": rng.normal(size=(300,)).astype(np.float32) * 1e4,
            "a": {"y": rng.normal(size=(3, 5)).astype(np.float32),
                  "b": rng.normal(size=(7,)).astype(np.float32) * 1e-3}}
    got = O.global_norm(jax.tree.map(torch.from_numpy, tree)).item()
    want = float(JO.global_norm(jax.tree.map(jnp.asarray, tree)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert [x.shape for x in O.tree_leaves(tree)] == \
        [x.shape for x in jax.tree_util.tree_leaves(tree)]
    t = {"a": torch.ones(4), "b": torch.ones(3)}
    assert abs(O.global_norm(t).item() - np.sqrt(7)) < 1e-6


def test_updates_in_chunks_equal_one_pass(monkeypatch):
    """A leaf updated in first-axis slices (UPDATE_CHUNK) gives the same
    bits as one pass over it.  (The global norm, summed slice by slice,
    may move in its last bits; a clip of 1e9 keeps it out of the
    update.)"""
    rng = np.random.default_rng(6)
    for state_dtype in ("float32", "int8"):
        cfg = O.OptimizerConfig(state_dtype=state_dtype, lr=1e-2,
                                grad_clip=1e9)
        p0 = rng.normal(size=(9, 4, 64)).astype(np.float32)
        g = torch.from_numpy(rng.normal(size=p0.shape).astype(np.float32))
        out = []
        for chunk in (1 << 26, 300):
            monkeypatch.setattr(O, "UPDATE_CHUNK", chunk)
            p = {"w": torch.from_numpy(p0.copy())}
            s = O.init_opt_state(p, cfg)
            for _ in range(2):
                O.apply_updates(p, {"w": g}, s, cfg)
            out.append((p["w"].clone(), O.tree_leaves(s)))
        assert len(O._chunks(torch.empty(9, 4, 64))) == 9
        assert torch.equal(out[0][0], out[1][0])
        for a, b in zip(out[0][1], out[1][1]):
            assert torch.equal(a, b)


def _reference_adamw(params, grads, m, v, t, cfg):
    gnorm = np.sqrt(sum((g ** 2).sum() for g in grads.values()))
    clip = min(1.0, cfg.grad_clip / (gnorm + 1e-9))
    out = {}
    for k in params:
        g = grads[k] * clip
        m[k] = cfg.b1 * m[k] + (1 - cfg.b1) * g
        v[k] = cfg.b2 * v[k] + (1 - cfg.b2) * g * g
        mh = m[k] / (1 - cfg.b1 ** t)
        vh = v[k] / (1 - cfg.b2 ** t)
        out[k] = params[k] - cfg.lr * (mh / (np.sqrt(vh) + cfg.eps)
                                       + cfg.weight_decay * params[k])
    return out, m, v


def test_adamw_matches_numpy_reference_fp32():
    """tests/test_optimizer.py::test_adamw_matches_reference_fp32 on the
    port (rtol 1e-5, atol 1e-6, as there)."""
    cfg = O.OptimizerConfig(lr=1e-2, state_dtype="float32")
    rng = np.random.default_rng(0)
    p_np = {"w": rng.normal(size=(100,)), "b": rng.normal(size=(7, 3))}
    g_np = {"w": rng.normal(size=(100,)), "b": rng.normal(size=(7, 3))}
    p = {k: torch.tensor(v, dtype=torch.float32) for k, v in p_np.items()}
    g = {k: torch.tensor(v, dtype=torch.float32) for k, v in g_np.items()}
    s = O.init_opt_state(p, cfg)
    m = {k: np.zeros_like(v) for k, v in p_np.items()}
    v = {k: np.zeros_like(x) for k, x in p_np.items()}
    ref = dict(p_np)
    for t in range(1, 4):
        O.apply_updates(p, g, s, cfg)
        ref, m, v = _reference_adamw(ref, g_np, m, v, t, cfg)
    for k in p:
        np.testing.assert_allclose(p[k].numpy(), ref[k], rtol=1e-5,
                                   atol=1e-6)


def test_int8_adam_converges_like_fp32():
    """tests/test_optimizer.py::test_int8_adam_converges_like_fp32 on the
    port, with torch autograd for the gradient (same gates)."""
    rng = np.random.default_rng(3)
    A = torch.tensor(rng.normal(size=(64, 32)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(64,)), dtype=torch.float32)

    def loss_fn(w):
        r = A @ w - b
        return torch.mean(r * r)

    def run(cfg):
        w = {"w": torch.zeros(32, requires_grad=True)}
        s = O.init_opt_state(w, cfg)
        for _ in range(60):
            (g,) = torch.autograd.grad(loss_fn(w["w"]), [w["w"]])
            O.apply_updates(w, {"w": g}, s, cfg)
        return float(loss_fn(w["w"].detach()))

    l32 = run(O.OptimizerConfig(lr=3e-2, weight_decay=0.0,
                                state_dtype="float32"))
    l8 = run(O.OptimizerConfig(lr=3e-2, weight_decay=0.0,
                               state_dtype="int8"))
    l0 = float(loss_fn(torch.zeros(32)))
    An, bn = A.numpy(), b.numpy()
    opt = float(np.mean((An @ np.linalg.lstsq(An, bn, rcond=None)[0]
                         - bn) ** 2))
    assert l32 - opt < 0.2 * (l0 - opt), (l32, opt, l0)
    assert abs(l8 - l32) < 0.05 * (l0 - opt) + 1e-4


def test_sgd_path_and_grad_clip():
    rng = np.random.default_rng(5)
    params = {"w": torch.tensor(rng.normal(size=(100,)), dtype=torch.float32)}
    grads = {"w": torch.tensor(rng.normal(size=(100,)), dtype=torch.float32)}
    before = params["w"].clone()
    cfg = O.OptimizerConfig(kind="sgd", lr=0.1)
    _, _, met = O.apply_updates(params, grads, O.init_opt_state(params, cfg),
                                cfg)
    assert met["grad_norm"].item() > 0
    assert not torch.allclose(params["w"], before)
    cfg = O.OptimizerConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0)
    big = {"w": grads["w"] * 1e6}
    _, _, met = O.apply_updates(params, big, O.init_opt_state(params, cfg),
                                cfg)
    assert met["grad_norm"].item() > 1e3      # raw norm reported


@pytest.mark.parametrize("name,kw", [
    ("cosine", dict(peak=2.0, warmup_steps=5, total_steps=50)),
    ("cosine", dict(peak=3e-4, warmup_steps=0, total_steps=7, floor=0.0)),
    ("wsd", dict(peak=1.0, warmup_steps=10, stable_steps=80,
                 decay_steps=10)),
    ("wsd", dict(peak=1e-2, warmup_steps=3, stable_steps=4,
                 decay_steps=0, floor=0.25)),
    ("constant", dict(peak=1e-3)),
])
def test_schedules_match_reference(name, kw):
    got = S.get_schedule(name, **kw)
    want = jax.jit(JS.get_schedule(name, **kw))
    tol = dict(rtol=1e-6, atol=2e-7 * kw["peak"])
    for s in range(0, 112):
        g = got(s)
        assert g.dtype == torch.float32 and g.ndim == 0
        np.testing.assert_allclose(g.item(), float(want(jnp.int32(s))),
                                   err_msg=f"step {s}", **tol)
    g = S.get_schedule(name, **kw)(torch.tensor(7, dtype=torch.int32))
    np.testing.assert_allclose(g.item(), float(want(jnp.int32(7))), **tol)
    with pytest.raises(ValueError):
        S.get_schedule("linear", **kw)


def test_wsd_and_cosine_shapes():
    lr = S.get_schedule("wsd", peak=1.0, warmup_steps=10, stable_steps=80,
                        decay_steps=10)
    xs = np.array([lr(s).item() for s in range(110)])
    assert xs[0] == 0.0 and abs(xs[10] - 1.0) < 1e-6
    assert np.all(np.abs(xs[10:90] - 1.0) < 1e-6)
    assert xs[-1] <= 0.12 and np.all(np.diff(xs[90:]) <= 1e-9)
    xs = np.array([S.cosine(s, peak=2.0, warmup_steps=5,
                            total_steps=50).item() for s in range(50)])
    assert xs.argmax() == 5 and xs[-1] < xs[5]


def _integer_scaled(rng, shape, pods=None):
    """Leaves whose every block max is 127 * 2^e and every element an
    integer multiple of 2^e: g / scale is an integer, so stochastic
    rounding cannot round."""
    lead = () if pods is None else (pods,)
    k = rng.integers(-127, 128, size=lead + shape).astype(np.float32)
    flat = k.reshape(*lead, -1)
    flat[..., ::256] = 127.0                   # every block's max
    e = 2.0 ** rng.integers(-6, 3)
    return (flat.reshape(k.shape) * e).astype(np.float32)


def test_quantize_stochastic_exact_on_integer_values():
    rng = np.random.default_rng(0)
    x = _integer_scaled(rng, (1000,))
    q, scale = C.quantize_stochastic(torch.from_numpy(x),
                                     torch.Generator().manual_seed(1))
    jq, jscale = JC.quantize_stochastic(jnp.asarray(x), jax.random.key(1))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        C.dequantize(q, scale, x.shape).numpy(),
        np.asarray(JC.dequantize(jq, jscale, x.shape)))
    np.testing.assert_array_equal(C.dequantize(q, scale, x.shape).numpy(),
                                  x)


def test_stochastic_rounding_unbiased_and_bounded():
    """tests/test_compression.py's two checks on the port, plus the
    rounding helper's mean on its own."""
    gen = torch.Generator().manual_seed(0)
    x = torch.full((4096,), 0.3)
    q, scale = C.quantize_stochastic(x, gen)
    assert abs(C.dequantize(q, scale, x.shape).mean().item() - 0.3) < 0.003
    r = C._stochastic_round(torch.full((4096,), 2.25), gen)
    assert set(r.unique().tolist()) == {2.0, 3.0}
    assert abs(r.mean().item() - 2.25) < 0.03
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(1000,)), dtype=torch.float32)
    q, scale = C.quantize_stochastic(x, torch.Generator().manual_seed(1))
    y = C.dequantize(q, scale, x.shape)
    assert (y - x).abs().max() <= x.abs().max() / 127 * 1.5


def _reference_pod_mean(stacked, key):
    fn = jax.vmap(lambda g, k: JC.compressed_psum_leaf(g, k, "pod"),
                  in_axes=(0, None), axis_name="pod")
    return np.asarray(fn(jnp.asarray(stacked), key))


def test_compressed_psum_leaf_matches_reference():
    """The pod mean over a leading axis vs the reference's per-leaf
    arithmetic under ``jax.vmap(axis_name='pod')`` (its ``psum`` over
    the mapped axis): exact on integer-scaled leaves, and an unbiased
    mean elsewhere."""
    rng = np.random.default_rng(2)
    stacked = _integer_scaled(rng, (3, 300), pods=4)
    got = C.compressed_psum_leaf(torch.from_numpy(stacked),
                                 torch.Generator().manual_seed(0))
    want = _reference_pod_mean(stacked, jax.random.key(0))
    assert tuple(got.shape) == (3, 300) == want.shape[1:]
    for pod in range(4):                      # every pod holds the mean
        np.testing.assert_array_equal(got.numpy(), want[pod])

    g = rng.normal(size=(4, 2048)).astype(np.float32)
    outs = [C.compressed_psum_leaf(torch.from_numpy(g),
                                   torch.Generator().manual_seed(s))
            for s in range(64)]
    mean = torch.stack(outs).mean(0).numpy()
    ref = _reference_pod_mean(g, jax.random.key(0))[0]
    # The estimator's expectation: the mean scale times the pods' summed
    # unrounded g / scale, over the pods (the reference's own formula).
    scale = np.abs(g.reshape(4, -1, 256)).max(-1) / np.float32(127)
    expect = (scale.mean(0)[:, None]
              * (g.reshape(4, -1, 256) / scale[..., None]).sum(0)
              / 4).reshape(-1)
    step = scale.mean(0).max()
    assert np.abs(mean - expect).max() < 0.5 * step
    assert np.abs(outs[0].numpy() - ref).max() <= 1.01 * step
