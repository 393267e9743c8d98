"""RWKV-6's bf16 gradients against their f32 twins, the port beside the
JAX package run op by op (``jax.disable_jit``), on the CPU.

chip_smoke.py's phase 10b holds each bf16 sublayer gradient of the arms
within 0.05 of its f32 twin (on the same input and widened weights),
but for RWKV-6's time mix, and prints rwkv6-3b's whole-model bf16
gradient beside its f32 twin ungated.  These tests are the measured
reason: at the reduced config the reference's own bf16 gradients sit
as far from its f32 twin as the port's do, leaf by leaf, so the
distance is the bf16 arithmetic that both packages run, not the port's.
The reference's compiled form keeps bf16 intermediates in f32 inside
XLA's fusions and is no witness.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.train import optimizer as O

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_models import _configs, _jb, _params, _tb  # noqa: E402

F32 = dict(param_dtype="float32", activation_dtype="float32")


def _dist(a, b) -> float:
    """||a - b|| / ||b|| (||a|| where b is 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den if den else np.linalg.norm(a))


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _zipf(cfg, T: int) -> dict:
    toks = np.minimum(np.random.default_rng(0).zipf(1.5, size=(1, T + 1)),
                      cfg.vocab_size - 1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_bf16_rwkv6_time_mix_gradient_rounds_as_reference():
    """Each layer's time mix, fed the reference's own bf16 input: the
    gradient of <out, c> (input and every weight) in bf16 against the
    f32 twin's (the same input and weights widened), in the port and
    in the reference op by op.  Leaf by leaf the port's distance is no
    larger than the reference's (read: equal to 4 digits but for mu_g,
    mu_k, mu_r and mu_v, f32 weights cast to bf16, whose bf16 gradients
    the port sums 11-39 % closer to f32).  Both reach 0.070 (layer 3's
    mu_r: port 0.0703, reference 0.0704) past the 0.05 the other
    sublayers keep; rwkv6-3b at full width reads up to 0.0695 (u) on an
    H100 80GB HBM3 at 700 W."""
    jcfg, cfg = _configs("rwkv6-3b")
    jp, tp = _params(jcfg, cfg)
    hd = cfg.rwkv_head_dim
    batch = _zipf(cfg, 64)
    c = np.random.default_rng(1).normal(
        size=(1, 64, cfg.d_model)).astype(np.float32)

    def port_grads(h, p):
        leaves = [h.detach().requires_grad_(True)] + [
            w.detach().requires_grad_(True) for w in O.tree_leaves(p)]
        out = SSM.rwkv6_time_mix(leaves[0], O.tree_unflatten(
            p, leaves[1:]), head_dim=hd)
        return [g.float().numpy() for g in torch.autograd.grad(
            (out.double() * torch.from_numpy(c).double()).sum(), leaves)]

    def ref_grads(h, p):
        g = jax.grad(lambda h, p: jnp.sum(JSSM.rwkv6_time_mix(
            h, p, head_dim=hd).astype(jnp.float32) * c),
            argnums=(0, 1))(h, p)
        return [_np(g[0])] + [_np(x) for x in jax.tree_util.tree_leaves(
            g[1])]

    with jax.disable_jit():
        x = JM.encode_inputs(jcfg, jp, _jb(batch))
        for sb in range(cfg.n_superblocks):
            jb = jax.tree.map(lambda a: a[sb], jp["blocks"])["s0"]
            tb = M._index(tp["blocks"], sb)["s0"]
            h = JL.rms_norm(x, jb["norm1"], jcfg.rms_eps)
            th = M._tensor(np.asarray(h))
            p32 = jax.tree.map(lambda a: a.astype(jnp.float32), jb["mixer"])
            ref16 = ref_grads(h, jb["mixer"])
            ref32 = ref_grads(h.astype(jnp.float32), p32)
            port16 = port_grads(th, tb["mixer"])
            port32 = port_grads(th.float(), M.tree_map(
                lambda t: t.float(), tb["mixer"]))
            for r16, r32, q16, q32 in zip(ref16, ref32, port16, port32):
                ref, port = _dist(r16, r32), _dist(q16, q32)
                assert port <= 1.1 * ref + 1e-4, (sb, port, ref)
            x = JM._apply_sublayer(jcfg, "rwkv6", False, jb, x)


def test_bf16_rwkv6_gradient_rounds_as_reference():
    """The whole reduced model (4 layers, 1 x 32 Zipf tokens): the bf16
    loss gradient against the f32 twin's, leaf by leaf, in the port and
    in the reference op by op, agree within 0.15 of the reference's
    (read: within 0.085, at distances of 0.07-0.21).  chip_smoke.py
    prints rwkv6-3b's at full width (2 of its 32 layers)."""
    jcfg, cfg = _configs("rwkv6-3b")
    jp, tp = _params(jcfg, cfg)
    jcfg32, cfg32 = (dataclasses.replace(c, **F32) for c in (jcfg, cfg))
    batch = _zipf(cfg, 32)

    def ref(c, p):
        return jax.tree_util.tree_leaves(jax.grad(
            lambda p: JM.loss_fn(c, p, _jb(batch), remat=False))(p))

    with jax.disable_jit():
        ref16 = ref(jcfg, jp)
    ref32 = jax.jit(lambda p: ref(jcfg32, p))(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp))
    _, port16 = ST.value_and_grad(cfg, tp, _tb(batch), remat=False)
    _, port32 = ST.value_and_grad(cfg32, M.tree_map(lambda t: t.float(), tp),
                                  _tb(batch), remat=False)
    pairs = list(zip(ref16, ref32, O.tree_leaves(port16),
                     O.tree_leaves(port32)))
    assert len(pairs) == len(jax.tree_util.tree_leaves(jp))
    for r16, r32, q16, q32 in pairs:
        want = _dist(_np(r16), _np(r32))
        got = _dist(q16.float().numpy(), q32.numpy())
        assert abs(got - want) <= 0.15 * want + 1e-6, (got, want)
