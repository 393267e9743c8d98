"""rwkv6's whole-model gradient through depth, the port against the JAX
package, on the CPU.

On the card, central differences along the f32 twin's gradient resolve
rwkv6-3b's whole model at 2 layers and at no step from 4 layers on (the
loss bends along the gradient within any step that f32 resolves;
chip_smoke.py's TRAIN_ARMS).  Here the port's gradient of the whole
reduced model at 32 layers, T = 96 (three of RWKV-6's 32-token chunks),
is held against ``jax.grad`` of the reference's loss, leaf by leaf.
"""

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_train import (JM, ST, _batch, _configs, _jb,  # noqa: E402
                              _leaves, _params, _tb)
from test_torch_train_arms_steps import _half_ulp  # noqa: E402

DEPTH, T = 32, 96
# max |port - reference| / max |reference| a leaf.  Read: 5.9e-4 (u;
# the channel mix's wk 3.7e-4), where the reference's own gradient
# moves up to 1.75e-3 (u; wk 1.29e-3) when its weights move by half an
# ulp (``_half_ulp``, seeds 5 and 6): RWKV-6's recurrence amplifies
# rounding through the layers, and the port's distance is at most 0.71
# of the reference's own spread, leaf by leaf.  At 4 layers both read
# under 3e-5, within tests/test_torch_train.py's 1e-4.
DEPTH_TOL = 1e-3


def test_rwkv6_whole_model_gradient_at_depth_as_jax_grad():
    jcfg, cfg = _configs("rwkv6-3b", n_layers=DEPTH)
    jp, tp = _params(jcfg, cfg)
    batch = _batch(cfg, B=1, T=T)
    vg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, _jb(batch), remat=False)))
    jl, jg = vg(jp)
    loss, grads = ST.value_and_grad(cfg, tp, _tb(batch), remat=False)
    assert abs(loss.item() - float(jl)) <= 1e-6 * abs(float(jl))
    want = [np.asarray(b) for b in jax.tree_util.tree_leaves(jg)]
    got = _leaves(grads)
    assert len(got) == len(want)
    port = [float(np.abs(a.numpy() - b).max() / np.abs(b).max())
            for a, b in zip(got, want) if np.abs(b).max() > 0]
    assert max(port) <= DEPTH_TOL, max(port)
    # the limit stays within what half an ulp moves the reference by
    spread = max(float(np.abs(np.asarray(x) - b).max() / np.abs(b).max())
                 for s in (5, 6)
                 for x, b in zip(jax.tree_util.tree_leaves(
                     vg(_half_ulp(jp, s))[1]), want) if np.abs(b).max() > 0)
    assert DEPTH_TOL <= spread, spread
