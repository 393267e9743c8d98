"""stablelm-12b (reduced) in f16 through the port's LM path vs the JAX
package's, on the CPU.

``ArchConfig(param_dtype="float16", activation_dtype="float16")`` is a
valid config in both packages; on the card the port serves it through
the sm90 flash kernel's f16 instantiation (``chip_smoke.py``'s f16
phase).  Here both get the JAX package's f16 parameters through
``params_from_numpy`` and the same tokens: forward with both attention
impls, prefill + decode_step, and BatchedServer.

Tolerance.  The reference's own two forwards in f16, compiled
(``JM.forward``: XLA keeps f16 intermediates in f32 inside its fusions)
and op by op (composed from its public pieces under
``jax.disable_jit``, rounding every f16 result as its source is written),
differ by 0.00099 of max|logits| (4.85); the port reads 0.00102 (xla)
and 0.00105 (flash) from the compiled one.  The gate is twice the
reference's own spread, measured in the test, and below 0.003.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.server import BatchedServer as JaxServer
from repro.serving.server import Request as JaxRequest
from repro_torch.configs import get_arch
from repro_torch.models import model as M
from repro_torch.serving import BatchedServer, Request

F16 = dict(param_dtype="float16", activation_dtype="float16")
ARCH = "stablelm-12b"


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-6)


@pytest.fixture(scope="module")
def env():
    """The reduced config in f16 in both packages, the reference's
    parameters, the port's copy of them, and seeded tokens."""
    jcfg = dataclasses.replace(jax_get_arch(ARCH, reduced=True), **F16)
    cfg = dataclasses.replace(get_arch(ARCH, reduced=True), **F16)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = M.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                             device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 65)).astype(np.int32)
    return jcfg, jp, cfg, tp, toks


def _op_by_op_forward(jcfg, jp, batch):
    """The reference's forward composed from its public pieces, run under
    ``jax.disable_jit`` by the caller."""
    x = JM.encode_inputs(jcfg, jp, batch)
    for sb in range(jcfg.n_superblocks):
        x = JM.superblock_apply(jcfg, jax.tree.map(lambda a: a[sb],
                                                   jp["blocks"]), x, sb)
    x = JL.rms_norm(x, jp["final_norm"], jcfg.rms_eps)
    return jnp.einsum("btd,dv->btv", x, jp["unembed"],
                      preferred_element_type=jnp.float32)


def test_f16_parameters_and_activations(env):
    _, jp, cfg, tp, _ = env
    assert cfg.param_dtype == "float16"
    assert tp["embed"].dtype == torch.float16
    assert str(jp["embed"].dtype) == "float16"


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_f16_forward_matches_reference(env, impl, capsys):
    jcfg, jp, cfg, tp, toks = env
    jcfg = dataclasses.replace(jcfg, attention_impl=impl)
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    batch = {"tokens": jnp.asarray(toks[:, :64])}
    want = np.asarray(JM.forward(jcfg, jp, batch, remat=False))
    with jax.disable_jit():
        op = np.asarray(_op_by_op_forward(jcfg, jp, batch))
    got = M.forward(cfg, tp, {"tokens": torch.from_numpy(toks[:, :64])})
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    port, spread = _rel(got.numpy(), want), _rel(want, op)
    with capsys.disabled():
        print(f"\n{ARCH} f16 forward ({impl}): port vs reference "
              f"{port:.4g}, reference compiled vs op by op {spread:.4g} "
              f"of max|logits| {np.abs(want).max():.4g}")
    assert port < min(2 * spread, 0.003)


def test_f16_prefill_decode_matches_reference_and_forward(env):
    """prefill(64) + one decode step against the reference's (the same
    gate as forward) and against the port's own forward(65) (0.05,
    tests/test_models.py's gate); the caches keep the reference's
    dtypes."""
    jcfg, jp, cfg, tp, toks = env
    T = 64
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :T])},
                        cache_len=T + 4)
    jd, jc = JM.decode_step(jcfg, jp, jc, {"tokens": jnp.asarray(
        toks[:, T:])})
    tl, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :T])},
                       cache_len=T + 4)
    td, tc = M.decode_step(cfg, tp, tc, {"tokens": torch.from_numpy(
        toks[:, T:])})
    assert _rel(tl.numpy(), np.asarray(jl)) < 0.003
    assert _rel(td.numpy(), np.asarray(jd)) < 0.003
    for key in ("k", "v", "pos"):
        assert str(tc["s0"][key].dtype).split(".")[-1] == \
            str(jc["s0"][key].dtype)
    full = M.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert _rel(td[:, 0].numpy(), full[:, T].numpy()) < 0.05


def test_f16_server_matches_reference_tokens(env):
    """Greedy BatchedServer on the reference's f16 parameters: the same
    tokens and engine steps as the reference's server."""
    jcfg, jp, cfg, tp, _ = env
    kw = dict(slots=3, prompt_len=16, cache_len=48)
    rng = np.random.default_rng(5)
    spec = [(rng.integers(0, cfg.vocab_size, int(rng.integers(3, 14))),
             int(rng.integers(2, 9))) for _ in range(6)]
    jreqs = [JaxRequest(i, p, max_new_tokens=n)
             for i, (p, n) in enumerate(spec)]
    reqs = [Request(i, p, max_new_tokens=n) for i, (p, n) in enumerate(spec)]
    jserver = JaxServer(jcfg, jp, **kw)
    server = BatchedServer(cfg, tp, device="cpu", **kw)
    jserver.serve(jreqs)
    server.serve(reqs)
    assert all(r.done for r in reqs)
    assert [r.tokens_out for r in reqs] == [r.tokens_out for r in jreqs]
    assert server.steps == jserver.steps
