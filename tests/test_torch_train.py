"""The port's training path vs the JAX package's, on the CPU.

Gradients: ``loss_fn``'s gradients (``launch.steps.value_and_grad``)
against ``jax.grad`` on the same parameters (``params_from_numpy``) and
batch, in the f32 variants of reduced minicpm-2b (dense), qwen3-moe
(MoE: the stable-sort routing), jamba (Mamba's scan + MoE + attention),
rwkv6 and musicgen (``embeds``).  The reference runs ``remat=False`` (to
save compile time), the port every remat setting.  Elementwise, a
gradient must lie within 1e-4 * max|leaf| of the reference's (measured
worst 2.3e-5, rwkv6), and the loss within 1e-6 relative.  Every remat
policy's gradient is bitwise the port's ``remat=False`` one.

Training steps: after an optimizer step Adam moves each element by
about lr * sign(g), so an element whose gradient is near 0 may move the
other way in the two packages.  Steps are compared by loss (1e-6
relative; measured at most 1.1e-7, a resumed run's included) and by
||Δparams|| / ||params|| (1e-5; measured 1.0e-6 after 3 steps).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import all_arch_names
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import steps as JST
from repro.models import model as JM
from repro.train import optimizer as JO
from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.train import optimizer as O
from repro_torch.train.trainer import Trainer, TrainerConfig

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
F32_CFG = dict(param_dtype="float32", activation_dtype="float32")
GRAD_ARCHS = ["minicpm-2b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
              "rwkv6-3b", "musicgen-medium"]
GRAD_TOL = 1e-4                 # of max|leaf|, elementwise
STEP_LOSS_RTOL = 1e-6
RESUMED_LOSS_RTOL = 1e-6
PARAM_REL_TOL = 1e-5


def _configs(name, **kw):
    kw = {**F32_CFG, **kw}
    return (dataclasses.replace(jax_get_arch(name, reduced=True), **kw),
            dataclasses.replace(get_arch(name, reduced=True), **kw))


def _params(jcfg, cfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, M.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")


def _batch(cfg, B=2, T=16, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.frontend is not None:
        batch = {"embeds": rng.normal(size=(B, T, cfg.d_model))
                 .astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T))
                 .astype(np.int32)}
    batch["labels"] = rng.integers(0, cfg.vocab_size, (B, T)) \
        .astype(np.int32)
    batch["labels"][0, :3] = -1                       # masked positions
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tree):
    return O.tree_leaves(tree)


def _grads_close(got, want):
    g, w = _leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=GRAD_TOL * np.abs(b).max() + 1e-12)


def _rel_param_diff(got, want) -> float:
    num = sum(float(np.sum((a.detach().double().numpy()
                            - np.asarray(b, np.float64)) ** 2))
              for a, b in zip(_leaves(got), jax.tree_util.tree_leaves(want)))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2))
              for b in jax.tree_util.tree_leaves(want))
    return (num / den) ** 0.5


@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_loss_gradients_match_jax_grad(name):
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg, cfg)
    batch = _batch(cfg)
    jl, jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, _jb(batch), remat=False))(jp)
    loss, grads = ST.value_and_grad(cfg, tp, _tb(batch), remat=False)
    assert abs(loss.item() - float(jl)) <= 1e-6 * abs(float(jl))
    _grads_close(grads, jg)
    for leaf in _leaves(tp):                   # the caller's tensors
        assert leaf.is_leaf and not leaf.requires_grad
    for policy in M.REMAT_POLICIES:
        l2, g2 = ST.value_and_grad(cfg, tp, _tb(batch), remat=True,
                                   remat_policy=policy)
        assert l2.item() == loss.item(), policy
        for a, b in zip(_leaves(g2), _leaves(grads)):
            assert torch.equal(a, b), policy


def test_bf16_embedding_gradient_rounds_as_reference():
    """In bf16 the tied embedding's rows that the batch looks up sum
    every repeat of their token in bf16, in the reference (gather's
    transpose, a bf16 scatter-add) as in the port (index backward), so
    on Zipf tokens those rows sit far from the f32 twin's gradient.  The
    port's distance must be the reference's within 5 %; the other rows
    (the unembedding's product alone) and a block leaf stay within about
    one bf16 rounding in both.  Readings (4 x 512 tokens): batch rows
    0.128 in both, other rows 0.0049, wq 0.0069 and 0.0071."""
    jcfg, cfg = (jax_get_arch("minicpm-2b", reduced=True),
                 get_arch("minicpm-2b", reduced=True))
    jcfg32, cfg32 = _configs("minicpm-2b")
    rng = np.random.default_rng(0)
    toks = np.minimum(rng.zipf(1.5, size=(4, 513)),
                      cfg.vocab_size - 1).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    want = {}
    for tag, c, p in (("16", jcfg, jp), ("32", jcfg32, jp32)):
        want[tag] = jax.grad(lambda q: JM.loss_fn(c, q, _jb(batch),
                                                  remat=False))(p)
    got = {}
    for tag, c, p in (("16", cfg, jp), ("32", cfg32, jp32)):
        tp = M.params_from_numpy(c, jax.tree.map(np.asarray, p), "cpu")
        got[tag] = ST.value_and_grad(c, tp, _tb(batch), remat=False)[1]
    rows = np.zeros(cfg.vocab_size, bool)
    rows[np.unique(batch["tokens"])] = True

    def dist(g16, g32, key):
        a = np.asarray(np.asarray(g16[key], np.float32) if key == "embed"
                       else g16["blocks"]["s0"]["mixer"][key], np.float64)
        b = np.asarray(np.asarray(g32[key]) if key == "embed"
                       else g32["blocks"]["s0"]["mixer"][key], np.float64)
        if key != "embed":
            return np.linalg.norm(a - b) / np.linalg.norm(b), None
        return tuple(np.linalg.norm(a[m] - b[m]) / np.linalg.norm(b[m])
                     for m in (rows, ~rows))

    def port(tree):
        return M.tree_map(lambda t: t.float().numpy(), tree)
    r_in, r_out = dist(want["16"], want["32"], "embed")
    p_in, p_out = dist(port(got["16"]), port(got["32"]), "embed")
    print(f"batch rows {p_in} (reference {r_in}), other rows {p_out} "
          f"(reference {r_out})")
    assert r_in > 0.05 and abs(p_in - r_in) <= 0.05 * r_in
    assert max(r_out, p_out) <= 0.01
    r_wq, _ = dist(want["16"], want["32"], "wq")
    p_wq, _ = dist(port(got["16"]), port(got["32"]), "wq")
    assert max(r_wq, p_wq) <= 0.01 and p_wq <= 1.5 * r_wq


def _backward_products(cfg, params, batch, **kw) -> tuple[int, int]:
    """(weight products, batched products) that one backward runs:
    ``bmm`` calls with a batch of 1 and with more."""
    from torch.utils._python_dispatch import TorchDispatchMode
    counts = [0, 0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.bmm.default:
                counts[args[0].shape[0] > 1] += 1
            return func(*args, **(kwargs or {}))

    for p in _leaves(params):
        p.requires_grad_(True)
    loss = M.loss_fn(cfg, params, batch, **kw)
    with Count():
        loss.backward()
    return tuple(counts)


def test_remat_recomputes_what_its_policy_says():
    """Backward reruns the forward's products under remat "nothing",
    only the batched ones (attention) under "dots_no_batch", and none
    without remat or under "everything" — the reference's policies."""
    _, cfg = _configs("minicpm-2b")
    tp = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _tb(_batch(cfg))
    none = _backward_products(cfg, tp, batch, remat=False)
    every = _backward_products(cfg, tp, batch, remat_policy="everything")
    dots = _backward_products(cfg, tp, batch, remat_policy="dots_no_batch")
    nothing = _backward_products(cfg, tp, batch, remat_policy="nothing")
    # Per layer the forward runs 6 weight products (q, k, v, o, wi, wo)
    # and 2 batched ones.  The recompute stops once it has rebuilt every
    # tensor backward needs (torch's early stop), so under "nothing" the
    # last product of a superblock, whose output no backward reads, is
    # not rerun: 5 of the 6.
    n = cfg.n_layers
    assert every == none
    assert dots == (none[0], none[1] + 2 * n)
    assert nothing == (none[0] + 5 * n, none[1] + 2 * n)


def test_make_train_step_matches_reference():
    jcfg, cfg = _configs("minicpm-2b")
    jp, tp = _params(jcfg, cfg, seed=1)
    jopt, opt = JO.OptimizerConfig(lr=1e-3), O.OptimizerConfig(lr=1e-3)
    jstep = jax.jit(JST.make_train_step(jcfg, jopt, remat=False))
    step = ST.make_train_step(cfg, opt, remat=True)
    js, ts = JO.init_opt_state(jp, jopt), O.init_opt_state(tp, opt)
    for i in range(3):
        batch = _batch(cfg, seed=10 + i)
        jp, js, jm = jstep(jp, js, _jb(batch))
        tp2, ts2, m = step(tp, ts, _tb(batch))
        assert tp2 is tp and ts2 is ts
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=STEP_LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert _rel_param_diff(tp, jp) <= PARAM_REL_TOL
    assert int(ts["count"]) == 3


def test_specs_match_reference_eval_shape():
    """param/opt-state/input/cache specs: meta tensors, leaf for leaf
    the reference's eval_shape trees by shape and dtype, at full
    width, for every config."""
    def same(got, want):
        g, w = _leaves(got), jax.tree_util.tree_leaves(want)
        assert [tuple(x.shape) for x in g] == [x.shape for x in w]
        assert [str(x.dtype)[6:] for x in g] == [str(x.dtype) for x in w]
        assert all(x.device.type == "meta" for x in g)

    opt = dict(state_dtype="int8")
    for name in all_arch_names():
        jcfg, cfg = jax_get_arch(name), get_arch(name)
        same(ST.param_specs(cfg), JST.param_specs(jcfg))
        same(ST.opt_state_specs(cfg, O.OptimizerConfig(**opt)),
             JST.opt_state_specs(jcfg, JO.OptimizerConfig(**opt)))
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            same(ST.input_specs(cfg, SHAPES[shape]),
                 JST.input_specs(jcfg, JSHAPES[shape]))
        same(ST.cache_specs(cfg, SHAPES["decode_32k"]),
             JST.cache_specs(jcfg, JSHAPES["decode_32k"]))


def test_prefill_and_decode_steps_match_model():
    jcfg, cfg = _configs("minicpm-2b")
    _, tp = _params(jcfg, cfg)
    toks = _batch(cfg, T=9)["tokens"]
    logits, cache = ST.make_prefill_step(cfg, 16)(tp, _tb({"tokens":
                                                          toks[:, :8]}))
    assert logits.grad_fn is None
    step_logits, _ = ST.make_decode_step(cfg)(
        tp, cache, _tb({"tokens": toks[:, 8:9]}))
    full = M.forward(cfg, tp, _tb({"tokens": toks}), remat=False)
    np.testing.assert_allclose(step_logits[:, 0].numpy(),
                               full[:, 8].detach().numpy(), rtol=1e-4,
                               atol=1e-4 * full.abs().max().item())


def _zipf_batches(cfg, n, B=4, T=32, seed=0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = np.minimum(rng.zipf(1.5, size=(B, T + 1)),
                          cfg.vocab_size - 1).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _losses(log) -> list:
    return [r["loss"] for r in log]


def test_port_trainer_resumes_a_reference_checkpoint(tmp_path):
    """The reference Trainer writes a checkpoint; a port Trainer and a
    fresh reference Trainer resume it and run the same batches: step
    numbers equal, losses within 1e-6 relative."""
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig
    jcfg, cfg = _configs("minicpm-2b")
    batches = _zipf_batches(cfg, 7)
    kw = dict(total_steps=20, ckpt_every=2, log_every=100, peak_lr=1e-2,
              warmup_steps=2)
    jt = JTrainer(jcfg, JO.OptimizerConfig(),
                  JTrainerConfig(workdir=str(tmp_path / "ref"), **kw))
    jt.run(iter(batches[:4]), 4)
    jt.close()
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    jt2 = JTrainer(jcfg, JO.OptimizerConfig(),
                   JTrainerConfig(workdir=str(tmp_path / "ref"), **kw))
    tt = Trainer(cfg, O.OptimizerConfig(),
                 TrainerConfig(workdir=str(tmp_path / "port"), **kw),
                 device="cpu")
    assert tt.step == jt2.step == 3
    want = jt2.run(iter(batches[4:]), 3)
    got = tt.run(iter(batches[4:]), 3)
    jt2.close()
    tt.close()
    assert [r["step"] for r in got] == [r["step"] for r in want] == [3, 4, 5]
    np.testing.assert_allclose(_losses(got), _losses(want),
                               rtol=RESUMED_LOSS_RTOL)
    np.testing.assert_allclose([r["lr"] for r in got],
                               [r["lr"] for r in want], rtol=1e-6)


def test_trainer_loss_decreases_and_resumes(tmp_path):
    """tests/test_checkpoint_trainer.py::
    test_trainer_loss_decreases_and_resumes on the port: bf16 reduced
    minicpm-2b on Zipf-skewed .npy shards through the self-scheduled
    loader, 30 steps at peak lr 1e-2, checkpoints every 10."""
    from repro_torch.data.pipeline import (ShardManifest,
                                           SelfScheduledLoader)
    cfg = get_arch("minicpm-2b", reduced=True)
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "shards", exist_ok=True)
    shards = []
    for i in range(4):
        toks = np.minimum(rng.zipf(1.5, size=4 * 65 * 40),
                          cfg.vocab_size - 1).astype(np.int32)
        path = str(tmp_path / "shards" / f"s{i}.npy")
        np.save(path, toks)
        shards.append(ShardManifest(f"s{i}", path, len(toks),
                                    int(toks.nbytes)))
    loader = SelfScheduledLoader(shards, batch_size=4, seq_len=64,
                                 poll_interval=0.003)
    tcfg = TrainerConfig(workdir=str(tmp_path), total_steps=30,
                         ckpt_every=10, log_every=100, peak_lr=1e-2)
    tr = Trainer(cfg, O.OptimizerConfig(), tcfg, device="cpu")
    log = tr.run(loader.batches(30), 30)
    tr.close()
    first = np.mean([r["loss"] for r in log[:5]])
    last = np.mean([r["loss"] for r in log[-5:]])
    assert last < first - 0.5, (first, last)
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in log)

    tr2 = Trainer(cfg, O.OptimizerConfig(), tcfg, device="cpu")
    assert tr2.step >= 21
    log2 = tr2.run(loader.batches(5), 5)
    tr2.close()
    assert log2[-1]["step"] >= tr2.step - 1


def test_checkpointed_run_resumes_like_the_uninterrupted_run(tmp_path):
    """6 steps straight vs 3 steps, a fresh Trainer from the step-2
    checkpoint, 3 more: the same losses (bitwise on the CPU)."""
    _, cfg = _configs("minicpm-2b")
    batches = _zipf_batches(cfg, 6, seed=3)
    kw = dict(total_steps=6, ckpt_every=2, log_every=100, peak_lr=1e-2,
              warmup_steps=1)
    whole = Trainer(cfg, O.OptimizerConfig(),
                    TrainerConfig(workdir=str(tmp_path / "a"), **kw),
                    device="cpu")
    want = _losses(whole.run(iter(batches), 6))
    whole.close()
    first = Trainer(cfg, O.OptimizerConfig(),
                    TrainerConfig(workdir=str(tmp_path / "b"), **kw),
                    device="cpu")
    first.run(iter(batches[:3]), 3)
    first.close()
    second = Trainer(cfg, O.OptimizerConfig(),
                     TrainerConfig(workdir=str(tmp_path / "b"), **kw),
                     device="cpu")
    assert second.step == 3
    got = _losses(second.run(iter(batches[3:]), 3))
    second.close()
    assert got == want[3:]


def test_a_step_leaves_no_tensor_behind(tmp_path):
    """With the cycle collector off, the number of live tensors does not
    grow from step to step: no reference cycle holds a step's gradients
    (on the card each would keep a parameter-sized buffer alive)."""
    import gc
    _, cfg = _configs("minicpm-2b")
    tr = Trainer(cfg, O.OptimizerConfig(),
                 TrainerConfig(workdir=str(tmp_path), ckpt_every=0,
                               log_every=100), device="cpu")
    counts = []
    gc.collect()
    gc.disable()
    try:
        for b in _zipf_batches(cfg, 4, seed=6):
            tr.run(iter([b]), 1)
            counts.append(sum(1 for o in gc.get_objects()
                              if isinstance(o, torch.Tensor)))
    finally:
        gc.enable()
        tr.close()
    assert len(set(counts)) == 1, counts


def test_serving_after_training_records_no_graph(tmp_path):
    """A trainer's parameters keep requires_grad=False after its steps,
    so a BatchedServer on the same tensors in the same process records
    no autograd graph: its logits and cache carry no grad_fn."""
    from repro_torch.serving import BatchedServer, Request
    _, cfg = _configs("minicpm-2b")
    tr = Trainer(cfg, O.OptimizerConfig(),
                 TrainerConfig(workdir=str(tmp_path), ckpt_every=0,
                               log_every=100), device="cpu")
    tr.run(iter(_zipf_batches(cfg, 2, seed=7)), 2)
    tr.close()
    assert not any(p.requires_grad for p in _leaves(tr.params))
    server = BatchedServer(cfg, tr.params, slots=2, prompt_len=8,
                           cache_len=24, device="cpu")
    server.admit(Request(0, np.arange(1, 6, dtype=np.int32),
                         max_new_tokens=4))
    server.step()
    assert not any(t.requires_grad or t.grad_fn is not None
                   for t in _leaves(server.cache))
    logits, _ = M.decode_step(cfg, server.params, server.cache,
                              {"tokens": torch.zeros((2, 1), dtype=torch.int32)})
    assert logits.grad_fn is None and not logits.requires_grad


def test_remesh_commits_and_continues(tmp_path):
    _, cfg = _configs("minicpm-2b")
    batches = _zipf_batches(cfg, 4, seed=5)
    tr = Trainer(cfg, O.OptimizerConfig(),
                 TrainerConfig(workdir=str(tmp_path), ckpt_every=0,
                               log_every=100), device="cpu")
    tr.run(iter(batches[:2]), 2)
    before = {k: v.detach().clone() for k, v in
              zip(range(99), _leaves(tr.params))}
    tr.remesh("cpu")
    assert tr.step == 3 and tr.device.type == "cpu"
    for i, leaf in enumerate(_leaves(tr.params)):
        assert torch.equal(leaf, before[i])
    log = tr.run(iter(batches[2:]), 2)
    tr.close()
    assert [r["step"] for r in log[-2:]] == [3, 4]
    assert all(np.isfinite(r["loss"]) for r in log)


def test_trainer_defaults_to_the_card(tmp_path):
    cfg = get_arch("minicpm-2b", reduced=True)
    if torch.cuda.device_count():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, O.OptimizerConfig(),
                TrainerConfig(workdir=str(tmp_path)))


_CHILD = r"""
import json, runpy, sys
module, argv = sys.argv[1], sys.argv[2:]
sys.argv = [module] + argv
runpy.run_module(module, run_name="__main__")
print(json.dumps({"foreign": sorted(
    m for m in sys.modules
    if m in ("jax", "repro", "ml_dtypes")
    or m.startswith(("jax.", "repro.", "ml_dtypes.")))}))
"""


@pytest.mark.parametrize("arch", ["minicpm-2b", "musicgen-medium"])
def test_train_cli_runs_without_jax(tmp_path, arch):
    """``python -m repro_torch.launch.train --reduced --device cpu``
    (musicgen through the stub-frontend path) trains, checkpoints and
    leaves jax, ml_dtypes and every repro module out of sys.modules."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, "repro_torch.launch.train",
         "--arch", arch, "--reduced", "--device", "cpu", "--steps", "6",
         "--batch-size", "2", "--seq-len", "32", "--ckpt-every", "3",
         "--workdir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"foreign": []}
    assert any(line.startswith("loss ") and "over 6 steps" in line
               for line in lines), proc.stdout[-2000:]
    assert os.listdir(tmp_path / "ckpt")


def test_flash_training_is_refused_on_the_cpu():
    """attention_impl="flash" under grad raises where the reference's
    jax.grad fails, instead of cutting the q/k/v gradients."""
    from repro.kernels import ops as jops
    jq = jnp.ones((1, 2, 128, 16))
    with pytest.raises(AssertionError):          # _pallas_call_jvp_rule
        jax.grad(lambda q: jops.flash_attention(q, jq, jq).sum())(jq)
    _, cfg = _configs("minicpm-2b", attention_impl="flash")
    tp = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="_pallas_call_jvp_rule"):
        ST.value_and_grad(cfg, tp, _tb(_batch(cfg)), remat=False)
    with torch.no_grad():                      # inference still runs
        assert torch.isfinite(M.loss_fn(cfg, tp, _tb(_batch(cfg))))
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k = torch.randn(1, 2, 8, 16)
    for backend in ops.BACKENDS:
        with pytest.raises(NotImplementedError):
            ops.flash_attention(q, k, k, backend=backend)
        assert ops.flash_attention(q.detach(), k, k, backend=backend) \
            .shape == q.shape
