"""``Trainer(mesh=...)`` on a gloo process group of world 8, the port's
counterpart of the reference's elastic re-mesh test
(``tests/test_checkpoint_trainer.py::test_elastic_remesh_subprocess``).

Eight CPU processes build a (4, 2) ("data", "model") ``DeviceMesh`` and
train reduced minicpm-2b in f32 for 10 steps on seeded batches (every
rank feeds the same global batch); then they re-mesh onto a (2, 2) mesh
of ranks 0-3 (ranks 4-7 drop out) and train 10 more steps.  Rank 0 also
trains the one-device port ``Trainer`` on the same batches.  Checks:
- the mesh run's first 5 losses equal the one-device run's within rtol
  1e-5 (f32; the sharded sums add in another order);
- the re-meshed trainer reaches step >= 20 with finite losses;
- ``jax`` and ``repro`` stay out of ``sys.modules``.
Also: checkpoints cross between a mesh Trainer and a device Trainer,
both ways, bitwise.
"""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORLD = 8
LOSS_RTOL = 1e-5

RANK_SCRIPT = r"""
import dataclasses, json, os, sys
rank, work = int(sys.argv[1]), sys.argv[2]
sys.path.insert(0, SRC)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(work, "store"), WORLD), rank=rank, world_size=WORLD)
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
cfg = dataclasses.replace(get_arch("minicpm-2b", reduced=True),
                          param_dtype="float32", activation_dtype="float32")
toks = np.random.default_rng(0).integers(
    0, cfg.vocab_size, size=(20, 8, 65), dtype=np.int32)
batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
kw = dict(total_steps=40, ckpt_every=5, log_every=100)
mesh8 = make_mesh((4, 2), ("data", "model"), "cpu")
tr = Trainer(cfg, OptimizerConfig(),
             TrainerConfig(workdir=os.path.join(work, "mesh"), **kw),
             mesh=mesh8)
tr.run(iter(batches[:10]), 10)
mesh_losses = [r["loss"] for r in tr.metrics_log]
# lose half the data-parallel workers -> re-mesh to 2x2
mesh4 = make_mesh((2, 2), ("data", "model"), "cpu", ranks=[0, 1, 2, 3])
tr.remesh(mesh4)
assert tr.mesh is mesh4 and tr.active == (rank < 4)
tr.run(iter(batches[10:20]), 10)
tr.close()
out = {"mesh": mesh_losses,
       "after": [r["loss"] for r in tr.metrics_log[10:]], "step": tr.step}
if rank == 0:
    one = Trainer(cfg, OptimizerConfig(),
                  TrainerConfig(workdir=os.path.join(work, "one"), **kw),
                  device="cpu")
    one.run(iter(batches[:10]), 10)
    one.close()
    out["one"] = [r["loss"] for r in one.metrics_log]
out["jax"] = "jax" in sys.modules
out["repro"] = any(k == "repro" or k.startswith("repro.")
                   for k in sys.modules)
with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(script: str, work, world: int = WORLD, timeout: int = 300):
    """``script`` in ``world`` processes (argv: rank, work dir); their
    outputs' tails on failure."""
    path = os.path.join(work, "rank.py")
    with open(path, "w") as f:
        f.write(script.replace("SRC", repr(SRC)).replace(
            "WORLD", str(world)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, path, str(r), str(work)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, log[-2000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, bad


@pytest.mark.slow
def test_mesh_trainer_matches_one_device_and_remeshes(tmp_path):
    run_ranks(RANK_SCRIPT, tmp_path)
    res = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(WORLD)]
    r0 = res[0]
    for a, b in zip(r0["mesh"][:5], r0["one"][:5]):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (r0["mesh"], r0["one"])
    # every rank saw the same losses before the re-mesh
    assert all(r["mesh"] == r0["mesh"] for r in res)
    for r in res[:4]:
        assert r["step"] >= 20
        assert len(r["after"]) == 10
        assert all(math.isfinite(x) for x in r["after"])
        assert r["after"] == r0["after"]
    for r in res[4:]:
        assert r["after"] == []          # dropped out at the re-mesh
    assert not any(r["jax"] or r["repro"] for r in res)


CROSS_SCRIPT = r"""
import dataclasses, os, sys
work = sys.argv[2]
sys.path.insert(0, SRC)
import numpy as np
import torch
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
from repro_torch.train.trainer import Trainer, TrainerConfig
cfg = dataclasses.replace(get_arch("minicpm-2b", reduced=True),
                          param_dtype="float32", activation_dtype="float32")
toks = np.random.default_rng(1).integers(
    0, cfg.vocab_size, size=(6, 4, 33), dtype=np.int32)
batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
tcfg = TrainerConfig(workdir=work, total_steps=10, ckpt_every=2,
                     log_every=100)
mesh = make_mesh((1, 1), ("data", "model"), "cpu")   # a world-1 gloo group

def whole(tree):
    return [t.full_tensor() if hasattr(t, "full_tensor") else t
            for t in tree_leaves(tree)]

# written on a mesh, restored onto the CPU device
a = Trainer(cfg, OptimizerConfig(), tcfg, mesh=mesh)
a.run(iter(batches[:3]), 3)
a.close()
b = Trainer(cfg, OptimizerConfig(), tcfg, device="cpu")
assert b.step == 3, b.step
assert all(torch.equal(x, y) for x, y in zip(whole(a.params),
                                             whole(b.params)))
# written on the device, restored onto the mesh
b.run(iter(batches[3:5]), 2)
b.close()
c = Trainer(cfg, OptimizerConfig(), tcfg, mesh=mesh)
assert c.step == 5, c.step
assert all(torch.equal(x, y) for x, y in zip(whole(b.params),
                                             whole(c.params)))
assert all(torch.equal(x, y) for x, y in zip(whole(b.opt_state),
                                             whole(c.opt_state)))
print("CROSS_OK")
"""


def test_checkpoints_cross_between_mesh_and_device(tmp_path):
    """A checkpoint written by a mesh Trainer (DTensor leaves saved
    whole) restores onto a device, and one written on a device restores
    onto a mesh, bitwise (a world-1 gloo group in a subprocess)."""
    script = CROSS_SCRIPT.replace("SRC", repr(SRC))
    r = subprocess.run([sys.executable, "-c", script, "0", str(tmp_path)],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert "CROSS_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-2000:]


# The model's other arms and the int8 moments on the (4, 2) mesh: each
# resumes a checkpoint written by the reference's Trainer.
ARMS = {"qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
        "jamba-v0.1-52b": ("jamba-v0.1-52b", {}),
        "rwkv6-3b": ("rwkv6-3b", {}),
        "musicgen-medium": ("musicgen-medium", {}),
        "minicpm-2b-int8": ("minicpm-2b", {"state_dtype": "int8"})}
ARM_KW = dict(total_steps=20, ckpt_every=1, log_every=100, peak_lr=1e-2,
              warmup_steps=2)
# Steps run from the reference checkpoint: the loss of the restored
# parameters, and the loss after one update from the restored moments.
# Not more: an early AdamW step turns each gradient entry near zero whose
# sign differs in its last bit into a whole +-lr change, and by the third
# resumed step rwkv6's loss differs by 1.7e-4 relative between the
# reference and the one-device port as much as between either and the
# mesh.
ARM_RESUMED = 2
ARM_LOSS_RTOL = 1e-5            # f32; the sharded sums add in another order

ARMS_SCRIPT = r"""
import dataclasses, json, os, sys
rank, work = int(sys.argv[1]), sys.argv[2]
sys.path.insert(0, SRC)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(work, "store"), WORLD), rank=rank, world_size=WORLD)
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
spec = json.load(open(os.path.join(work, "arms.json")))
mesh = make_mesh((4, 2), ("data", "model"), "cpu")

def trainer(arm, where, **kw):
    name, opt = spec["arms"][arm]
    cfg = dataclasses.replace(get_arch(name, reduced=True),
                              param_dtype="float32",
                              activation_dtype="float32")
    return Trainer(cfg, OptimizerConfig(**opt), TrainerConfig(
        workdir=os.path.join(work, arm, where), **spec["kw"]), **kw)

def batches(arm):
    z = np.load(os.path.join(work, arm, "batches.npz"))
    keys = [k for k in ("tokens", "embeds", "labels") if k in z]
    return [{k: z[k][i] for k in keys} for i in range(len(z["labels"]))]

out = {}
for arm in spec["arms"]:
    tr = trainer(arm, "mesh", mesh=mesh)
    start = tr.step
    tr.run(iter(batches(arm)), len(batches(arm)))
    tr.close()
    out[arm] = {"start": start, "mesh": [r["loss"] for r in tr.metrics_log],
                "steps": [r["step"] for r in tr.metrics_log]}
# ranks 0-4 each run one arm's one-device Trainer at the same time
arms = list(spec["arms"])
if rank < len(arms):
    arm = arms[rank]
    one = trainer(arm, "one", device="cpu")
    one.run(iter(batches(arm)), len(batches(arm)))
    one.close()
    out[arm]["one"] = [r["loss"] for r in one.metrics_log]
out["jax"] = "jax" in sys.modules
out["repro"] = any(k == "repro" or k.startswith("repro.")
                   for k in sys.modules)
with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def _arm_batches(cfg, n, B=8, T=16, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (n, B, T))
           .astype(np.int32)}
    if cfg.frontend is not None:
        out["embeds"] = rng.normal(size=(n, B, T, cfg.d_model)) \
            .astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (n, B, T)) \
            .astype(np.int32)
    return out


@pytest.fixture(scope="module")
def arm_runs(tmp_path_factory):
    """The reference's Trainer trains each arm 2 steps (a checkpoint
    after step 1), then ARM_RESUMED more: its losses from step 2 on.
    Eight gloo ranks resume that checkpoint on a (4, 2) mesh and train
    the same steps; ranks 0-4 also resume it on one CPU device."""
    import jax
    from repro.configs import get_arch as jax_get_arch
    from repro.train import optimizer as JO
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig
    work = tmp_path_factory.mktemp("arms")
    ref = {}
    for arm, (name, opt) in ARMS.items():
        jcfg = dataclasses.replace(jax_get_arch(name, reduced=True),
                                   param_dtype="float32",
                                   activation_dtype="float32")
        z = _arm_batches(jcfg, 2 + ARM_RESUMED)
        os.makedirs(work / arm)
        np.savez(work / arm / "batches.npz",
                 **{k: v[2:] for k, v in z.items()})
        seq = [{k: v[i] for k, v in z.items()} for i in range(2 + ARM_RESUMED)]
        jt = JTrainer(jcfg, JO.OptimizerConfig(**opt),
                      JTrainerConfig(workdir=str(work / arm / "ref"),
                                     **ARM_KW))
        jt.run(iter(seq[:2]), 2)
        jt.async_ckpt.wait()                  # the checkpoint of step 1
        for where in ("mesh", "one"):
            shutil.copytree(work / arm / "ref", work / arm / where)
        jt.run(iter(seq[2:]), ARM_RESUMED)
        jt.close()
        ref[arm] = {"loss": [r["loss"] for r in jt.metrics_log[2:]],
                    "steps": [r["step"] for r in jt.metrics_log[2:]]}
        jax.clear_caches()
    with open(work / "arms.json", "w") as f:
        json.dump({"arms": ARMS, "kw": ARM_KW}, f)
    run_ranks(ARMS_SCRIPT, work)
    res = [json.load(open(work / f"rank{r}.json")) for r in range(WORLD)]
    return ref, res


@pytest.mark.slow
@pytest.mark.parametrize("arm", list(ARMS))
def test_mesh_trainer_arm_resumes_a_reference_checkpoint(arm, arm_runs):
    """MoE routing, Mamba's chunked scan and conv, RWKV-6's WKV, the
    frontend's embeds and the int8 moments, run with values on a
    (4, 2) gloo mesh: the losses of the steps resumed from the reference
    Trainer's checkpoint equal the reference's own and the one-device
    port Trainer's within ARM_LOSS_RTOL."""
    ref, res = arm_runs
    r0 = res[0][arm]
    assert r0["start"] == 2
    assert r0["steps"] == ref[arm]["steps"] == [2, 3]
    one = next(r[arm]["one"] for r in res if "one" in r[arm])
    np.testing.assert_allclose(r0["mesh"], ref[arm]["loss"],
                               rtol=ARM_LOSS_RTOL)
    np.testing.assert_allclose(one, ref[arm]["loss"], rtol=ARM_LOSS_RTOL)
    np.testing.assert_allclose(r0["mesh"], one, rtol=ARM_LOSS_RTOL)
    assert all(r[arm]["mesh"] == r0["mesh"] for r in res)
    assert not any(r["jax"] or r["repro"] for r in res)
