"""``make_compressed_allreduce`` over a gloo process group of world 8,
a (4, 2) ("pod", "data") ``DeviceMesh``, against the stacked-pod
``compressed_psum_leaf`` (itself held against the JAX package's in
``test_torch_optimizer.py``).

Each rank holds its pod's leaves (drawn from the pod's seed) and a
generator seeded alike on every rank.  Checks, on every rank:
- the mean over pods is bitwise ``compressed_psum_leaf`` of the four
  pods' leaves stacked, leaf by leaf in the tree's order;
- with the same leaves on every pod (the reference's test), the mean
  stays within 0.02 of the input, relative to its largest magnitude.
"""

import json
import os

import pytest

from test_torch_trainer_mesh import run_ranks

RANK_SCRIPT = r"""
import json, os, sys
rank, work = int(sys.argv[1]), sys.argv[2]
sys.path.insert(0, SRC)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(work, "store"), WORLD), rank=rank, world_size=WORLD)
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.compression import (
    compressed_psum_leaf, make_compressed_allreduce)
mesh = make_mesh((4, 2), ("pod", "data"), "cpu")
fn = make_compressed_allreduce(mesh, axis="pod")

def leaves(seed):
    rng = np.random.default_rng(seed)
    return {"a": torch.tensor(rng.normal(size=(2048,)), dtype=torch.float32),
            "b": torch.tensor(rng.normal(size=(3, 300)) * 5,
                              dtype=torch.float32)}

pod = mesh.get_coordinate()[0]
got = fn(leaves(100 + pod), torch.Generator().manual_seed(7))
pods = [leaves(100 + p) for p in range(4)]
gen = torch.Generator().manual_seed(7)
want = {k: compressed_psum_leaf(torch.stack([t[k] for t in pods]), gen)
        for k in ("a", "b")}
same = all(torch.equal(got[k], want[k]) for k in want)
tree = leaves(0)
rep = fn(tree, torch.Generator().manual_seed(3))
err = max(float((rep[k] - tree[k]).abs().max() / tree[k].abs().max())
          for k in tree)
with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
    json.dump({"same": same, "err": err, "pod": pod}, f)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.mark.slow
def test_compressed_allreduce_on_a_pod_mesh_is_the_stacked_mean(tmp_path):
    run_ranks(RANK_SCRIPT, tmp_path)
    res = [json.load(open(os.path.join(tmp_path, f"rank{r}.json")))
           for r in range(8)]
    assert sorted(r["pod"] for r in res) == [0, 0, 1, 1, 2, 2, 3, 3]
    assert all(r["same"] for r in res), res
    assert all(r["err"] < 0.02 for r in res), res
