"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

Each test runs the dry run in a fresh interpreter that never imports JAX
(the fake process group of world 512 is per process, and the port must
not pull in ``jax`` or ``repro``):
- one full-width cell per family (dense, MoE, Mamba hybrid, RWKV-6,
  audio frontend) at ``decode_32k``, on both production meshes, comes
  out ``ok`` with positive roofline terms, and its per-chip traced
  FLOPs times the chips are at least the same one-superblock step's
  FLOPs traced unsharded (sharding splits work; redistributions and
  replicated compute only add);
- the self-scheduled sweep on the threads and the processes backends at
  ``--jobs 2`` writes the same records (FLOPs, bytes, collectives);
- ``jax`` and ``repro`` stay out of ``sys.modules``.
The records' analytic bytes and ``model_flops`` are held against the
reference in ``test_torch_roofline.py``.
"""

import json
import os
import subprocess
import sys

import pytest

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

CELLS_SCRIPT = r"""
import dataclasses, json, sys
sys.path.insert(0, SRC)
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import dryrun, steps
from repro_torch.roofline.analysis import compute_terms

def unsharded_flops(cfg, shape):
    cfg1 = dataclasses.replace(cfg, n_layers=cfg.pattern_period)
    counter = FlopCounterMode(display=False)
    with counter:
        steps.make_decode_step(cfg1)(steps.param_specs(cfg1),
                                     steps.cache_specs(cfg1, shape),
                                     steps.input_specs(cfg1, shape))
    return counter.get_total_flops()

out = []
for arch in ARCHS:
    cfg = get_arch(arch)
    shape = SHAPES["decode_32k"]
    plain = unsharded_flops(cfg, shape)
    for mp in (False, True):
        rec = dryrun.run_cell(cfg, shape, mp)
        row = {"arch": arch, "mesh": rec["mesh"], "ok": rec["ok"],
               "error": rec.get("error"), "unsharded": plain}
        if rec["ok"]:
            t = compute_terms(rec)
            row.update(chips=rec["chips"], flops=rec["cost"]["flops"],
                       compute_s=t.compute_s, memory_s=t.memory_s,
                       collective_s=t.collective_s,
                       keys=sorted(rec))
        out.append(row)
out.append({"jax": "jax" in sys.modules,
            "repro": any(k == "repro" or k.startswith("repro.")
                         for k in sys.modules)})
print("CELLS " + json.dumps(out))
"""

FAMILIES = ["minicpm-2b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
            "rwkv6-3b", "musicgen-medium"]

# The reference record's keys, with graph_nodes for hlo_bytes.
RECORD_KEYS = sorted(
    "arch shape mesh kind ok n_superblocks params active_params "
    "model_flops chips param_bytes_per_chip cache_bytes_per_chip cost "
    "collectives graph_nodes block_cost block_collectives compile_s "
    "total_s memory".split())


def _run(script: str, timeout: int = 600) -> str:
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=timeout,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


@pytest.mark.slow
def test_one_cell_per_family_on_both_meshes():
    script = CELLS_SCRIPT.replace("SRC", repr(SRC)).replace(
        "ARCHS", repr(FAMILIES))
    line = next(ln for ln in _run(script).splitlines()
                if ln.startswith("CELLS "))
    rows = json.loads(line[len("CELLS "):])
    mods = rows.pop()
    assert mods == {"jax": False, "repro": False}
    assert len(rows) == 2 * len(FAMILIES)
    for r in rows:
        assert r["ok"], r
        assert r["compute_s"] > 0 and r["memory_s"] > 0, r
        assert r["collective_s"] > 0, r      # FSDP gathers at least
        assert r["flops"] * r["chips"] >= r["unsharded"], r
        assert r["keys"] == RECORD_KEYS, r["keys"]
    assert {r["mesh"] for r in rows} == {"16x16", "2x16x16"}


SWEEP_SCRIPT = r"""
import sys
sys.path.insert(0, SRC)
from repro_torch.launch import dryrun
dryrun.main(["--arch", "musicgen-medium", "--shape", "decode_32k",
             "--multi-pod", "both", "--jobs", "2", "--exec-backend",
             BACKEND, "--out", OUT])
print("SWEEP", "jax" in sys.modules,
      any(k == "repro" or k.startswith("repro.") for k in sys.modules))
"""


def _records(path) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name)) as f:
            rec = json.load(f)
        assert rec["ok"], (name, rec.get("error"), rec.get("traceback"))
        out[name] = {k: rec[k] for k in ("ok", "cost", "collectives",
                                         "memory", "block_cost",
                                         "param_bytes_per_chip")}
    return out


@pytest.mark.slow
def test_sweep_on_threads_and_processes_at_two_jobs(tmp_path):
    got = {}
    for backend in ("threads", "processes"):
        out = tmp_path / backend
        script = SWEEP_SCRIPT.replace("SRC", repr(SRC)).replace(
            "BACKEND", repr(backend)).replace("OUT", repr(str(out)))
        text = _run(script)
        assert "SWEEP False False" in text, text[-2000:]
        got[backend] = _records(out)
        assert sorted(got[backend]) == [
            "musicgen-medium__decode_32k__16x16.json",
            "musicgen-medium__decode_32k__2x16x16.json"]
        assert all(r["ok"] for r in got[backend].values())
    assert got["threads"] == got["processes"]
    # an existing record is skipped
    script = SWEEP_SCRIPT.replace("SRC", repr(SRC)).replace(
        "BACKEND", repr("threads")).replace(
        "OUT", repr(str(tmp_path / "threads")))
    assert _run(script).count("[skip]") == 2


def test_start_fake_group_refuses_another_backend():
    script = r"""
import os, sys, tempfile
sys.path.insert(0, SRC)
import torch.distributed as dist
from repro_torch.launch import dryrun
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(tempfile.mkdtemp(), "s"), 1), rank=0, world_size=1)
try:
    dryrun.start_fake_group()
except RuntimeError as e:
    print("REFUSED", "'gloo' group of world 1" in str(e))
rec = dryrun.run_cell(dryrun.get_arch("musicgen-medium"),
                      dryrun.SHAPES["decode_32k"], False)
print("CELL", rec["ok"], "gloo" in rec["error"])
dist.destroy_process_group()
""".replace("SRC", repr(SRC))
    text = _run(script, timeout=120)
    assert "REFUSED True" in text and "CELL False True" in text, text


@pytest.mark.parametrize("T,chunk", [(64, 16), (60, 16), (256, 256),
                                     (7, 4), (1024, 256)])
def test_mamba_chunks_scanned_together_are_bitwise_the_loop(T, chunk):
    """The DTensor path's Mamba scan (every chunk's associative scan at
    once) gives the plain loop's values bit for bit."""
    import torch
    from repro_torch.models import ssm
    g = torch.Generator().manual_seed(T)
    a = torch.rand((2, T, 3, 4), generator=g)
    bx = torch.randn((2, T, 3, 4), generator=g)
    assert torch.equal(ssm._selective_scan(a, bx, chunk),
                       ssm._selective_scan_chunks_together(a, bx, chunk))
