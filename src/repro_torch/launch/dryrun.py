"""Multi-pod dry run: trace every (arch x shape x mesh) cell, no device.

Port of ``repro/launch/dryrun.py``.  The reference compiles each cell
for 512 placeholder host devices (``--xla_force_host_platform_device_
count=512``); the port runs each cell's step on DTensors over PyTorch's
fake process group of world 512, whose collectives do nothing, with
meta tensors as the local shards.  Nothing is allocated and no device
is touched.  Each worker process starts that group once, before its
first cell (:func:`start_fake_group`); importing this module starts
nothing.

For every cell the dry run:
  1. builds the meta specs of params / optimizer state / caches
     (``launch/steps.py``);
  2. derives shardings from the ``distribution.sharding`` rules and
     makes DTensors of them;
  3. runs the step (train: ``value_and_grad`` + ``apply_updates``;
     prefill / decode: ``make_prefill_step`` / ``make_decode_step``)
     with the trunk cut to ONE superblock, recording rank 0's local
     program as an FX graph (``roofline/trace.py``);
  4. records that graph's FLOPs (``FlopCounterMode``), bytes accessed
     (unfused), peak temporary bytes (a liveness walk) and collective
     traffic (``roofline/graph_parse.py``);
  5. separately traces ONE superblock (fwd, and for train fwd + its
     gradient and its optimizer update) with the same shardings, so
     that totals compose as the reference's do: full +
     (n_superblocks - 1) * block;
  6. writes a JSON record to --out.

The record has the reference's keys, with ``graph_nodes`` (the traced
graph's node count) where the reference has ``hlo_bytes``.  ``cost``
and ``memory`` are the port's own counts from the traced graph, not
XLA's ``cost_analysis()`` / ``memory_analysis()``: ``bytes accessed``
counts every op's inputs and outputs unfused (an upper bound on a
fusing compiler's), ``argument_size_in_bytes`` comes from the specs
and ``temp_size_in_bytes`` from the liveness walk.  The per-chip bytes
are the reference's analytic ``_sharded_bytes``.  Where an op has no
sharding strategy the model redistributes its inputs (see
``models/model.py``); those collectives are in the counts.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --out experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import threading
import time
import traceback
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_arch, shapes_for
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.core.messages import Task
from repro_torch.distribution.sharding import (
    NamedSharding, P, _axes, batch_shardings, batch_spec, cache_shardings,
    opt_state_shardings, param_shardings, tree_map_shardings)
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh, mesh_context
from repro_torch.models import model as M
from repro_torch.roofline.graph_parse import collective_bytes
from repro_torch.roofline.trace import LocalTrace
from repro_torch.train.optimizer import (
    OptimizerConfig, apply_updates, init_opt_state, tree_leaves,
    tree_unflatten)

F32 = torch.float32
WORLD = 512

# One cell at a time in a process: the fake group starts once, and
# DTensor's implicit replication is a process-wide switch, so the
# threads backend's workers take turns.
_TRACE_LOCK = threading.Lock()
_MESHES: dict[bool, Any] = {}


def start_fake_group() -> None:
    """The fake process group of world 512 (rank 0), once per process.
    Raises if a default group of another backend already exists."""
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake" or dist.get_world_size() != WORLD:
            raise RuntimeError(
                f"the dry run needs the fake process group of world "
                f"{WORLD}, but this process already has a {backend!r} "
                f"group of world {dist.get_world_size()}")
        return
    # DTensor warns at every reduction over two mesh dims ("2 sequential
    # all_reduce operations"); the counts hold what it sends.
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    # Internal to PyTorch (torch.testing): the one import of it.
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)


def production_mesh(multi_pod: bool):
    """The production mesh, built once per process."""
    if multi_pod not in _MESHES:
        start_fake_group()
        _MESHES[multi_pod] = make_production_mesh(multi_pod=multi_pod)
    return _MESHES[multi_pod]


def _j(obj):
    """JSON-safe."""
    if isinstance(obj, dict):
        return {k: _j(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_j(v) for v in obj]
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    return str(obj)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6*N*D (train) / 2*N*D (serve), N = active params, D = tokens."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch * 1.0      # decode: one token


def _sharded_bytes(specs, shardings, mesh) -> int:
    """Analytic per-chip bytes for a sharded tree of meta tensors (the
    reference's ``_sharded_bytes``)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape)) \
        if hasattr(mesh, "mesh_dim_names") else mesh.shape
    leaves = tree_leaves(specs)
    shs = tree_leaves(shardings)
    total = 0
    for leaf, sh in zip(leaves, shs):
        n = 1
        for d in leaf.shape:
            n *= d
        div = 1
        for axes in sh.spec:
            for a in _axes(axes):
                div *= sizes[a]
        total += (n // max(div, 1)) * leaf.element_size()
    return total


# ---------------------------------------------------------------------------
# Tracing on the fake mesh
# ---------------------------------------------------------------------------

def _local_meta(t: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    shape = list(t.shape)
    for pl, n in zip(sh.placements, sh.mesh.shape):
        if pl.is_shard():
            shape[pl.dim] //= n
    return torch.empty(shape, dtype=t.dtype, device="meta")


def _dtensors(trace: LocalTrace, tree, shardings):
    from torch.distributed.tensor import DTensor

    def one(t, sh):
        local = trace.input(_local_meta(t, sh))
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return tree_map_shardings(one, tree, shardings)


def _place(x, sh: NamedSharding):
    """Redistribute an output DTensor to its target sharding (the
    reference's ``out_shardings``); a plain tensor made inside the step
    counts as replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, sh.mesh, [Replicate()] * sh.mesh.ndim,
                               run_check=False)
    return x.redistribute(sh.mesh, sh.placements)


def _traced(fn, args: list, mesh) -> LocalTrace:
    """Run ``fn`` on DTensors made of (tree, shardings) pairs, recording
    the local program."""
    trace = LocalTrace()
    dts = [_dtensors(trace, tree, sh) for tree, sh in args]
    with mesh_context(mesh):
        fn(*dts)
    return trace


def _cost(trace: LocalTrace) -> dict:
    return {"flops": trace.flops(),
            "bytes accessed": trace.bytes_accessed()}


def _one_superblock(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, n_layers=cfg.pattern_period)


def _strip(shardings):
    """Shardings with the leading (stacked superblock) entry dropped."""
    if isinstance(shardings, dict):
        return {k: _strip(v) for k, v in shardings.items()}
    return NamedSharding(shardings.mesh, P(*tuple(shardings.spec)[1:]))


def _strip_specs(specs):
    return M.tree_map(lambda x: torch.empty(tuple(x.shape[1:]),
                                            dtype=x.dtype, device="meta"),
                      specs)


def run_cell(cfg: ArchConfig, shape: ShapeConfig, multi_pod: bool,
             opt_cfg: Optional[OptimizerConfig] = None,
             measure_block: bool = True,
             remat: bool = True) -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: dict[str, Any] = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "kind": shape.kind, "ok": False,
        "n_superblocks": cfg.n_superblocks,
        "params": cfg.param_count(),
        "active_params": cfg.param_count(active_only=True),
        "model_flops": model_flops(cfg, shape),
    }
    opt_cfg = opt_cfg or OptimizerConfig(state_dtype="int8")
    t0 = time.time()
    try:
        with _TRACE_LOCK:
            mesh = production_mesh(multi_pod)
            rec["chips"] = mesh.size()
            rec.update(_trace_cell(cfg, shape, mesh, opt_cfg,
                                   measure_block, remat, t0))
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def _trace_cell(cfg, shape, mesh, opt_cfg, measure_block, remat,
                t0) -> dict:
    rec: dict[str, Any] = {}
    pspecs = steps.param_specs(cfg)
    psh = param_shardings(pspecs, mesh)
    batch = steps.input_specs(cfg, shape)
    bsh = batch_shardings(mesh, batch)
    rec["param_bytes_per_chip"] = _sharded_bytes(pspecs, psh, mesh)
    arg_bytes = rec["param_bytes_per_chip"] + _sharded_bytes(batch, bsh,
                                                             mesh)
    cfg1 = _one_superblock(cfg)
    p1 = steps.param_specs(cfg1)
    psh1 = param_shardings(p1, mesh)
    lsh = NamedSharding(mesh, batch_spec(mesh, shape.global_batch, 2))

    if shape.kind == "train":
        ospecs = steps.opt_state_specs(cfg, opt_cfg)
        osh = opt_state_shardings(ospecs, pspecs, psh, mesh)
        rec["opt_bytes_per_chip"] = _sharded_bytes(ospecs, osh, mesh)
        arg_bytes += rec["opt_bytes_per_chip"]
        o1 = steps.opt_state_specs(cfg1, opt_cfg)
        osh1 = opt_state_shardings(o1, p1, psh1, mesh)
        step = steps.make_train_step(cfg1, opt_cfg, remat=remat)
        trace = _traced(step, [(p1, psh1), (o1, osh1), (batch, bsh)],
                        mesh)
    else:
        cspecs = steps.cache_specs(cfg, shape)
        csh = cache_shardings(cspecs, mesh)
        rec["cache_bytes_per_chip"] = _sharded_bytes(cspecs, csh, mesh)
        c1 = steps.cache_specs(cfg1, shape)
        csh1 = cache_shardings(c1, mesh)
        if shape.kind == "prefill":
            prefill = steps.make_prefill_step(cfg1, shape.seq_len)

            def step(params, b):
                logits, cache = prefill(params, b)
                _place(logits, lsh)
                tree_map_shardings(_place, cache, csh1)
            trace = _traced(step, [(p1, psh1), (batch, bsh)], mesh)
        else:
            arg_bytes += rec["cache_bytes_per_chip"]
            decode = steps.make_decode_step(cfg1)

            def step(params, cache, b):
                logits, new = decode(params, cache, b)
                _place(logits, lsh)
                tree_map_shardings(_place, new, csh1)
            trace = _traced(step, [(p1, psh1), (c1, csh1), (batch, bsh)],
                            mesh)

    rec["compile_s"] = round(time.time() - t0, 1)
    rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                     "temp_size_in_bytes": trace.peak_temp_bytes()}
    rec["cost"] = _cost(trace)
    st = collective_bytes(trace.graph, mesh.size())
    rec["collectives"] = {
        "operand_bytes": st.operand_bytes,
        "wire_bytes": st.wire_bytes,
        "wire_bytes_total": st.total_wire_bytes,
    }
    rec["graph_nodes"] = trace.n_nodes
    if measure_block and cfg.n_superblocks > 1:
        rec.update(_measure_block(cfg1, shape, mesh, p1, psh1, opt_cfg))
    return rec


def _measure_block(cfg: ArchConfig, shape: ShapeConfig, mesh,
                   pspecs, psh, opt_cfg: OptimizerConfig) -> dict:
    """Trace one superblock under the same shardings; compose costs.
    For train cells the block also holds one superblock's optimizer
    update: the reference's full step updates every superblock's
    parameters outside its loop, so a block's share of it counts
    (n_superblocks - 1) times more, as the loop body does."""
    out: dict[str, Any] = {}
    bspecs = _strip_specs(pspecs["blocks"])
    bsh = _strip(psh["blocks"])
    B = shape.global_batch
    T = shape.seq_len if shape.kind != "decode" else 1
    adt = getattr(torch, cfg.activation_dtype)
    xspec = torch.empty((B, T, cfg.d_model), dtype=adt, device="meta")
    xsh = NamedSharding(mesh, batch_spec(mesh, B, 2))

    if shape.kind == "decode":
        cspecs = steps.cache_specs(cfg, shape)
        one_cache = _strip_specs(cspecs)
        one_csh = _strip(cache_shardings(cspecs, mesh))

        def blk(bp, cache, x):
            bp = M.gather_params(bp)
            h = x
            for i, kind in enumerate(cfg.block_pattern):
                h, nc = M._apply_sublayer_decode(
                    cfg, kind, cfg.is_moe_layer(i), bp[f"s{i}"],
                    cache[f"s{i}"], h)
                tree_map_shardings(_place, nc, one_csh[f"s{i}"])
            _place(h, xsh)
        with torch.no_grad():
            tr = _traced(blk, [(bspecs, bsh), (one_cache, one_csh),
                               (xspec, xsh)], mesh)
        out["block_cost"] = _cost(tr)
        st = collective_bytes(tr.graph, mesh.size())
        out["block_collectives"] = {"wire_bytes_total": st.total_wire_bytes}
        return out

    def fwd(bp, x):
        _place(M.superblock_apply(cfg, bp, x), xsh)
    with torch.no_grad():
        tr = _traced(fwd, [(bspecs, bsh), (xspec, xsh)], mesh)
    cost = _cost(tr)
    wire = collective_bytes(tr.graph, mesh.size()).total_wire_bytes

    if shape.kind == "train":
        def vjp_fn(bp, x, ct):
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(bp)]
            xg = x.detach().requires_grad_(True)
            with torch.enable_grad():
                y = M.superblock_apply(
                    cfg, tree_unflatten(bp, leaves), xg)
                s = torch.sum(y.to(F32) * ct.to(F32))
                grads = torch.autograd.grad(s, leaves + [xg],
                                            allow_unused=True,
                                            materialize_grads=True)
            for g, t in zip(grads, leaves + [xg]):
                _place(g, NamedSharding(mesh, _spec_of(t, mesh)))
        tr2 = _traced(vjp_fn, [(bspecs, bsh), (xspec, xsh),
                               (xspec, xsh)], mesh)
        ospecs = init_opt_state(bspecs, opt_cfg)
        osh = opt_state_shardings(ospecs, bspecs, bsh, mesh)
        tr3 = _traced(lambda p, g, o: apply_updates(p, g, o, opt_cfg),
                      [(bspecs, bsh), (bspecs, bsh), (ospecs, osh)], mesh)
        for tr_ in (tr2, tr3):
            c2 = _cost(tr_)
            for k in set(cost) | set(c2):
                cost[k] = cost.get(k, 0.0) + c2.get(k, 0.0)
            wire += collective_bytes(tr_.graph,
                                     mesh.size()).total_wire_bytes
    out["block_cost"] = cost
    out["block_collectives"] = {"wire_bytes_total": wire}
    return out


def _spec_of(t, mesh) -> P:
    """The spec of a DTensor's placements (Partial placements are
    reduced away by placing on it)."""
    entries: list = [None] * t.ndim
    for name, pl in zip(mesh.mesh_dim_names, t.placements):
        if pl.is_shard():
            prev = entries[pl.dim]
            entries[pl.dim] = (name if prev is None
                               else tuple(_axes(prev)) + (name,))
    return P(*entries)


def _compile_cell(task: Task, *, opt_cfg: OptimizerConfig,
                  measure_block: bool) -> bool:
    """Worker fn for the self-scheduled cell dispatcher (module-level so
    it pickles under the multiprocessing spawn start method)."""
    a, s, mp, path = task.payload
    print(f"[run ] {task.task_id}", flush=True)
    rec = run_cell(get_arch(a), SHAPES[s], mp, opt_cfg,
                   measure_block=measure_block)
    with open(path, "w") as f:
        json.dump(_j(rec), f, indent=1)
    status = "ok" if rec["ok"] else f"FAIL: {rec.get('error')}"
    print(f"[done] {task.task_id}: {status} ({rec['total_s']}s)",
          flush=True)
    return bool(rec["ok"])


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    choices=sorted(ARCHS) + [None], nargs="?")
    ap.add_argument("--shape", default=None,
                    choices=sorted(SHAPES) + [None], nargs="?")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--no-block", action="store_true",
                    help="skip per-superblock roofline measurement")
    ap.add_argument("--opt-state", default="int8",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--jobs", type=int, default=1,
                    help="concurrent trace workers (self-scheduled)")
    ap.add_argument("--exec-backend", default="threads",
                    choices=["threads", "processes"],
                    help="execution backend for the cell dispatcher")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    for a in archs:
        cfg = get_arch(a)
        for sh in shapes_for(cfg):
            if args.shape and sh.name != args.shape:
                continue
            cells.append((a, sh.name))

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    opt_cfg = OptimizerConfig(state_dtype=args.opt_state)

    # Each (arch x shape x mesh) cell is one self-scheduled task; sized by
    # param count so largest-first traces the heavyweight models first.
    cell_tasks: list[Task] = []
    for a, s in cells:
        for mp in meshes:
            tag = f"{a}__{s}__{'2x16x16' if mp else '16x16'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (exists)")
                continue
            cell_tasks.append(Task(
                task_id=tag, size_bytes=get_arch(a).param_count(),
                payload=(a, s, mp, path)))

    if cell_tasks:
        from repro_torch.runtime import run_job
        run_job(cell_tasks,
                functools.partial(_compile_cell, opt_cfg=opt_cfg,
                                  measure_block=not args.no_block),
                backend=args.exec_backend, n_workers=args.jobs,
                organization="largest_first", poll_interval=0.05)


if __name__ == "__main__":
    main()
