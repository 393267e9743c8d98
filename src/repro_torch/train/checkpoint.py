"""Checkpointing with atomic commit, async save, auto-resume.

Port of ``repro/train/checkpoint.py``, in its on-disk layout (one
directory per step), so each package restores the other's checkpoints::

    <dir>/step_000000123/
        manifest.json          # step, n_leaves, treedef, shapes, dtypes
        leaf_00000.npy ...     # one file per leaf, JAX's leaf order
    <dir>/step_000000123.COMMITTED  # commit marker, written last

Leaves are numbered in the JAX package's order (dict keys sorted).
numpy has no bfloat16 without ``ml_dtypes``: a bf16 leaf is saved as
2-byte void (its bits), with ``"bfloat16"`` in the manifest, and read
back by view-casting those bits, as the reference does.  The
``treedef`` string is the port's own description of the tree.

Fault-tolerance contract:
  * a crash mid-save leaves no COMMITTED marker => restore ignores it;
  * saves run on a background thread (training continues) from a host
    copy taken before the save is queued;
  * restore places the leaves on any device (``device=``), which is
    what the trainer's ``remesh`` uses;
  * a DTensor leaf (a trainer on a device mesh) is saved whole
    (``full_tensor()``, a collective every rank of its mesh joins) and
    written by rank 0 alone, so a checkpoint written on a mesh restores
    onto a device and the other way round; ``restore`` places leaves by
    the trainer's shardings as it reads them.  Both go one leaf at a
    time.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distribution.sharding import distribute
from repro_torch.models.layers import is_dtensor
from repro_torch.models.model import tree_map
from repro_torch.train.optimizer import tree_leaves, tree_unflatten


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as the host array to save and its manifest dtype."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _load_leaf(path: str, dtype_str: str) -> torch.Tensor:
    arr = np.load(path)
    if arr.dtype.kind == "V" and dtype_str == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def _whole(t):
    """A DTensor gathered whole (every rank of its mesh calls this);
    anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _writer() -> bool:
    """Only rank 0 writes when a process group is up."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def _treedef(tree) -> str:
    """The tree's structure with ``*`` for each leaf, keys sorted."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Synchronous save with atomic commit.  Rank 0 writes; every rank
    joins the gathers of DTensor leaves, one leaf at a time, so that one
    whole leaf at most is alive beside the shards."""
    leaves = tree_leaves(tree)
    tag = f"step_{step:09d}"
    tmp = os.path.join(ckpt_dir, tag + ".tmp")
    final = os.path.join(ckpt_dir, tag)
    if not _writer():
        for x in leaves:
            _whole(x)
        return final
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": _treedef(tree),
                "leaves": []}
    for i, x in enumerate(leaves):
        arr, dtype = _to_numpy(torch.as_tensor(_whole(x)))
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append(
            {"shape": list(arr.shape), "dtype": dtype})
        del arr
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    # commit marker LAST: restore only trusts marked checkpoints
    open(final + ".COMMITTED", "w").close()
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(list_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        tag = os.path.join(ckpt_dir, f"step_{s:09d}")
        for p in (tag + ".COMMITTED", tag):
            if os.path.isdir(p):
                shutil.rmtree(p)
            elif os.path.exists(p):
                os.remove(p)


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.COMMITTED", name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name[:-10])):
            out.append(int(m.group(1)))
    return sorted(out)


def restore(ckpt_dir: str, step: int, template: Any,
            device: Optional[Any] = None, shardings: Any = None) -> Any:
    """Restore a step into the template's tree structure (any leaves:
    tensors, meta tensors or arrays), as tensors on ``device`` (default:
    the host).  ``shardings`` (a tree of ``NamedSharding`` like the
    template's) places each leaf on its mesh as it is read, so that one
    whole leaf at most is alive beside the shards."""
    tag = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(tag, "manifest.json")) as f:
        manifest = json.load(f)
    n = manifest["n_leaves"]
    shs = [None] * n if shardings is None else tree_leaves(shardings)
    leaves = []
    for i in range(n):
        x = _load_leaf(os.path.join(tag, f"leaf_{i:05d}.npy"),
                       manifest["leaves"][i]["dtype"])
        if device is not None:
            x = x.to(device)
        leaves.append(x if shs[i] is None else distribute(x, shs[i]))
    return tree_unflatten(template, leaves)


def restore_latest(ckpt_dir: str, template: Any,
                   device: Optional[Any] = None, shardings: Any = None
                   ) -> tuple[Optional[Any], int]:
    steps = list_steps(ckpt_dir)
    if not steps:
        return None, -1
    step = steps[-1]
    return restore(ckpt_dir, step, template, device, shardings), step


def _host_copy(x) -> Optional[torch.Tensor]:
    """A host copy that later in-place updates of ``x`` cannot reach
    (on the CPU, ``.cpu()`` and ``.numpy()`` would share its memory);
    None on a rank that does not write, once it has joined the gather."""
    whole = _whole(x)
    if not _writer():
        return None
    return torch.as_tensor(whole).detach().to("cpu", copy=True)


class AsyncCheckpointer:
    """Background-thread checkpointing; at most one save in flight."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, tree = item
                try:
                    save(self.ckpt_dir, step, tree, keep=self.keep)
                except Exception as e:       # surfaced on next save/close
                    self._err = e
            finally:
                self._q.task_done()

    def save_async(self, step: int, tree: Any) -> None:
        if self._err:
            raise RuntimeError("previous async save failed") from self._err
        # Copy to the host BEFORE queueing: training updates in place.
        self._q.put((step, tree_map(_host_copy, tree)))

    def wait(self) -> None:
        self._q.join()

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10)
        if self._err:
            raise RuntimeError("async save failed") from self._err

