"""Device meshes and the H100's roofline constants.

Port of ``repro/launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` (PyTorch's counterpart of
a ``jax.sharding.Mesh``), which needs a default process group of the
right world size:

  * on the card, an NCCL group (``make_mesh`` starts a world-1 group
    by itself when the mesh has one device);
  * in the tests, gloo groups of several CPU processes;
  * in the dry run (``launch/dryrun.py``), the fake process group of
    world 512 that stands in for the reference's 512 placeholder host
    devices.  Nothing here starts that group.

``make_abstract_mesh`` needs no process group at all: it carries the
axis names and sizes that the sharding rules read.

The triples-mode bridge: ``mesh_from_triples`` maps the paper's
(nodes, NPPN, threads) launch triple onto mesh axes — nodes -> pod
axis, NPPN -> data axis, threads x chips -> model axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.triples import TriplesConfig

# NVIDIA H100 SXM5 80 GB, datasheet figures (NVIDIA H100 Tensor Core GPU
# datasheet): the roofline denominators, per GPU.
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # HBM3 bytes/s
H100_HBM_BYTES = 80e9           # HBM3 capacity, bytes
# The collective term's link: one 400 Gb/s NDR InfiniBand port per GPU,
# as in a DGX H100.  Every 16-wide axis of the production meshes spans
# two 8-GPU nodes, so this inter-node rate bounds its collectives.
LINK_BW = 50e9                  # bytes/s per GPU
# NVLink 4 within an 8-GPU node (datasheet: 900 GB/s bidirectional).
# Unused: no 16-wide axis stays inside one node.
NVLINK_BW = 450e9               # bytes/s per direction per GPU

SINGLE_POD_SHAPE = (16, 16)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class _Devices:
    size: int


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices: what the sharding rules read
    (the counterpart of ``jax.sharding.AbstractMesh``)."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def devices(self) -> _Devices:
        return _Devices(self.size)


def make_abstract_mesh(shape: tuple[int, ...],
                       axes: tuple[str, ...]) -> AbstractMesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def abstract(mesh) -> AbstractMesh:
    """The axis names and sizes of a ``DeviceMesh`` (or an abstract
    mesh, returned as it is)."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return make_abstract_mesh(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def start_single_process_group(backend: str = "nccl") -> None:
    """A world-1 default process group (NCCL for the card, "gloo" for
    the CPU) over a ``FileStore`` in a fresh temporary directory."""
    if dist.is_initialized():
        return
    path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    dist.init_process_group(backend, store=dist.FileStore(path, 1),
                            rank=0, world_size=1)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda", *,
              ranks: Optional[list[int]] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group's ranks (the first ``prod(shape)``, or ``ranks``; the
    elastic re-mesh after worker loss uses this).  Without a group it
    starts a world-1 group when the mesh has one device, and raises
    otherwise, as ``jax.make_mesh`` raises when devices are too few.
    The card unless ``device_type`` names another ("cpu"); without a
    card a "cuda" mesh raises."""
    from torch.distributed.device_mesh import DeviceMesh
    if device_type == "cuda" and not torch.cuda.device_count():
        raise RuntimeError("no CUDA device; pass device_type='cpu' "
                           "for a CPU mesh")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"a mesh of {n} devices needs a process group of world "
                f"size {n}; start one (torch.distributed."
                f"init_process_group) first")
        start_single_process_group("gloo" if device_type == "cpu"
                                   else "nccl")
    world = dist.get_world_size()
    ranks = list(range(n)) if ranks is None else list(ranks)
    if len(ranks) != n or max(ranks) >= world:
        raise ValueError(
            f"mesh {tuple(shape)} needs {n} of the process group's "
            f"{world} ranks, got {ranks}")
    return DeviceMesh(device_type,
                      torch.tensor(ranks, dtype=torch.int64).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ("data", "model") over ranks 0-255, or (2, 16, 16)
    ("pod", "data", "model") over all 512, on the dry run's fake
    process group of world 512 (see ``launch/dryrun.py``)."""
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    axes = MULTI_POD_AXES if multi_pod else SINGLE_POD_AXES
    return make_mesh(shape, axes, "cpu")


@contextlib.contextmanager
def mesh_context(mesh):
    """``with mesh_context(mesh):`` — plain tensors made inside the
    model (RoPE tables, masks, positions) meet the DTensor parameters
    as replicated tensors (``implicit_replication``), the nearest
    counterpart of ``jax.set_mesh``."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield mesh


def mesh_from_triples(cfg: TriplesConfig, chips_per_node: int = 4,
                      pods: int = 1, device_type: str = "cuda"):
    """Map a triples-mode request onto a device mesh.

    nodes x nppn x (threads x chips) must equal the available device
    count (the default process group's world size, or the card count
    when there is no group); the same exclusive-mode arithmetic from
    core/triples.py validates the request before any devices are
    touched.  The mesh is on the card unless ``device_type`` names
    another ("cpu")."""
    n_devices = (dist.get_world_size() if dist.is_initialized()
                 else torch.cuda.device_count())
    shape = cfg.mesh_shape(chips_per_node)
    total = int(math.prod(shape)) * pods
    if total != n_devices:
        raise ValueError(
            f"triples {shape} x {pods} pods = {total} devices, "
            f"but {n_devices} are available")
    if pods > 1:
        return make_mesh((pods, *shape[:2], shape[2]),
                         ("pod", "nodes", "data", "model"), device_type)
    return make_mesh(shape, ("nodes", "data", "model"), device_type)
