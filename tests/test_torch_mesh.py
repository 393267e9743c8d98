"""The port's mesh tools (``repro_torch.launch.mesh``) beside the JAX
package's ``repro.launch.mesh``: abstract meshes, the triples bridge's
arithmetic and errors, and a real ``DeviceMesh`` over a gloo process
group (in a subprocess, so that no group outlives the test)."""

import os
import subprocess
import sys

import pytest
import torch

from repro.core.triples import TriplesConfig as JTriplesConfig
from repro.launch import mesh as JM
from repro_torch.core.triples import TriplesConfig
from repro_torch.launch import mesh as M

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("shape,axes", [((16, 16), ("data", "model")),
                                        ((2, 16, 16),
                                         ("pod", "data", "model")),
                                        ((4, 2), ("pod", "data"))])
def test_abstract_mesh_matches_reference(shape, axes):
    got = M.make_abstract_mesh(shape, axes)
    want = JM.make_abstract_mesh(shape, axes)
    assert dict(got.shape) == dict(want.shape)
    assert tuple(got.axis_names) == tuple(want.axis_names)
    assert got.size == want.size == got.devices.size


def test_production_shapes_are_the_references():
    assert (M.SINGLE_POD_SHAPE, M.SINGLE_POD_AXES) == \
        (JM.SINGLE_POD_SHAPE, JM.SINGLE_POD_AXES)
    assert (M.MULTI_POD_SHAPE, M.MULTI_POD_AXES) == \
        (JM.MULTI_POD_SHAPE, JM.MULTI_POD_AXES)


def test_mesh_without_a_group_raises_when_it_needs_more_than_one():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group of world size 4"):
        M.make_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="fake process group|world"):
        M.make_production_mesh(multi_pod=False)
    assert not dist.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("shape", [(1,), (1, 1), (2, 2)])
def test_card_mesh_without_a_card_raises_and_starts_no_group(shape):
    """The default device type is the card: with none, ``make_mesh``
    raises before it starts any process group (no CPU fallback)."""
    import torch.distributed as dist
    axes = ("data", "model")[:len(shape)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh(shape, axes)
    assert not dist.is_initialized()


@pytest.mark.parametrize("nodes,nppn,threads,chips,pods", [
    (2, 8, 1, 4, 1), (1, 1, 1, 1, 2), (4, 16, 2, 4, 2)])
def test_triples_errors_read_as_the_references(nodes, nppn, threads, chips,
                                               pods):
    """With no group and no card the port counts 0 devices, the
    reference its one CPU device; the messages are the same sentence."""
    with pytest.raises(ValueError) as got:
        M.mesh_from_triples(TriplesConfig(nodes, nppn, threads), chips, pods)
    with pytest.raises(ValueError) as want:
        JM.mesh_from_triples(JTriplesConfig(nodes, nppn, threads), chips,
                             pods)
    assert str(got.value).replace("but 0 are", "but 1 are") == \
        str(want.value)


def test_mesh_context_replicates_plain_tensors():
    from torch.distributed.tensor import DTensor
    with M.mesh_context("m") as m:
        assert m == "m"
        assert DTensor._op_dispatcher._allow_implicit_replication
    assert not DTensor._op_dispatcher._allow_implicit_replication


GLOO_SCRIPT = r"""
import os, sys
sys.path.insert(0, SRC)
import torch.distributed as dist
from repro_torch.core.triples import TriplesConfig
from repro_torch.launch import mesh as M
m1 = M.make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
assert m1.mesh_dim_names == ("pod", "data", "model")
t = M.mesh_from_triples(TriplesConfig(1, 1, 1), chips_per_node=1,
                        device_type="cpu")
assert t.device_type == "cpu"
assert tuple(t.shape) == (1, 1, 1)
assert t.mesh_dim_names == ("nodes", "data", "model")
try:
    M.mesh_from_triples(TriplesConfig(1, 1, 1), chips_per_node=1, pods=2)
    raise SystemExit("no error")
except ValueError as e:
    assert "= 2 devices, but 1 are available" in str(e), e
try:                          # no card: the default ("cuda") raises
    M.mesh_from_triples(TriplesConfig(1, 1, 1), chips_per_node=1)
    raise SystemExit("no error")
except RuntimeError as e:
    assert "no CUDA device" in str(e), e
try:
    M.make_mesh((2,), ("data",), "cpu")
    raise SystemExit("no error")
except ValueError as e:
    assert "needs 2" in str(e), e
print("MESH_OK", "jax" in sys.modules,
      any(k == "repro" or k.startswith("repro.") for k in sys.modules))
dist.destroy_process_group()
"""


def test_one_rank_mesh_on_gloo():
    script = GLOO_SCRIPT.replace("SRC", repr(os.path.abspath(SRC)))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120)
    assert "MESH_OK False False" in r.stdout, r.stdout[-2000:] + \
        r.stderr[-2000:]
