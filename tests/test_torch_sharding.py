"""The port's sharding rules against the JAX package's, exactly.

Both sides run on abstract meshes (no devices): the reference on
``jax.sharding.AbstractMesh``, the port on its ``make_abstract_mesh``.
Every spec is compared entry for entry:
- every parameter of all ten configs on both production meshes;
- the decode cache of every config at ``decode_32k``;
- the int8 (row-wise) optimizer-state shardings;
- a table of ``batch_spec`` cases;
- the reference's own ``make_spec`` cases and its hypothesis test.
Specs become DTensor placements by mesh dim (``to_placements``).
"""

import hypothesis.strategies as st
import jax
import numpy as np
import pytest
from hypothesis import given, settings

from repro.configs import SHAPES as JSHAPES
from repro.configs import all_arch_names
from repro.configs import get_arch as jget_arch
from repro.distribution import sharding as JSH
from repro.launch import steps as JST
from repro.launch.mesh import make_abstract_mesh as jmesh
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro_torch.configs import SHAPES, get_arch
from repro_torch.distribution import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_specs(tree):
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))
    return [(jax.tree_util.keystr(p), tuple(s.spec)) for p, s in leaves]


def _port_specs(tree):
    return [tuple(s.spec) for s in tree_leaves(tree)]


def _same(ref, port):
    assert len(ref) == len(port)
    for (path, a), b in zip(ref, port):
        # JAX's PartitionSpec drops trailing Nones of no entry
        a = a + (None,) * (len(b) - len(a))
        assert a == b, (path, a, b)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", all_arch_names())
def test_param_specs_equal_reference(name, mesh):
    shape, axes = MESHES[mesh]
    ref = JSH.param_shardings(JST.param_specs(jget_arch(name)),
                              jmesh(shape, axes))
    port = SH.param_shardings(ST.param_specs(get_arch(name)),
                              make_abstract_mesh(shape, axes))
    _same(_ref_specs(ref), _port_specs(port))


@pytest.mark.parametrize("name", all_arch_names())
def test_cache_specs_equal_reference(name):
    shape, axes = MESHES["2x16x16"]
    ref = JSH.cache_shardings(
        JST.cache_specs(jget_arch(name), JSHAPES["decode_32k"]),
        jmesh(shape, axes))
    port = SH.cache_shardings(
        ST.cache_specs(get_arch(name), SHAPES["decode_32k"]),
        make_abstract_mesh(shape, axes))
    _same(_ref_specs(ref), _port_specs(port))


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "minicpm-2b",
                                  "rwkv6-3b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_int8_opt_state_specs_equal_reference(name, mesh):
    shape, axes = MESHES[mesh]
    jm, pm = jmesh(shape, axes), make_abstract_mesh(shape, axes)
    jp = JST.param_specs(jget_arch(name))
    jo = jax.eval_shape(lambda p: jinit_opt_state(
        p, JOptimizerConfig(state_dtype="int8")), jp)
    ref = JSH.opt_state_shardings(jo, jp, JSH.param_shardings(jp, jm), jm)
    pp = ST.param_specs(get_arch(name))
    po = ST.opt_state_specs(get_arch(name),
                            OptimizerConfig(state_dtype="int8"))
    port = SH.opt_state_shardings(po, pp, SH.param_shardings(pp, pm), pm)
    _same(_ref_specs(ref), _port_specs(port))
    # the q of every moment keeps its parameter's spec
    psh = tree_leaves(SH.param_shardings(pp, pm))
    qs = [s for s in tree_leaves(port["m"])][0::2]
    assert [tuple(q.spec) for q in qs] == [tuple(s.spec) for s in psh]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("batch,extra", [(1, 1), (2, 1), (8, 2), (16, 1),
                                         (32, 2), (64, 1), (128, 3),
                                         (256, 1), (96, 2), (48, 0)])
def test_batch_spec_equals_reference(mesh, batch, extra):
    shape, axes = MESHES[mesh]
    want = tuple(JSH.batch_spec(jmesh(shape, axes), batch, extra))
    got = tuple(SH.batch_spec(make_abstract_mesh(shape, axes), batch,
                              extra))
    assert got == want + (None,) * (len(got) - len(want))


def test_make_spec_falls_back_on_indivisible():
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    assert tuple(SH.make_spec([[("model",)]], (8,), mesh)) == (None,)
    assert tuple(SH.make_spec([[("model",)]], (32,), mesh)) == ("model",)


def test_make_spec_priority_order():
    mesh = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    rule = [[("pod", "data"), ("data",)]]
    assert tuple(SH.make_spec(rule, (8,), mesh)) == (None,)
    assert tuple(SH.make_spec(rule, (16,), mesh)) == ("data",)
    assert tuple(SH.make_spec(rule, (64,), mesh)) == (("pod", "data"),)


def test_no_axis_used_twice():
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    spec = SH.make_spec([[("model",)], [("model",), ("data",)]], (32, 32),
                        mesh)
    assert tuple(spec) == ("model", "data")


def _spec_divides(spec, shape, mesh) -> bool:
    for dim, axes in zip(shape, tuple(spec)):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        if dim % int(np.prod([mesh.shape[a] for a in axes])):
            return False
    return True


@given(st.lists(st.integers(1, 4096), min_size=1, max_size=4))
@settings(max_examples=40, deadline=None)
def test_make_spec_always_valid_and_equal_reference(shape):
    mesh = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    rule = [[("pod", "data"), ("data",), ("model",)]] * len(shape)
    spec = SH.make_spec(rule, shape, mesh)
    assert _spec_divides(spec, shape, mesh)
    want = JSH.make_spec(rule, shape, jmesh((2, 16, 16),
                                            ("pod", "data", "model")))
    assert tuple(spec) == tuple(want)


def test_to_placements_by_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    pl = SH.to_placements(SH.P(("pod", "data"), None, "model"), mesh)
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert SH.to_placements(SH.P(None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        SH.to_placements(SH.P(("data", "pod")), mesh)
