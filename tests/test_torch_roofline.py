"""The port's roofline (terms at the H100's constants, collective bytes
from an FX graph) and the dry run's analytic per-chip bytes and model
FLOPs, against the JAX package's.

- ``RooflineTerms``: the reference's ``test_roofline_terms_math`` with
  the port's constants (1e-9 absolute on the terms);
- ``compute_terms`` of one record: composed flops, bytes and
  collective bytes equal the reference's exactly;
- collectives: an FX graph holding the reference's ``FAKE_HLO``
  collectives (operand shapes, dtypes, group sizes), plus an
  all-to-all, gives ``hlo_parse.collective_bytes(FAKE_HLO, 8)`` per
  category within 1e-6;
- per-chip param, optimizer and cache bytes and ``model_flops`` of
  every (arch x shape x mesh) cell equal the reference's exactly (the
  reference side on ``AbstractMesh``, nothing compiled).
"""

import os

import jax
import pytest
import torch
import torch.fx

from repro.configs import get_arch as jget_arch
from repro.configs import shapes_for as jshapes_for
from repro.distribution import sharding as JSH
from repro.launch import steps as JST
from repro.launch.mesh import make_abstract_mesh as jmesh
from repro.roofline.analysis import compute_terms as jcompute_terms
from repro.roofline.hlo_parse import collective_bytes as jcollective_bytes
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro_torch.configs import all_arch_names, get_arch, shapes_for
from repro_torch.distribution import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as ST
from repro_torch.roofline.analysis import RooflineTerms, compute_terms
from repro_torch.roofline.graph_parse import (
    category, collective_bytes, parse_graph_shapes)
from repro_torch.train.optimizer import OptimizerConfig

FAKE_HLO = """
HloModule jit_f, num_partitions=8

ENTRY %main_spmd (p0: f32[64,64]) -> f32[64,64] {
  %p0 = f32[64,64]{1,0} parameter(0)
  %dot = f32[64,64]{1,0} dot(%p0, %p0)
  %all-reduce = f32[64,64]{1,0} all-reduce(%dot), channel_id=1, replica_groups={{0,2,4,6},{1,3,5,7}}, use_global_device_ids=true
  %ag = bf16[128,64]{1,0} all-gather(%small), dimensions={0}, replica_groups=[2,4]<=[8]
  %small = bf16[32,64]{1,0} copy(%p0)
  %rs = f32[8,64]{1,0} reduce-scatter(%all-reduce), replica_groups={{0,1,2,3,4,5,6,7}}
  %cp = f32[64,64]{1,0} collective-permute(%dot), source_target_pairs={{0,1}}
  ROOT %out = f32[64,64]{1,0} add(%cp, %cp)
}
"""

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def test_roofline_terms_math():
    t = RooflineTerms(
        arch="a", shape="train_4k", mesh="16x16", chips=256,
        flops=MESH.PEAK_FLOPS_BF16 * 0.5,      # 0.5 s of per-chip compute
        hbm_bytes=MESH.HBM_BW * 0.25,          # 0.25 s of HBM
        collective_bytes=MESH.LINK_BW * 1.0,   # 1.0 s on the link
        model_flops=MESH.PEAK_FLOPS_BF16 * 256 * 0.4).finalize()
    assert abs(t.compute_s - 0.5) < 1e-9
    assert abs(t.memory_s - 0.25) < 1e-9
    assert abs(t.collective_s - 1.0) < 1e-9
    assert t.bottleneck == "collective"
    assert abs(t.useful_ratio - 0.8) < 1e-9
    assert abs(t.roofline_fraction - 0.4) < 1e-9


def test_h100_constants_are_the_datasheets():
    assert MESH.PEAK_FLOPS_BF16 == 989e12
    assert MESH.HBM_BW == 3.35e12
    assert MESH.H100_HBM_BYTES == 80e9
    assert MESH.LINK_BW == 50e9 and MESH.NVLINK_BW == 450e9


@pytest.mark.parametrize("with_block", [True, False])
def test_compute_terms_composes_as_reference(with_block):
    rec = {
        "arch": "a", "shape": "train_4k", "mesh": "16x16", "chips": 256,
        "n_superblocks": 10,
        "cost": {"flops": 100.0, "bytes accessed": 10.0},
        "collectives": {"wire_bytes_total": 20.0},
        "model_flops": 1e6,
    }
    if with_block:
        rec["block_cost"] = {"flops": 7.0, "bytes accessed": 1.0}
        rec["block_collectives"] = {"wire_bytes_total": 2.0}
    got, want = compute_terms(rec), jcompute_terms(rec)
    assert (got.flops, got.hbm_bytes, got.collective_bytes) == \
        (want.flops, want.hbm_bytes, want.collective_bytes)
    assert got.model_flops == want.model_flops
    assert got.useful_ratio == want.useful_ratio
    if with_block:
        assert got.flops == 100.0 + 9 * 7.0


def _fake_graph():
    """FAKE_HLO's collectives as FX nodes (group names 'g4', 'g8')."""
    F = torch.ops._c10d_functional
    g = torch.fx.Graph()

    def node(target, args, val):
        n = g.call_function(target, args)
        n.meta["val"] = val
        return n

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    p0 = g.placeholder("p0")
    p0.meta["val"] = meta((64, 64))
    dot = node(torch.ops.aten.mm.default, (p0, p0), meta((64, 64)))
    ar = node(F.all_reduce.default, (dot, "sum", "g4"), meta((64, 64)))
    node(F.wait_tensor.default, (ar,), meta((64, 64)))
    small = node(torch.ops.aten.clone.default, (p0,),
                 meta((32, 64), torch.bfloat16))
    node(F.all_gather_into_tensor.default, (small, 4, "g4"),
         meta((128, 64), torch.bfloat16))
    node(F.reduce_scatter_tensor.default, (ar, "sum", 8, "g8"),
         meta((8, 64)))
    node(F.isend.default, (dot, 1, 0, "g8"), meta((64, 64)))
    node(F.all_to_all_single.default, (dot, [8] * 8, [8] * 8, "g8"),
         meta((64, 64)))
    return g


def test_collective_bytes_equal_hlo_parse():
    g = _fake_graph()
    sizes = {"g4": 4, "g8": 8}
    got = collective_bytes(g, 8, group_sizes=sizes)
    want = jcollective_bytes(FAKE_HLO, n_devices=8)
    for kind in want.wire_bytes:
        assert abs(got.wire_bytes[kind] - want.wire_bytes[kind]) < 1e-6
        assert abs(got.operand_bytes[kind] - want.operand_bytes[kind]) < 1e-6
    f64 = 64 * 64 * 4
    assert abs(got.wire_bytes["all-to-all"] - 7 / 8 * f64) < 1e-6
    assert got.total_wire_bytes == pytest.approx(
        want.total_wire_bytes + 7 / 8 * f64, abs=1e-6)
    shapes = parse_graph_shapes(g)
    assert shapes["p0"] == f64
    clone = next(n for n in g.nodes
                 if n.target is torch.ops.aten.clone.default)
    assert shapes[clone.name] == 32 * 64 * 2
    assert category(torch.ops._c10d_functional.wait_tensor.default) is None
    assert category(torch.ops.aten.mm.default) is None


def _ref_sharded_bytes():
    """The reference dry run's ``_sharded_bytes`` and ``model_flops``.
    Its module sets XLA_FLAGS for 512 host devices at import; the JAX
    backend of this process is started first, so the flag changes
    nothing here, and it is put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as JD
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return JD


@pytest.mark.parametrize("name", all_arch_names())
def test_per_chip_bytes_and_model_flops_equal_reference(name):
    JD = _ref_sharded_bytes()
    jcfg, cfg = jget_arch(name), get_arch(name)
    jp, pp = JST.param_specs(jcfg), ST.param_specs(cfg)
    jo = jax.eval_shape(lambda p: jinit_opt_state(
        p, JOptimizerConfig(state_dtype="int8")), jp)
    po = ST.opt_state_specs(cfg, OptimizerConfig(state_dtype="int8"))
    for shape, axes in MESHES.values():
        jm, pm = jmesh(shape, axes), MESH.make_abstract_mesh(shape, axes)
        jpsh, ppsh = JSH.param_shardings(jp, jm), SH.param_shardings(pp, pm)
        assert D._sharded_bytes(pp, ppsh, pm) == \
            JD._sharded_bytes(jp, jpsh, jm)
        assert D._sharded_bytes(
            po, SH.opt_state_shardings(po, pp, ppsh, pm), pm) == \
            JD._sharded_bytes(jo, JSH.opt_state_shardings(jo, jp, jpsh, jm),
                              jm)
        for jshape, pshape in zip(jshapes_for(jcfg), shapes_for(cfg)):
            assert D.model_flops(cfg, pshape) == \
                JD.model_flops(jcfg, jshape)
            if pshape.kind == "train":
                continue
            jc, pc = JST.cache_specs(jcfg, jshape), \
                ST.cache_specs(cfg, pshape)
            assert D._sharded_bytes(pc, SH.cache_shardings(pc, pm), pm) == \
                JD._sharded_bytes(jc, JSH.cache_shardings(jc, jm), jm)
