"""The plain reference against the program, on the CPU at small sizes.

With float32 activations the program multiplies bfloat16 weights in
float32 as the reference does, so the two agree to rounding; at the
configured bfloat16 they differ by the program's roundings."""

import ast
import pathlib
import sys

import pytest
import torch

import tiny
from pb import harness, manifest as mf, weights
from reference import decoder as ref

sys.path.insert(0, str(harness.SRC))
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

CONFIGS = ["stablelm-12b", "qwen3-moe-30b-a3b"]


def _arch(config, **kw):
    return {**mf.config(config)["arch"], **tiny.ARCH[config], **kw}


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_matches_the_program_in_f32(config, impl):
    arch = _arch(config, activation_dtype="float32", attention_impl=impl)
    params = weights.draw(arch, 2 ** 31 + 3, "cpu")
    toks = torch.randint(0, arch["vocab_size"], (2, 48),
                         generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got = M.forward(ArchConfig(**arch), params, {"tokens": toks})
        seqs = [toks[0], toks[1]]
        rows = [(b, p) for b in range(2) for p in range(48)]
        calls = [[(b, p) for b in range(2) for p in range(48)]]
        want = ref.Decoder(ref.Sizes.from_arch(arch), params).logits(
            seqs, rows, calls)
    assert ref.logit_err(got.reshape(96, -1), want) < 2e-5


@pytest.mark.parametrize("config", CONFIGS)
def test_bf16_program_is_near_the_reference(config):
    arch = _arch(config)
    params = weights.draw(arch, 11, "cpu")
    toks = torch.randint(0, arch["vocab_size"], (1, 32),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got = M.forward(ArchConfig(**arch), params, {"tokens": toks})
        want = ref.Decoder(ref.Sizes.from_arch(arch), params).logits(
            [toks[0]], [(0, p) for p in range(32)],
            [[(0, p) for p in range(32)]])
    err = ref.logit_err(got[0], want)
    assert 1e-4 < err < 0.1


@pytest.mark.parametrize("gs,n", [(16, 16), (8, 24), (32, 32)])
def test_moe_routing_and_capacity_match_the_program(gs, n):
    torch.manual_seed(0)
    D, E, K, Fd = 16, 8, 2, 12
    sz = ref.Sizes(n_layers=1, d_model=D, n_heads=1, n_kv_heads=1,
                   head_dim=D, d_ff=Fd, vocab_size=4, rope_theta=1e4,
                   rms_eps=1e-5, n_experts=E, top_k=K, capacity_factor=1.25,
                   moe_group_size=gs)
    p = {"router": torch.randn(D, E), "wi": torch.randn(E, D, 2, Fd) * 0.3,
         "wo": torch.randn(E, Fd, D) * 0.3}
    x = torch.randn(1, n, D)
    got = L.moe(x, p, n_experts=E, top_k=K, activation="silu",
                capacity_factor=1.25, group_size=gs)
    dec = ref.Decoder(sz, {})
    want = dec._moe(x[0], p, [torch.arange(n)])
    assert torch.allclose(got[0], want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cell", [w["name"]
                                  for w in mf.manifest()["workloads"]])
def test_whole_runs_agree_with_the_reference_in_f32(cell):
    ov = tiny.overrides(cell, activation_dtype="float32")
    out = harness.run_cell(cell, 2 ** 31 + 99, 1.0, False, device="cpu",
                           overrides=ov)
    assert out["_compared"]
    assert all(v < 1e-4 for v, _ in out["_compared"].values())
    assert out["attempted"] > 0


def test_reference_imports_nothing_of_the_program():
    src = pathlib.Path(ref.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "dataclasses", "math", "typing", "torch"}
