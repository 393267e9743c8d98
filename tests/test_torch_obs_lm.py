"""The LM forward's ranges and counters (``repro_torch.obs.lm``), on the
CPU at the reduced configurations.

Under ``torch.profiler`` every layer names its stages once,
flat and in order, from ``obs.lm.STAGES`` alone; with no profiler the
forward enters no range and moves no counter.  ``product_ops`` equals
the count from the shapes, and ``moe_kept`` the choices that the
benchmark's plain reference (``perfbench/reference/decoder.py``) keeps
under capacity on the same parameters.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import pytest
import torch

from repro_torch.configs import all_arch_names, get_arch
from repro_torch.models import model as M
from repro_torch.obs import lm

BENCH = os.path.join(os.path.dirname(__file__), "..", "perfbench")
MIXER = {"attn": ["attn.qkv", "attn.rope", "attn.core", "attn.out"],
         "mamba": ["mamba"], "rwkv6": ["rwkv6.time"]}
MOE = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
B, T = 2, 16


@pytest.fixture(autouse=True)
def _clean_counters():
    lm.reset()
    yield
    lm.reset()


def _inputs(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = M.init_params(cfg, gen, device="cpu")
    if cfg.frontend is not None:
        batch = {"embeds": torch.randn(B, T, cfg.d_model, generator=gen)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T),
                                         generator=gen)}
    return params, batch


def _forward(cfg, params, batch):
    with torch.inference_mode():
        return M.forward(cfg, params, batch)


def _expected_stages(cfg) -> list:
    seq = ["embed"]
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        seq += ["norm", *MIXER[kind], "norm"]
        if kind == "rwkv6":
            seq.append("rwkv6.channel")
        elif cfg.is_moe_layer(i):
            seq += MOE
        else:
            seq.append("mlp")
    return seq + ["norm", "unembed"]


@pytest.mark.parametrize("arch", all_arch_names())
def test_each_layer_names_its_stages_once_flat_and_in_order(arch):
    cfg = get_arch(arch, reduced=True)
    params, batch = _inputs(cfg)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _forward(cfg, params, batch)
    ranges = sorted((e for e in prof.events() if e.is_user_annotation),
                    key=lambda e: e.time_range.start)
    assert {e.name for e in ranges} <= set(lm.STAGES)
    assert [e.name for e in ranges] == _expected_stages(cfg)
    for prev, nxt in zip(ranges, ranges[1:]):
        assert nxt.time_range.start >= prev.time_range.end, (prev.name,
                                                             nxt.name)


@pytest.mark.parametrize("arch", ["stablelm-12b", "qwen3-moe-30b-a3b"])
def test_without_a_profiler_nothing_records(arch, monkeypatch):
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    cfg = get_arch(arch, reduced=True)
    params, batch = _inputs(cfg)
    assert not lm.on()
    assert lm.stage("norm") is lm.stage("unembed")
    _forward(cfg, params, batch)
    assert entered == []
    assert lm.counters() == {"product_ops": {}, "tokens": 0,
                             "moe_choices": 0, "moe_slots": 0, "moe_kept": 0}


def test_recording_without_a_profiler_and_reset():
    cfg = get_arch("qwen3-moe-30b-a3b", reduced=True)
    params, batch = _inputs(cfg)
    with lm.recording():
        with lm.recording():
            assert lm.on()
        assert lm.on()
        _forward(cfg, params, batch)
    assert not lm.on()
    c = lm.counters()
    assert sum(c["product_ops"].values()) > 0 and c["moe_slots"] > 0
    assert c["tokens"] == B * T
    lm.reset()
    assert lm.counters()["product_ops"] == {} and lm.counters()[
        "moe_kept"] == 0 and lm.counters()["tokens"] == 0


@pytest.mark.parametrize("hold", [1, 3, 4096])
def test_held_keep_masks_fold_to_the_same_count(hold, monkeypatch):
    """Past ``_HOLD`` held masks the count folds early; the snapshot
    reads the same whenever the folds fall."""
    monkeypatch.setattr(lm, "_HOLD", hold)
    cfg = get_arch("qwen3-moe-30b-a3b", reduced=True)
    params, batch = _inputs(cfg)
    with lm.recording():
        for _ in range(3):
            _forward(cfg, params, batch)
            assert len(lm._keep) <= hold
    monkeypatch.setattr(lm, "_HOLD", 4096)
    c = lm.counters()
    assert lm._keep == []
    lm.reset()
    with lm.recording():
        _forward(cfg, params, batch)
    one = lm.counters()
    assert c["moe_kept"] == 3 * one["moe_kept"] > 0
    assert c["tokens"] == 3 * one["tokens"] == 3 * B * T


def test_an_unknown_stage_is_refused_while_recording():
    assert lm.stage("nope") is lm.stage("norm")    # off: the shared no-op
    with lm.recording(), pytest.raises(ValueError, match="unknown stage"):
        lm.stage("nope")


def _dense_ops(cfg) -> dict:
    """Operations of a dense forward with flash attention, by dtype:
    the four projections and the MLP's output in the activations' dtype,
    the MLP's input and the unembedding widened to f32."""
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim_, cfg.d_ff)
    z = 2 if cfg.gated_mlp else 1
    n = B * T
    low = cfg.n_layers * 2 * n * (2 * d * h * hd + 2 * d * kv * hd + f * d)
    wide = cfg.n_layers * 2 * n * d * z * f + 2 * n * d * cfg.vocab_size
    return {"bf16": low, "f32": wide}


def _moe_ops(cfg) -> dict:
    """The same with experts: the router, the one-hot dispatch, the
    experts at capacity (padding included) and the combine."""
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim_, cfg.d_ff)
    E, K = cfg.n_experts, cfg.top_k
    S = B * T
    gs = max(g for g in range(1, min(S, cfg.moe_group_size) + 1)
             if S % g == 0)
    G = S // gs
    cap = max(int(cfg.capacity_factor * K * gs / E), 1)
    low = wide = 0
    for i in range(cfg.n_layers):
        low += 2 * S * (2 * d * h * hd + 2 * d * kv * hd)
        if not cfg.is_moe_layer(i):
            low += 2 * S * f * d
            wide += 2 * S * d * 2 * f
            continue
        low += 2 * G * gs * K * E * cap + 2 * G * gs * K * E
        wide += (2 * S * d * E                          # router
                 + 2 * 2 * G * gs * E * cap * d         # dispatch, combine
                 + 2 * E * G * cap * 3 * d * f)         # experts
    wide += 2 * S * d * cfg.vocab_size
    return {"bf16": low, "f32": wide}


@pytest.mark.parametrize("arch,expected", [
    ("stablelm-12b", _dense_ops), ("minicpm-2b", _dense_ops),
    ("granite-34b", _dense_ops), ("nemotron-4-340b", _dense_ops),
    ("qwen3-moe-30b-a3b", _moe_ops),
    ("llama4-maverick-400b-a17b", _moe_ops)])
def test_product_ops_equal_the_count_from_the_shapes(arch, expected):
    cfg = dataclasses.replace(get_arch(arch, reduced=True),
                              attention_impl="flash")
    params, batch = _inputs(cfg)
    with lm.recording():
        _forward(cfg, params, batch)
    assert lm.counters()["product_ops"] == expected(cfg)


def _bench_modules():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from pb import weights
    from reference import decoder
    return weights, decoder


@pytest.mark.parametrize("seed,capacity_factor", [(2 ** 31 + 7, 1.25),
                                                  (11, 0.5), (12, 2.0)])
def test_moe_kept_equals_the_reference_count(seed, capacity_factor,
                                             monkeypatch):
    """At float32 activations on the benchmark's qwen3 cell cut small
    (8 experts, top 2, one group of 64 tokens), the program keeps the
    choices the reference keeps, and some overflow."""
    weights, decoder = _bench_modules()
    arch = {"name": "qwen3-moe-30b-a3b", "family": "moe",
            "n_layers": 2, "d_model": 128, "n_heads": 4, "n_kv_heads": 2,
            "head_dim": 32, "d_ff": 96, "vocab_size": 512, "n_experts": 8,
            "top_k": 2, "moe_period": 1, "moe_offset": 0,
            "capacity_factor": capacity_factor, "moe_group_size": 2048,
            "rope_theta": 1e6, "rms_eps": 1e-5, "activation": "silu",
            "gated_mlp": True, "param_dtype": "bfloat16",
            "activation_dtype": "float32", "attention_impl": "flash"}
    n_tok = 64
    params = weights.draw(arch, seed, "cpu")
    toks = torch.randint(0, arch["vocab_size"], (1, n_tok),
                         generator=torch.Generator().manual_seed(seed))
    cfg = M.ArchConfig(**arch)
    with lm.recording():
        _forward(cfg, params, {"tokens": toks})
    c = lm.counters()

    kept = []
    real = torch.bincount
    monkeypatch.setattr(torch, "bincount", lambda x, **kw: kept.append(
        x.numel()) or real(x, **kw))
    ref = decoder.Decoder(decoder.Sizes.from_arch(arch), params)
    with torch.inference_mode():
        ref.logits([toks[0]], [(0, n_tok - 1)],
                   [[(0, t) for t in range(n_tok)]])
    cap = max(int(capacity_factor * 2 * n_tok / 8), 1)
    assert len(kept) == arch["n_layers"]
    assert c["moe_choices"] == arch["n_layers"] * n_tok * 2
    assert c["moe_slots"] == arch["n_layers"] * 8 * cap
    assert c["moe_kept"] == sum(kept)
    if capacity_factor < 2:
        assert c["moe_kept"] < c["moe_choices"]


@pytest.mark.cuda
def test_stage_seconds_on_the_card(monkeypatch):
    """On the card the ranges put nothing of their own on the device,
    and each stage's range holds device time in the profile (but
    ``attn.core``: flash's kernels are launched by no aten operation)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b", reduced=True),
                              attention_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (B, T), device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    _forward(cfg, params, {"tokens": toks})
    kernels = []
    for record in (False, True):
        with monkeypatch.context() as m:
            if not record:
                m.setattr(lm, "on", lambda: False)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                _forward(cfg, params, {"tokens": toks})
                torch.cuda.synchronize()
        kernels.append(sorted(e.name for e in prof.events()
                              if e.device_type == cuda
                              and e.name not in lm.STAGES))
    assert kernels[0] == kernels[1]
    stage_s = {e.key: e.device_time_total for e in prof.key_averages()
               if e.key in lm.STAGES and e.device_type == cpu}
    assert set(stage_s) == set(_expected_stages(cfg))
    assert all(v > 0 for k, v in stage_s.items() if k != "attn.core")
    c = lm.counters()
    assert 0 < c["moe_kept"] <= c["moe_choices"]
