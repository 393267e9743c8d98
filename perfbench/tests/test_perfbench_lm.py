"""The program's LM ranges and counters as the benchmark reads them
(``pb/lm.py``, the six readers over them, ``stages.py``), on synthetic
profiles and on the CPU."""

import sys
from types import SimpleNamespace

import pytest

import tiny
from pb import harness, lm, manifest as mf, trace

CUDA, CPU = "cuda", "cpu"
NEW = ("useful_ops_share.score", "moe_fill.score", "moe_drop_share.score")


class _Ev:
    def __init__(self, name, dev, s, t, flag=None, device_time=0.0):
        self.name = self.key = name
        self.device_type = dev
        self.time_range = SimpleNamespace(start=s, end=t)
        if flag is not None:
            self.is_user_annotation = flag
        self.device_time_total = device_time


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events

    def key_averages(self):
        return [e for e in self._events if e.device_type == CPU]


@pytest.fixture
def synthetic(monkeypatch):
    """Device types as the synthetic events name them."""
    import torch
    monkeypatch.setattr(torch.autograd, "DeviceType",
                        SimpleNamespace(CUDA=CUDA, CPU=CPU))


def _kernels():
    return [_Ev("sm80_xmma_gemm_f32f32_f32f32", CUDA, 5, 20),
            _Ev("void_at::native::elementwise_kernel", CUDA, 22, 40),
            _Ev("nvjet_tst_320x128", CUDA, 50, 70),
            _Ev("void_at::native::copy_kernel", CUDA, 80, 90),
            _Ev("sm80_xmma_gemm_f32f32_f32f32", CUDA, 100, 110)]


def _ranges(flag=True):
    """The program's stages on the host, and their device-side copies
    (flagged as the profiler flags them, or not at all)."""
    host = [_Ev("norm", CPU, 1, 10), _Ev("attn.qkv", CPU, 10, 30,
                                         device_time=33.0),
            _Ev("mlp", CPU, 35, 60, device_time=28.0),
            _Ev("moe.route", CPU, 61, 62)]
    dev = [_Ev("attn.qkv", CUDA, 5, 40, flag), _Ev("mlp", CUDA, 50, 70, flag)]
    return host + dev


def _harness_range():
    return [_Ev("bench.forward", CPU, 0, 85)]


def test_the_stage_list_is_the_programs():
    if str(harness.SRC) not in sys.path:
        sys.path.insert(0, str(harness.SRC))
    from repro_torch.obs import lm as program
    assert lm.STAGES == program.STAGES
    assert lm.program() is program


def test_reduce_reads_the_same_with_the_stage_ranges(synthetic):
    keys = ("busy_s", "by_kind", "moe_s", "n_device_ops")
    without = trace.reduce(_Prof(_harness_range() + _kernels()), 0.2)
    with_ = trace.reduce(_Prof(_harness_range() + _kernels() + _ranges()),
                         0.2)
    assert {k: with_[k] for k in keys} == {k: without[k] for k in keys}
    assert without["n_device_ops"] == 5


@pytest.mark.parametrize("flag", [True, None], ids=["flagged", "unflagged"])
def test_gaps_are_named_by_the_innermost_open_range(flag, synthetic):
    prof = _Prof(_harness_range() + _kernels() + _ranges(flag))
    gaps = lm.gaps_by_stage(prof)
    # gaps begin at 20 (attn.qkv open inside bench.forward), 40 (mlp),
    # 70 (bench.forward alone) and 90 (no range open); longest first
    assert [n for n, _ in gaps] == ["mlp", "bench.forward", "harness",
                                    "attn.qkv"]
    assert [v for _, v in gaps] == pytest.approx([1e-5, 1e-5, 1e-5, 2e-6])
    assert lm.gaps_by_stage(prof, top=1) == [gaps[0]]


def test_stage_seconds_from_the_profile(synthetic):
    import stages
    s = stages.stage_seconds(_Prof(_harness_range() + _kernels() +
                                   _ranges()))
    assert set(s) == set(lm.STAGES)
    assert s["attn.qkv"] == 33e-6 and s["mlp"] == 28e-6 and s["norm"] == 0


def _ctx(trace_=True, kind="score"):
    arch = {**mf.config("stablelm-12b")["arch"], **tiny.ARCH["stablelm-12b"]}
    return SimpleNamespace(
        kind=kind, arch=arch, window_s=1.0,
        trace={"busy_s": 2.0, "window_s": 2.1} if trace_ else None)


SNAP = {"product_ops": {"f32": 600, "bf16": 200}, "tokens": 16,
        "moe_choices": 400, "moe_slots": 200, "moe_kept": 100}
EMPTY = {"product_ops": {}, "tokens": 0, "moe_choices": 0, "moe_slots": 0,
         "moe_kept": 0}


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("case", ["untraced", "not_score", "no_program",
                                  "nothing_recorded"])
def test_a_new_reader_is_silent_without_its_inputs(name, case, monkeypatch):
    snap = {"no_program": None, "nothing_recorded": EMPTY}.get(case, SNAP)
    monkeypatch.setattr(lm, "snapshot", lambda: snap)
    ctx = _ctx(trace_=case != "untraced",
               kind="chat" if case == "not_score" else "score")
    assert harness.load_reader(name)(ctx) is None


def _twice(snap):
    """The snapshot of two such calls recorded without a reset between."""
    return {k: ({n: 2 * x for n, x in v.items()} if isinstance(v, dict)
                else 2 * v) for k, v in snap.items()}


@pytest.mark.parametrize("calls", [1, 2])
def test_the_new_readers_read_the_counters(calls, monkeypatch):
    from pb import flops
    snap = SNAP if calls == 1 else _twice(SNAP)
    monkeypatch.setattr(lm, "snapshot", lambda: snap)
    ctx = _ctx()
    got = {n: harness.load_reader(n)(ctx) for n in NEW}
    useful = 2 * flops.matmul_params(ctx.arch) * 16
    assert got == pytest.approx({
        "useful_ops_share.score": 100.0 * useful / 800,
        "moe_fill.score": 50.0, "moe_drop_share.score": 75.0})


def test_the_new_metrics_are_in_the_manifest():
    man = mf.manifest()
    per_layer = {m["name"]: m for m in man["per_layer"]}
    for n in NEW:
        m = per_layer[n]
        assert m["moves"] == "score_tokens_per_s"
        assert m["source"] in ("program_span", "program_counter")
    assert per_layer["useful_ops_share.score"]["workloads"] == [
        "stablelm-12b.score-4k", "qwen3-moe-30b-a3b.score-4k"]
    for n in ("moe_fill.score", "moe_drop_share.score"):
        assert per_layer[n]["workloads"] == ["qwen3-moe-30b-a3b.score-4k"]


def test_the_attribution_runs_on_the_cpu():
    import torch
    import stages
    if str(harness.SRC) not in sys.path:
        sys.path.insert(0, str(harness.SRC))
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import model as M
    from pb import weights
    name = "qwen3-moe-30b-a3b"
    arch = {**mf.config(name)["arch"], **tiny.ARCH[name]}
    cfg, params = ArchConfig(**arch), weights.draw(arch, 2 ** 31 + 9, "cpu")
    toks = torch.randint(0, arch["vocab_size"], (1, 64),
                         generator=torch.Generator().manual_seed(9))

    def forward():
        with torch.inference_mode():
            M.forward(cfg, params, {"tokens": toks})

    prof, wall, out = stages.attribute(forward, 1)
    assert [c["recording"] for c in out["calls"]] == [False, True]
    assert wall == out["calls"][-1]["wall_s"]
    assert {e.name for e in prof.events()} >= {"embed", "moe.route"}
    c = out["counters"]
    assert c["tokens"] == 64 and set(out["stage_s"]) == set(lm.STAGES)
    assert c["moe_choices"] == arch["n_layers"] * 64 * arch["top_k"]
    assert 0 < c["moe_kept"] <= c["moe_choices"]
    assert sum(c["product_ops"].values()) > 0
    assert out["busy_s"] == 0 and out["covered"] is None
