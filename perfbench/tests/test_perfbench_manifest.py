"""BENCHMARK.json against the benchmark's contract, and the files it
names."""

import json
import re

import pytest

from pb import manifest as mf

MAN = mf.manifest()
E2E = {m["name"]: m for m in MAN["end_to_end"]}
CELLS = {w["name"]: w for w in MAN["workloads"]}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _reports(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= len(MAN["command"]) <= 32
    assert all(LINE.match(w) for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (mf.ROOT / p).is_dir()
    for w in MAN["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MAN["paths"])


def test_run_seconds_fits_a_full_check():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_no_name_shared_between_metrics_cells_and_configs():
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    for c in m.get("workloads", []):
        assert c in CELLS
    if m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert (mf.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_every_cell_of_a_layer_metric_reports_what_it_moves(m):
    moved = E2E[m["moves"]]
    cells = m.get("workloads", list(CELLS))
    assert cells
    for c in cells:
        assert _reports(c, moved), (m["name"], c)


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in MAN["per_layer"]}
    for name in layers:
        assert name == name.strip() and "\n" not in name


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4)
    assert LINE.match(w["why"])
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert w["config"] in {c["name"] for c in MAN["configs"]}
    assert (mf.BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
    assert (mf.BENCH_DIR / "cells" / f"{w['name']}.json").is_file()
    e2e = [m for m in MAN["end_to_end"] if _reports(w["name"], m)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(_reports(w["name"], m) for m in MAN["per_layer"])
    limits = mf.cell_file(w["name"]).get("limits", {})
    assert limits and all(v > 0 for v in limits.values())


def test_pairs_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head_size|expansion|experts_per_tok")


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("perfbench/configs/")
    assert LINE.match(c["source"]) and LINE.match(c["why"])
    assert len(c["reduced"]) <= 16
    assert not any(WIDTH.search(k) for k in c["reduced"])
    f = json.loads((mf.ROOT / c["file"]).read_text())
    assert f["source"] == c["source"]
    # ``reduced`` names cuts of the published keys; where the program
    # computes the model otherwise, the key keeps its published value
    # and ``departures`` says what runs instead
    for k in c["reduced"]:
        assert k in f and k not in f["departures"]
    a = f["arch"]
    assert (a["d_model"], a["n_layers"], a["n_heads"], a["n_kv_heads"],
            a["vocab_size"], a["head_dim"]) == (
        f["hidden_size"], f["num_hidden_layers"], f["num_attention_heads"],
        f["num_key_value_heads"], f["vocab_size"],
        f.get("head_dim", f["hidden_size"] // f["num_attention_heads"]))
    if a.get("n_experts"):
        assert (a["n_experts"], a["top_k"], a["d_ff"]) == (
            f["num_experts"], f["num_experts_per_tok"],
            f["moe_intermediate_size"])
    else:
        assert a["d_ff"] == f["intermediate_size"]
    eps_key = "rms_norm_eps" if "rms_norm_eps" in f else "layer_norm_eps"
    assert a["rms_eps"] == f[eps_key] or eps_key in f["departures"]
    assert a["rope_theta"] == f["rope_theta"]
    assert a["param_dtype"] == f["torch_dtype"]
