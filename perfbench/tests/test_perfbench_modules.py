"""A run loads neither JAX nor the JAX package (``repro``), compared by
whole top-level module names: the program's package, ``repro_torch``,
begins with the JAX package's name."""

import json
import subprocess
import sys
import textwrap

from pb import harness


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.sub", sys)
    assert "repro" in harness.forbidden_modules()


def test_a_run_loads_no_jax(tmp_path):
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(harness.mf.BENCH_DIR)!r})
        sys.path.insert(0, {str(harness.mf.BENCH_DIR / 'tests')!r})
        import tiny
        from pb import harness
        for cell in ("stablelm-12b.score-4k", "qwen3-moe-30b-a3b.score-4k"):
            harness.run_cell(cell, 5, 0.5, False, device="cpu",
                             overrides=tiny.overrides(cell))
        print(json.dumps(sorted(m.split(".")[0] for m in sys.modules)))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_without_a_card_the_command_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, str(harness.mf.BENCH_DIR / "run.py"), "--workload",
         "stablelm-12b.score-4k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
