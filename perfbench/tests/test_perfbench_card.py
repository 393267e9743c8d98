"""One short run of each cell on the card (``-m cuda``)."""

import json
import subprocess
import sys

import pytest

from pb import manifest as mf

CELLS = [w["name"] for w in mf.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, str(mf.BENCH_DIR / "run.py"), "--workload", cell,
         "--seed", "2147483999", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=mf.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "compared"
