"""``repro_torch.launch.serve`` against ``repro.launch.serve``.

Both launchers build the config, draw the weights, make their seeded
requests and serve them.  The two frameworks' generators differ, so the
test hands the port's launcher the reference's weights (its
``init_params`` replaced by one that carries ``jax.random.PRNGKey(0)``'s
parameters across) and runs both in f32; the printed request count,
tokens, engine steps and token lists must then be equal.
"""

import dataclasses
import re
import sys

import jax
import numpy as np
import pytest

import repro.launch.serve as jax_serve
from repro.configs import get_arch as jax_get_arch
from repro.models import model as JM
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import model as M

F32_CFG = dict(param_dtype="float32", activation_dtype="float32")
HEAD = re.compile(r"arch=(\S+): (\d+) requests, (\d+) tokens in .*\((?:.*), "
                  r"(\d+) engine steps\)")


def _summary(out: str) -> tuple:
    lines = out.strip().splitlines()
    head = HEAD.match(lines[0])
    assert head, lines[0]
    return head.groups(), [ln for ln in lines[1:] if ln.startswith("  req")]


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "rwkv6-3b",
                                  "jamba-v0.1-52b",
                                  "llama4-maverick-400b-a17b"])
def test_launcher_prints_reference_tokens(name, monkeypatch, capsys):
    def f32(get):
        return lambda arch, reduced=False: dataclasses.replace(
            get(arch, reduced=reduced), **F32_CFG)

    monkeypatch.setattr(jax_serve, "get_arch", f32(jax_get_arch))
    monkeypatch.setattr(serve, "get_arch", f32(get_arch))

    def reference_params(cfg, generator, device=None):
        jcfg = dataclasses.replace(jax_get_arch(name, reduced=True),
                                   **F32_CFG)
        tree = jax.tree.map(np.asarray,
                            JM.init_params(jcfg, jax.random.PRNGKey(0)))
        return M.params_from_numpy(cfg, tree, device)

    monkeypatch.setattr(M, "init_params", reference_params)
    args = ["--arch", name, "--requests", "5", "--max-new", "5"]
    monkeypatch.setattr(sys, "argv", ["serve.py"] + args)
    jax_serve.main()
    want = _summary(capsys.readouterr().out)
    serve.main(args + ["--device", "cpu"])
    got = _summary(capsys.readouterr().out)
    assert got == want
    assert want[0][1:] == ("5", "25", want[0][3])
