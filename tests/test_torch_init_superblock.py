"""``init_superblock_params`` against the JAX package's, and against the
port's own ``init_params``.

The two frameworks' generators differ, so the port is held to the
reference on leaf paths, shapes and dtypes, and to its own
``init_params`` on values: from a generator in the state the top-level
draws leave, superblocks 0, 1, ... drawn in turn equal ``init_params``'
stacked slices bitwise.  ``init_params`` keeps drawing one sublayer at a
time (a whole superblock of jamba is 8 sublayers).
"""

import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import model as JM
from repro_torch.configs import get_arch
from repro_torch.models import model as M

torch.set_num_threads(1)

ARCHS = ["stablelm-12b", "minicpm-2b", "granite-34b", "nemotron-4-340b",
         "qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b",
         "rwkv6-3b", "musicgen-medium", "pixtral-12b"]


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _cases():
    for name in ARCHS:
        n = get_arch(name, reduced=True).n_superblocks
        for sb in sorted({0, n - 1}):
            yield name, sb


@pytest.mark.parametrize("name,sb", list(_cases()))
def test_init_superblock_params_matches_reference_and_init_params(name, sb):
    jcfg = jax_get_arch(name, reduced=True)
    cfg = get_arch(name, reduced=True)
    want = {p: np.asarray(x) for p, x in _leaves(
        JM.init_superblock_params(jcfg, jax.random.PRNGKey(0), sb))}

    gen = torch.Generator().manual_seed(3)
    M._init_top(cfg, gen)
    for i in range(sb + 1):
        got = M.init_superblock_params(cfg, gen, i)
    got = dict(_leaves(got))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
        assert got[path].device.type == "cpu", path

    params = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for (s, *rest), leaf in got.items():
        stacked = params["blocks"][s]
        for key in rest:
            stacked = stacked[key]
        assert stacked.shape[0] == cfg.n_superblocks
        assert torch.equal(stacked[sb], leaf), (s, *rest)


def test_init_superblock_params_defaults_to_superblock_zero():
    cfg = get_arch("jamba-v0.1-52b", reduced=True)
    a = M.init_superblock_params(cfg, torch.Generator().manual_seed(1))
    b = M.init_superblock_params(cfg, torch.Generator().manual_seed(1), 0)
    assert sorted(a) == [f"s{i}" for i in range(cfg.pattern_period)]
    for (pa, x), (pb, y) in zip(_leaves(a), _leaves(b)):
        assert pa == pb and torch.equal(x, y)


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "qwen3-moe-30b-a3b"])
def test_init_params_draws_one_sublayer_at_a_time(name, monkeypatch):
    """init_params never builds a superblock whole: it does not call
    init_superblock_params, and each sublayer it draws is freed before
    it draws the next."""
    cfg = get_arch(name, reduced=True)
    draw = M.init_sublayer_params
    alive: list = []
    calls = []

    def one_at_a_time(c, g, layer_idx):
        assert all(ref() is None for ref in alive), \
            f"a sublayer is still alive when sublayer {layer_idx} is drawn"
        out = draw(c, g, layer_idx)
        alive[:] = [weakref.ref(t) for _, t in _leaves(out)]
        calls.append(layer_idx)
        return out

    def whole(*args, **kwargs):
        raise AssertionError("init_params drew a whole superblock")

    monkeypatch.setattr(M, "init_sublayer_params", one_at_a_time)
    monkeypatch.setattr(M, "init_superblock_params", whole)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert calls == list(range(cfg.n_superblocks * cfg.pattern_period))
    assert sorted(params["blocks"]) == [f"s{i}" for i in
                                        range(cfg.pattern_period)]
