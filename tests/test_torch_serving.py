"""The port's BatchedServer vs the JAX package's, and the port alone.

Both servers get the JAX package's f32 parameters (through
``params_from_numpy``) and the same requests; greedy decoding must give
identical token lists and engine steps, for dense, MoE (capacity 1 at
four slots), Mamba and RWKV-6 configs (whose caches nest two levels
deep).  The slot-semantics tests mirror tests/test_data_serving.py on
the port.  A fresh interpreter that drives the port's LM path (forward,
prefill, decode, serve, ``launch.serve --device cpu``) must leave JAX
and every ``repro`` module unimported.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import model as JM
from repro.serving.server import BatchedServer as JaxServer
from repro.serving.server import Request as JaxRequest
from repro_torch.configs import get_arch
from repro_torch.models import model as M
from repro_torch.serving import BatchedServer, Request

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
F32_CFG = dict(param_dtype="float32", activation_dtype="float32")


def _env(name, **kw):
    jcfg = dataclasses.replace(jax_get_arch(name, reduced=True), **kw)
    cfg = dataclasses.replace(get_arch(name, reduced=True), **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, M.params_from_numpy(cfg, jax.tree.map(
        np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def server_env():
    """One reduced-arch param set shared by the slot-semantics tests."""
    _, _, cfg, params = _env("minicpm-2b")
    return cfg, params


def _requests(cls, vocab, n, seed, prompt_hi, new_lo, new_hi):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, int(rng.integers(3, prompt_hi))),
                max_new_tokens=int(rng.integers(new_lo, new_hi)))
            for i in range(n)]


@pytest.mark.parametrize("name,slots,n_req", [
    ("stablelm-12b", 3, 7), ("minicpm-2b", 2, 5), ("granite-34b", 4, 6),
    ("nemotron-4-340b", 2, 5), ("qwen3-moe-30b-a3b", 4, 7),
    ("llama4-maverick-400b-a17b", 4, 6), ("rwkv6-3b", 4, 6),
    ("jamba-v0.1-52b", 4, 6)])
def test_server_matches_reference_tokens_and_steps(name, slots, n_req):
    jcfg, jp, cfg, tp = _env(name, **F32_CFG)
    kw = dict(slots=slots, prompt_len=16, cache_len=48)
    jreqs = _requests(JaxRequest, cfg.vocab_size, n_req, 5, 14, 2, 9)
    reqs = _requests(Request, cfg.vocab_size, n_req, 5, 14, 2, 9)
    jserver = JaxServer(jcfg, jp, **kw)
    server = BatchedServer(cfg, tp, device="cpu", **kw)
    jserver.serve(jreqs)
    server.serve(reqs)
    assert [r.tokens_out for r in reqs] == [r.tokens_out for r in jreqs]
    assert all(r.done for r in reqs)
    assert server.steps == jserver.steps


def test_server_needs_a_card_unless_told_cpu(server_env):
    cfg, params = server_env
    if torch.cuda.device_count():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedServer(cfg, params)
    assert BatchedServer(cfg, params, device="cpu").device.type == "cpu"


def test_batched_server_completes_all_requests(server_env):
    cfg, params = server_env
    server = BatchedServer(cfg, params, slots=3, prompt_len=16,
                           cache_len=64, device="cpu")
    reqs = _requests(Request, cfg.vocab_size, 7, 0, 14, 2, 7)
    server.serve(reqs)
    for r in reqs:
        assert r.done
        assert 1 <= len(r.tokens_out) <= r.max_new_tokens
    assert len(reqs) > server.slots


def test_admit_full_returns_false_without_cache_corruption(server_env):
    """With every slot occupied, ``admit`` returns False and leaves the
    KV cache, the last-token buffer and the slot table bitwise as they
    were; once a slot frees, the same request admits and completes."""
    cfg, params = server_env
    server = BatchedServer(cfg, params, slots=2, prompt_len=8,
                           cache_len=64, device="cpu")
    occupants = [Request(i, np.arange(1, 5 + i), max_new_tokens=40)
                 for i in range(2)]
    for r in occupants:
        assert server.admit(r)
    cache_before = M.tree_map(lambda t: t.clone(), server.cache)
    last_before = server._last_token.copy()
    slots_before = list(server.slot_req)

    late = Request(9, np.array([7, 8, 9]), max_new_tokens=4)
    assert not server.admit(late)
    assert not late.tokens_out and not late.done
    assert server.slot_req == slots_before
    assert np.array_equal(server._last_token, last_before)
    for name, leaves in cache_before.items():
        for key, t in leaves.items():
            assert torch.equal(t, server.cache[name][key])

    server.serve([late])
    assert late.done and all(r.done for r in occupants)


def test_slot_frees_on_eos_and_on_max_new_tokens(server_env):
    cfg, params = server_env
    prompt = np.array([3, 1, 4, 1, 5])
    server = BatchedServer(cfg, params, slots=2, prompt_len=8,
                           cache_len=64, device="cpu")
    capped = Request(0, prompt, max_new_tokens=3)
    server.serve([capped])
    assert capped.done and len(capped.tokens_out) == 3
    assert server.slot_req == [None, None]

    eos_id = capped.tokens_out[1]
    server2 = BatchedServer(cfg, params, slots=2, prompt_len=8,
                            cache_len=64, device="cpu")
    eased = Request(1, prompt, max_new_tokens=50, eos_id=eos_id)
    server2.serve([eased])
    assert eased.done
    assert eased.tokens_out[-1] == eos_id
    assert len(eased.tokens_out) == 2 < eased.max_new_tokens
    assert server2.slot_req == [None, None]


def test_request_order_determinism_under_greedy_decode(server_env):
    cfg, params = server_env

    def run():
        reqs = _requests(Request, cfg.vocab_size, 5, 42, 8, 2, 5)
        server = BatchedServer(cfg, params, slots=2, prompt_len=8,
                               cache_len=64, device="cpu")
        server.serve(reqs)
        return {r.request_id: list(r.tokens_out) for r in reqs}

    first, second = run(), run()
    assert first == second
    assert all(out for out in first.values())


_LM_SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.serving import BatchedServer, Request
import dataclasses
cfg = dataclasses.replace(get_arch("stablelm-12b", reduced=True),
                          attention_impl="flash")
params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
logits = M.forward(cfg, params, {"tokens": np.zeros((1, 16), np.int32)})
server = BatchedServer(cfg, params, slots=2, prompt_len=8, cache_len=32,
                       device="cpu")
reqs = [Request(i, np.arange(1, 4 + i), max_new_tokens=3) for i in range(3)]
server.serve(reqs)
serve.main(["--device", "cpu", "--requests", "2", "--max-new", "2"])
print(json.dumps({
    "finite": bool(torch.isfinite(logits).all()),
    "tokens": [len(r.tokens_out) for r in reqs],
    "foreign": sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "repro.")))
                      + (["repro"] if "repro" in sys.modules else []),
}))
"""


def test_port_lm_path_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", _LM_SCRIPT],
                          capture_output=True, text=True, env=env,
                          timeout=240, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("arch=stablelm-12b-reduced: 2 requests")
    doc = json.loads(lines[-1])
    assert doc["finite"] and doc["tokens"] == [3, 3, 3]
    assert doc["foreign"] == []


def test_launch_serve_cli_mirrors_reference_flags(capsys):
    """``--reduced`` cannot be turned off (store_true, default True, as in
    the JAX launcher); ``--device`` defaults to the card."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "arch=stablelm-12b-reduced: 3 requests, 9 tokens" in out
    if not torch.cuda.device_count():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--requests", "1"])


def test_server_takes_reference_keywords(server_env):
    """greedy and seed, as the reference's callers pass them: the same
    tokens and steps as without them, and as the reference's server."""
    cfg, params = server_env
    jcfg, jp, _, _ = _env("minicpm-2b")
    kw = dict(slots=2, prompt_len=16, cache_len=48)
    plain = BatchedServer(cfg, params, device="cpu", **kw)
    server = BatchedServer(cfg, params, greedy=True, seed=0, device="cpu",
                           **kw)
    jserver = JaxServer(jcfg, jp, greedy=True, seed=0, **kw)
    assert server.greedy is True and server.seed == 0
    runs = []
    for srv, cls in ((plain, Request), (server, Request),
                     (jserver, JaxRequest)):
        reqs = _requests(cls, cfg.vocab_size, 4, 11, 14, 2, 7)
        srv.serve(reqs)
        runs.append(([r.tokens_out for r in reqs], srv.steps))
    assert runs[0] == runs[1] == runs[2]


def test_server_greedy_false_decodes_reference_tokens(server_env):
    """The reference stores greedy and never reads it, so greedy=False
    decodes greedily there: the port gives the same tokens and steps."""
    cfg, params = server_env
    jcfg, jp, _, _ = _env("minicpm-2b")
    kw = dict(slots=2, prompt_len=16, cache_len=48, greedy=False, seed=3)
    server = BatchedServer(cfg, params, device="cpu", **kw)
    jserver = JaxServer(jcfg, jp, **kw)
    assert server.greedy is False and server.seed == 3
    reqs = _requests(Request, cfg.vocab_size, 4, 13, 14, 2, 7)
    jreqs = _requests(JaxRequest, cfg.vocab_size, 4, 13, 14, 2, 7)
    server.serve(reqs)
    jserver.serve(jreqs)
    assert [r.tokens_out for r in reqs] == [r.tokens_out for r in jreqs]
    assert server.steps == jserver.steps


def test_splice_writes_every_nested_leaf():
    """An RWKV-6 cache is three levels deep (sublayer, time/channel,
    shift/wkv): admit writes the prefilled request's leaves into its
    slot at every depth, cast to the batch cache's dtypes, and touches
    no other slot."""
    _, _, cfg, params = _env("rwkv6-3b")
    server = BatchedServer(cfg, params, slots=3, prompt_len=8,
                           cache_len=16, device="cpu")
    server.cache = M.tree_map(lambda t: torch.full_like(t, 5), server.cache)
    server.cache["s0"]["time"]["wkv"] = server.cache["s0"]["time"][
        "wkv"].double()
    assert server.admit(Request(0, np.arange(1, 6), max_new_tokens=2))
    _, one = M.prefill(cfg, server.params, {"tokens": torch.tensor(
        [[0, 0, 0, 1, 2, 3, 4, 5]], dtype=torch.int32)}, cache_len=16)
    assert server.cache["s0"]["time"]["wkv"].dtype == torch.float64
    for part, leaves in one["s0"].items():
        for key, leaf in leaves.items():
            big = server.cache["s0"][part][key]
            assert torch.equal(big[:, 0:1], leaf.to(big.dtype)), (part, key)
            assert (big[:, 1:] == 5).all(), (part, key)


_ARMS_SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_arch
from repro_torch.models import model as M
from repro_torch.serving import BatchedServer, Request
out = {}
for name in ("qwen3-moe-30b-a3b", "rwkv6-3b"):
    cfg = get_arch(name, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.arange(12, dtype=np.int32).reshape(1, 12)
    logits = M.forward(cfg, params, {"tokens": toks})
    _, cache = M.prefill(cfg, params, {"tokens": toks[:, :11]},
                         cache_len=16)
    step, _ = M.decode_step(cfg, params, cache, {"tokens": toks[:, 11:]})
    server = BatchedServer(cfg, params, slots=2, prompt_len=8,
                           cache_len=32, device="cpu")
    reqs = [Request(i, np.arange(1, 4 + i), max_new_tokens=3)
            for i in range(3)]
    server.serve(reqs)
    out[name] = {"finite": bool(torch.isfinite(logits).all()
                                and torch.isfinite(step).all()),
                 "tokens": [len(r.tokens_out) for r in reqs]}
out["foreign"] = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "repro.")))
out["foreign"] += ["repro"] if "repro" in sys.modules else []
print(json.dumps(out))
"""


def test_port_moe_and_rwkv_paths_run_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", _ARMS_SCRIPT],
                          capture_output=True, text=True, env=env,
                          timeout=240, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("qwen3-moe-30b-a3b", "rwkv6-3b"):
        assert doc[name] == {"finite": True, "tokens": [3, 3, 3]}, name
    assert doc["foreign"] == []
