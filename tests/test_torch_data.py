"""The port's data loader (``repro_torch.data.pipeline``) vs the JAX
package's, on the CPU.

For one seed the synthetic token store — every shard file and
``store_manifest.json`` — is the reference's byte for byte, and the
loader's batches equal the reference's array for array (exact: integer
token ids), on threads and on processes.  The port's processes run
goes through a fresh interpreter that never imports JAX: a live XLA
client in the parent would make a forked worker hang, and the port's
start-method rule looks only at torch.  The reference's own loader
tests (tests/test_data_serving.py, tests/test_store.py) are mirrored on
the port.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.data import pipeline as JP
from repro_torch.data import pipeline as P
from repro_torch.store import codec

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SHARDS = dict(n_shards=6, vocab_size=300, tokens_per_shard_mean=3000,
              seed=4)
LOADER = dict(batch_size=3, seq_len=20, n_ingest_workers=3,
              poll_interval=0.003, seed=9)
N_BATCHES = 12


def _tree_bytes(root) -> dict:
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root))}


def _batches(loader, n=N_BATCHES) -> list:
    return [(b["tokens"], b["labels"]) for b in loader.batches(n)]


def test_token_store_is_the_reference_byte_for_byte(tmp_path):
    mine = P.synthetic_token_shards(str(tmp_path / "port"), **SHARDS)
    ref = JP.synthetic_token_shards(str(tmp_path / "ref"), **SHARDS)
    got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "ref")
    assert list(got) == list(want)
    assert "store_manifest.json" in got and len(got) == SHARDS["n_shards"] + 1
    for name in want:
        assert got[name] == want[name], name
    assert [(s.shard_id, s.n_tokens, s.size_bytes) for s in mine] == \
        [(s.shard_id, s.n_tokens, s.size_bytes) for s in ref]
    reopened = P.token_shard_manifests(str(tmp_path / "port"))
    assert reopened == mine


def test_token_sampler_draws_the_ids_and_keeps_the_sizes(tmp_path):
    """A ``token_sampler`` (the port's one addition) changes only the
    ids: the shard sizes are the default store's, the ids are what the
    sampler drew from the sizes' rng, and the shards read back through
    the checksummed codec."""
    def zipf(rng, n):
        return np.minimum(rng.zipf(1.5, size=n), SHARDS["vocab_size"] - 1)

    plain = P.synthetic_token_shards(str(tmp_path / "plain"), **SHARDS)
    skewed = P.synthetic_token_shards(str(tmp_path / "zipf"), **SHARDS,
                                      token_sampler=zipf)
    assert [s.n_tokens for s in skewed] == [s.n_tokens for s in plain]
    rng = np.random.default_rng(SHARDS["seed"])
    rng.pareto(1.5, size=SHARDS["n_shards"])
    for shard in P.token_shard_manifests(str(tmp_path / "zipf")):
        cols, _ = codec.read_shard(shard.path, columns=["tokens"])
        assert cols["tokens"].dtype == np.int32
        np.testing.assert_array_equal(cols["tokens"],
                                      zipf(rng, shard.n_tokens))


def test_batches_equal_the_reference_on_threads(tmp_path):
    shards = P.synthetic_token_shards(str(tmp_path), **SHARDS)
    jshards = JP.token_shard_manifests(str(tmp_path))
    got = _batches(P.SelfScheduledLoader(shards, **LOADER))
    want = _batches(JP.SelfScheduledLoader(jshards, **LOADER))
    assert len(got) == len(want) == N_BATCHES
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt.dtype == wt.dtype == np.int32
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)


_PROCESSES_CHILD = r"""
import json, sys
import numpy as np
root, out = sys.argv[1], sys.argv[2]
kw = json.loads(sys.argv[3])
from repro_torch.data.pipeline import (SelfScheduledLoader,
                                       token_shard_manifests)
loader = SelfScheduledLoader(token_shard_manifests(root),
                             exec_backend="processes", **kw)
bs = list(loader.batches(int(sys.argv[4])))
np.savez(out, **{f"{k}{i}": b[k] for i, b in enumerate(bs)
                 for k in ("tokens", "labels")})
foreign = sorted(m for m in sys.modules
                 if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({"n": len(bs), "foreign": foreign,
                  "results": len(loader.job_result.results)}))
"""


def test_batches_equal_the_reference_on_processes(tmp_path):
    """The port's processes backend (fork: torch has not initialised
    CUDA) in an interpreter without JAX, against the reference's
    processes backend here (spawn: XLA is live)."""
    root = str(tmp_path / "shards")
    P.synthetic_token_shards(root, **SHARDS)
    out = str(tmp_path / "port.npz")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", _PROCESSES_CHILD, root, out,
         json.dumps(LOADER), str(N_BATCHES)],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc == {"n": N_BATCHES, "foreign": [],
                   "results": SHARDS["n_shards"]}
    ref = JP.SelfScheduledLoader(JP.token_shard_manifests(root),
                                 exec_backend="processes", **LOADER)
    want = _batches(ref)
    got = np.load(out)
    for i, (wt, wl) in enumerate(want):
        np.testing.assert_array_equal(got[f"tokens{i}"], wt)
        np.testing.assert_array_equal(got[f"labels{i}"], wl)


def test_loader_ingests_every_shard_once(tmp_path):
    shards = P.synthetic_token_shards(str(tmp_path), n_shards=6,
                                      vocab_size=128,
                                      tokens_per_shard_mean=4000)
    loader = P.SelfScheduledLoader(shards, batch_size=2, seq_len=32,
                                   poll_interval=0.003)
    assert len(loader.job_result.results) == 6
    L = 33
    assert loader._ingested_tokens == sum((s.n_tokens // L) * L
                                          for s in shards)
    assert loader.job_result.messages_sent == 6


def test_loader_batch_shapes_and_shift(tmp_path):
    shards = P.synthetic_token_shards(str(tmp_path), n_shards=4,
                                      vocab_size=64,
                                      tokens_per_shard_mean=3000, seed=1)
    loader = P.SelfScheduledLoader(shards, batch_size=3, seq_len=16,
                                   poll_interval=0.003, seed=7)
    batches = list(loader.batches(5))
    assert len(batches) == 5
    for b in batches:
        assert b["tokens"].shape == b["labels"].shape == (3, 16)
        assert b["tokens"].dtype == b["labels"].dtype == np.int32
        np.testing.assert_array_equal(b["tokens"][:, 1:],
                                      b["labels"][:, :-1])


def test_npy_shards_and_corruption(tmp_path):
    """Bare .npy shards load as in the reference (the trainer test's
    Zipf fixture); a corrupted store shard fails the ingest job."""
    rng = np.random.default_rng(0)
    npy = []
    for i in range(3):
        toks = np.minimum(rng.zipf(1.5, size=700), 99).astype(np.int32)
        path = str(tmp_path / f"s{i}.npy")
        np.save(path, toks)
        npy.append(P.ShardManifest(f"s{i}", path, len(toks),
                                   int(toks.nbytes)))
    got = _batches(P.SelfScheduledLoader(npy, **LOADER), 4)
    want = _batches(JP.SelfScheduledLoader(
        [JP.ShardManifest(*vars(s).values()) for s in npy], **LOADER), 4)
    for (gt, gl), (wt, wl) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)

    shards = P.synthetic_token_shards(str(tmp_path / "st"), n_shards=4,
                                      tokens_per_shard_mean=4096, seed=3)
    cols, meta = codec.read_shard(shards[0].path)
    assert meta["shard_id"] == shards[0].shard_id
    assert len(cols["tokens"]) == shards[0].n_tokens
    blob = bytearray(open(shards[1].path, "rb").read())
    blob[-1] ^= 0xFF
    with open(shards[1].path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(RuntimeError, match="failed"):
        P.SelfScheduledLoader(shards, batch_size=2, seq_len=32,
                              n_ingest_workers=2, poll_interval=0.003)
