"""Self-scheduled training-data ingestion.

Port of ``repro/data/pipeline.py`` (host work; no torch).  The paper's
manager/worker loop applied to the input layer: training shards are
tasks, ingest hosts are workers.  The manager hands out shards
largest-first; a straggling host simply claims fewer shards, and a dead
host's in-flight shards are re-queued — the same straggler story as
§IV.A, now protecting the training input pipeline.

Ingest runs on the unified runtime (:func:`repro_torch.runtime.run_job`),
so the 'hosts' can be threads (default) or real OS processes, started
by the runtime's rule (spawned once torch has initialised CUDA; a
forked worker runs one intra-op thread).  Each shard's sequences return
to the manager inside the DONE message.  The loader exposes a per-step
iterator of fixed-shape (tokens, labels) numpy batches, which the
trainer moves to its device.

Shard files and the on-disk manifest come from :mod:`repro_torch.store`
— the same checksummed columnar codec and ``StoreManifest`` index the
track store uses — so for one seed the shard files and
``store_manifest.json`` are the JAX package's byte for byte;
:class:`ShardManifest` here is just the loader-facing view of a store
``ShardRecord``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from collections import deque
from typing import Callable, Iterator

import numpy as np

from repro_torch.core.messages import Task
from repro_torch.runtime import run_job
from repro_torch.store import codec
from repro_torch.store.format import ShardRecord, StoreManifest

TOKEN_SHARD_SUFFIX = ".shard"


@dataclasses.dataclass(frozen=True)
class ShardManifest:
    """Loader view of one token shard (see module docstring)."""

    shard_id: str
    path: str
    n_tokens: int
    size_bytes: int

    @classmethod
    def from_record(cls, root: str, rec: ShardRecord) -> "ShardManifest":
        return cls(shard_id=rec.shard_id,
                   path=os.path.join(root, rec.filename),
                   n_tokens=rec.n_points, size_bytes=rec.size_bytes)


def token_shard_manifests(root: str) -> list[ShardManifest]:
    """Loader views for every shard in a token store directory."""
    manifest = StoreManifest.load(root)
    return [ShardManifest.from_record(root, rec)
            for rec in manifest.shards]


def synthetic_token_shards(root: str, *, n_shards: int = 16,
                           vocab_size: int = 512,
                           tokens_per_shard_mean: int = 65536,
                           seed: int = 0,
                           token_sampler: Callable[
                               [np.random.Generator, int], np.ndarray]
                           | None = None) -> list[ShardManifest]:
    """Heavy-tailed shard sizes (like the aerodrome dataset's Fig 3).

    Written as a :mod:`repro_torch.store` store: checksummed codec
    shards plus a ``store_manifest.json`` index (re-openable later with
    :func:`token_shard_manifests`).  Token ids are uniform below
    ``vocab_size`` unless ``token_sampler(rng, n)`` draws them (int32
    ids below ``vocab_size``, from the shard sizes' ``rng``)."""
    rng = np.random.default_rng(seed)
    records = []
    w = rng.pareto(1.5, size=n_shards) + 0.2
    w = w / w.mean()
    for i in range(n_shards):
        shard_id = f"shard_{i:05d}"
        n = max(int(tokens_per_shard_mean * w[i]), 2048)
        if token_sampler is None:
            toks = rng.integers(0, vocab_size, size=n, dtype=np.int32)
        else:
            toks = np.asarray(token_sampler(rng, n), np.int32)
        data = codec.encode_shard({"tokens": toks},
                                  meta={"shard_id": shard_id,
                                        "vocab_size": vocab_size})
        filename = f"{shard_id}{TOKEN_SHARD_SUFFIX}"
        path = os.path.join(root, filename)
        os.makedirs(root, exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        records.append(ShardRecord(
            shard_id=shard_id, filename=filename, n_tracks=1,
            n_points=n, size_bytes=len(data),
            sha256=hashlib.sha256(data).hexdigest()))
    StoreManifest(compression="zlib", shards=records,
                  meta={"kind": "token-shards",
                        "vocab_size": vocab_size}).save(root)
    return [ShardManifest.from_record(root, rec) for rec in records]


class SelfScheduledLoader:
    """Batches from shards claimed via largest-first self-scheduling."""

    def __init__(self, shards: list[ShardManifest], *,
                 batch_size: int, seq_len: int,
                 n_ingest_workers: int = 4,
                 organization: str = "largest_first",
                 poll_interval: float = 0.005,
                 exec_backend: str = "threads",
                 seed: int = 0):
        self.shards = shards
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.n_ingest_workers = n_ingest_workers
        self.organization = organization
        self.poll_interval = poll_interval
        self.exec_backend = exec_backend
        self.rng = np.random.default_rng(seed)
        self._buf: deque[np.ndarray] = deque()
        self._ingested_tokens = 0
        self._run_ingest()

    # -- ingest phase (the paper's protocol) -------------------------------

    def _ingest_shard(self, task: Task) -> np.ndarray:
        """Worker fn: shard file -> (n_seq, seq_len+1) sequence array,
        returned to the manager in the DONE message.  Store-codec shards
        decode through the checksummed reader, so a corrupted shard
        fails the task loudly instead of training on garbage; bare
        ``.npy`` paths keep working for hand-rolled fixtures."""
        if task.payload.endswith(".npy"):
            toks = np.load(task.payload)
        else:
            cols, _meta = codec.read_shard(task.payload,
                                           columns=["tokens"])
            toks = cols["tokens"]
        L = self.seq_len + 1
        n_seq = len(toks) // L
        if n_seq == 0:
            return np.zeros((0, L), np.int32)
        return toks[: n_seq * L].reshape(n_seq, L).astype(np.int32)

    def _run_ingest(self) -> None:
        tasks = [Task(task_id=s.shard_id, size_bytes=s.size_bytes,
                      payload=s.path) for s in self.shards]
        self.job_result = run_job(
            tasks, self._ingest_shard,
            backend=self.exec_backend,
            n_workers=self.n_ingest_workers,
            organization=self.organization,
            poll_interval=self.poll_interval)
        # Deterministic buffer order regardless of DONE arrival order.
        for tid in sorted(self.job_result.results):
            seqs = self.job_result.results[tid]
            for s in seqs:
                self._buf.append(s)
            self._ingested_tokens += int(seqs.size)

    # -- batch iterator ----------------------------------------------------

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        order = self.rng.permutation(len(self._buf))
        seqs = list(self._buf)
        bs = self.batch_size
        for i in range(0, len(order) - bs + 1, bs):
            chunk = np.stack([seqs[j] for j in order[i:i + bs]])
            yield {"tokens": chunk[:, :-1].astype(np.int32),
                   "labels": chunk[:, 1:].astype(np.int32)}

    def batches(self, n: int) -> Iterator[dict[str, np.ndarray]]:
        """Infinite-ish batch stream (reshuffles each epoch)."""
        count = 0
        while count < n:
            for b in self:
                yield b
                count += 1
                if count >= n:
                    return
