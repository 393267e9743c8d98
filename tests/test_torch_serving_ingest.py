"""Port continuous ingest and store front end (``repro_torch.serving``)
vs the JAX package's ``repro.serving``, and the port alone.

Both packages run the same numpy and the same byte-level codec, so the
tolerance is exact equality: byte-identical feed files, equal lifecycle
hook sequences, equal ``stats`` (an injected tick clock makes
``last_commit_at`` comparable too), equal retained state and query
answers, and sealed stores byte-identical to each other and to a batch
``build_store``.  The store manifest records the absolute feed root, so
every run whose store is compared runs at one path (``base/run``) and is
moved aside after, as in tests/test_torch_workflow_dag.py.
"""

from __future__ import annotations

import os
import random
import shutil
import tempfile
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.serving as jax_serving
import repro.serving.service as jax_service
import repro.store.format as jax_format
import repro.store.reader as jax_reader
import repro.store.writer as jax_writer
import repro_torch.serving as port_serving
import repro_torch.serving.service as port_service
import repro_torch.store.format as port_format
import repro_torch.store.reader as port_reader
import repro_torch.store.writer as port_writer

PKGS = {
    "jax": types.SimpleNamespace(
        serving=jax_serving, service=jax_service,
        StoreManifest=jax_format.StoreManifest,
        TrackStore=jax_reader.TrackStore, build_store=jax_writer.build_store),
    "port": types.SimpleNamespace(
        serving=port_serving, service=port_service,
        StoreManifest=port_format.StoreManifest,
        TrackStore=port_reader.TrackStore,
        build_store=port_writer.build_store),
}

# tests/test_serving_ingest.py:33-34: a dozen small feed files cut
# several shards before seal.
TARGET = 96
SPEC_KW = dict(n_files=12, obs_per_file=48, seed=3)
HOOKS = ("scan", "cut", "pre_build", "post_build", "pre_commit",
         "post_commit", "seal")


class _TickClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _store_bytes(root: str) -> list[bytes]:
    """The manifest, then every shard file it names, as bytes."""
    manifest = port_format.StoreManifest.load(root)
    return [_read(os.path.join(root, "store_manifest.json"))] + [
        _read(os.path.join(root, s.filename)) for s in manifest.shards]


def _read_all(p, store_dir, manifest=None):
    store = p.TrackStore(store_dir, manifest=manifest, prefetch=0)
    items = []
    for plan in store.plan():
        batch = store.read_shard_batch(plan.shard.shard_id)
        items.extend((tid, obs) for tid, (obs, _s) in zip(batch.track_ids,
                                                          batch.items))
    return items


def _norm(info: dict) -> dict:
    """Hook info as plain data (a ShardPlan is each package's class)."""
    out = {}
    for k, v in info.items():
        out[k] = (v.shard_id, v.sources) if k == "plan" else v
    return out


def _at(base, pkg: str, fn, *args):
    """Run ``fn(PKGS[pkg], run_dir, *args)`` at ``base/run``, then move
    the tree to ``base/<pkg>``; return fn's result."""
    run = base / "run"
    shutil.rmtree(run, ignore_errors=True)
    run.mkdir()
    out = fn(PKGS[pkg], str(run), *args)
    shutil.rmtree(base / pkg, ignore_errors=True)
    shutil.move(str(run), str(base / pkg))
    return out


# -- feeds ----------------------------------------------------------------


@pytest.mark.parametrize("spec_kw", [
    dict(), dict(n_files=12, obs_per_file=48, seed=3),
    dict(n_files=5, obs_per_file=8, seed=11, update_period_s=4.0),
    dict(n_files=3, obs_per_file=200, seed=7),
])
def test_synthetic_feed_same_bytes(tmp_path, spec_kw):
    files = {}
    for pkg, p in PKGS.items():
        root = tmp_path / pkg
        root.mkdir()
        feed = p.serving.SyntheticFeed(str(root),
                                       p.serving.FeedSpec(**spec_kw))
        paths = feed.emit(2) + feed.emit_all()
        assert feed.exhausted and feed.emitted == feed.total
        files[pkg] = [(os.path.basename(q), _read(q)) for q in paths]
    assert files["port"] == files["jax"]
    assert len(files["port"]) == port_serving.FeedSpec(**spec_kw).n_files


# -- a scripted poll/seal sequence ---------------------------------------


def _scripted(p, run: str, emits: tuple) -> dict:
    feed_dir, store_dir = os.path.join(run, "feed"), os.path.join(run,
                                                                  "store")
    os.makedirs(feed_dir)
    events = []
    hooks = {name: (lambda name: lambda **info: events.append(
        (name, _norm(info))))(name) for name in HOOKS}
    feed = p.serving.SyntheticFeed(feed_dir, p.serving.FeedSpec(**SPEC_KW))
    svc = p.serving.IngestService(feed_dir, store_dir, target_points=TARGET,
                                  hooks=hooks, clock=_TickClock())
    answers = []
    for k in emits:
        feed.emit(k)
        committed = svc.poll_once()
        tids = sorted(svc.retained)
        answers.append({
            "committed": committed, "lag": svc.ingest_lag(),
            "generation": svc.generation, "stats": dict(svc.stats),
            "latest": [svc.latest(track_id=t) for t in tids[:3]],
            "by_icao": [svc.latest(icao24=i)
                        for i in sorted(svc.retained_by_icao)[:3]],
            "nearest": [svc.nearest(lat, lon) for lat, lon in
                        ((39.0, -98.0), (30.5, -120.0), (45.0, -70.0))],
        })
    manifest = svc.seal()
    return {"events": events, "answers": answers,
            "stats": dict(svc.stats), "retained": svc.retained,
            "by_icao": svc.retained_by_icao, "sealed": svc.sealed,
            "generation": manifest.generation,
            "store": _store_bytes(store_dir)}


@pytest.mark.parametrize("emits", [(1, 3, 2, 4, 2), (12,), (2, 2, 2, 2, 4)])
def test_scripted_ingest_equals_reference(tmp_path, emits):
    want = _at(tmp_path, "jax", _scripted, emits)
    got = _at(tmp_path, "port", _scripted, emits)
    assert got == want
    names = [name for name, _info in got["events"]]
    assert names[-1] == "seal" and names.count("cut") >= 2
    assert got["sealed"] and got["stats"]["files_accepted"] == 12
    # Sealed live store == a batch build over the same feed directory.
    batch = str(tmp_path / "batch")
    shutil.move(str(tmp_path / "port"), str(tmp_path / "run"))
    port_writer.build_store(str(tmp_path / "run" / "feed"), batch,
                            target_points=TARGET)
    assert _store_bytes(str(tmp_path / "run" / "store")) \
        == _store_bytes(batch) == got["store"]


# -- mid-append kill + restart -------------------------------------------


def _kill_resume(p, run: str, opseed: int, kill_at: int) -> dict:
    rng = random.Random(opseed)
    feed_dir = os.path.join(run, "feed")
    store_dir = os.path.join(run, "store")
    os.makedirs(feed_dir)
    feed = p.serving.SyntheticFeed(feed_dir, p.serving.FeedSpec(**SPEC_KW))
    events = []

    def bomb(name):
        def hook(**info):
            events.append((name, _norm(info)))
            if len(events) == kill_at:
                raise p.serving.ServiceKilled(f"kill at event {kill_at}")
        return hook

    svc = p.serving.IngestService(feed_dir, store_dir, target_points=TARGET,
                                  hooks={n: bomb(n) for n in HOOKS})
    killed = False
    try:
        while not feed.exhausted:
            feed.emit(rng.randint(1, 3))
            svc.poll_once()
        svc.seal()
    except p.serving.ServiceKilled:
        killed = True
    feed.emit_all()
    svc2 = p.serving.IngestService(feed_dir, store_dir, target_points=TARGET)
    resumed_sealed = svc2.sealed
    if not svc2.sealed:
        svc2.poll_once()
        svc2.seal()
    svc3 = p.serving.IngestService(feed_dir, store_dir, target_points=TARGET)
    return {"events": events, "killed": killed,
            "resumed_sealed": resumed_sealed, "sealed": svc3.sealed,
            "retained": svc3.retained, "store": _store_bytes(store_dir)}


@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 60))
@settings(max_examples=10, deadline=None)
def test_mid_append_kill_resume_equals_reference(opseed, kill_at):
    import pathlib
    base = pathlib.Path(tempfile.mkdtemp(prefix="torch-serving-kill-"))
    try:
        want = _at(base, "jax", _kill_resume, opseed, kill_at)
        got = _at(base, "port", _kill_resume, opseed, kill_at)
        assert got == want
        assert got["sealed"]
        # The resumed store is a batch build's bytes.
        shutil.move(str(base / "port"), str(base / "run"))
        port_writer.build_store(str(base / "run" / "feed"),
                                str(base / "batch"), target_points=TARGET)
        assert got["store"] == _store_bytes(str(base / "batch"))
        assert set(got["retained"]) == {
            t.track_id for t in port_format.StoreManifest.load(
                str(base / "batch")).tracks}
    finally:
        shutil.rmtree(base, ignore_errors=True)


def _restart(p, run: str) -> dict:
    feed_dir, store_dir = os.path.join(run, "feed"), os.path.join(run,
                                                                  "store")
    os.makedirs(feed_dir)
    feed = p.serving.SyntheticFeed(feed_dir, p.serving.FeedSpec(**SPEC_KW))
    svc = p.serving.IngestService(feed_dir, store_dir, target_points=TARGET)
    feed.emit(8)
    svc.poll_once()
    svc2 = p.serving.IngestService(feed_dir, store_dir, target_points=TARGET)
    fresh = svc2.scan()
    return {"generation": svc.generation,
            "committed": svc.stats["shards_committed"],
            "pending": sorted(t for t, _p, _s in svc._pending),
            "fresh": [(t, s) for t, _p, s in fresh],
            "poll": svc2.poll_once(), "generation2": svc2.generation,
            "committed2": svc2.stats["shards_committed"],
            "retained2": svc2.retained}


def test_restart_does_not_reingest_committed(tmp_path):
    want = _at(tmp_path, "jax", _restart)
    got = _at(tmp_path, "port", _restart)
    assert got == want
    assert got["committed"] >= 1
    # Only the never-committed remainder reappears, and stays pending.
    assert [t for t, _s in got["fresh"]] == got["pending"]
    assert got["poll"] == 0 and got["committed2"] == 0
    assert got["generation2"] == got["generation"]


def test_sealed_service_refuses_accepts(tmp_path):
    feed_dir, store_dir = str(tmp_path / "feed"), str(tmp_path / "store")
    os.makedirs(feed_dir)
    feed = port_serving.SyntheticFeed(
        feed_dir, port_serving.FeedSpec(n_files=3, obs_per_file=16))
    svc = port_serving.IngestService(feed_dir, store_dir,
                                     target_points=TARGET)
    feed.emit_all()
    svc.poll_once()
    svc.seal()
    with pytest.raises(RuntimeError, match="sealed"):
        svc.accept(svc.scan())
    # A service reopened on the sealed store is sealed too.
    again = port_serving.IngestService(feed_dir, store_dir,
                                       target_points=TARGET)
    assert again.sealed
    with pytest.raises(RuntimeError, match="sealed"):
        again.accept([("x.csv", os.path.join(feed_dir, "x.csv"), 100)])


def _dag(p, run: str, n_workers: int) -> dict:
    feed_dir, store_dir = os.path.join(run, "feed"), os.path.join(run,
                                                                  "store")
    os.makedirs(feed_dir)
    feed = p.serving.SyntheticFeed(feed_dir, p.serving.FeedSpec(**SPEC_KW))
    svc = p.serving.IngestService(feed_dir, store_dir, target_points=TARGET)

    def stop_when():
        if not feed.exhausted:
            feed.emit(3)
            return False
        return not svc.scan()

    svc.run_service(backend="threads", n_workers=n_workers,
                    stop_when=stop_when)
    stats = {k: v for k, v in svc.stats.items() if k != "last_commit_at"}
    stats.pop("scans")           # one per DAG tick: timing-dependent
    return {"sealed": svc.sealed, "stats": stats, "retained": svc.retained,
            "store": _store_bytes(store_dir)}


@pytest.mark.parametrize("n_workers", [1, 2])
def test_run_service_threads_seals_to_batch_bytes(tmp_path, n_workers):
    want = _at(tmp_path, "jax", _dag, n_workers)
    got = _at(tmp_path, "port", _dag, n_workers)
    assert got == want and got["sealed"]
    shutil.move(str(tmp_path / "port"), str(tmp_path / "run"))
    port_writer.build_store(str(tmp_path / "run" / "feed"),
                            str(tmp_path / "batch"), target_points=TARGET)
    assert got["store"] == _store_bytes(str(tmp_path / "batch"))


# -- the store front end -------------------------------------------------


def _front(p, run: str) -> dict:
    """Generation pinning across commits, slot rejection without a
    pinned manifest, one shard decode per step."""
    feed_dir, store_dir = os.path.join(run, "feed"), os.path.join(run,
                                                                  "store")
    os.makedirs(feed_dir)
    Query = p.service.Query
    feed = p.serving.SyntheticFeed(feed_dir, p.serving.FeedSpec(**SPEC_KW))
    svc = p.serving.IngestService(feed_dir, store_dir, target_points=TARGET)
    feed.emit(6)
    svc.poll_once()
    pinned = p.StoreManifest.load(store_dir)
    front = p.serving.StoreFrontEnd(svc, tiny_slots=1, bulk_slots=1)
    log = {"pinned_generation": pinned.generation}
    snap = Query(1, "snapshot")
    log["admit_snap"] = front.admit(snap)
    log["snap_generation"] = snap.generation
    second = Query(2, "snapshot", {"digest": True})
    log["admit_second"] = front.admit(second)
    log["second_trace"] = (second.generation,
                           second.query_id in front._bulk_reads)
    steps = []

    def step():
        before = front.stats["shard_decodes"]
        done = [q.query_id for q in front.step()]
        steps.append((front.stats["shard_decodes"] - before, done))

    step()
    feed.emit_all()
    svc.poll_once()
    svc.seal()
    log["after_generation"] = svc.generation
    tiny = Query(3, "latest", {"track_id": sorted(svc.retained)[-1]})
    log["admit_tiny"] = front.admit(tiny)
    log["admit_tiny2"] = front.admit(Query(4, "nearest",
                                           {"lat": 40.0, "lon": -100.0}))
    while not (snap.done and tiny.done):
        step()
    log["admit_second_again"] = front.admit(second)
    while not second.done:
        step()
    near = Query(5, "nearest", {"lat": 40.0, "lon": -100.0})
    by_icao = Query(6, "latest", {"icao24": sorted(svc.retained_by_icao)[0]})
    served = front.serve([near, by_icao])
    log.update({
        "steps": steps, "stats": dict(front.stats),
        "tiny": (tiny.generation, tiny.result),
        "snap_ids": [tid for tid, _obs in snap.result],
        "snap_digest": p.service.snapshot_digest(snap.result),
        "pinned_digest": p.service.snapshot_digest(
            _read_all(p, store_dir, manifest=pinned)),
        "pinned_ids": [t.track_id for t in pinned.tracks],
        "second": (second.generation, second.result),
        "served": [(q.query_id, q.generation, q.result) for q in served],
        "busy": front.busy,
    })
    return log


def test_front_end_interleaving_equals_reference(tmp_path):
    want = _at(tmp_path, "jax", _front)
    got = _at(tmp_path, "port", _front)
    assert got == want
    # Pinning: the snapshot returned exactly the pinned generation.
    assert got["snap_generation"] == got["pinned_generation"] >= 1
    assert got["after_generation"] > got["pinned_generation"]
    assert sorted(got["snap_ids"]) == sorted(got["pinned_ids"])
    assert got["snap_digest"] == got["pinned_digest"]
    assert got["tiny"][0] == got["after_generation"]
    # Rejection leaves no pinned manifest and no partial read.
    assert got["admit_snap"] and not got["admit_second"]
    assert got["second_trace"] == (None, False)
    assert got["admit_tiny"] and not got["admit_tiny2"]
    assert got["admit_second_again"]
    assert got["second"][0] == got["after_generation"]
    # At most one shard decode per step with one bulk slot.
    assert all(n <= 1 for n, _done in got["steps"])
    assert sum(n for n, _d in got["steps"]) == got["stats"]["shard_decodes"]
    # Two rejections above, and serve() re-offers its second tiny query
    # once while its one tiny slot is held.
    assert got["stats"]["rejected"] == 3 and not got["busy"]


def test_query_kinds_and_slots_validate():
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="unknown query kind"):
            pkg.service.Query(1, "export")
    assert port_service.TINY_KINDS == jax_service.TINY_KINDS
    assert port_service.BULK_KINDS == jax_service.BULK_KINDS
    assert port_serving.__all__ == jax_serving.__all__
    with pytest.raises(ValueError, match="at least one slot"):
        port_serving.StoreFrontEnd(types.SimpleNamespace(tracer=None),
                                   tiny_slots=0)
    with pytest.raises(ValueError, match="needs track_id= or icao24="):
        port_serving.IngestService("/nonexistent/feed",
                                   "/nonexistent/store").latest()
