"""Port's columnar track store vs the JAX package's, and the port alone.

The same seeded columns encode to the same shard bytes in both
packages; a store the port builds from the reference's golden archives
is byte-identical to the reference's build; every read selection and
every store task list agrees; and in the port, store-backed processing
equals the zip path bitwise (the twin of tests/test_store.py's golden
gate), on the CPU plain versions.
"""

import os

import numpy as np
import pytest
import torch

from repro.store import TrackStore as JaxTrackStore
from repro.store import build_store as jax_build_store
from repro.store import codec as jax_codec
from repro.tracks.archive import Archiver, archive_tasks_from_tree
from repro.tracks.datasets import ScaledDatasetSpec, write_scaled_dataset
from repro.tracks.organize import Organizer, organize_tasks_from_dir
from repro.tracks.registry import synthetic_registry
from repro.tracks.segments import \
    segment_tasks_from_store as jax_tasks_from_store
from repro_torch.store import (
    StoreManifest, TrackStore, build_store, codec, make_store_uri,
    parse_store_uri)
from repro_torch.store import reader as port_reader
from repro_torch.store import uri as port_uri
from repro_torch.tracks.segments import (
    SegmentProcessor, segment_tasks_from_archive_tree,
    segment_tasks_from_store)

torch.set_num_threads(1)

PLANE_FIELDS = ("times", "lat", "lon", "alt_msl_m", "alt_agl_m",
                "vrate_ms", "gspeed_ms", "heading_rad", "turn_rad_s")


def _columns(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 500))
    return {
        "time": np.sort(rng.uniform(0, 3600, n)),
        "lat": rng.uniform(24, 48, n),
        "lon": rng.uniform(-125, -67, n),
        "alt": rng.uniform(0, 12000, n).astype(np.float32),
        "icao_codes": rng.integers(0, 2 ** 32 - 1, n).astype(np.uint32),
        "offsets": np.cumsum(rng.integers(0, 9, 6)).astype(np.int64),
    }


@pytest.mark.parametrize("compression", ["zlib", "none"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_shard_same_bytes(seed, compression):
    cols = _columns(seed)
    meta = {"shard_id": f"s{seed:05d}", "icao_values": ["a1b2c3", "abc"]}
    got = codec.encode_shard(cols, meta=meta, compression=compression)
    want = jax_codec.encode_shard(cols, meta=meta, compression=compression)
    assert got == want
    decoded, meta2 = codec.decode_shard(want)
    assert meta2 == meta
    for name, arr in cols.items():
        assert decoded[name].tobytes() == arr.tobytes()


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The reference's golden archives, and one store built from them by
    each package."""
    root = tmp_path_factory.mktemp("torch_store_golden")
    raw, org, arc = (str(root / d) for d in ("raw", "org", "arc"))
    write_scaled_dataset(raw, ScaledDatasetSpec(name="g", n_files=4,
                                                scale=1e4))
    organizer = Organizer(org, synthetic_registry(n=2000, seed=13))
    for t in organize_tasks_from_dir(raw):
        organizer(t)
    archiver = Archiver(org, arc)
    for t in archive_tasks_from_tree(org):
        archiver(t)
    store, ref_store = str(root / "store"), str(root / "ref_store")
    return {"arc": arc, "store": store, "ref_store": ref_store,
            "manifest": build_store(arc, store, target_points=400),
            "ref_manifest": jax_build_store(arc, ref_store,
                                            target_points=400)}


def test_store_build_byte_identical_to_reference(golden):
    m, ref = golden["manifest"], golden["ref_manifest"]
    assert len(m.shards) > 1
    assert m.canonical_bytes() == ref.canonical_bytes()
    for s in m.shards:
        with open(os.path.join(golden["store"], s.filename), "rb") as a, \
                open(os.path.join(golden["ref_store"], s.filename),
                     "rb") as b:
            assert a.read() == b.read()
    assert StoreManifest.load(golden["store"]).canonical_bytes() == \
        m.canonical_bytes()


def _selections(manifest):
    s0, s1 = manifest.shards[0].shard_id, manifest.shards[-1].shard_id
    return [{"track": manifest.tracks[0].track_id},
            {"track": manifest.tracks[-1].track_id},
            {"shard": s0}, {"shard": s1, "rows": "1:4"},
            {"shard": s0, "rows": "2:"}, {}]


def test_selections_read_back_equal(golden):
    port = TrackStore(golden["store"])
    ref = JaxTrackStore(golden["store"])
    for sel in _selections(golden["manifest"]):
        got, want = port.read_selection(sel), ref.read_selection(sel)
        assert [t for t, _, _ in got] == [t for t, _, _ in want], sel
        for (_, go, gs), (_, wo, ws) in zip(got, want):
            assert gs == ws
            for k in ("time", "lat", "lon", "alt", "icao24"):
                np.testing.assert_array_equal(go[k], wo[k])
    tid = golden["manifest"].tracks[3].track_id
    for k, v in port.read_track(tid).items():
        np.testing.assert_array_equal(v, ref.read_track(tid)[k])


def test_uri_grammar_has_one_home(golden):
    assert port_reader.parse_store_uri is port_uri.parse_store_uri
    assert port_reader.make_store_uri is port_uri.make_store_uri
    uri = make_store_uri(golden["store"], shard="s00001", rows="0:8")
    assert parse_store_uri(uri) == (golden["store"],
                                    {"rows": "0:8", "shard": "s00001"})


@pytest.mark.parametrize("granularity", ["shard", "track", "rows"])
def test_store_tasks_match_reference(golden, granularity):
    got = segment_tasks_from_store(golden["store"], granularity, 3)
    want = jax_tasks_from_store(golden["store"], granularity, 3)
    assert len(got) > 1
    assert [(t.task_id, t.size_bytes, t.payload) for t in got] == \
        [(t.task_id, t.size_bytes, t.payload) for t in want]


def _assert_same(a, b):
    assert a.icao24 == b.icao24 and a.airspace == b.airspace
    np.testing.assert_array_equal(a.count, b.count)
    for f in PLANE_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def test_store_vs_zip_process_batch_bitwise(golden):
    ztasks = segment_tasks_from_archive_tree(golden["arc"])
    ttasks = segment_tasks_from_store(golden["store"], granularity="track")
    assert [t.task_id.replace(os.sep, "/") for t in ztasks] == \
        [t.task_id for t in ttasks]
    proc = SegmentProcessor(device="cpu")
    bz = proc.process_batch(ztasks)
    bs = proc.process_batch(ttasks)
    assert len(bz) == len(bs) == len(ztasks)
    for t in ztasks:
        _assert_same(bz[t.task_id], bs[t.task_id.replace(os.sep, "/")])


def test_shard_tasks_and_process_store_agree(golden):
    proc = SegmentProcessor(device="cpu")
    per_track = proc.process_batch(
        segment_tasks_from_store(golden["store"], granularity="track"))
    via_shards: dict = {}
    for res in proc.process_batch(segment_tasks_from_store(
            golden["store"], granularity="shard")).values():
        via_shards.update(res)
    via_stream = proc.process_store(golden["store"], prefetch=2)
    assert set(per_track) == set(via_shards) == set(via_stream)
    for tid in per_track:
        _assert_same(per_track[tid], via_shards[tid])
        _assert_same(per_track[tid], via_stream[tid])


def test_processor_pickles_without_its_stores(golden):
    import pickle
    proc = SegmentProcessor(device="cpu")
    proc.read_observations(make_store_uri(
        golden["store"], track=golden["manifest"].tracks[0].track_id))
    assert proc._stores
    clone = pickle.loads(pickle.dumps(proc))
    assert clone._stores == {}
    tid = golden["manifest"].tracks[1].track_id
    uri = make_store_uri(golden["store"], track=tid)
    _assert_same(clone.process_file(uri), proc.process_file(uri))
