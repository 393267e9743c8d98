"""Port tracing layer (``repro_torch.obs``) vs the JAX package's
``repro.obs``, and the port alone.

The tracer's mechanics are those tests/test_obs.py checks (ring
eviction and ``dropped``, the raw fast path, clock rebinding,
``phase_of``), held on the port and against the reference on the same
event sequence.  The discrete-event sim runs the same float arithmetic
in both packages, so a traced sim run through ``run_job`` (worker
deaths, several tasks a message) or ``run_dag`` gives event lists equal
tuple for tuple, virtual ``ts`` and ``dur`` included, and summaries whose
``canonical_bytes`` are identical.  The exporters (Perfetto docs,
``from_chrome_trace``, ``render_report`` lines), the schema validators
(valid and broken docs) and the store reader's spans on a fake clock
agree with the reference's too, and so do the serving events on an
injected clock: the ingest lifecycle, the store reader over a store the
ingest service committed, and the query front end's admissions,
rejections and spans.  Everything passes between the two packages as
plain Python data or JSON.
"""

from __future__ import annotations

import copy
import json
import threading

import pytest

import repro.bench.schema as jax_schema
import repro.core.cost_model as jax_cost
import repro.core.messages as jax_messages
import repro.obs as jax_obs
import repro.obs.report as jax_report
import repro.runtime as jax_runtime
import repro.runtime.dag as jax_dag
import repro_torch.bench.schema as port_schema
import repro_torch.core.cost_model as port_cost
import repro_torch.core.messages as port_messages
import repro_torch.obs as port_obs
import repro_torch.obs.report as port_report
import repro_torch.runtime as port_runtime
import repro_torch.runtime.dag as port_dag
from repro_torch.obs import INSTANT, Tracer, phase_of

PACKAGES = {
    "jax": (jax_obs, jax_messages.Task, jax_runtime, jax_dag, jax_cost,
            jax_schema),
    "port": (port_obs, port_messages.Task, port_runtime, port_dag,
             port_cost, port_schema),
}


class _TickClock:
    """Fake monotonic clock: advances one unit per reading."""

    def __init__(self, step=1.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


class _ThreadTickClock:
    """A tick clock per thread: each thread's readings are the same
    whatever the threads' interleaving."""

    def __init__(self):
        self._local = threading.local()

    def __call__(self):
        t = getattr(self._local, "t", 0.0) + 1.0
        self._local.t = t
        return t


def _tasks(task_cls, n, *, mb=4):
    return [task_cls(task_id=f"t{i:04d}", size_bytes=(i % 5 + 1) * mb
                     * 100_000, timestamp=i) for i in range(n)]


# ---------------------------------------------------------------------------
# Tracer mechanics.
# ---------------------------------------------------------------------------

def test_ring_eviction_and_dropped_accounting():
    trs = {pkg: PACKAGES[pkg][0].Tracer(capacity=4) for pkg in PACKAGES}
    for tr in trs.values():
        for i in range(10):
            tr.emit(float(i), INSTANT, "e", "task", 0, f"t{i}")
    tr = trs["port"]
    assert len(tr) == 4
    assert tr.dropped == 6
    # Oldest evicted first: the ring retains the newest four.
    assert [e[0] for e in tr.events] == [6.0, 7.0, 8.0, 9.0]
    assert tr.events == trs["jax"].events
    assert tr.dropped == trs["jax"].dropped
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0


def test_raw_fast_path_accounts_like_emit():
    a, b = Tracer(capacity=3), Tracer(capacity=3)
    for i in range(5):
        a.emit(float(i), INSTANT, "e", "task", 0)
    raw = b.raw
    for i in range(5):
        raw((float(i), INSTANT, "e", "task", 0, None, None))
    b.emitted += 5
    assert b.events == a.events
    assert b.dropped == a.dropped == 2
    ref = jax_obs.Tracer(capacity=3)
    for i in range(5):
        ref.emit(float(i), INSTANT, "e", "task", 0)
    assert a.events == ref.events and a.dropped == ref.dropped


def test_clock_injection_and_rebind():
    got = []
    for pkg in ("port", "jax"):
        tr = PACKAGES[pkg][0].Tracer(clock=_TickClock())
        assert tr.now() == 1.0 and tr.now() == 2.0
        tr.instant("i", "sched", "m")          # reads the injected clock
        assert tr.events[-1][0] == 3.0
        tr.set_clock(lambda: 42.0)
        tr.span("s", "sched", "m", tr.now(), tr.now() + 1.0)
        assert tr.events[-1][:2] == (42.0, 1.0)
        got.append(tr.events)
    assert got[0] == got[1]


def test_capacity_validation():
    with pytest.raises(ValueError):
        Tracer(capacity=0)
    assert port_obs.DEFAULT_CAPACITY == jax_obs.DEFAULT_CAPACITY
    assert port_obs.EVENT_FIELDS == jax_obs.EVENT_FIELDS
    assert port_obs.CATEGORIES == jax_obs.CATEGORIES
    assert port_obs.INSTANT == jax_obs.INSTANT


@pytest.mark.parametrize("task_id", ["radar:t0042", "t0042", None,
                                     "screen:screen/t0_a4/g1", 7])
def test_phase_of_buckets(task_id):
    assert phase_of(task_id) == jax_obs.phase_of(task_id)
    assert phase_of("radar:t0042") == "radar"
    assert phase_of("t0042") == "all" and phase_of(None) == "all"


# ---------------------------------------------------------------------------
# Sim parity: run_job and run_dag, event for event.
# ---------------------------------------------------------------------------

def _traced_sim_job(pkg, n, k, org, seed, death, speed=None):
    obs, task_cls, runtime, _dag, cost, _schema = PACKAGES[pkg]
    tr = obs.Tracer()
    res = runtime.run_job(_tasks(task_cls, n), None, backend="sim",
                          n_workers=3, organization=org,
                          tasks_per_message=k, organize_seed=seed,
                          cost_model=cost.PHASES["process"],
                          worker_death=death, worker_speed=speed,
                          raise_on_failure=False, tracer=tr)
    return tr, res


@pytest.mark.parametrize("n,k,org,seed,death", [
    (12, 1, "largest_first", 0, {0: 2.0}),
    (30, 3, "chronological", 2, {0: 2.0}),
    (25, 2, "largest_first", 4, {0: 1.0, 2: 3.0}),
    (17, 3, "chronological", 1, None),
])
def test_sim_run_job_trace_equals_reference(n, k, org, seed, death):
    got, gres = _traced_sim_job("port", n, k, org, seed, death)
    want, wres = _traced_sim_job("jax", n, k, org, seed, death)
    assert len(gres.completed_ids) == n
    assert got.events == want.events
    assert got.dropped == want.dropped == 0
    assert port_schema.canonical_bytes(
        port_obs.summary_from_tracer(got, label="x")) \
        == jax_schema.canonical_bytes(
            jax_obs.summary_from_tracer(want, label="x"))
    if death:
        assert any(e[2] == "requeued" for e in got.events)
        assert any(e[2] == "worker_dead" for e in got.events)


def test_sim_straggler_trace_equals_reference():
    speed = [1.0, 0.25, 1.0]
    got, _ = _traced_sim_job("port", 60, 2, "largest_first", 0, None,
                             speed)
    want, _ = _traced_sim_job("jax", 60, 2, "largest_first", 0, None,
                              speed)
    assert got.events == want.events
    doc = port_obs.summary_from_tracer(got, label="s")
    assert port_schema.canonical_bytes(doc) == jax_schema.canonical_bytes(
        jax_obs.summary_from_tracer(want, label="s"))
    workers = {w: d for w, d in doc["workers"].items()
               if isinstance(d, dict)}
    assert min(workers, key=lambda w: workers[w]["speed_est"]) == "1"


def _fanout(task, _result):
    return [type(task)(task_id=f"{task.task_id}/{s}",
                       size_bytes=task.size_bytes, timestamp=task.timestamp)
            for s in ("x", "y")]


_MODEL_KW = dict(name="t", r_process=1e6, b_node=8e6, b_global=64e6,
                 cpu_rate=50e6, contention_alpha=0.001,
                 task_overhead_s=0.01, msg_overhead_s=0.001)


def _spec_dag(pkg, n=24):
    """``a`` streams 1:2 into ``b``; a barrier edge admits ``c``."""
    _obs, task_cls, _rt, dag_mod, cost, _schema = PACKAGES[pkg]
    tasks = [task_cls(task_id=f"d{i % 3}/t{i:04d}",
                      size_bytes=((i * 7919) % 97 + 1) * 100_000,
                      timestamp=float((i * 13) % n))
             for i in range(n)]
    dag = dag_mod.StreamingDAG()
    dag.add_node("a", tasks=tasks,
                 cost_model=cost.PhaseCostModel(**_MODEL_KW))
    dag.add_node("b")
    dag.add_node("c", cost_model=cost.PhaseCostModel(
        **dict(_MODEL_KW, name="c", cpu_rate=5e6)))
    dag.add_edge("a", "b", expand=_fanout)
    dag.add_edge("a", "c", on_complete=lambda: [
        task_cls(task_id=f"c{k:03d}", size_bytes=(k + 1) * 250_000,
                 timestamp=float(k)) for k in range(n // 3)])
    return dag


@pytest.mark.parametrize("shards,policy,tpm,death", [
    (1, "static", 2, None),
    (2, "sized_lpt", 1, None),
    (2, "fifo_selfsched", 2, {0: 0.5, 3: 1.5}),
])
def test_sim_run_dag_trace_equals_reference(shards, policy, tpm, death):
    kw = dict(backend="sim", n_workers=6, n_manager_shards=shards,
              tasks_per_message=tpm, policy=policy, worker_death=death,
              poll_interval=0.002,
              failure_timeout=1.0 if death else None)
    trs, res = {}, {}
    for pkg in ("port", "jax"):
        trs[pkg] = PACKAGES[pkg][0].Tracer()
        res[pkg] = PACKAGES[pkg][3].run_dag(_spec_dag(pkg), tracer=trs[pkg],
                                            **kw)
    got, want = trs["port"], trs["jax"]
    assert got.events == want.events
    assert {e[2] for e in got.events if e[3] == "dag"} \
        >= {"admit", "node_sealed", "node_complete"}
    assert {phase_of(e[5]) for e in got.events if e[2] == "exec"} \
        == {"a", "b", "c"}
    assert port_schema.canonical_bytes(
        port_obs.summary_from_tracer(got, label="dag")) \
        == jax_schema.canonical_bytes(
            jax_obs.summary_from_tracer(want, label="dag"))
    assert len(res["port"].node_completed["b"]) == 48


# ---------------------------------------------------------------------------
# Exporters and report.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sim_traces():
    """The same traced sim run in both packages, with a slowed worker."""
    out = {}
    for pkg in ("port", "jax"):
        obs, task_cls, runtime, _dag, cost, _schema = PACKAGES[pkg]
        tr = obs.Tracer()
        runtime.run_job(_tasks(task_cls, 40), None, backend="sim",
                        n_workers=4, cost_model=cost.PHASES["process"],
                        worker_speed=[1.0, 1.0, 0.25, 1.0], tracer=tr)
        out[pkg] = tr
    assert out["port"].events == out["jax"].events
    return out


def test_chrome_trace_docs_equal_reference(sim_traces):
    events = sim_traces["jax"].events
    got = port_obs.to_chrome_trace(events, label="rt")
    want = jax_obs.to_chrome_trace(events, label="rt")
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    doc = json.loads(json.dumps(got))
    assert port_obs.from_chrome_trace(doc) == jax_obs.from_chrome_trace(doc)
    assert len(port_obs.from_chrome_trace(doc)) == len(events)


def test_perfetto_round_trip_preserves_structure():
    tr = Tracer(clock=_TickClock())
    tr.instant("queued", "task", 0, task_id="a:t1")
    tr.span("exec", "task", 3, 10.0, 12.5, task_id="a:t1", extra=4096)
    tr.instant("admit", "dag", "radar", extra=7)
    doc = json.loads(json.dumps(port_obs.to_chrome_trace(tr.events,
                                                         label="rt")))
    back = port_obs.from_chrome_trace(doc)
    t0 = min(e[0] for e in tr.events)

    def norm(events, rel):
        return [(round(e[0] - (t0 if rel else 0.0), 6), round(e[1], 6),
                 e[2], e[3], str(e[4]), e[5], e[6]) for e in events]

    assert norm(back, rel=False) == norm(tr.events, rel=True)
    assert sum(1 for e in back if e[1] == INSTANT) == 2


def test_render_report_lines_equal_reference(sim_traces):
    events = sim_traces["jax"].events
    got = port_report.render_report(
        port_obs.build_summary(events, label="full"))
    want = jax_report.render_report(
        jax_obs.build_summary(events, label="full"))
    assert got == want
    text = "\n".join(got)
    for needle in ("makespan", "lifecycle:", "per-phase critical path:",
                   "slowest workers", "dispatch timeline"):
        assert needle in text


def test_write_trace_files_and_report_cli(sim_traces, tmp_path, capsys):
    tr = sim_traces["port"]
    paths = port_obs.write_trace_files(tr, str(tmp_path / "port"),
                                       label="smoke")
    ref = jax_obs.write_trace_files(sim_traces["jax"],
                                    str(tmp_path / "jax"), label="smoke")
    for kind in ("trace", "summary"):
        with open(paths[kind], "rb") as a, open(ref[kind], "rb") as b:
            assert a.read() == b.read()
    outs = {}
    for path in (paths["trace"], paths["summary"]):
        assert port_report.main([path]) == 0
        outs[path] = capsys.readouterr().out
        assert jax_report.main([path]) == 0
        assert capsys.readouterr().out == outs[path]
        assert "critical path" in outs[path]
        assert "slowest workers" in outs[path]
    rebuilt = tmp_path / "rebuilt.json"
    assert port_report.main([paths["trace"], "--summary-out",
                             str(rebuilt)]) == 0
    capsys.readouterr()
    doc = json.loads(rebuilt.read_bytes())
    assert port_schema.validate_obs_summary(doc) == []
    bogus = tmp_path / "nope.json"
    bogus.write_text('{"schema": "other/v1"}')
    assert port_report.main([str(bogus)]) == 1


# ---------------------------------------------------------------------------
# Schema validators.
# ---------------------------------------------------------------------------

def _breakages(doc):
    """Copies of ``doc`` broken one way each (deep copies)."""
    out = []
    for key in list(doc):
        bad = copy.deepcopy(doc)
        del bad[key]
        out.append(bad)
        bad = copy.deepcopy(doc)
        bad[key] = None
        out.append(bad)
    bad = copy.deepcopy(doc)
    bad["schema"] = "other/v1"
    out.append(bad)
    return out + [None, [], {}]


def test_obs_summary_validator_equals_reference(sim_traces):
    doc = json.loads(json.dumps(jax_obs.summary_from_tracer(
        sim_traces["jax"], label="v")))
    assert port_schema.validate_obs_summary(doc) == []
    broken = _breakages(doc)
    bad = copy.deepcopy(doc)
    bad["scenario"]["metrics"].pop("critical_path_s")
    broken.append(bad)
    bad = copy.deepcopy(doc)
    bad["scenario"]["metrics"]["makespan_s"] = "slow"
    broken.append(bad)
    for d in broken:
        got = port_schema.validate_obs_summary(d)
        assert got == jax_schema.validate_obs_summary(d)
    assert all(port_schema.validate_obs_summary(d) for d in broken)


@pytest.fixture(scope="module")
def obs_bench_doc():
    from repro.bench import obs as jax_obsbench
    return json.loads(json.dumps(jax_obsbench.run_obs_campaign(
        quick=True, filters=["determinism"])))


@pytest.mark.parametrize("validator", [
    "validate_obs", "validate_campaign", "validate_kernels",
    "validate_storage", "validate_scheduling", "validate_serving",
    "validate_encounters", "validate_smoke"])
def test_bench_validators_equal_reference(obs_bench_doc, validator):
    port_fn = getattr(port_schema, validator)
    jax_fn = getattr(jax_schema, validator)
    docs = [obs_bench_doc] + _breakages(obs_bench_doc)
    rec = copy.deepcopy(obs_bench_doc)
    rec["scenarios"][0]["status"] = "bogus"
    rec["scenarios"][0]["metrics"].pop("makespan_seconds")
    docs.append(rec)
    for d in docs:
        assert port_fn(d) == jax_fn(d)
    if validator == "validate_obs":
        assert port_fn(obs_bench_doc) == []


def test_schema_constants_and_canonical_bytes_equal_reference(
        obs_bench_doc):
    for name in jax_schema.__all__:
        if name.isupper():
            assert getattr(port_schema, name) == getattr(jax_schema, name)
    assert port_schema.canonical_bytes(obs_bench_doc) \
        == jax_schema.canonical_bytes(obs_bench_doc)
    rec = obs_bench_doc["scenarios"][0]
    assert port_schema.canonical_bytes(rec) == jax_schema.canonical_bytes(
        rec)
    assert port_schema.validate_record(rec) == jax_schema.validate_record(
        rec)


# ---------------------------------------------------------------------------
# Store reader spans on a fake clock.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same archives, built into a store by each package."""
    from repro.store import build_store as jax_build_store
    from repro.tracks.archive import Archiver, archive_tasks_from_tree
    from repro.tracks.datasets import ScaledDatasetSpec, write_scaled_dataset
    from repro.tracks.organize import Organizer, organize_tasks_from_dir
    from repro.tracks.registry import synthetic_registry
    from repro_torch.store import build_store

    root = tmp_path_factory.mktemp("torch_obs_store")
    raw, org, arc = (str(root / d) for d in ("raw", "org", "arc"))
    write_scaled_dataset(raw, ScaledDatasetSpec(name="g", n_files=2,
                                                scale=1e4))
    organizer = Organizer(org, synthetic_registry(n=2000, seed=13))
    for t in organize_tasks_from_dir(raw):
        organizer(t)
    archiver = Archiver(org, arc)
    for t in archive_tasks_from_tree(org):
        archiver(t)
    port_root, jax_root = str(root / "port"), str(root / "jax")
    manifest = build_store(arc, port_root, target_points=400)
    jax_build_store(arc, jax_root, target_points=400)
    return {"port": port_root, "jax": jax_root, "manifest": manifest}


def _store_events(pkg, root, clock, prefetch):
    if pkg == "port":
        from repro_torch.store.reader import TrackStore
        tr = Tracer(clock=clock)
    else:
        from repro.store.reader import TrackStore
        tr = jax_obs.Tracer(clock=clock)
    store = TrackStore(root, tracer=tr)
    n = len(list(store.iter_batches(prefetch=prefetch)))
    return n, tr.events


def test_store_spans_equal_reference_in_order(stores):
    n, got = _store_events("port", stores["port"], _TickClock(), 0)
    m, want = _store_events("jax", stores["jax"], _TickClock(), 0)
    assert n == m == len(stores["manifest"].shards) > 1
    assert got == want
    decodes = [e for e in got if e[2] == "store_decode"]
    assert [e[4] for e in decodes] \
        == [s.shard_id for s in stores["manifest"].shards]
    assert all(isinstance(e[6], int) and e[6] > 0 and e[1] > 0.0
               for e in decodes)


def test_store_prefetch_spans_equal_reference(stores):
    n, got = _store_events("port", stores["port"], _ThreadTickClock(), 2)
    m, want = _store_events("jax", stores["jax"], _ThreadTickClock(), 2)
    assert n == m == len(stores["manifest"].shards) > 1

    def key(e):
        return tuple(str(x) for x in e)

    assert sorted(got, key=key) == sorted(want, key=key)
    names = [e[2] for e in got]
    assert names.count("store_decode") == n
    assert names.count("store_prefetch") == n
    # One wait per handoff, the end of stream's included.
    assert names.count("store_wait") == n + 1
    assert all(e[1] >= 0.0 for e in got if e[2] == "store_wait")


def test_untraced_store_reads_the_same(stores):
    from repro_torch.store.reader import TrackStore
    plain = [b.track_ids for b in TrackStore(stores["port"]).iter_batches()]
    traced = [b.track_ids for b in TrackStore(
        stores["port"], tracer=Tracer()).iter_batches()]
    assert plain == traced and plain


# ---------------------------------------------------------------------------
# Serving spans on a fake clock (tests/test_obs.py:203-275).
# ---------------------------------------------------------------------------

def _served(pkg, root):
    """A small store built through each package's serving ingest path,
    traced on a tick clock."""
    import os
    serving = __import__(("repro_torch" if pkg == "port" else "repro")
                         + ".serving", fromlist=["IngestService"])
    feed_dir, store_dir = str(root / "feed"), str(root / "store")
    os.makedirs(feed_dir)
    feed = serving.SyntheticFeed(feed_dir, serving.FeedSpec(
        n_files=8, obs_per_file=48, seed=3))
    tr = PACKAGES[pkg][0].Tracer(clock=_TickClock())
    svc = serving.IngestService(feed_dir, store_dir, target_points=96,
                                tracer=tr)
    feed.emit_all()
    svc.poll_once()
    manifest = svc.seal()
    return {"serving": serving, "svc": svc, "tracer": tr,
            "store": store_dir, "manifest": manifest}


@pytest.fixture()
def served(tmp_path):
    return {pkg: _served(pkg, tmp_path / pkg) for pkg in PACKAGES}


def _summary_bytes(pkg, tr, label):
    obs, schema = PACKAGES[pkg][0], PACKAGES[pkg][5]
    return schema.canonical_bytes(obs.summary_from_tracer(tr, label=label))


def test_ingest_lifecycle_events_equal_reference(served):
    got, want = served["port"]["tracer"], served["jax"]["tracer"]
    assert got.events == want.events
    assert _summary_bytes("port", got, "ingest") \
        == _summary_bytes("jax", want, "ingest")
    serving = [e for e in got.events if e[3] == "serving"]
    assert {"ingest_scan", "ingest_cut", "ingest_build", "ingest_commit",
            "ingest_seal"} <= {e[2] for e in serving}
    builds = [e for e in serving if e[2] == "ingest_build"]
    commits = [e for e in serving if e[2] == "ingest_commit"]
    assert len(builds) == len(commits) \
        == len(served["port"]["manifest"].shards) > 1
    assert all(e[1] > 0.0 for e in builds + commits)
    assert all(0.0 < e[0] <= got.clock.t for e in serving)


def test_served_store_reader_spans_equal_reference(served):
    from repro.store.reader import TrackStore as JaxTrackStore
    from repro_torch.store.reader import TrackStore
    events, counts = {}, {}
    for pkg, cls in (("port", TrackStore), ("jax", JaxTrackStore)):
        tr = PACKAGES[pkg][0].Tracer(clock=_ThreadTickClock())
        store = cls(served[pkg]["store"], tracer=tr)
        counts[pkg] = len(list(store.iter_batches(prefetch=2)))
        events[pkg] = tr.events

    def key(e):
        return tuple(str(x) for x in e)

    n = len(served["port"]["manifest"].shards)
    assert counts["port"] == counts["jax"] == n > 1
    assert sorted(events["port"], key=key) == sorted(events["jax"], key=key)
    decodes = [e for e in events["port"] if e[2] == "store_decode"]
    assert {e[4] for e in decodes} \
        == {s.shard_id for s in served["port"]["manifest"].shards}
    assert all(isinstance(e[6], int) and e[6] > 0 for e in decodes)
    assert sum(1 for e in events["port"] if e[2] == "store_prefetch") == n


def test_frontend_query_events_equal_reference(served):
    out = {}
    for pkg in PACKAGES:
        svc, tr = served[pkg]["svc"], served[pkg]["tracer"]
        serving = served[pkg]["serving"]
        front = serving.StoreFrontEnd(svc, tiny_slots=1)
        assert front.tracer is tr
        tid = sorted(svc.retained)[0]
        q1 = serving.Query(1, "latest", {"track_id": tid})
        q2 = serving.Query(2, "latest", {"track_id": tid})
        q3 = serving.Query(3, "snapshot", {"digest": True})
        admitted = (front.admit(q1), front.admit(q2), front.admit(q3))
        front.step()
        done = front.serve([q2])
        while q3.done is False:
            front.step()
        out[pkg] = {"admitted": admitted, "events": list(tr.events),
                    "results": (q1.result, done[0].result, q3.result),
                    "stats": dict(front.stats),
                    "summary": _summary_bytes(pkg, tr, "serve")}
    assert out["port"] == out["jax"]
    events = out["port"]["events"]
    names = [(e[2], e[5]) for e in events if e[4] == "frontend"]
    assert ("query_admit", "latest:1") in names
    assert ("query_reject", "latest:2") in names
    spans = [e for e in events if e[2] == "query" and e[5] == "latest:1"]
    assert len(spans) == 1 and spans[0][1] > 0.0
    # The pinned snapshot read's shard decodes sit on the same timeline.
    assert sum(1 for e in events if e[2] == "store_decode") \
        == len(served["port"]["manifest"].shards)
