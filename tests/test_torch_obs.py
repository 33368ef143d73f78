"""The port's request tracing and flight timeline (seaweedfs_tpu_torch/obs/
trace.py, config.py, timeline.py), held against the JAX package's obs/.

Each case mirrors a reference case (tests/test_obs_tracing.py,
tests/test_devledger_timeline.py, tests/test_trace_ring_stress.py) and
runs it on both packages where both can take the same input; comparisons
are exact unless a time is involved.  The last cases hold the span tree of
a resident degraded read in the port (DeviceShardCache on the CPU) equal to
the JAX package's, less the one listed difference: the port copies nothing
up, so it has no h2d_copy span.
"""
import asyncio
import dataclasses
import itertools
import logging
import os
import threading
import time

import lockwatch
import pytest

from seaweedfs_tpu import obs as jax_obs
from seaweedfs_tpu.obs import timeline as jax_timeline
from seaweedfs_tpu.ops import rs_resident as jr
from seaweedfs_tpu.storage import ec as jax_ec
from seaweedfs_tpu_torch import obs
from seaweedfs_tpu_torch.obs import devledger, timeline
from seaweedfs_tpu_torch.obs import trace as obs_trace
from seaweedfs_tpu_torch.obs.config import ObsConfig
from seaweedfs_tpu_torch.obs.trace import Trace, TraceRing
from seaweedfs_tpu_torch.ops import rs_resident as tr
from seaweedfs_tpu_torch.serving import EcReadDispatcher, ServingConfig
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.storage import ec

from test_torch_ec import _needles, _pair

MIB = 1 << 20


def _same_verdict(make_port, make_ref):
    """Both validators accept (with equal fields) or both raise."""
    outcomes = []
    for make in (make_port, make_ref):
        try:
            outcomes.append(("ok", dataclasses.asdict(make().validated())))
        except ValueError:
            outcomes.append(("raise", None))
    assert outcomes[0] == outcomes[1]
    return outcomes[0][0]


def test_obs_config_validation_equals_reference():
    assert ObsConfig().validated().trace_ring == 256
    assert dataclasses.asdict(ObsConfig()) == dataclasses.asdict(
        jax_obs.ObsConfig())
    grid = {
        "slow_ms": (-1.0, 0.0, 2.5),
        "trace_ring": (0, 1, 256),
        "timeline_interval_seconds": (0.0, -1.0, 0.25),
        "timeline_window": (1, 2, 120),
        "tail_ring": (0, 1),
        "tail_alpha": (0.0, 0.2, 1.0, 1.5),
        "tail_floor_ms": (-0.5, 0.0, 10.0),
    }
    verdicts = set()
    for field, values in grid.items():
        for v in values:
            verdicts.add(_same_verdict(
                lambda: ObsConfig(**{field: v}),
                lambda: jax_obs.ObsConfig(**{field: v})))
    assert verdicts == {"ok", "raise"}


def test_trace_header_roundtrip():
    for raw in ("", "abc", "abc-def", "-x", "a-b-c"):
        assert obs.parse_trace_header(raw) == jax_obs.parse_trace_header(raw)
    assert obs.TRACE_HEADER == jax_obs.TRACE_HEADER
    t, tok = obs.start_trace("GET /x", "volume", "srv")
    try:
        hdr = obs.outbound_headers()[obs.TRACE_HEADER]
        assert hdr == f"{t.trace_id}-{t.root_id}"
        # the header the port sends parses the same in the reference
        assert jax_obs.parse_trace_header(hdr) == (t.trace_id, t.root_id)
    finally:
        obs.finish_trace(t, tok, 200)
    assert obs.outbound_headers() == {}


@pytest.mark.parametrize("capacity", [1, 3, 8])
def test_trace_ring_bounded_newest_first_and_filters(capacity):
    rings = (TraceRing(capacity=capacity),
             jax_obs.trace.TraceRing(capacity=capacity))
    docs = []
    for ring, cls in zip(rings, (Trace, jax_obs.trace.Trace)):
        for i in range(7):
            t = cls(f"id{i % 3}", "volume", f"req{i}")
            t.wall_start = 1_700_000_000 + i
            t.end = t.t0 + 0.5
            ring.add(t)
        views = [ring.snapshot(), ring.snapshot(limit=1),
                 ring.snapshot(trace_id="id1"),
                 ring.snapshot(since_unix=1_700_000_005),
                 ring.snapshot(limit=1, trace_id="id0")]
        docs.append([[(d["trace_id"], d["name"]) for d in v] for v in views])
    assert docs[0] == docs[1]
    assert len(docs[0][0]) == min(capacity, 7)
    assert docs[0][0][0] == ("id0", "req6")


def test_span_nesting_and_stage_sink():
    results = []
    for mod in (obs, jax_obs):
        t, tok = mod.start_trace("GET /y", "volume")
        with mod.span("shard_read", bytes=7):
            with mod.span("host_reconstruct"):
                pass
        mod.finish_trace(t, tok, 200)
        d = mod.RING.snapshot(1)[0]
        by_name = {s["name"]: s for s in d["spans"]}
        assert by_name["host_reconstruct"]["parent_span_id"] == \
            by_name["shard_read"]["span_id"]
        assert by_name["shard_read"]["parent_span_id"] == d["root_span_id"]
        with mod.stage_sink() as sink:
            for i in range(3):
                with mod.span("device_execute", h2d_bytes=10, layout="flat",
                              kernel=f"k{i}"):
                    pass
        dur, calls, ann = sink["device_execute"]
        assert dur > 0
        results.append((
            [(s["name"], s.get("annotations")) for s in d["spans"]],
            calls, ann, sorted(d),
        ))
    assert results[0] == results[1]
    assert results[0][1] == 3 and results[0][2]["h2d_bytes"] == 30
    assert results[0][2]["kernel"] == "k2"  # non-numeric: the last wins


def test_record_span_replay_and_stage_histogram():
    hist = metrics.REQUEST_STAGE_SECONDS.labels(stage="batch_pack")
    n0 = hist.count
    t, tok = obs.start_trace("GET /z", "volume")
    ctx = obs.current()
    obs.finish_trace(t, tok, 200)
    obs.record_span(ctx, "batch_pack", t.t0, 0.003, observe=False,
                    annotations={"calls": 1})
    assert hist.count == n0  # a replay is not observed twice
    obs.record_span(None, "batch_pack", 0.0, 0.001)
    assert hist.count == n0 + 1
    assert [(s.name, s.annotations) for s in t.spans] == [
        ("batch_pack", {"calls": 1})]
    # every stage is pre-registered, the reference's list
    assert metrics.TRACE_STAGES == jax_obs.trace._metrics.TRACE_STAGES
    assert metrics.STAGE_SECONDS_BUCKETS == \
        jax_obs.trace._metrics.STAGE_SECONDS_BUCKETS
    text = metrics.generate_latest(metrics.REGISTRY).decode()
    for stage in metrics.TRACE_STAGES:
        assert f'SeaweedFS_request_stage_seconds_count{{stage="{stage}"}}' \
            in text


def test_slow_request_log(caplog):
    obs.configure(ObsConfig(slow_ms=0.0001))
    try:
        with caplog.at_level(logging.WARNING, logger="obs"):
            t, tok = obs.start_trace("GET /slow", "volume")
            with obs.span("shard_read"):
                time.sleep(0.002)
            obs.finish_trace(t, tok, 200)
        assert any(
            "slow request" in r.message and t.trace_id in r.message
            and "shard_read=" in r.message
            for r in caplog.records
        )
    finally:
        obs.configure(ObsConfig())


def test_disabled_tracing_keeps_the_stage_histogram():
    obs.configure(ObsConfig(enabled=False))
    hist = metrics.REQUEST_STAGE_SECONDS.labels(stage="shard_read")
    n0 = hist.count
    try:
        t, tok = obs.start_trace("GET /off", "volume")
        assert (t, tok) == (None, None)
        with obs.span("shard_read"):
            pass
        obs.finish_trace(t, tok, 200)
        assert hist.count == n0 + 1
    finally:
        obs.configure(ObsConfig())


def test_drain_lane_does_not_inherit_spawner_trace():
    """The port's dispatcher spawns its drain lane under obs.detached():
    each request's trace carries its own batch stages via the queue-hop
    replay, and a later round never grows a finished trace."""

    class Store:
        def ec_volume_is_resident(self, vid):
            return True

        def read_ec_needles_batch(self, vid, requests, remote_read=None,
                                  zero_copy=False):
            with obs.span("shard_read", op="locate", needles=len(requests)):
                time.sleep(0.002)  # keep the lane alive across both reads
            return [b"x"] * len(requests)

    async def go():
        d = EcReadDispatcher(Store(), lambda vid: None,
                             ServingConfig(max_batch=4, max_wait_us=500))

        async def traced_read(nid):
            t, tok = obs.start_trace(f"GET /{nid}", "volume")
            await d.read(1, nid, None)
            obs.finish_trace(t, tok, 200)
            return t

        t1, t2 = await asyncio.gather(traced_read(1), traced_read(2))
        for t in (t1, t2):
            names = [s.name for s in t.spans]
            assert names.count("queue_wait") == 2, names
            assert "batch_dispatch" in names and "shard_read" in names
            replayed = {s.name: s for s in t.spans}
            assert replayed["shard_read"].annotations["calls"] == 1
        n1 = len(t1.spans)
        await traced_read(3)
        assert len(t1.spans) == n1, "drain lane kept spawner's trace"

    asyncio.run(go())


# --- flight timeline (test_devledger_timeline.py) ------------------------------


@pytest.fixture
def clean_ledger():
    devledger.LEDGER.reset_for_tests()
    yield
    devledger.LEDGER.reset_for_tests()


def test_timeline_ring_bounded_and_deltas_correct(clean_ledger):
    s = timeline.TimelineSampler(node="n1", window=4)
    assert s.capacity == 4
    s.sample(now=100)  # baseline
    devledger.record(workload="scrub", busy_s=0.5, dispatches=2)
    smp = s.sample(now=101)
    assert smp["busy_ms"] == {"scrub": 500.0}
    assert smp["disp"] == {"scrub": 2}
    smp2 = s.sample(now=102)
    assert smp2["busy_ms"] == {} and smp2["disp"] == {}
    for t in range(103, 110):
        s.sample(now=t)
    snap = s.snapshot()
    assert [x["t"] for x in snap] == [106, 107, 108, 109]
    assert [x["t"] for x in s.snapshot(window_s=1)] == [108, 109]
    # the sample's keys are the reference's
    ref = jax_timeline.TimelineSampler(node="n1", window=4).sample(now=1)

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) and k != "busy_ms"
                and k != "disp" else None for k, v in d.items()}

    assert keys(smp2) == keys(ref)


def test_timeline_reads_the_qos_series(clean_ledger):
    s = timeline.TimelineSampler(node="n1", window=4)
    s.sample(now=1)
    from seaweedfs_tpu_torch import stats

    stats.VOLUME_SERVER_EC_QOS_SHED.labels(tier="bulk",
                                           reason="deadline").inc(3)
    stats.VOLUME_SERVER_EC_QOS_QUEUE_DEPTH.labels(tier="interactive").set(5)
    smp = s.sample(now=2)
    assert smp["qos"]["shed"] == {"interactive": 0, "bulk": 3}
    assert smp["qos"]["depth"]["interactive"] == 5
    stats.VOLUME_SERVER_EC_QOS_QUEUE_DEPTH.labels(tier="interactive").set(0)
    assert metrics.REGISTRY.get_sample_value(
        "SeaweedFS_volumeServer_ec_qos_shed_total",
        {"tier": "bulk", "reason": "deadline"}) >= 3
    assert metrics.REGISTRY.get_sample_value("no_such_series") is None


def test_take_new_hands_each_sample_once_and_survives_overrun():
    s = timeline.TimelineSampler(node="n1", window=3)
    s.sample(now=1)
    s.sample(now=2)
    assert [x["t"] for x in s.take_new()] == [1, 2]
    assert s.take_new() == []
    for t in range(3, 9):
        s.sample(now=t)
    assert [x["t"] for x in s.take_new()] == [6, 7, 8]


def test_exemplar_links_resolve_against_trace_ring():
    s = timeline.TimelineSampler(node="n1", window=4).install()
    try:
        t, tok = obs_trace.start_trace("GET /7,aa", "volume")
        t.add_span("device_execute", t.t0, 0.040)
        t.add_span("queue_wait", t.t0, 0.001)
        time.sleep(0.002)
        obs_trace.finish_trace(t, tok, status=200)
        ex = s.sample(now=500)["exemplar"]
        assert ex["trace_id"] == t.trace_id
        assert ex["span"] == "device_execute" and ex["ms"] > 0
        resolved = obs_trace.RING.snapshot(trace_id=ex["trace_id"])
        assert resolved and resolved[0]["trace_id"] == ex["trace_id"]
        assert "exemplar" not in s.sample(now=501)
    finally:
        s.uninstall()
    assert s._on_trace not in obs_trace.FINISH_OBSERVERS


def test_observer_exception_never_breaks_finish_trace():
    def boom(_t):
        raise RuntimeError("observer bug")

    obs_trace.FINISH_OBSERVERS.append(boom)
    try:
        t, tok = obs_trace.start_trace("GET /x", "volume")
        obs_trace.finish_trace(t, tok, status=200)  # must not raise
        assert obs_trace.RING.snapshot(trace_id=t.trace_id)
    finally:
        obs_trace.FINISH_OBSERVERS.remove(boom)


def test_timeline_sampler_threadsafe_under_concurrent_records(clean_ledger):
    s = timeline.TimelineSampler(node="n1", window=16)
    stop = threading.Event()
    n_records = [0]

    def hammer():
        while not stop.is_set():
            devledger.record(workload="scrub", busy_s=0.001, dispatches=1)
            n_records[0] += 1

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for th in threads:
        th.start()
    seen = 0
    try:
        for t in range(50):
            seen += s.sample(now=1000 + t)["disp"].get("scrub", 0)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
    seen += s.sample(now=2000)["disp"].get("scrub", 0)
    assert seen == devledger.LEDGER.dispatches_by_workload()["scrub"]


# --- ring races (test_trace_ring_stress.py) -------------------------------------


def _make_trace(i: int) -> Trace:
    t = Trace(f"tid{i % 37:04x}", "volume", f"GET /{i}")
    for s, stage in enumerate(("queue_wait", "shard_read", "d2h_copy")):
        t.add_span(stage, t.t0, 0.001 * s)
    t.end = t.t0 + 0.005
    return t


def test_trace_ring_snapshot_races_add_and_resize():
    errors: list = []
    snapshots = [0]
    stop = threading.Event()
    with lockwatch.watch():
        ring = TraceRing(capacity=64)

        def writer(wid):
            i = wid
            try:
                while not stop.is_set():
                    t = _make_trace(i)
                    ring.add(t)
                    t.add_span("host_reconstruct", t.t0, 0.002)
                    i += 4
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        def resizer():
            try:
                cap = 16
                while not stop.is_set():
                    ring.resize(cap)
                    cap = 16 if cap == 128 else cap * 2
                    time.sleep(0.0005)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        def snapshotter():
            try:
                while not stop.is_set():
                    for d in ring.snapshot(limit=32):
                        assert isinstance(d["spans"], list)
                        for sp in d["spans"]:
                            assert "name" in sp and "duration_us" in sp
                    ring.snapshot(trace_id="tid0001")
                    ring.snapshot(since_unix=time.time() - 5)
                    snapshots[0] += 1
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = ([threading.Thread(target=writer, args=(w,))
                    for w in range(4)]
                   + [threading.Thread(target=resizer)]
                   + [threading.Thread(target=snapshotter) for _ in range(2)])
        for th in threads:
            th.start()
        time.sleep(1.0)
        stop.set()
        for th in threads:
            th.join(timeout=10)
            assert not th.is_alive(), "stress thread wedged"
    assert not errors, errors
    assert snapshots[0] > 0
    assert len(ring.snapshot()) <= 128


# --- the resident read's span tree, both packages --------------------------------


@pytest.fixture(scope="module")
def one_bucket(tmp_path_factory):
    """A small volume of equal-size needles encoded by both packages: the
    needles wholly on shard 0 reconstruct in one call in both (one size
    bucket for the JAX package, one ragged call for the port)."""
    needles = _needles(5, 40, [6000])
    return _pair(tmp_path_factory.mktemp("spans"), needles), needles


def _mount(mod, base, down=(0, 11)):
    ev = mod.EcVolume(os.path.dirname(base), 1)
    for sid in range(14):
        if sid not in down:
            ev.add_shard(sid)
    return ev


def _tree(mod, fn):
    """Run fn inside a fresh trace of `mod`: -> [(name, parent name,
    annotation keys)] in recording order."""
    t, tok = mod.start_trace("GET /1,parity", "volume")
    try:
        fn()
    finally:
        mod.finish_trace(t, tok, 200)
    names = {t.root_id: "<root>"}
    names.update({s.span_id: s.name for s in t.spans})
    return [(s.name, names[s.parent_id], sorted(s.annotations))
            for s in t.spans]


def _without_h2d(tree):
    return [s for s in tree if s[0] != "h2d_copy"]


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
def test_resident_read_span_tree_equals_reference(one_bucket, layout):
    (jbase, tbase), needles = one_bucket
    jev, tev = _mount(jax_ec, jbase), _mount(ec, tbase)
    jcache = jr.DeviceShardCache(shard_quantum=MIB, layout=layout)
    cache = tr.DeviceShardCache(shard_quantum=MIB, layout=layout,
                                device="cpu")
    try:
        assert jev.load_shards_to_device(jcache) == 12
        assert tev.load_shards_to_device(cache) == 12
        on0 = [nid for nid, _, _ in needles
               if [iv.to_shard_and_offset()[0]
                   for iv in tev.locate_needle(nid)[2]] == [0]][:12]
        assert len(on0) >= 4
        got, want = [], []
        port = _tree(obs, lambda: got.extend(
            tev.read_needles_batch(on0, backend="torch")))
        ref = _tree(jax_obs, lambda: want.extend(
            jev.read_needles_batch(on0)))
        assert [n.data for n in got] == [n.data for n in want]
        # the one listed difference: no h2d_copy in the port
        assert "h2d_copy" in [s[0] for s in ref]
        assert "h2d_copy" not in [s[0] for s in port]
        assert port == _without_h2d(ref)
        assert [s[0] for s in port] == [
            "shard_read", "batch_pack", "device_execute", "d2h_copy"]
        assert port[3][1] == "device_execute"
        # the single degraded read: locate, then the resident call
        port1 = _tree(obs, lambda: tev.read_needle(on0[0], backend="torch"))
        ref1 = _tree(jax_obs, lambda: jev.read_needle(on0[0]))
        assert port1 == _without_h2d(ref1)
    finally:
        for ev in (jev, tev):
            ev.close()


def test_host_degraded_read_span_tree_equals_reference(one_bucket):
    """Without a cache both packages gather survivors and reconstruct on
    the host; a locally held interval is one shard_read."""
    (jbase, tbase), needles = one_bucket
    jev, tev = _mount(jax_ec, jbase), _mount(ec, tbase)
    try:
        names = set()
        for nid, _, data in needles[:3] + needles[-3:]:
            got = []
            port = _tree(obs, lambda: got.append(
                tev.read_needle(nid, backend="torch")))
            ref = _tree(jax_obs, lambda: jev.read_needle(nid))
            assert got[0].data == data
            assert port == ref
            names |= {s[0] for s in port}
        assert names == {"shard_read", "host_reconstruct"}
    finally:
        for ev in (jev, tev):
            ev.close()


def test_bulk_legs_record_their_stages(tmp_path):
    """write_ec_files under a trace records bulk_read / bulk_device /
    bulk_write, as the reference's bulk.publish does."""
    from test_torch_ec import _write

    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume

    base = _write(Volume, Needle, str(tmp_path), _needles(3, 5, [3000]))
    t, tok = obs.start_trace("POST /encode", "volume")
    try:
        ec.write_ec_files(base, backend="torch")
    finally:
        obs.finish_trace(t, tok, 200)
    spans = {s.name: s for s in t.spans}
    assert set(spans) == {"bulk_read", "bulk_device", "bulk_write"}
    assert spans["bulk_device"].annotations["pipeline"] == "encode"
    assert all(s.duration >= 0 for s in t.spans)


def test_hot_shapes_count_calls_by_class(one_bucket):
    (_, tbase), needles = one_bucket
    tev = _mount(ec, tbase)
    cache = tr.DeviceShardCache(shard_quantum=MIB, device="cpu")
    try:
        tev.load_shards_to_device(cache)
        tr._call_stats.clear()
        for nid, _, _ in itertools.islice(needles, 3):
            tev.read_needle(nid, backend="torch")
        tev.read_needles_batch([nid for nid, _, _ in needles],
                               backend="torch")
        # one clock for both calls: each computes last_dispatch_age_s
        # from its own time.time(), and two reads a millisecond apart
        # would round to different ages
        now = time.time()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tr.time, "time", lambda: now)
            hot = tr.hot_shapes(10)
            top = tr.hot_shapes(1)
        assert sum(h["dispatches"] for h in hot) >= 2
        assert {h["kernel"] for h in hot} == {"fused_reconstruct"}
        assert hot == sorted(hot, key=lambda h: -h["dispatches"])
        assert all(h["ewma_ms"] >= 0 for h in hot)
        assert top == hot[:1]
        assert tr.aot_stats() == {}
    finally:
        tev.close()
