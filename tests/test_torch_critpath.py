"""The port's critical-path attribution and tail retention
(seaweedfs_tpu_torch/obs/critpath.py, tailstore.py), held against the JAX
package's.

`attribute` and `assemble` are the reference's arithmetic: on the same
seeded interval lists and entry sets the port's dicts must equal the
reference's exactly (clock-skew reconciliation, client-anchored wire
legs and ring/pin dedupe included).  The tail-store cases mirror
tests/test_tailpath.py on the port's store; the handler cases drive the
/debug/critpath, /debug/tail and /debug/traces handlers with a request
stand-in.
"""
import asyncio
import json
from types import SimpleNamespace

import numpy as np
import pytest

from seaweedfs_tpu.obs import critpath as jax_critpath
from seaweedfs_tpu_torch import obs
from seaweedfs_tpu_torch.obs import critpath, tailstore
from seaweedfs_tpu_torch.obs import trace as obs_trace
from seaweedfs_tpu_torch.server.http import HTTPError
from seaweedfs_tpu_torch.stats import metrics

STAGES = list(critpath.STAGE_SEGMENT) + ["mystery_stage"]


def _req(**query):
    return SimpleNamespace(query={k: str(v) for k, v in query.items()})


def _call(handler, **query):
    """-> (status, JSON body) of an async handler."""
    resp = asyncio.run(handler(_req(**query)))
    return resp.status, json.loads(resp.body)


# --- attribution on seeded inputs, both packages ------------------------------


def test_segments_and_stage_map_equal_reference():
    assert critpath.SEGMENTS == jax_critpath.SEGMENTS
    assert critpath.STAGE_SEGMENT == jax_critpath.STAGE_SEGMENT
    assert critpath._PRIORITY == jax_critpath._PRIORITY
    assert metrics.CRITPATH_SEGMENTS == jax_critpath.SEGMENTS


@pytest.mark.parametrize("name", [
    "GET /3,01637037d6", "GET /", "POST /dir/sub?x=1", "HEAD /7,aa?r=1",
    "", "GET", "DELETE /buckets/b/k", "GET /debug/traces",
])
def test_route_of_equals_reference(name):
    assert critpath.route_of(name) == jax_critpath.route_of(name)


@pytest.mark.parametrize("seed", range(12))
def test_attribute_equals_reference(seed):
    rng = np.random.default_rng(seed)
    total = float(rng.integers(0, 200_000))
    segs = list(critpath._PRIORITY) + ["untraced", "nonsense"]
    intervals = []
    for _ in range(int(rng.integers(0, 40))):
        s = float(rng.integers(-5_000, 210_000))
        e = s + float(rng.integers(-1_000, 80_000))
        intervals.append((s, e, str(rng.choice(segs))))
    got = critpath.attribute(intervals, total)
    assert got == jax_critpath.attribute(intervals, total)
    assert set(got) == set(critpath.SEGMENTS)
    assert abs(sum(got.values()) - total) <= len(got)  # rounding only


def _entries(rng, n_nodes: int) -> list[dict]:
    """A seeded trace across `n_nodes` entries: each child hangs off a
    random span of an earlier entry, with random skewed wall clocks."""
    ents = []
    for i in range(n_nodes):
        dur = int(rng.integers(1_000, 150_000))
        spans = []
        for j in range(int(rng.integers(0, 7))):
            off = int(rng.integers(0, dur))
            spans.append({
                "name": str(rng.choice(STAGES)),
                "span_id": f"s{i}_{j}",
                "parent_span_id": f"r{i}",
                "offset_us": off,
                "duration_us": int(rng.integers(0, dur - off + 1)),
                **({"annotations": {"bytes": int(rng.integers(0, 9))}}
                   if rng.random() < 0.5 else {}),
            })
        parent = ""
        if i and rng.random() < 0.85:
            p = ents[int(rng.integers(0, i))]
            cands = [s["span_id"] for s in p["spans"]] + [p["root_span_id"]]
            parent = str(rng.choice(cands))
        elif i:
            parent = "dangling"
        ents.append({
            "trace_id": "T", "role": str(rng.choice(["volume", "filer"])),
            "server": f"n{i % 3}", "name": f"GET /{i},ab",
            "parent_span_id": parent, "root_span_id": f"r{i}",
            "start_unix_ms": 1_000_000 + int(rng.integers(-50, 200)),
            "duration_us": dur, "status": "200", "spans": spans,
        })
    return ents


@pytest.mark.parametrize("seed", range(16))
def test_assemble_equals_reference(seed):
    rng = np.random.default_rng(100 + seed)
    ents = _entries(rng, int(rng.integers(1, 6)))
    # ring + pin copies of some entries
    ents += [dict(e) for e in ents if rng.random() < 0.3]
    skew = {f"n{k}": float(rng.integers(-40, 40)) for k in range(3)}
    client = float(rng.integers(0, 250_000)) if seed % 2 else None
    for s in (skew, {}, None, lambda server: skew.get(server, 0.0)):
        got = critpath.assemble(ents, s, client_total_us=client)
        want = jax_critpath.assemble(ents, s, client_total_us=client)
        assert got == want
        assert sum(got["segments_us"].values()) == pytest.approx(
            got["total_us"], abs=len(critpath.SEGMENTS))
    assert critpath.assemble([]) is None is jax_critpath.assemble([])


def _parent_child_entries(child_wall_skew_ms=0.0):
    """test_tailpath.py's two-node trace: filerA's root with a chunk_fetch
    call span, volB's child hanging off it, its wall clock skewed."""
    parent = {
        "trace_id": "T1", "role": "filer", "server": "filerA",
        "name": "GET /blob.bin", "parent_span_id": "",
        "root_span_id": "R", "start_unix_ms": 1_000_000,
        "duration_us": 100_000, "status": "200",
        "spans": [{"name": "chunk_fetch", "span_id": "S1", "parent_id": "R",
                   "offset_us": 10_000, "duration_us": 80_000}],
    }
    child = {
        "trace_id": "T1", "role": "volume", "server": "volB",
        "name": "GET /1,aa", "parent_span_id": "S1", "root_span_id": "C",
        "start_unix_ms": 1_000_015 + int(child_wall_skew_ms),
        "duration_us": 60_000, "status": "200",
        "spans": [{"name": "device_execute", "span_id": "D1",
                   "parent_id": "C", "offset_us": 5_000,
                   "duration_us": 50_000}],
    }
    return parent, child


def test_clock_skew_reconciliation():
    parent, child = _parent_child_entries(child_wall_skew_ms=5_000.0)
    for skew, offset in (({"volB": 5_000.0}, 15_000), (None, 30_000)):
        doc = critpath.assemble([parent, child], skew_ms=skew)
        assert doc == jax_critpath.assemble([parent, child], skew_ms=skew)
        vol = next(p for p in doc["participants"] if p["role"] == "volume")
        assert vol["offset_us"] == offset
    assert sum(doc["segments_us"].values()) == doc["total_us"] == 100_000
    assert doc["segments_us"]["device_execute"] == 50_000
    assert doc["segments_us"]["network_gap"] == 30_000
    assert doc["segments_us"]["untraced"] == 20_000


def test_client_anchored_assembly_puts_wire_legs_in_network_gap():
    parent, child = _parent_child_entries()
    doc = critpath.assemble([parent, child], skew_ms={},
                            client_total_us=120_000)
    assert doc == jax_critpath.assemble([parent, child], skew_ms={},
                                        client_total_us=120_000)
    assert (doc["total_us"], doc["server_total_us"]) == (120_000, 100_000)
    assert doc["segments_us"]["network_gap"] == 50_000
    doc = critpath.assemble([parent, child], skew_ms={},
                            client_total_us=90_000)
    assert doc["total_us"] == 100_000


def test_assemble_dedupes_ring_and_pin_copies():
    parent, child = _parent_child_entries()
    doc = critpath.assemble([parent, child, dict(parent), dict(child)])
    assert doc == jax_critpath.assemble(
        [parent, child, dict(parent), dict(child)])
    assert len(doc["participants"]) == 2
    assert doc["segments_us"]["device_execute"] == 50_000


# --- the tail store (test_tailpath.py) ----------------------------------------


def _finish_one(name="GET /1,aabbcc", dur_s=0.0, trace_id=None,
                flag_store=None, flag_kind=None):
    t, tok = obs.start_trace(name, "volume", "vs1", trace_id=trace_id)
    t.t0 -= dur_s
    if flag_store is not None:
        flag_store.flag(t.trace_id, flag_kind or "qos_shed")
    obs.finish_trace(t, tok, 200)
    return t.trace_id


def test_tail_ring_retention_under_churn():
    # alpha ~0 holds the route's p99 estimate at its first value (the
    # window then holds the slow trace): with the default 0.2 the estimate
    # decays to the fast requests' own p99 within ~100 samples, and the
    # top 1% of the churn's timing jitter would then pin and, with enough
    # of them, evict the slow pin
    store = tailstore.TailStore(node="vs1", capacity=8, floor_ms=50.0,
                                alpha=1e-9)
    store.install()
    try:
        slow_id = _finish_one(dur_s=0.2)
        pins = store.snapshot(trace_id=slow_id)
        assert len(pins) == 1 and pins[0]["reason"] == "floor"
        assert pins[0]["entries"]
        for _ in range(max(obs_trace.CONFIG.trace_ring, 256) * 2):
            _finish_one(dur_s=0.0)
        assert not obs_trace.RING.snapshot(trace_id=slow_id)
        pins = store.snapshot(trace_id=slow_id)
        assert len(pins) == 1 and pins[0]["entries"]
        assert tailstore.pinned(slow_id)
        assert critpath.local_entries(slow_id)
        # /debug/traces?id= falls back to the pin, /debug/critpath too
        status, doc = _call(obs.traces_handler, id=slow_id)
        assert status == 200 and doc["traces"][0]["trace_id"] == slow_id
        status, doc = _call(critpath.critpath_handler(), id=slow_id)
        assert status == 200 and doc["trace_id"] == slow_id
    finally:
        store.uninstall()


def test_tail_ring_bounded_newest_pins_win():
    store = tailstore.TailStore(node="vs1", capacity=4, floor_ms=10.0)
    store.install()
    try:
        ids = [_finish_one(dur_s=0.05) for _ in range(9)]
        pins = store.snapshot()
        assert [p["trace_id"] for p in pins] == list(reversed(ids[-4:]))
    finally:
        store.uninstall()


def test_incident_flag_pins_a_fast_trace():
    store = tailstore.TailStore(node="vs1", capacity=4, floor_ms=1e9)
    store.install()
    try:
        fast_id = _finish_one(dur_s=0.0, flag_store=store, flag_kind="hedge")
        pins = store.snapshot(trace_id=fast_id)
        assert len(pins) == 1 and pins[0]["reason"] == "incident:hedge"
        t, tok = obs.start_trace("GET /2,dd", "volume", "vs1")
        tailstore.flag_ambient("compile_storm", t.trace_id)  # not a trigger
        obs.finish_trace(t, tok, 200)
        assert not store.snapshot(trace_id=t.trace_id)
        assert tailstore.TAIL_TRIGGER_KINDS == __import__(
            "seaweedfs_tpu.obs.tailstore", fromlist=["x"]).TAIL_TRIGGER_KINDS
    finally:
        store.uninstall()


def test_set_floor_ms_validation():
    store = tailstore.TailStore(node="vs1", capacity=4, floor_ms=0.0)
    with pytest.raises(ValueError):
        store.set_floor_ms(-1.0)
    store.install()
    try:
        assert not store.snapshot(trace_id=_finish_one(dur_s=0.05))
        store.set_floor_ms(10.0)
        assert store.snapshot(trace_id=_finish_one(dur_s=0.05))
    finally:
        store.uninstall()


def test_route_counters_sum_to_the_route_total():
    """Every finished root trace feeds SeaweedFS_critpath_seconds: the six
    segments of a route add up to its route seconds."""
    route = "GET /<fid>"
    seg = {s: metrics.CRITPATH_SECONDS.labels(route=route, segment=s).value
           for s in critpath.SEGMENTS}
    tot = metrics.CRITPATH_ROUTE_SECONDS.labels(route=route).value
    store = tailstore.TailStore(node="vs1", capacity=4)
    store.install()
    try:
        for i in range(5):
            t, tok = obs.start_trace(f"GET /3,0{i}aa", "volume", "vs1")
            t.t0 -= 0.01
            obs.record_span(obs.current(), "device_execute", t.t0 + 0.002,
                            0.004)
            obs.record_span(obs.current(), "queue_wait", t.t0, 0.003)
            obs.finish_trace(t, tok, 200)
    finally:
        store.uninstall()
    d_seg = {s: metrics.CRITPATH_SECONDS.labels(route=route, segment=s).value
             - seg[s] for s in critpath.SEGMENTS}
    d_tot = metrics.CRITPATH_ROUTE_SECONDS.labels(route=route).value - tot
    assert d_tot == pytest.approx(0.05, rel=0.2)
    assert sum(d_seg.values()) == pytest.approx(d_tot, abs=5e-6)
    assert d_seg["device_execute"] == pytest.approx(0.02, abs=1e-5)
    # queue_wait covers 0-3 ms, the device 2-6 ms: the device wins the overlap
    assert d_seg["queue_wait"] == pytest.approx(0.01, abs=1e-5)
    assert store.routes()[route]["count"] == 5


# --- the handlers ----------------------------------------------------------------


def test_debug_handlers_contract():
    with pytest.raises(HTTPError) as e:
        asyncio.run(critpath.critpath_handler()(_req()))
    assert e.value.status == 400
    with pytest.raises(HTTPError) as e:
        asyncio.run(critpath.critpath_handler()(
            _req(id="x", client_total_us="abc")))
    assert e.value.status == 400
    assert _call(critpath.critpath_handler(), id="nope")[0] == 404
    assert _call(obs.traces_handler, id="nope")[0] == 404
    for bad in ({"limit": -1}, {"since": "nan"}, {"limit": "x"}):
        with pytest.raises(HTTPError) as e:
            asyncio.run(obs.traces_handler(_req(**bad)))
        assert e.value.status == 400
    store = tailstore.TailStore(node="vs1", capacity=4, floor_ms=1.0)
    store.install()
    try:
        tid = _finish_one(dur_s=0.01)
        status, doc = _call(tailstore.tail_handler(store))
        assert status == 200
        assert set(doc) == {"node", "capacity", "routes", "pinned"}
        assert "entries" not in doc["pinned"][0]
        status, doc = _call(tailstore.tail_handler(store), id=tid)
        assert status == 200 and doc["pinned"][0]["entries"]
        assert _call(tailstore.tail_handler(store), id="nope")[0] == 404
        status, doc = _call(critpath.critpath_handler(), id=tid,
                            client_total_us=20_000)
        assert status == 200 and doc["total_us"] >= 20_000
        status, doc = _call(obs.traces_handler, limit=1)
        assert status == 200 and len(doc["traces"]) == 1
    finally:
        store.uninstall()
