"""The master's cluster telemetry plane in the port, held against the JAX
package's (stats/cluster.py, the heartbeat's telemetry payload, the
master's /cluster/health.json and /metrics, the shell's readers).

- The heartbeat: a reference and a port volume server over copies of one
  seeded directory (a degraded EC volume resident in a CPU device cache, a
  plain volume behind the streaming ingest plane) get the same writes, the
  same reads and the same forced breaker state; their `_build_telemetry()`
  must agree field for field but the stage digests and timeline samples
  (timing-dependent; their shipping is held against the reference in
  tests/test_torch_telemetry_shipping.py), the compile_* fields (the port
  has no compile cache), the wall clock and the pipeline's transfer bytes
  (each package's kernels move different bytes).
- `ClusterTelemetry`: a seeded heartbeat sequence, carried across as wire
  bytes with a pinned clock, through both; every export must be equal,
  the SeaweedFS_cluster_* text of /metrics included.
- Mirrors of tests/test_cluster_health.py's unit cases.
- The shell: cluster.health [-json] and the volume.* readers on a port
  cluster and a reference cluster with the same servers, equal after
  masking addresses, ages and clocks.
"""
import asyncio
import functools
import json
import re
import shutil
import time

import numpy as np
import pytest

from seaweedfs_tpu import stats as jax_stats
from seaweedfs_tpu.ingest import IngestConfig as JaxIngestConfig
from seaweedfs_tpu.ops import rs_resident as jax_rs_resident
from seaweedfs_tpu.pb import master_pb2 as jax_master_pb2
from seaweedfs_tpu.serving import ServingConfig as JaxServingConfig
from seaweedfs_tpu.serving import qos as jax_qos
from seaweedfs_tpu.stats import cluster as jax_cluster
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ingest import IngestConfig
from seaweedfs_tpu_torch.ops import rs_resident
from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.server import volume as server_volume
from seaweedfs_tpu_torch.server.http import Client
from seaweedfs_tpu_torch.serving import ServingConfig
from seaweedfs_tpu_torch.serving import qos
from seaweedfs_tpu_torch.stats import cluster
from seaweedfs_tpu_torch.storage import types as t

from test_torch_store import EC_VID, MIB, VID, build_dir

SEED = 1208


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    d = tmp_path_factory.mktemp("health_src")
    plain, coded = build_dir(str(d))
    return str(d), plain, coded


@pytest.fixture
def small_caches(monkeypatch):
    """Both servers' caches with 1 MiB padding quanta (equal padding, so
    equal used bytes; the defaults pad 12 survivors to 800 MB)."""
    from seaweedfs_tpu.ops import rs_resident as jr

    monkeypatch.setattr(
        server_volume.rs_resident, "DeviceShardCache",
        functools.partial(rs_resident.DeviceShardCache, shard_quantum=MIB))
    monkeypatch.setattr(
        jr, "DeviceShardCache",
        functools.partial(jax_rs_resident.DeviceShardCache,
                          shard_quantum=MIB))


# ------------------------------------------------------------- heartbeat

# counters the payload reads from each package's process-wide registry:
# compared as deltas over the test, since earlier tests in the same
# process count into one package's registry and not the other's
_REGISTRY_FIELDS = ("dispatcher_shed", "ec_reads_total",
                    "ec_reads_shed_total", "ingest_bytes_total",
                    "ingest_fsyncs_total", "ingest_streamed_seals")
# not compared field for field (see the module docstring)
_SKIPPED = {"stage_digests", "timeline_samples_json", "compile_hits",
            "compile_misses", "compile_cache_enabled", "wall_clock_unix_ms",
            "ec_h2d_bytes", "ec_d2h_bytes"}


def _fields(tel) -> dict:
    """{field: value} of a telemetry message, repeated and map fields as
    plain lists and dicts."""
    out = {}
    for name in jax_master_pb2.VolumeServerTelemetry.DESCRIPTOR.fields_by_name:
        v = getattr(tel, name)
        if name == "resident_shards_by_volume":
            v = dict(v)
        elif name in ("device_bytes_per_device", "stage_digests",
                      "timeline_samples_json"):
            v = list(v)
        out[name] = v
    return out


async def _resident(vs, n, timeout=60.0):
    t_end = time.monotonic() + timeout
    cache = vs.store.ec_device_cache
    while time.monotonic() < t_end:
        if vs.store.ec_volume_is_resident(EC_VID) and \
                cache.resident_count(EC_VID) == n:
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"EC volume never became resident: {vs.store.ec_volume_is_resident(EC_VID)} {cache.resident_count(EC_VID)} {cache.stats()}")


async def _requests(vs, reqs):
    c = Client("127.0.0.1", vs.port)
    out = []
    try:
        for method, path, body in reqs:
            status, _, data = await c.request(
                method, path, {"Content-Type": "application/octet-stream"}
                if body else None, body)
            out.append((status, len(data)))
    finally:
        await c.close()
    return out


def _trip(q, interactive):
    """Open a QoS controller's interactive breaker for a minute."""
    br = q._breakers[interactive]
    for _ in range(br.trip_after + 1):
        br.record_rejection()
    br.cooldown_s = 60.0


def test_heartbeat_telemetry_matches_the_reference(source, tmp_path,
                                                   small_caches):
    from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer

    src, plain, coded = source
    rng = np.random.default_rng(SEED)
    writes = [("POST", "/" + t.format_fid(VID, 100 + i,
                                          int(rng.integers(1 << 32))),
               rng.bytes(int(rng.integers(200, 20_000)))) for i in range(12)]
    reads = [("GET", "/" + t.format_fid(EC_VID, nid, cookie), b"")
             for nid, cookie, _ in coded]
    order = rng.permutation(len(reads))
    first = [reads[i] for i in order[:24]]
    after_trip = [reads[i] for i in order[24:]]

    async def go():
        dirs = [tmp_path / "port", tmp_path / "ref"]
        for d in dirs:
            shutil.copytree(src, d)
        port = server_volume.VolumeServer(
            [], [str(dirs[0])], port=0, ec_backend="torch",
            ec_device_cache_mb=256, ec_serving=ServingConfig(layout="flat", mesh=False),
            ec_ingest=IngestConfig(fsync=True))
        ref = RefVolumeServer(
            masters=[], directories=[str(dirs[1])], port=0, grpc_port=0,
            ec_backend="cpu", ec_device_cache_mb=256,
            ec_serving=JaxServingConfig(layout="flat", mesh=False),
            ec_ingest=JaxIngestConfig(backend="cpu", fsync=True))
        await port.start()
        await ref.start(heartbeat=False)
        try:
            for vs in (port, ref):
                await _resident(vs, 12)
            before = [_fields(vs._build_telemetry()) for vs in (port, ref)]
            answers = []
            for vs, q, inter in ((port, port.ec_dispatcher.qos,
                                  qos.INTERACTIVE),
                                 (ref, ref.ec_dispatcher.qos,
                                  jax_qos.INTERACTIVE)):
                got = await _requests(vs, writes + first)
                _trip(q, inter)
                got += await _requests(vs, after_trip)
                # the same budget-pressure eviction on both caches
                cache = vs.store.ec_device_cache
                cache.budget = cache.stats()[1]
                cache.put(EC_VID + 40, 0, b"\x07" * 4096)
                answers.append(got)
            jax_stats.metrics.VOLUME_SERVER_EC_OVERLAP_FRACTION.set(0.625)
            stats.metrics.VOLUME_SERVER_EC_OVERLAP_FRACTION.set(0.625)
            after = [_fields(vs._build_telemetry()) for vs in (port, ref)]
            return answers, before, after
        finally:
            await port.stop()
            await ref.stop()

    answers, before, after = asyncio.run(go())
    assert answers[0] == answers[1]
    assert all(s in (200, 201) for s, _ in answers[0][:len(writes)])
    assert all(s == 200 for s, _ in answers[0][len(writes):])
    mine, theirs = after
    for f in _REGISTRY_FIELDS:
        mine[f] -= before[0][f]
        theirs[f] -= before[1][f]
    for f in _SKIPPED:
        mine.pop(f)
        theirs.pop(f)
    assert mine == theirs
    # the fields the heartbeat repair filled carry what happened
    assert mine["qos_breaker_open"] is True
    assert mine["device_evictions"] >= 1 and mine["device_pin_claims"] >= 1
    assert mine["ec_reads_total"] == len(reads)
    assert mine["ec_reads_shed_total"] == len(after_trip)
    assert mine["overlap_fraction"] == 0.625
    # the needles' bytes as stored (body and header), at least the bodies
    assert mine["ingest_bytes_total"] >= sum(len(b) for *_, b in writes)
    assert mine["ingest_fsyncs_total"] >= 1


# ------------------------------------------------------- ClusterTelemetry

STAGES = ("queue_wait", "device_execute", "shard_read", "d2h_copy")
URLS = [f"10.0.0.{i}:80{i}0" for i in range(1, 6)]


def _heartbeats(seed: int, n: int = 160):
    """A seeded heartbeat sequence: [(kind, url, telemetry wire bytes or
    None, now, mesh_pod)].  Nodes pulse irregularly (some go stale, one
    disconnects and rejoins), carry clock stamps, residency maps, pod
    ranks, timeline samples (re-shipped to exercise the dedupe) and stage
    digests on the shared ladder and on shorter and longer ones."""
    rng = np.random.default_rng(seed)
    n_b = len(stats.STAGE_SECONDS_BUCKETS) + 1
    now = 1_000.0
    events = []
    for _ in range(n):
        now += float(rng.choice([0.1, 0.4, 0.9, 1.7, 2.6]))
        url = URLS[int(rng.integers(len(URLS)))]
        if rng.random() < 0.05:
            events.append(("disconnect", url, None, now, ""))
            continue
        pod = "pod-a" if url in URLS[3:] else ""
        if rng.random() < 0.1:
            events.append(("observe", url, None, now, pod))
            continue
        tel = jax_master_pb2.VolumeServerTelemetry(
            device_budget_bytes=int(rng.integers(1, 80)) << 30,
            device_used_bytes=int(rng.integers(0, 40)) << 30,
            device_resident_shards=int(rng.integers(0, 60)),
            device_evictions=int(rng.integers(0, 9)),
            device_pin_claims=int(rng.integers(0, 9)),
            dispatcher_queue_depth=int(rng.integers(0, 50)),
            dispatcher_inflight=int(rng.integers(0, 3)),
            dispatcher_shed=int(rng.integers(0, 1000)),
            qos_breaker_open=bool(rng.random() < 0.3),
            ec_reads_total=int(rng.integers(0, 10**6)),
            ec_reads_shed_total=int(rng.integers(0, 1000)),
            overlap_fraction=float(rng.choice([0.0, 0.5, 1.25, 1.875])),
            ec_h2d_bytes=int(rng.integers(0, 10**9)),
            ec_d2h_bytes=int(rng.integers(0, 10**9)),
            tier_hbm_volumes=int(rng.integers(0, 5)),
            tier_host_volumes=int(rng.integers(0, 5)),
            tier_promotions=int(rng.integers(0, 20)),
            tier_demotions=int(rng.integers(0, 20)),
            tier_host_bytes=int(rng.integers(0, 10**10)),
            ingest_bytes_total=int(rng.integers(0, 10**10)),
            ingest_rows_device=int(rng.integers(0, 100)),
            ingest_rows_host=int(rng.integers(0, 100)),
            ingest_shed_total=int(rng.integers(0, 100)),
            ingest_fsyncs_total=int(rng.integers(0, 100)),
            ingest_active_pipelines=int(rng.integers(0, 4)),
            ingest_streamed_seals=int(rng.integers(0, 4)),
            mesh_process_id=int(rng.integers(0, 2)) if pod else 0,
            mesh_process_count=2 if pod else 1,
            wall_clock_unix_ms=int(now * 1e3 + rng.integers(-500, 500)),
        )
        tel.device_bytes_per_device.extend(
            int(b) for b in rng.integers(0, 1 << 30, int(rng.integers(0, 3))))
        for vid in rng.choice(9, int(rng.integers(0, 4)), replace=False):
            tel.resident_shards_by_volume[int(vid)] = int(rng.integers(1, 15))
        for t_ in sorted({int(now) - int(k) for k in rng.integers(0, 3, 2)}):
            tel.timeline_samples_json.append(json.dumps(
                {"t": t_, "busy": float(rng.choice([0.0, 0.25, 0.5]))}))
        if rng.random() < 0.1:
            tel.timeline_samples_json.append("not json")
        for stage in rng.choice(STAGES, int(rng.integers(0, 3)),
                                replace=False):
            width = int(rng.choice([n_b, n_b, 3, n_b + 4]))
            counts = [int(c) for c in rng.integers(0, 5, width)]
            d = tel.stage_digests.add()
            d.stage = str(stage)
            d.bucket_counts.extend(counts)
            d.count = sum(counts)
            d.sum_seconds = float(rng.random() * 0.01)
        events.append(("observe", url, tel.SerializeToString(), now, pod))
    return events


def _cluster_lines(text: str, stage_set) -> list[str]:
    """The SeaweedFS_cluster_* samples of a /metrics text, sorted, that
    this ClusterTelemetry's refresh sets: stage series only for
    `stage_set`, and no SLO series (earlier tests in the process may
    have set others, which a refresh leaves as they were; the SLO
    series are the SLO engine's, not the refresh's)."""
    out = []
    for line in text.splitlines():
        if not re.match(r"^SeaweedFS_cluster_\w", line) or "_created" in line \
                or "_slo_" in line:
            continue
        m = re.search(r'stage="([^"]*)"', line)
        if m and m.group(1) not in stage_set:
            continue
        out.append(line)
    return sorted(out)


def _exports(ct, now):
    return {
        "health": ct.health(now=now),
        "stale": ct.stale_node_urls(now=now),
        "breakers": ct.breakers_open(now=now),
        "fresh": ct.fresh_node_urls(now=now),
        "sheds": ct.read_shed_totals(),
        "skew": {u: ct.clock_skew_ms(u) for u in URLS},
        "quantiles": {(s, q): ct.stage_quantile(s, q)
                      for s in STAGES for q in (0.5, 0.9, 0.99)},
        "buckets": {s: ct.stage_buckets(s) for s in STAGES},
        "timeline": ct.timeline(now=now),
        "timeline_window": ct.timeline(window_s=3, now=now),
    }


@pytest.mark.parametrize("seed", [3, 17, 2026])
def test_cluster_telemetry_matches_the_reference(seed):
    from seaweedfs_tpu.stats.metrics import REGISTRY as JAX_REGISTRY
    from prometheus_client import generate_latest as jax_generate_latest

    events = _heartbeats(seed)
    mine = cluster.ClusterTelemetry(pulse_seconds=1, retention_seconds=30)
    theirs = jax_cluster.ClusterTelemetry(pulse_seconds=1,
                                          retention_seconds=30)
    checked = 0
    for i, (kind, url, raw, now, pod) in enumerate(events):
        if kind == "disconnect":
            mine.disconnect(url)
            theirs.disconnect(url)
        else:
            mine.observe(url, None if raw is None else
                         master_pb2.VolumeServerTelemetry.FromString(raw),
                         now=now, mesh_pod=pod)
            theirs.observe(url, None if raw is None else
                           jax_master_pb2.VolumeServerTelemetry.FromString(
                               raw), now=now, mesh_pod=pod)
        if i % 20 == 19:
            at = now + 1.5
            assert _exports(mine, at) == _exports(theirs, at), i
            mine.refresh_gauges(now=at)
            theirs.refresh_gauges(now=at)
            merged = {s for s in STAGES if mine.stage_buckets(s)}
            got = _cluster_lines(
                stats.generate_latest(stats.REGISTRY).decode(), merged)
            want = _cluster_lines(
                jax_generate_latest(JAX_REGISTRY).decode(), merged)
            assert got == want, i
            assert len(got) > 20
            checked += 1
    assert checked == len(events) // 20
    # the sequence reached every branch the comparison is meant to cover
    h = mine.health(now=events[-1][3])
    assert h["cluster"]["nodes_stale"] >= 1 and "pods" in h
    assert any(n.get("connected") is False for n in h["nodes"].values()) or \
        any(e[0] == "disconnect" for e in events)
    assert all(h["cluster"]["stages"][s]["count"] > 0 for s in STAGES)


# ------------------------------------- mirrors of test_cluster_health.py


def test_stage_digest_deltas():
    """Only stages with new observations ship, with per-bucket increments
    over the shared ladder (+Inf last); equal to the reference's on the
    same observations."""
    got = []
    for pkg in (stats, jax_stats):
        h = pkg.REQUEST_STAGE_SECONDS.labels(stage="host_reconstruct")
        snap0 = pkg.stage_histogram_snapshot()
        for v in (0.0003, 0.0003, 5.0):
            h.observe(v)
        snap1 = pkg.stage_histogram_snapshot()
        deltas = {s: (b, c, ds) for s, b, c, ds in
                  pkg.stage_digest_deltas(snap0, snap1)}
        assert set(deltas) == {"host_reconstruct"}
        buckets, count, dsum = deltas["host_reconstruct"]
        assert count == 3 and sum(buckets) == 3
        assert len(buckets) == len(pkg.STAGE_SECONDS_BUCKETS) + 1
        assert buckets[-1] == 1  # the 5 s observation rode +Inf
        assert 5.0 < dsum < 5.01
        assert pkg.stage_digest_deltas(snap1, snap1) == []
        got.append((buckets, count, round(dsum, 12)))
    assert got[0] == got[1]
    assert stats.STAGE_SECONDS_BUCKETS == jax_stats.STAGE_SECONDS_BUCKETS


def test_quantile_from_buckets():
    edges = stats.STAGE_SECONDS_BUCKETS
    q = cluster.quantile_from_buckets
    assert q([0] * (len(edges) + 1), 0.5) is None
    counts = [0] * (len(edges) + 1)
    counts[1] = 10
    assert edges[0] < q(counts, 0.5) <= edges[1]
    counts = [0] * (len(edges) + 1)
    counts[-1] = 4
    assert q(counts, 0.99) == edges[-1]
    rng = np.random.default_rng(7)
    for _ in range(200):
        counts = [int(c) for c in rng.integers(0, 6, len(edges) + 1)]
        for p in (0.01, 0.5, 0.9, 0.99, 1.0):
            assert q(counts, p) == jax_cluster.quantile_from_buckets(
                counts, p)


def _tel(pkg_pb, used, shed, stage_counts):
    t_ = pkg_pb.VolumeServerTelemetry(
        device_budget_bytes=100, device_used_bytes=used, dispatcher_shed=shed)
    d = t_.stage_digests.add()
    d.stage = "queue_wait"
    d.bucket_counts.extend(stage_counts)
    d.count = sum(stage_counts)
    d.sum_seconds = 0.001
    return t_


@pytest.mark.parametrize("side", ["port", "ref"])
def test_cluster_telemetry_staleness_and_merge(side):
    mod, pb = ((cluster, master_pb2) if side == "port"
               else (jax_cluster, jax_master_pb2))
    ct = mod.ClusterTelemetry(pulse_seconds=1)
    assert ct.stale_after == 2.0
    n_b = len(stats.STAGE_SECONDS_BUCKETS) + 1
    ct.observe("a:1", _tel(pb, 10, 1, [2] + [0] * (n_b - 1)), now=100.0)
    ct.observe("b:2", _tel(pb, 20, 2, [0, 2] + [0] * (n_b - 2)), now=101.5)
    h = ct.health(now=102.5)
    assert not h["nodes"]["b:2"]["stale"]
    assert h["nodes"]["a:1"]["stale"]
    assert h["cluster"]["nodes_stale"] == 1
    assert h["cluster"]["device_used_bytes"] == 20
    assert h["cluster"]["stages"]["queue_wait"]["count"] == 4
    ct.disconnect("a:1")
    h = ct.health(now=102.5)
    assert h["nodes"]["a:1"]["connected"] is False
    assert h["nodes"]["a:1"]["device"]["used_bytes"] == 10
    q = ct.stage_quantile("queue_wait", 0.99)
    assert q is not None and q <= stats.STAGE_SECONDS_BUCKETS[1]


@pytest.mark.parametrize("side", ["port", "ref"])
def test_digest_ladder_drift_preserves_overflow(side):
    mod, pb = ((cluster, master_pb2) if side == "port"
               else (jax_cluster, jax_master_pb2))
    ct = mod.ClusterTelemetry(pulse_seconds=1)
    tel = pb.VolumeServerTelemetry()
    d = tel.stage_digests.add()
    d.stage = "queue_wait"
    d.bucket_counts.extend([1, 0, 3])
    d.count = 4
    ct.observe("a:1", tel, now=100.0)
    buckets = ct.stage_buckets("queue_wait")
    assert buckets[0] == 1 and buckets[-1] == 3 and sum(buckets) == 4
    assert ct.health(now=100.0)["cluster"]["stages"]["queue_wait"][
        "overflow"] == 3
    tel2 = pb.VolumeServerTelemetry()
    d2 = tel2.stage_digests.add()
    d2.stage = "shard_read"
    d2.bucket_counts.extend([1] * (len(stats.STAGE_SECONDS_BUCKETS) + 5))
    d2.count = len(stats.STAGE_SECONDS_BUCKETS) + 5
    ct.observe("a:1", tel2, now=100.0)
    buckets = ct.stage_buckets("shard_read")
    assert sum(buckets) == d2.count and buckets[-1] == 5


@pytest.mark.parametrize("side", ["port", "ref"])
def test_disconnected_node_retention(side):
    mod, pb = ((cluster, master_pb2) if side == "port"
               else (jax_cluster, jax_master_pb2))
    ct = mod.ClusterTelemetry(pulse_seconds=1, retention_seconds=60)
    ct.observe("a:1", pb.VolumeServerTelemetry(), now=100.0)
    ct.disconnect("a:1")
    assert "a:1" in ct.health(now=150.0)["nodes"]
    assert "a:1" not in ct.health(now=161.0)["nodes"]
    ct.observe("b:2", pb.VolumeServerTelemetry(), now=100.0)
    assert ct.health(now=1000.0)["nodes"]["b:2"]["stale"]


# ------------------------------------------------------------------ shell

TRACE_ID = "5eed5eed5eed5eed"
PLAIN_VID = 2


def _shell_mask(text: str, urls: dict) -> list[str]:
    """Addresses to names; every number (ages, seconds, clocks, byte
    counts of process-wide registries) to <n>, the compile-cache column
    (the reference's is process-wide; the port has none) to <cache>, and
    the column padding the numbers' widths set to one space."""
    for url, name in sorted(urls.items(), key=lambda kv: -len(kv[0])):
        text = text.replace(url, name)
    text = re.sub(r"compile_cache=\w+", "compile_cache=<cache>", text)
    text = re.sub(r"\d+(\.\d+)?", "<n>", text)
    return [re.sub(" +", " ", line) for line in text.splitlines()]


def _doc_shape(doc):
    """A JSON document with every number replaced by its type."""
    if isinstance(doc, dict):
        return {k: _doc_shape(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_doc_shape(v) for v in doc]
    if isinstance(doc, bool) or doc is None or isinstance(doc, str):
        return doc
    return "<n>"


async def _shell_case(side, blobs):
    from unittest import mock

    from test_torch_cluster import FROZEN
    from test_torch_repair import _encode_on_holder

    await side.start()
    out = {}
    try:
        await side.allocate_and_fill(blobs)
        vs0 = side.c.volume_servers[0]
        await side.rpc(vs0, "AllocateVolume", volume_id=PLAIN_VID,
                       replication="000")
        await _encode_on_holder(side, spread=False)
        await side.wait_for(
            lambda: vs0.store.ec_device_cache.resident_count(1) == 14,
            "all 14 shards resident")
        await side.sh("volume.repair.resume")
        cl = Client(vs0.ip, vs0.port)
        try:
            with mock.patch("time.time", return_value=FROZEN), \
                    mock.patch("time.time_ns",
                               return_value=int(FROZEN * 1e9)):
                st, _, _ = await cl.request(
                    "POST", f"/{PLAIN_VID},0101020304", None, b"traced")
            assert st in (200, 201)
            st, _, body = await cl.request(
                "GET", f"/{PLAIN_VID},0101020304",
                {"X-Seaweed-Trace-Id": f"{TRACE_ID}-00000001"})
            assert (st, body) == (200, b"traced")
            for fid, data, _ in blobs:
                st, _, body = await cl.request("GET", f"/{fid}")
                assert (st, body) == (200, data)
        finally:
            await cl.close()
        # one pulse after the reads: the master's view holds them
        tel = side.c.master.telemetry
        mark = time.time()
        await side.wait_for(
            lambda: all(tel._nodes[vs.url].last_seen > mark
                        for vs in side.c.volume_servers), "a fresh pulse")
        urls = {vs.url: "server-" + "ab"[i]
                for i, vs in enumerate(side.c.volume_servers)}
        urls[side.c.master.url] = "master"
        for line in ("cluster.health", "volume.device.status",
                     "volume.tier.status", "volume.ingest.status",
                     f"volume.trace -node {vs0.url} -id {TRACE_ID}",
                     f"volume.trace.why -id {TRACE_ID} -node {vs0.url}",
                     "cluster.health -json"):
            side.out.seek(0)
            side.out.truncate(0)
            await side.sh(line)
            text = side.out.getvalue()
            out[line.split(" -")[0] + (" -json" if "-json" in line else "")
                ] = text if "-json" in line else _shell_mask(text, urls)
        out["urls"] = urls
    finally:
        await side.stop()
    return out


def _digests_from_construction(monkeypatch, vs_cls, metrics_mod):
    """Each server's first heartbeat ships its stage histograms' growth
    since the server was built, not since the process began: earlier
    tests of this process observed into each package's registry
    differently."""
    init = vs_cls.__init__

    def patched(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._stage_snapshot = metrics_mod.stage_histogram_snapshot()

    monkeypatch.setattr(vs_cls, "__init__", patched)


def test_telemetry_shell_commands_match_the_reference(tmp_path, small_caches,
                                                      monkeypatch):
    from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
    from test_torch_cluster import _blobs
    from test_torch_repair import _side_class

    _digests_from_construction(monkeypatch, server_volume.VolumeServer,
                               stats.metrics)
    _digests_from_construction(monkeypatch, RefVolumeServer,
                               jax_stats.metrics)

    Side = _side_class()
    blobs = _blobs()[:8]
    vkw = {"port": {"ec_device_cache_mb": 256,
                    "ec_serving": ServingConfig(layout="flat", mesh=False)},
           "ref": {"ec_device_cache_mb": 256,
                   "ec_serving": JaxServingConfig(layout="flat",
                                                  mesh=False)}}
    kw = dict(interval_seconds=0.25)
    ref = asyncio.run(_shell_case(Side("ref", str(tmp_path / "ref"), 2, kw,
                                       vkw), blobs))
    port = asyncio.run(_shell_case(Side("port", str(tmp_path / "port"), 2,
                                        kw, vkw), blobs))
    # both packages' servers ship stage digests: the merged-digest block
    # is compared with the rest
    assert "stage latency estimates (merged digests):" in port[
        "cluster.health"]
    for key in ("cluster.health", "volume.device.status",
                "volume.tier.status", "volume.ingest.status",
                "volume.trace", "volume.trace.why"):
        # rows come in address order, and the ports are the OS's choice
        assert sorted(port[key]) == sorted(ref[key]), key
    # the documents: the same blocks, the SLO engine's (no objective
    # declared) and the merged stage digests included
    docs, compile_fields = [], []
    for side in (port, ref):
        doc = json.loads(side["cluster.health -json"])
        for url, name in side["urls"].items():
            doc = json.loads(json.dumps(doc).replace(url, name))
        # the reference's compile counters are process-wide (earlier
        # tests in this process count into them); the port has none
        compile_fields.append([
            {k: node["device"].pop(k) for k in (
                "compile_hits", "compile_misses", "compile_cache_enabled")}
            for _, node in sorted(doc["nodes"].items())])
        docs.append(doc)
    assert compile_fields[0] == [{"compile_hits": 0, "compile_misses": 0,
                                  "compile_cache_enabled": False}] * 2
    mine, theirs = docs
    assert set(mine) == set(theirs)
    assert mine["slo"] == theirs["slo"] and mine["slo"]["objectives"] == {}
    assert mine["cluster"]["stages"] and \
        set(mine["cluster"]["stages"]) == set(theirs["cluster"]["stages"])
    assert _doc_shape(mine) == _doc_shape(theirs)
    assert mine["cluster"]["ec_volume_residency"] == \
        theirs["cluster"]["ec_volume_residency"] == {"1": {"server-a": 14}}
    for doc in (mine, theirs):
        dev = doc["nodes"]["server-a"]["device"]
        assert dev["resident_shards"] == 14
        assert doc["nodes"]["server-a"]["dispatcher"][
            "qos_breaker_open"] is False
    assert mine["nodes"]["server-a"]["device"] == \
        theirs["nodes"]["server-a"]["device"]
    assert " ec volume <n>: <n> resident shards" in port[
        "volume.device.status"]
