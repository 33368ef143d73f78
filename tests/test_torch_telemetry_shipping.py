"""The heartbeat's stage digests and flight-timeline samples in the port,
held against the JAX package's (server/volume.py `_build_telemetry`, the
master's stats/cluster.py merge and `timeline`, the incident bundle's
timeline window).

Mirrors tests/test_devledger_timeline.py's timeline-shipping, cluster
timeline and bundle-timeline cases on both packages, and adds the stage
digests' ACK gate: a heartbeat the master never acknowledged (a dropped
pulse, a broken stream) is shipped again, so the master's merged digest
loses no observation.  Exact host arithmetic and JSON: no tolerance but
the digests' float sums.
"""
import asyncio
import json

import pytest

from seaweedfs_tpu.obs import incident as ref_incident
from seaweedfs_tpu.obs import timeline as ref_timeline
from seaweedfs_tpu.pb import master_pb2 as ref_master_pb2
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu.stats import cluster as ref_cluster
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu_torch.obs import incident as port_incident
from seaweedfs_tpu_torch.obs import timeline as port_timeline
from seaweedfs_tpu_torch.pb import master_pb2 as port_master_pb2
from seaweedfs_tpu_torch.server.volume import VolumeServer as PortVolumeServer
from seaweedfs_tpu_torch.stats import cluster as port_cluster
from seaweedfs_tpu_torch.stats import metrics as port_metrics

SIDES = {
    "port": (PortVolumeServer, port_timeline, port_cluster, port_metrics,
             port_master_pb2, port_incident),
    "ref": (RefVolumeServer, ref_timeline, ref_cluster, ref_metrics,
            ref_master_pb2, ref_incident),
}


def _server(side, tmp_path):
    vs_cls = SIDES[side][0]
    if side == "port":
        return vs_cls([], [str(tmp_path)], port=0, ec_backend="torch")
    return vs_cls(masters=[], directories=[str(tmp_path)], port=0,
                  grpc_port=0)


def _stream_break(vs) -> None:
    """What `_heartbeat_stream`'s finally does when the stream breaks."""
    vs._hb_sent, vs._hb_acked = 0, 0
    vs._digest_shipped = {}
    vs._digest_inflight_at = None
    vs._timeline_shipped = 0
    vs._timeline_inflight_at = None


# (the series, its gauge in each package's stats.metrics)
QOS_GAUGES = (
    ("SeaweedFS_volumeServer_ec_qos_queue_depth",
     "VOLUME_SERVER_EC_QOS_QUEUE_DEPTH"),
    ("SeaweedFS_volumeServer_ec_qos_breaker_state",
     "VOLUME_SERVER_EC_QOS_BREAKER_STATE"),
)


def _timeline_shipping(side, tmp_path):
    """The reference's test_timeline_heartbeat_shipping_ack_gated, on one
    package: -> what each build shipped and the master's timeline.  A
    sample reads the QoS queue-depth and breaker gauges of the process's
    registry live: they start at a fresh process's 0 here (an earlier
    test in the same process, e.g. tests/test_qos_admission.py, may leave
    one set) and get their values back after."""
    _, tl_mod, cl_mod, metrics_mod, *_ = SIDES[side]
    saved = {}
    for series, name in QOS_GAUGES:
        for tier in ("interactive", "bulk"):
            saved[name, tier] = metrics_mod.REGISTRY.get_sample_value(
                series, {"tier": tier})
            getattr(metrics_mod, name).labels(tier=tier).set(0)
    vs = _server(side, tmp_path)
    vs.timeline = tl_mod.TimelineSampler(node="vs:1", window=8)

    def shipped(tel):
        return [json.loads(s)["t"] for s in tel.timeline_samples_json]

    out = []
    try:
        vs.timeline.sample(now=100)
        tel1 = vs._build_telemetry()
        out.append(shipped(tel1))
        vs._hb_sent += 1
        vs.timeline.sample(now=101)
        tel2 = vs._build_telemetry()  # outstanding shipment un-acked: defer
        vs._hb_sent += 1
        out.append(shipped(tel2))
        vs._hb_acked = 2
        tel3 = vs._build_telemetry()  # retire, ship the deferred sample
        vs._hb_sent += 1
        out.append(shipped(tel3))
        vs._hb_acked = 3
        tel4 = vs._build_telemetry()
        vs._hb_sent += 1
        out.append(shipped(tel4))
        # stream break with a shipment un-acked: the new stream re-ships
        vs.timeline.sample(now=102)
        tel5 = vs._build_telemetry()
        out.append(shipped(tel5))
        _stream_break(vs)
        tel6 = vs._build_telemetry()
        out.append(shipped(tel6))
        # master side: the duplicate 102 folds into one row per (node, t)
        ct = cl_mod.ClusterTelemetry(pulse_seconds=1)
        ct.observe("vs:1", tel5, now=200.0)
        ct.observe("vs:1", tel6, now=201.0)
        return out, ct.timeline()
    finally:
        vs.store.close()
        for (name, tier), v in saved.items():
            getattr(metrics_mod, name).labels(tier=tier).set(v or 0)


def test_timeline_heartbeat_shipping_ack_gated(tmp_path):
    port = _timeline_shipping("port", tmp_path / "port")
    ref = _timeline_shipping("ref", tmp_path / "ref")
    assert port[0] == ref[0] == [[100], [], [101], [], [102], [102]]
    for doc in (port[1], ref[1]):
        doc.pop("generated_unix_ms")
        assert [row["t"] for row in doc["samples"]] == [102]
        assert doc["nodes"] == ["vs:1"]
        for row in doc["samples"]:  # counters of each process's own ledger
            for smp in row["nodes"].values():
                smp["busy_ms"] = smp["disp"] = {}
                smp.pop("resident_bytes", None)
    assert port[1] == ref[1]


def test_timeline_backlog_is_capped_at_one_ring(tmp_path):
    """A long partition (no acknowledgement) keeps at most one ring of
    unshipped samples, the oldest dropped, in both packages."""
    got = []
    for side in ("port", "ref"):
        _, tl_mod, *_ = SIDES[side]
        vs = _server(side, tmp_path / side)
        vs.timeline = tl_mod.TimelineSampler(node="vs:1", window=4)
        try:
            shipped = []
            for t in range(100, 110):
                vs.timeline.sample(now=t)
                tel = vs._build_telemetry()
                vs._hb_sent += 1
                shipped.append([json.loads(s)["t"]
                                for s in tel.timeline_samples_json])
            _stream_break(vs)
            tel = vs._build_telemetry()
            shipped.append([json.loads(s)["t"]
                            for s in tel.timeline_samples_json])
            got.append((shipped, len(vs._timeline_backlog)))
        finally:
            vs.store.close()
    assert got[0] == got[1]
    assert got[0][0][-1] == [106, 107, 108, 109]


STAGE = "batch_dispatch"
OBS = ([0.0003, 0.004, 0.0007, 0.02, 2.5, 0.0009],
       [0.006, 0.00002, 0.3, 0.0011])


def _digest_shipping(side, tmp_path):
    """Observations, a heartbeat that ships them and is never
    acknowledged (the stream breaks), more observations, the re-shipping
    heartbeat acknowledged, an idle build: -> the digests each build
    shipped and the master's merged stage (it saw only the heartbeats
    that got through)."""
    *_, cl_mod, metrics_mod, pb, _ = SIDES[side]
    hist = metrics_mod.REQUEST_STAGE_SECONDS.labels(stage=STAGE)
    vs = _server(side, tmp_path)
    try:
        # earlier tests of this process observed into the same registry
        vs._stage_snapshot = metrics_mod.stage_histogram_snapshot()
        builds = []
        for v in OBS[0]:
            hist.observe(v)
        builds.append(vs._build_telemetry())  # heartbeat 1: dropped
        vs._hb_sent += 1
        _stream_break(vs)
        for v in OBS[1]:
            hist.observe(v)
        builds.append(vs._build_telemetry())  # heartbeat 1 of stream 2
        vs._hb_sent += 1
        vs._hb_acked = 1
        builds.append(vs._build_telemetry())  # retired; nothing new
        vs._hb_sent += 1
        hist.observe(0.0042)
        vs._hb_acked = 2
        builds.append(vs._build_telemetry())  # only the new observation
        ct = cl_mod.ClusterTelemetry(pulse_seconds=1)
        for tel in builds[1:]:  # the dropped heartbeat never arrived
            ct.observe("vs:1", pb.VolumeServerTelemetry.FromString(
                tel.SerializeToString()), now=100.0)
        shipped = [[(d.stage, list(d.bucket_counts), d.count)
                    for d in tel.stage_digests if d.stage == STAGE]
                   for tel in builds]
        sums = [sum(d.sum_seconds for d in tel.stage_digests
                    if d.stage == STAGE) for tel in builds]
        return shipped, sums, ct.stage_buckets(STAGE), ct.health(now=100.0)
    finally:
        vs.store.close()


def test_stage_digests_survive_a_dropped_heartbeat(tmp_path):
    port = _digest_shipping("port", tmp_path / "port")
    ref = _digest_shipping("ref", tmp_path / "ref")
    assert port[0] == ref[0]
    assert port[1] == pytest.approx(ref[1], abs=1e-12)
    shipped = port[0]
    n0, n1 = len(OBS[0]), len(OBS[1])
    assert [d[0][2] if d else 0 for d in shipped] == [n0, n0 + n1, 0, 1]
    # every observation reached the master exactly once
    merged = port[2]
    assert merged == ref[2] and sum(merged) == n0 + n1 + 1
    want = [0] * len(merged)
    for v in [*OBS[0], *OBS[1], 0.0042]:
        i = next((i for i, e in enumerate(port_metrics.STAGE_SECONDS_BUCKETS)
                  if v <= e), len(merged) - 1)
        want[i] += 1
    assert merged == want
    assert port[3]["cluster"]["stages"][STAGE] == \
        ref[3]["cluster"]["stages"][STAGE]


def _aligned(cl_mod, pb):
    ct = cl_mod.ClusterTelemetry(pulse_seconds=1)

    def tel(samples):
        t = pb.VolumeServerTelemetry()
        t.timeline_samples_json.extend(
            json.dumps(s, separators=(",", ":")) for s in samples)
        return t

    ct.observe("a:1", tel([
        {"t": 100, "node": "a:1", "busy_ms": {"ingest": 10.0}},
        {"t": 101, "node": "a:1", "busy_ms": {}},
    ]), now=101.0)
    ct.observe("b:2", tel([
        {"t": 100, "node": "b:2", "busy_ms": {"scrub": 5.0}},
    ]), now=101.0)
    docs = [ct.timeline(), ct.timeline(window_s=0.5)]
    bad = pb.VolumeServerTelemetry()
    bad.timeline_samples_json.append("not json")
    bad.timeline_samples_json.append(json.dumps({"no_t": 1}))
    ct.observe("a:1", bad, now=102.0)
    docs.append(ct.timeline())
    late = pb.VolumeServerTelemetry()
    ct.observe("a:1", late, now=100.0 + cl_mod.RETENTION_SECONDS + 1)
    docs.append(ct.timeline())
    for doc in docs:
        doc.pop("generated_unix_ms")
    return docs


def test_cluster_timeline_clock_aligned_assembly():
    port = _aligned(port_cluster, port_master_pb2)
    ref = _aligned(ref_cluster, ref_master_pb2)
    assert port == ref
    doc = port[0]
    rows = {row["t"]: row["nodes"] for row in doc["samples"]}
    assert doc["nodes"] == ["a:1", "b:2"] and set(rows) == {100, 101}
    assert rows[100]["b:2"]["busy_ms"] == {"scrub": 5.0}
    assert [row["t"] for row in port[1]["samples"]] == [101]
    assert len(port[2]["samples"]) == 2
    assert port_cluster.RETENTION_SECONDS == ref_cluster.RETENTION_SECONDS
    # a:1's t=100 sample aged out with its node's retention; b:2's stays
    assert {row["t"]: sorted(row["nodes"]) for row in port[3]["samples"]} \
        == {100: ["b:2"], 101: ["a:1"]}


@pytest.fixture
def bundle_dirs(tmp_path):
    saved = (port_incident.CONFIG, ref_incident.CONFIG)
    for mod in (port_incident, ref_incident):
        mod.configure(mod.IncidentConfig(
            dir=str(tmp_path / mod.__name__.split(".")[0]),
            min_interval_seconds=0.0))
    yield
    port_incident.configure(saved[0])
    ref_incident.configure(saved[1])


def _bundle_with(mod, timeline_fn, health=None):
    b = mod.IncidentBundler(lambda: [], lambda: health or {"cluster": {}},
                            timeline_fn=timeline_fn)
    summary = asyncio.run(b.capture({"slo": "read_p99"}, window_s=30.0))
    with open(summary["path"], encoding="utf-8") as f:
        return summary, json.load(f)


def test_incident_bundle_embeds_timeline_window(bundle_dirs):
    docs = []
    for mod in (port_incident, ref_incident):
        captured: list = []

        def timeline_fn(window_s, captured=captured):
            captured.append(window_s)
            return {"window_seconds": window_s, "nodes": ["a:1"],
                    "samples": [{"t": 100, "nodes": {
                        "a:1": {"busy_ms": {"scrub": 9.0}}}}]}

        summary, bundle = _bundle_with(mod, timeline_fn)
        assert captured == [30.0]
        docs.append((sorted(summary), bundle))
    (keys_p, port), (keys_r, ref) = docs
    assert keys_p == keys_r
    assert sorted(port) == sorted(ref)
    assert port["timeline"] == ref["timeline"]
    assert port["timeline"]["samples"][0]["nodes"]["a:1"]["busy_ms"] == \
        {"scrub": 9.0}
    for doc in (port, ref):
        doc.pop("written_unix_ms")
        # the master's own rings hold what earlier tests of this process
        # traced and recorded: the correlation and the worst critical
        # paths come from them
        doc["critpaths"] = []
        doc["correlation"] = {}
        for node in doc["nodes"].values():
            node["events"] = []
            node["trace_count"] = 0
    assert port == ref


def test_incident_bundle_survives_timeline_failure(bundle_dirs):
    for mod in (port_incident, ref_incident):
        def broken(_w):
            raise RuntimeError("assembly bug")

        summary, bundle = _bundle_with(mod, broken, health={})
        assert summary is not None  # the bundle still lands
        assert bundle["timeline"] is None
