"""The master half of the port's observability plane, held against the
JAX package's: the incident bundler (obs/incident.py), the master's SLO
loop, /debug/critpath fan-out, /debug/timeline, /debug/tail,
/debug/incident, POST /cluster/incident/dump and /debug/stacks
(server/master.py), the pushgateway loop (stats/metrics.py) and the
shell's cluster.slo, cluster.timeline, cluster.tail and
cluster.incident.dump.

- Units: the bundler's correlation, keep cap and rate limit on the same
  seeded inputs in both packages.
- The incident e2e (tests/test_incident_plane.py:331) on both packages'
  LocalCluster: the same blobs, `ec.encode` spread over two servers,
  reads on the holder until the read_p99 SLO burns; the bundle's keys, the
  correlation and the rate limit must equal the reference's.  The same
  run holds the master's cross-node critical path of a read
  (tests/test_tailpath.py:211) to the reference's segment structure.
- The push loop (tests/test_metrics_push.py) for the master and volume
  roles.
- The four shell commands byte-equal to the reference's output for the
  same master documents.
"""
import asyncio
import io
import json
import os
import re
import time

import numpy as np
import pytest

from seaweedfs_tpu.obs import SloConfig as RefSloConfig
from seaweedfs_tpu.obs import incident as ref_incident
from seaweedfs_tpu.repair import RepairConfig as RefRepairConfig
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run
from seaweedfs_tpu_torch import obs
from seaweedfs_tpu_torch.obs import incident as port_incident
from seaweedfs_tpu_torch.repair import RepairConfig
from seaweedfs_tpu_torch.server.http import (
    Client, HTTPServer, Response, json_response)
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv as PortEnv
from seaweedfs_tpu_torch.shell import run_command as port_run

INCIDENTS = (port_incident, ref_incident)


@pytest.fixture(autouse=True)
def _restore_incident_config():
    """The incident configs are process-global (like the trace rings);
    every test gets the defaults back."""
    saved = [m.CONFIG for m in INCIDENTS]
    yield
    for m, cfg in zip(INCIDENTS, saved):
        m.configure(cfg)
        m.EVENTS.clear()


# ------------------------------------------------------------------ units


def _node_docs(seed: int) -> dict:
    """Seeded per-node incident payloads: trace entries at several capture
    points sharing ids across nodes, and trace-stamped events."""
    rng = np.random.default_rng(seed)
    ids = [f"{int(x):016x}" for x in rng.integers(1, 1 << 62, 12)]
    docs = {}
    for n in range(int(rng.integers(2, 5))):
        traces = []
        for _ in range(int(rng.integers(0, 10))):
            traces.append({
                "trace_id": str(rng.choice(ids)),
                "role": str(rng.choice(["volume", "master"])),
                "server": str(rng.choice(["", f"n{n}:80"])),
                "name": str(rng.choice(["GET /3,01", "grpc VolumeEcShardRead",
                                        "POST /3,02"])),
                "parent_span_id": str(rng.choice(["", "ab12cd34"])),
                "duration_us": int(rng.integers(0, 10_000)),
            })
        events = [{"unix_ms": 1, "kind": "qos_shed", "details": {},
                   "trace_id": str(rng.choice(ids + ["", ""]))}
                  for _ in range(int(rng.integers(0, 4)))]
        docs[f"10.0.0.{n}:8080"] = {"events": events, "traces": traces}
    if rng.random() < 0.3:
        docs["10.0.0.9:8080"] = {"error": "Connection refused"}
    return docs


@pytest.mark.parametrize("seed", range(8))
def test_correlation_equals_the_reference(seed):
    nodes = _node_docs(seed)
    got = [m.IncidentBundler._correlate(json.loads(json.dumps(nodes)))
           for m in INCIDENTS]
    assert got[0] == got[1]


def test_bundles_capped_and_rate_limited_like_the_reference(tmp_path):
    """keep=2, a 60 s interval on an injected clock: the same sequence of
    captures writes, suppresses and forces the same bundles, and the cap
    prunes the same files (stale .tmp leftovers too)."""
    outcomes = []
    for m in INCIDENTS:
        d = tmp_path / m.__name__.split(".")[0]
        d.mkdir()
        (d / "incident-1-old.json.tmp.99").write_text("{}")
        m.configure(m.IncidentConfig(dir=str(d), keep=2,
                                     min_interval_seconds=60.0))
        now = [1000.0]
        b = m.IncidentBundler(lambda: [], lambda: {"nodes": {}},
                              clock=lambda: now[0])
        seq = []
        for step, (dt, force) in enumerate(
                [(0, False), (10, False), (0, True), (55, False),
                 (0, True), (1, False)]):
            now[0] += dt
            res = asyncio.run(b.capture({"slo": f"s{step}"}, 5.0,
                                        force=force))
            seq.append(None if res is None else sorted(res))
            time.sleep(0.002)  # distinct written_unix_ms names
        names = sorted(re.sub(r"incident-\d+-", "incident-", f)
                       for f in os.listdir(d))
        outcomes.append((seq, names, b.bundles_written))
    assert outcomes[0] == outcomes[1]
    seq, names, written = outcomes[0]
    # the interval runs from the last SLO-fired bundle; a forced dump
    # neither waits for it nor restarts it
    assert [s is not None for s in seq] == [True, False, True, True, True,
                                            False]
    assert written == 4 and len(names) == 2


def test_disabled_bundler_writes_nothing():
    for m in INCIDENTS:
        m.configure(m.IncidentConfig(dir=""))
        b = m.IncidentBundler(lambda: [], lambda: {})
        assert asyncio.run(b.capture({"slo": "x"}, 5.0, force=True)) is None


def test_failed_node_and_profile_are_recorded_not_fatal(tmp_path):
    """A node that refuses the fan-out and a profile capture that fails
    land in the bundle as errors; the bundle is still written."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    port_incident.configure(port_incident.IncidentConfig(
        dir=str(tmp_path), profile_seconds=0.1))
    b = port_incident.IncidentBundler(lambda: [dead], lambda: {"nodes": {}})
    summary = asyncio.run(b.capture({"slo": "read_p99", "latency": True},
                                    5.0))
    with open(summary["path"]) as f:
        bundle = json.load(f)
    assert "error" in bundle["nodes"][dead]
    assert bundle["profile"]["node"] == dead and bundle["profile"]["error"]
    assert summary["profile"] == bundle["profile"]


# ---------------------------------------------------------------- master


def test_master_routes_and_refusals(tmp_path, monkeypatch):
    """The master's debug routes answer as the reference's: a dump without
    -obs.incident.dir is 503, a bad window 400, a GET of the dump 405;
    /debug/timeline refuses a bad window; /debug/stacks is there only with
    SWFS_DEBUG=1; the health document carries the slo block."""
    async def go(debug, inc_dir):
        if debug:
            monkeypatch.setenv("SWFS_DEBUG", "1")
        else:
            monkeypatch.delenv("SWFS_DEBUG", raising=False)
        m = MasterServer(port=0, obs_slo=obs.SloConfig(read_p99_ms=5.0),
                         obs_incident=port_incident.IncidentConfig(
                             dir=inc_dir))
        await m.start()
        c = Client(m.ip, m.port)
        try:
            out = {}
            for method, path in (
                    ("POST", "/cluster/incident/dump"),
                    ("POST", "/cluster/incident/dump?window=nan"),
                    ("POST", "/cluster/incident/dump?window=-5"),
                    ("GET", "/cluster/incident/dump"),
                    ("GET", "/debug/timeline?window=x"),
                    ("GET", "/debug/timeline?window=5"),
                    ("GET", "/debug/stacks"), ("GET", "/debug/tail"),
                    ("GET", "/debug/incident"), ("GET", "/debug/traces"),
                    ("GET", "/debug/critpath?id=feedfacefeedface"),
                    ("GET", "/cluster/health.json")):
                status, _, body = await c.request(method, path)
                out[(method, path)] = (status, body)
            return out
        finally:
            await c.close()
            await m.stop()

    out = asyncio.run(go(True, ""))
    assert out[("POST", "/cluster/incident/dump")][0] == 503
    assert out[("GET", "/debug/stacks")][0] == 200
    assert b"--- thread" in out[("GET", "/debug/stacks")][1]
    health = json.loads(out[("GET", "/cluster/health.json")][1])
    assert health["slo"]["objectives"]["read_p99"]["target"] == 0.005
    assert out[("GET", "/debug/critpath?id=feedfacefeedface")][0] == 404
    for path in ("/debug/tail", "/debug/incident", "/debug/traces",
                 "/debug/timeline?window=5"):
        assert out[("GET", path)][0] == 200, path
    assert out[("GET", "/debug/timeline?window=x")][0] == 400
    out = asyncio.run(go(False, str(tmp_path)))
    assert out[("GET", "/debug/stacks")][0] == 404
    assert out[("POST", "/cluster/incident/dump?window=nan")][0] == 400
    assert out[("POST", "/cluster/incident/dump?window=-5")][0] == 400
    assert out[("GET", "/cluster/incident/dump")][0] == 405
    summary = json.loads(out[("POST", "/cluster/incident/dump")][1])
    assert os.path.exists(summary["path"])
    assert summary["nodes"] == ["<master>"]


def test_cpuprofile_and_memprofile_dump_at_exit(tmp_path):
    """`-cpuprofile` and `-memprofile` before the command (the reference's
    global flags): a cProfile dump and tracemalloc's top allocations land
    when the command exits."""
    import pstats
    import subprocess
    import sys

    cpu, mem = tmp_path / "cpu.prof", tmp_path / "mem.txt"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "-cpuprofile", str(cpu),
         "-memprofile", str(mem), "version"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert pstats.Stats(str(cpu)).total_calls > 0
    assert mem.read_text().strip()


def test_thread_stacks_name_every_thread():
    import threading

    from seaweedfs_tpu_torch.utils import profiling

    done = threading.Event()
    th = threading.Thread(target=done.wait, name="swfs-probe", daemon=True)
    th.start()
    try:
        text = profiling.thread_stacks()
    finally:
        done.set()
        th.join()
    assert "--- thread swfs-probe" in text and "--- thread MainThread" in text


# ------------------------------------------------------------- push loop


class PushSink:
    """A pushgateway on the port's HTTP server: records (job, instance,
    body) per PUT /metrics/job/<job>/instance/<instance>."""

    def __init__(self, port: int = 0):
        self.pushes: list = []
        self.server = HTTPServer(self._handle, port=port)

    async def _handle(self, req):
        parts = req.path.strip("/").split("/")
        assert req.method == "PUT" and parts[:2] == ["metrics", "job"]
        self.pushes.append((parts[2], parts[4], await req.read()))
        return Response(200)

    async def start(self):
        await self.server.start()
        return f"127.0.0.1:{self.server.port}"

    async def stop(self):
        await self.server.stop()


async def _wait(pred, timeout=15.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if pred():
            return True
        await asyncio.sleep(0.05)
    return False


def test_master_and_volume_servers_push_metrics(tmp_path):
    async def go():
        gw = PushSink()
        addr = await gw.start()
        master = MasterServer(port=0, metrics_address=addr,
                              metrics_interval_seconds=1)
        await master.start()
        vs = VolumeServer([master.advertise_url], [str(tmp_path / "v")],
                          port=0, ec_backend="torch", pulse_seconds=1,
                          metrics_address=addr, metrics_interval_seconds=1)
        await vs.start()
        try:
            assert await _wait(lambda: {"master", "volumeServer"} <= {
                j for j, _, _ in gw.pushes})
            by_job = {j: (i, b) for j, i, b in gw.pushes}
            assert by_job["master"][0] == master.url
            assert by_job["volumeServer"][0] == vs.url
            assert b"SeaweedFS_master_received_heartbeats" in \
                by_job["master"][1]
            assert b"SeaweedFS_volumeServer_volumes" in \
                by_job["volumeServer"][1]
        finally:
            await vs.stop()
            await master.stop()
            await gw.stop()

    asyncio.run(go())


def test_final_push_on_cancellation():
    async def go():
        gw = PushSink()
        addr = await gw.start()
        master = MasterServer(port=0, metrics_address=addr,
                              metrics_interval_seconds=3600)
        await master.start()
        assert await _wait(lambda: gw.pushes, 10), "startup push never came"
        n_before = len(gw.pushes)
        await master.stop()  # cancels the push task mid-sleep
        assert len(gw.pushes) > n_before, \
            "cancellation dropped the final interval's samples"
        assert gw.pushes[-1][0] == "master"
        await gw.stop()

    asyncio.run(go())


def test_push_survives_gateway_outage():
    async def go():
        gw = PushSink()
        addr = await gw.start()
        port = gw.server.port
        await gw.stop()  # the gateway is down at server start
        master = MasterServer(port=0, metrics_address=addr,
                              metrics_interval_seconds=1)
        await master.start()
        try:
            await asyncio.sleep(1.5)  # at least one failed push
            gw2 = PushSink(port)
            await gw2.start()
            try:
                assert await _wait(lambda: gw2.pushes, 10), \
                    "the push loop died during the outage"
                assert gw2.pushes[0][0] == "master"
            finally:
                await gw2.stop()
        finally:
            await master.stop()

    asyncio.run(go())


# ---------------------------------------------------------- shell output


def _master_docs(seed: int, node_urls: list) -> dict:
    """The documents the four commands read, from the port's own planes
    on seeded inputs: the health document with an SLO block, a cluster
    timeline, per-node tail documents and a dump summary."""
    from seaweedfs_tpu_torch.obs import slo as port_slo
    from seaweedfs_tpu_torch.pb import master_pb2
    from seaweedfs_tpu_torch.stats import cluster

    rng = np.random.default_rng(seed)
    ct = cluster.ClusterTelemetry(pulse_seconds=1)
    for i, url in enumerate(node_urls):
        tel = master_pb2.VolumeServerTelemetry()
        for t in range(100, 104):
            busy = {wl: float(rng.integers(0, 900)) for wl in
                    rng.choice(["serving_interactive", "scrub", "ingest"],
                               int(rng.integers(0, 3)), replace=False)}
            smp = {"t": t, "node": url, "busy_ms": busy,
                   "qos": {"shed": {"queue_budget": int(rng.integers(0, 3))}},
                   "ingest": {"bytes": int(rng.integers(0, 5 << 20)),
                              "backpressure": int(rng.integers(0, 2))}}
            if rng.random() < 0.5:
                smp["exemplar"] = {"name": "GET /1,0a", "ms": 12.5 + i,
                                   "trace_id": f"{t:016x}", "span": "queue_wait"}
            tel.timeline_samples_json.append(json.dumps(smp))
        ct.observe(url, tel, now=104.0)
    health = ct.health(now=104.0)
    clock = [1000.0]
    tel_stub = type("T", (), {
        "stage_buckets": lambda self, s: list(bk),
        "read_shed_totals": lambda self: (reads[0], reads[1]),
        "breakers_open": lambda self: 0})()
    bk = [0.0] * 15
    reads = [0, 0]
    eng = port_slo.SloEngine(port_slo.SloConfig(
        read_p99_ms=2.5, error_rate_pct=1.0, time_to_healthy_seconds=30,
        fast_window_seconds=5, slow_window_seconds=15), tel_stub,
        clock=lambda: clock[0])
    for _ in range(6):
        clock[0] += 5
        bk[int(rng.integers(0, 15))] += float(rng.integers(1, 50))
        reads[0] += int(rng.integers(10, 100))
        reads[1] += int(rng.integers(0, 5))
        eng.evaluate()
    health["slo"] = eng.status()
    tails = {}
    for url in node_urls:
        routes = {}
        for route in ("GET /<fid>", "grpc /VolumeEcShardRead"):
            segs = {seg: float(rng.random()) for seg in (
                "queue_wait", "device_execute", "network_gap", "untraced")}
            routes[route] = {"count": int(rng.integers(1, 500)),
                             "total_s": sum(segs.values()),
                             "pinned": int(rng.integers(0, 4)),
                             "segments_s": segs}
        tails[url] = {"routes": routes, "pinned": [
            {"trace_id": f"{int(rng.integers(1 << 40)):016x}",
             "name": "GET /1,0a", "total_ms": float(rng.uniform(1, 90)),
             "reason": str(rng.choice(["p99", "floor", "incident:qos_shed"]))}
            for _ in range(int(rng.integers(0, 5)))]}
    dump = {"path": "/var/incidents/incident-1-manual.json",
            "nodes": ["<master>"] + node_urls,
            "correlation": {"trace_ids_multi_node": ["aa", "bb"],
                            "trace_ids_cross_server": ["aa"],
                            "nodes_with_data": 2},
            "profile": {"node": node_urls[0], "error": "HTTP 404"}
            if seed % 2 else None}
    return {"health": health, "timeline": ct.timeline(window_s=None),
            "tails": tails, "dump": dump}


@pytest.mark.parametrize("seed", [3, 8])
def test_cluster_shell_commands_byte_equal_the_reference(seed, monkeypatch):
    from seaweedfs_tpu.shell import command_cluster as ref_command_cluster

    # the reference's cluster.tail gathers its fan-out with asyncio but
    # its module never imports it (a NameError on every call); lend it
    # the module so the reference's output exists to compare against
    monkeypatch.setattr(ref_command_cluster, "asyncio", asyncio,
                        raising=False)

    async def go():
        docs: dict = {}

        async def handle(req):
            host = req.headers.get("Host", "")
            if req.path == "/cluster/health.json":
                return json_response(docs["health"])
            if req.path == "/debug/timeline":
                return json_response(docs["timeline"])
            if req.path == "/debug/tail":
                return json_response(docs["tails"].get(host, {
                    "routes": {}, "pinned": []}))
            if req.path == "/cluster/incident/dump":
                assert req.method == "POST"
                return json_response(docs["dump"])
            return Response(404)

        servers = [HTTPServer(handle) for _ in range(3)]
        for srv in servers:
            await srv.start()
        master, *nodes = [f"127.0.0.1:{srv.port}" for srv in servers]
        docs.update(_master_docs(seed, nodes))
        outputs = []
        try:
            for env_cls, run in ((PortEnv, port_run), (RefEnv, ref_run)):
                out = io.StringIO()
                env = env_cls([master], out=out)
                for line in ("cluster.slo", "cluster.slo -json",
                             "cluster.timeline", "cluster.timeline -json",
                             "cluster.timeline -window 5", "cluster.tail",
                             "cluster.tail -limit 3", "cluster.tail -json",
                             "cluster.incident.dump",
                             "cluster.incident.dump -window 30 -json"):
                    out.write(f"$ {line}\n")
                    await run(env, line)
                outputs.append(out.getvalue())
        finally:
            for srv in servers:
                await srv.stop()
        return outputs

    port, ref = asyncio.run(go())
    assert port == ref
    assert "BURN" in port or " ok" in port
    assert "tail view from 3/3 nodes" in port


# -------------------------------------------------------------------- e2e


SLO_KW = dict(read_p99_ms=1e-4, read_stage="shard_read",
              fast_window_seconds=1.0, slow_window_seconds=2.0)
INC_KW = dict(min_interval_seconds=3600.0, profile_seconds=0.2)


def _side_class():
    from test_torch_cluster import _Side

    class Side(_Side):
        """test_torch_cluster's `_Side` (two servers, no repair plane) with
        the incident plane on the master: a latency SLO on shard_read that
        every read burns, and bundles under `inc_dir`."""

        def __init__(self, kind, base, inc_dir):
            super().__init__(kind, base, 2)
            self.inc_dir = inc_dir

        async def start(self):
            from seaweedfs_tpu.server import cluster as ref_cluster_mod
            from seaweedfs_tpu.server.volume import VolumeServer as RefVS
            from seaweedfs_tpu_torch.server.cluster import LocalCluster

            if self.kind == "port":
                self.c = LocalCluster(
                    n_volume_servers=self.n, base_dir=self.base,
                    pulse_seconds=1, ec_backend="torch", master_kwargs={
                        "ec_repair": RepairConfig(enabled=False),
                        "obs_slo": obs.SloConfig(**SLO_KW),
                        "obs_incident": port_incident.IncidentConfig(
                            dir=self.inc_dir, **INC_KW)})
                await self.c.start()
                self.env = PortEnv([self.c.master.advertise_url],
                                   out=self.out)
                return
            c = ref_cluster_mod.LocalCluster(
                base_dir=self.base, n_volume_servers=self.n, pulse_seconds=1,
                master_kwargs={
                    "ec_repair": RefRepairConfig(enabled=False),
                    "obs_slo": RefSloConfig(**SLO_KW),
                    "obs_incident": ref_incident.IncidentConfig(
                        dir=self.inc_dir, **INC_KW)})
            await c.master.start()
            for spec in c._specs:
                vs = RefVS(masters=[c.master.advertise_url], port=0,
                           grpc_port=0, **spec)
                await vs.start()
                c.volume_servers.append(vs)
                await c.wait_for_nodes(len(c.volume_servers))
            self.c = c
            self.env = RefEnv([c.master.advertise_url], out=self.out)

    return Side


async def _get(hostport: str, path: str, headers=None):
    host, port = hostport.rsplit(":", 1)
    cl = Client(host, int(port))
    try:
        return await cl.request("GET", path, headers)
    finally:
        await cl.close()


# the port's volume server refreshes its EC shard map from the master
# outside the request's trace (server/volume.py `_cached_ec_locations`: a
# cache that serves many requests), the reference's inside it: the
# master's `grpc LookupEcVolume` entry of a cache refresh is left out
_CACHE_REFRESH = "grpc LookupEcVolume"


def _participants(doc: dict) -> list:
    return sorted((p["role"], re.sub(r"/\d+,\w+", "/<fid>", p["name"]))
                  for p in doc["participants"]
                  if p["name"] != _CACHE_REFRESH)


def _shape(node: dict) -> tuple:
    """A critical-path tree without times: (entry name, span names,
    children's shapes)."""
    return (re.sub(r"/\d+,\w+", "/<fid>", node["name"]),
            sorted({sp["name"] for sp in node["spans"]}),
            sorted(_shape(c) for c in node["children"]
                   if c["name"] != _CACHE_REFRESH))


async def _obs_case(side, blobs):
    from test_torch_cluster import VID

    await side.start()
    try:
        await side.allocate_and_fill(blobs)
        await side.sh("lock")
        await side.sh(f"ec.encode -volumeId {VID}")
        await side.sh("unlock")
        await side.settle()
        front = side.c.volume_servers[0]
        master = side.c.master
        murl = f"{master.ip}:{master.port}"
        # every read crosses to the other server for its remote shards;
        # the master assembles each from both nodes' rings
        crit = []
        for i, (fid, data, _) in enumerate(blobs):
            # the client names the trace (a bare id: no parent span)
            tid = f"{0xa7c0 + i:016x}"
            t0 = time.perf_counter()
            st, _, body = await _get(front.url, f"/{fid}",
                                     {"X-Seaweed-Trace-Id": tid})
            client_us = int((time.perf_counter() - t0) * 1e6)
            assert (st, body) == (200, data)
            st, _, body = await _get(
                murl, f"/debug/critpath?id={tid}&client_total_us={client_us}")
            assert st == 200, body
            doc = json.loads(body)
            assert doc["total_us"] == max(client_us, doc["server_total_us"])
            assert sum(doc["segments_us"].values()) == doc["total_us"]
            assert doc["route"] == "GET /<fid>"
            crit.append(doc)
        bogus = []
        for url in (murl, front.url):
            for path in ("/debug/critpath", "/debug/traces"):
                st, _, body = await _get(url, f"{path}?id=feedfacefeedface")
                bogus.append((st, "not found" in json.loads(body)["error"]))
        # reads until the read_p99 SLO has burned and its bundle landed
        burned = None
        t_end = time.monotonic() + 60
        while time.monotonic() < t_end:
            for fid, data, _ in blobs:
                st, _, body = await _get(front.url, f"/{fid}")
                assert (st, body) == (200, data)
            slo = master._health_doc()["slo"]["objectives"]["read_p99"]
            files = [f for f in os.listdir(side.inc_dir)
                     if f.endswith("-read_p99.json")] if os.path.isdir(
                         side.inc_dir) else []
            if slo["violations_total"] >= 1 and files:
                burned = slo
                break
            await asyncio.sleep(0.3)
        assert burned is not None, f"{side.kind}: no burn and bundle"
        # the rate limit: a second fire is suppressed, a forced dump not
        again = await master.incident.capture(burned["last_verdict"], 30.0)
        side.out.seek(0)
        side.out.truncate(0)
        await side.sh("cluster.incident.dump -window 60 -json")
        text = side.out.getvalue()
        dump = json.loads(text[text.index("{"):])
        names = sorted(re.sub(r"incident-\d+-", "incident-", f)
                       for f in os.listdir(side.inc_dir))
        urls = {vs.url for vs in side.c.volume_servers}
        return {"crit": crit, "bogus": bogus, "burned": burned,
                "bundle_path": os.path.join(side.inc_dir, files[0]),
                "again": again, "dump": dump, "names": names, "urls": urls}
    finally:
        await side.stop()


def test_incident_plane_and_critpath_match_the_reference(
        tmp_path, monkeypatch):
    from test_torch_cluster import _blobs

    monkeypatch.setenv("SWFS_DEBUG", "1")  # /debug/profile at server start
    Side = _side_class()
    blobs = _blobs()[:10]
    out = {}
    for kind in ("ref", "port"):
        side = Side(kind, str(tmp_path / kind / "data"),
                    str(tmp_path / kind / "incidents"))
        out[kind] = asyncio.run(_obs_case(side, blobs))
        with open(out[kind]["bundle_path"]) as f:
            out[kind]["bundle"] = json.load(f)
    port, ref = out["port"], out["ref"]
    # the critical paths: the same participants and tree per read
    for mine, theirs in zip(port["crit"], ref["crit"]):
        assert _participants(mine) == _participants(theirs)
        assert _shape(mine["tree"]) == _shape(theirs["tree"])
        assert set(mine) == set(theirs)
    crossed = [d for d in port["crit"] if any(
        p["name"] == "grpc VolumeEcShardRead" for p in d["participants"])]
    assert crossed and all(d["tree"]["children"] for d in crossed)
    assert port["bogus"] == ref["bogus"] == [(404, True)] * 4
    # the bundle: keys, node docs, correlation, the slo verdict
    pb, rb = port["bundle"], ref["bundle"]
    assert set(pb) == set(rb)
    assert (pb["trigger"], pb["reason"]["slo"]) == (
        rb["trigger"], rb["reason"]["slo"]) == ("slo", "read_p99")
    assert set(pb["reason"]) == set(rb["reason"])
    for b, side in ((pb, port), (rb, ref)):
        assert side["urls"] <= set(b["nodes"]) and "<master>" in b["nodes"]
        assert "slo_violation" in {
            e["kind"] for e in b["nodes"]["<master>"]["events"]}
        for u in side["urls"]:
            assert set(b["nodes"][u]) == {"events", "trace_count"}
        corr = b["correlation"]
        assert corr["trace_ids_multi_node"] and corr["trace_ids_cross_server"]
        assert "slo" in b["health"] and b["critpaths"]
        assert b["profile"] is not None and (
            b["profile"].get("trace_dir") or b["profile"].get("error"))
        assert b["timeline"]["nodes"] == sorted(side["urls"])
    assert set(pb["correlation"]) == set(rb["correlation"])
    assert set(pb["health"]) == set(rb["health"])
    assert set(pb["critpaths"][0]) == set(rb["critpaths"][0])
    assert set(port["burned"]) == set(ref["burned"])
    assert port["burned"]["last_verdict"].keys() == \
        ref["burned"]["last_verdict"].keys()
    # the rate limit and the forced dump
    assert port["again"] is None and ref["again"] is None
    assert port["names"] == ref["names"] == [
        "incident-manual.json", "incident-read_p99.json"]
    assert set(port["dump"]) == set(ref["dump"])
    assert port["dump"]["correlation"]["trace_ids_multi_node"]
    assert "profile" in pb and pb["profile"].get("trace_dir"), pb["profile"]
