"""The port's volume server over HTTP (server/http.py, server/volume.py,
command/volume.py) on the CPU.

The server runs on port 0 over a directory holding a normal volume and a
degraded EC volume (shards 0 and 11 removed) resident in a CPU
DeviceShardCache, and concurrent clients on standard-library asyncio
streams (and http.client) read every needle: each body must equal the
written bytes and the JAX package's Store's needle on the same files.
Status codes, headers, conditional reads, ranges, uploads and deletes
mirror tests/test_serving_e2e.py and tests/test_conditional_get.py.
"""
import asyncio
import functools
import http.client
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from seaweedfs_tpu.storage import disk_location as jax_dl
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu_torch import command, stats
from seaweedfs_tpu_torch.ops import rs_resident
from seaweedfs_tpu_torch.server import volume as server_volume
from seaweedfs_tpu_torch.server.conditional import format_http_date
from seaweedfs_tpu_torch.server.http import Client
from seaweedfs_tpu_torch.serving import ServingConfig
from seaweedfs_tpu_torch.storage import types as t

from test_torch_store import EC_VID, VID, build_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIB = 1 << 20


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    d = tmp_path_factory.mktemp("vs_src")
    plain, coded = build_dir(str(d))
    ref = jax_store.Store([jax_dl.DiskLocation(str(d))], ec_backend="numpy")
    want = {nid: bytes(ref.read_ec_needle(EC_VID, nid, cookie).data)
            for nid, cookie, _ in coded}
    ref.close()
    return str(d), plain, coded, want


@pytest.fixture
def data_dir(source, tmp_path):
    src, plain, coded, want = source
    shutil.copytree(src, tmp_path / "d")
    return str(tmp_path / "d"), plain, coded, want


@pytest.fixture(autouse=True)
def small_cache(monkeypatch):
    """The server's cache with 1 MiB padding quanta (the default 64 MiB
    pads 12 survivors to 800 MB of CPU memory)."""
    monkeypatch.setattr(
        server_volume.rs_resident, "DeviceShardCache",
        functools.partial(rs_resident.DeviceShardCache, shard_quantum=MIB),
    )


def fid(vid, nid, cookie):
    return "/" + t.format_fid(vid, nid, cookie)


async def started(d, **kw):
    vs = server_volume.VolumeServer(
        [], [d], port=0, ec_backend="torch", ec_device_cache_mb=256, **kw)
    await vs.start()
    c = Client("127.0.0.1", vs.port)
    t_end = time.monotonic() + 30
    while time.monotonic() < t_end:
        _, _, body = await c.request("GET", "/status")
        ecv = json.loads(body)["EcVolumes"]
        if ecv and ecv[0]["serving"] and len(ecv[0]["resident"]) == 12:
            break
        await asyncio.sleep(0.02)
    else:
        raise AssertionError("EC volume never became resident")
    await c.close()
    return vs


def _routes():
    return {r: stats.VOLUME_SERVER_EC_READ_ROUTE.labels(route=r).value
            for r in ("batched", "native")}


def test_concurrent_reads_byte_equal(data_dir):
    d, plain, coded, want = data_dir

    async def go():
        vs = await started(d)
        try:
            r0 = _routes()
            b0 = stats.VOLUME_SERVER_EC_BATCH_SIZE.count

            async def client(i):
                c = Client("127.0.0.1", vs.port)
                try:
                    for k in range(i, i + 24):
                        nid, cookie, data = coded[k % len(coded)]
                        status, h, body = await c.request(
                            "GET", fid(EC_VID, nid, cookie))
                        assert status == 200, (nid, status)
                        assert body == data == want[nid]
                        assert h["Content-Type"] == "application/x-test"
                    for nid, cookie, data in plain:
                        status, _, body = await c.request(
                            "GET", fid(VID, nid, cookie))
                        assert (status, body) == (200, data)
                finally:
                    await c.close()

            await asyncio.gather(*(client(i) for i in range(16)))
            routes = {k: v - r0[k] for k, v in _routes().items()}
            batches = stats.VOLUME_SERVER_EC_BATCH_SIZE.count - b0
            assert routes == {"batched": 16 * 24, "native": 0}
            assert 1 <= batches < 16 * 24
            c = Client("127.0.0.1", vs.port)
            _, _, body = await c.request("GET", "/metrics")
            text = body.decode()
            assert 'SeaweedFS_volumeServer_ec_read_route_total{route="batched"}' in text
            assert "SeaweedFS_volumeServer_ec_resident_shards 12.0" in text
            assert 'SeaweedFS_volumeServer_volumes{collection="",type="ec_shards"} 12.0' in text
            _, _, body = await c.request("GET", "/status")
            st = json.loads(body)
            assert [v["id"] for v in st["Volumes"]] == [VID]
            assert st["EcVolumes"][0]["shard_ids"] == [
                s for s in range(14) if s not in (0, 11)]
            await c.close()
        finally:
            await vs.stop()

    asyncio.run(go())


def test_status_codes_and_headers(data_dir):
    d, plain, coded, _ = data_dir
    nid, cookie, data = coded[0]

    async def go():
        vs = await started(d)
        c = Client("127.0.0.1", vs.port)
        try:
            url = fid(EC_VID, nid, cookie)
            status, h, body = await c.request("GET", url)
            assert status == 200 and body == data
            etag, lm = h["Etag"], h["Last-Modified"]
            assert lm == format_http_date(1_700_000_000)
            assert h["Accept-Ranges"] == "bytes"
            assert h["Content-Disposition"] == f'inline; filename="f{nid}"'
            for hdrs, code in (
                ({"If-None-Match": etag}, 304),
                ({"If-None-Match": f"W/{etag}"}, 304),
                ({"If-None-Match": '"deadbeef"'}, 200),
                ({"If-Modified-Since": lm}, 304),
                ({"If-Modified-Since": format_http_date(1_600_000_000)}, 200),
            ):
                status, h2, body = await c.request("GET", url, hdrs)
                assert status == code, hdrs
                if code == 304:
                    assert body == b"" and h2["Etag"] == etag
            status, h, body = await c.request("GET", url, {"Range": "bytes=10-99"})
            assert (status, body) == (206, data[10:100])
            assert h["Content-Range"] == f"bytes 10-99/{len(data)}"
            status, _, body = await c.request("GET", url, {"Range": "bytes=-7"})
            assert (status, body) == (206, data[-7:])
            status, h, _ = await c.request(
                "GET", url, {"Range": f"bytes={len(data)}-"})
            assert status == 416 and h["Content-Range"] == f"bytes */{len(data)}"
            status, h, body = await c.request("HEAD", url)
            assert status == 200 and body == b""
            assert int(h["Content-Length"]) == len(data)
            for path, code in (
                (fid(EC_VID, nid, cookie ^ 1), 403),
                (fid(EC_VID, 0xDEAD, 1), 404),
                (fid(77, 1, 1), 404),
                (fid(VID, plain[0][0], plain[0][1] ^ 1), 403),
                (fid(VID, 0xDEAD, 1), 404),
                ("/not-a-fid", 400),
            ):
                assert (await c.request("GET", path))[0] == code, path
            # a spent deadline budget answers 504 at admission
            status, _, _ = await c.request(
                "GET", url, {"X-Seaweed-Deadline-Ms": "0.000001"})
            assert status == 504
            assert (await c.request("PATCH", url))[0] == 405
        finally:
            await c.close()
            await vs.stop()

    asyncio.run(go())


def test_crc_mismatch_is_500(data_dir):
    d, plain, _, _ = data_dir
    nid, cookie, data = plain[2]
    dat = os.path.join(d, f"{VID}.dat")
    with open(dat, "rb") as f:
        raw = f.read()
    pos = raw.index(data[:64])
    with open(dat, "r+b") as f:  # flip one body byte
        f.seek(pos + 5)
        f.write(bytes([raw[pos + 5] ^ 0xFF]))

    async def go():
        vs = await started(d)
        c = Client("127.0.0.1", vs.port)
        try:
            status, _, body = await c.request("GET", fid(VID, nid, cookie))
            assert status == 500 and b"CRC" in body
        finally:
            await c.close()
            await vs.stop()

    asyncio.run(go())


def test_upload_read_delete_round_trip(data_dir):
    d, plain, coded, _ = data_dir

    async def go():
        vs = await started(d)
        c = Client("127.0.0.1", vs.port)
        try:
            url = fid(VID, 0x4242, 0x1234)
            status, _, body = await c.request(
                "POST", url, {"Content-Type": "text/plain"}, b"hello volume")
            size = json.loads(body)["size"]
            assert status == 200 and size > 12  # the needle's stored size
            status, h, body = await c.request("GET", url)
            assert (status, body) == (200, b"hello volume")
            assert h["Content-Type"] == "text/plain"
            boundary = "XyZ"
            form = (f"--{boundary}\r\nContent-Disposition: form-data; "
                    f'name="file"; filename="a.bin"\r\nContent-Type: '
                    f"image/png\r\n\r\n").encode() + b"\x89PNG..." + \
                f"\r\n--{boundary}--\r\n".encode()
            url2 = fid(VID, 0x4343, 0x99)
            status, _, body = await c.request(
                "POST", url2,
                {"Content-Type": f"multipart/form-data; boundary={boundary}"},
                form)
            assert status == 200 and json.loads(body)["name"] == "a.bin"
            status, h, body = await c.request("GET", url2)
            assert (status, body) == (200, b"\x89PNG...")
            assert h["Content-Type"] == "image/png"
            assert h["Content-Disposition"] == 'inline; filename="a.bin"'
            assert (await c.request("DELETE", fid(VID, 0x4242, 0x1)))[0] == 403
            status, _, body = await c.request("DELETE", url)
            assert status == 200 and json.loads(body)["size"] == size
            assert (await c.request("GET", url))[0] == 404
            assert (await c.request("POST", fid(77, 1, 1), body=b"x"))[0] == 404
            # an EC delete tombstones locally; the needle then reads 404
            nid, cookie, _ = coded[1]
            status, _, _ = await c.request("DELETE", fid(EC_VID, nid, cookie))
            assert status == 200
            assert (await c.request("GET", fid(EC_VID, nid, cookie)))[0] == 404
        finally:
            await c.close()
            await vs.stop()

    asyncio.run(go())


def test_standard_library_client_and_body_cap(data_dir):
    """http.client (in a thread) reads, and an upload past
    -fileSizeLimitMB is refused with 413 before its body is read."""
    d, plain, coded, _ = data_dir

    async def go():
        vs = await started(d, client_max_size_mb=1)

        def std_reads():
            conn = http.client.HTTPConnection("127.0.0.1", vs.port, timeout=30)
            try:
                for nid, cookie, data in coded[:6]:
                    conn.request("GET", fid(EC_VID, nid, cookie))
                    r = conn.getresponse()
                    assert (r.status, r.read()) == (200, data)
                conn.request("POST", fid(VID, 9, 9), body=b"x" * (2 * MIB),
                             headers={"Content-Type": "application/octet-stream"})
                return conn.getresponse().status
            finally:
                conn.close()

        try:
            assert await asyncio.to_thread(std_reads) == 413
        finally:
            await vs.stop()

    asyncio.run(go())


def test_http_server_edge_cases():
    """server/http.py alone: chunked bodies, malformed requests, the body
    cap before an `Expect: 100-continue` body is sent, and a stop with a
    keep-alive client still connected."""
    from seaweedfs_tpu_torch.server.http import HTTPServer, Response

    async def handler(req):
        return Response(200, b"got %d" % len(await req.read()))

    async def raw(port, data):
        r, w = await asyncio.open_connection("127.0.0.1", port)
        w.write(data)
        await w.drain()
        out = await asyncio.wait_for(r.read(), 10)
        w.close()
        return out.split(b"\r\n")[0], out.rsplit(b"\r\n\r\n", 1)[-1]

    async def go():
        s = HTTPServer(handler, port=0, client_max_size=100)
        await s.start()
        try:
            assert await raw(s.port, (
                b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n"
                b"Connection: close\r\n\r\n5\r\nhello\r\n3\r\nabc\r\n0\r\n\r\n"
            )) == (b"HTTP/1.1 200 OK", b"got 8")
            for data, status in (
                (b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
                 b"zz\r\n", b"400"),
                (b"POST / HTTP/1.1\r\nContent-Length: abc\r\n\r\n", b"400"),
                (b"GARBAGE\r\n\r\n", b"400"),
                (b"GET / HTTP/2.0\r\n\r\n", b"505"),
                (b"POST / HTTP/1.1\r\nContent-Length: 1000\r\n"
                 b"Expect: 100-continue\r\n\r\n", b"413"),
            ):
                assert (await raw(s.port, data))[0].split()[1] == status, data
            c = Client("127.0.0.1", s.port)
            assert (await c.request("GET", "/"))[2] == b"got 0"
        finally:
            await asyncio.wait_for(s.stop(), 10)  # the client is connected

    asyncio.run(go())


def test_pipeline_slots_follow_the_config(data_dir):
    d = data_dir[0]
    for overlap, slots in ((True, 2), (False, 1)):
        vs = server_volume.VolumeServer(
            [], [d], port=0, ec_backend="torch", ec_device_cache_mb=64,
            ec_serving=ServingConfig(overlap=overlap, layout="blockdiag"))
        try:
            cache = vs.store.ec_device_cache
            assert cache.pipeline.slots == slots == vs.ec_serving.pipeline_slots
            assert cache.layout == "blockdiag" and cache.device.type == "cpu"
        finally:
            vs.store.close()


def test_server_refuses_a_master_and_a_cache_on_numpy(tmp_path):
    """The master half: a server given -mserver registers with that master
    (its heartbeat carries its volumes and telemetry into the topology).
    The cache half: a device cache on the numpy backend is refused."""
    from seaweedfs_tpu_torch.server.master import MasterServer

    async def go():
        ms = MasterServer(port=0)
        await ms.start()
        vs = server_volume.VolumeServer(
            [ms.advertise_url], [str(tmp_path / "v")], port=0,
            ec_backend="torch", pulse_seconds=1)
        vs.store.add_volume(7)
        await vs.start()
        try:
            for _ in range(200):
                if ms.topo.lookup_volume("", 7):
                    break
                await asyncio.sleep(0.02)
            assert [n.url for n in ms.topo.lookup_volume("", 7)] == [vs.url]
            assert ms.topo.data_nodes()[0].grpc_port == vs.grpc_port
            # the telemetry plane holds the node's payload, clock-stamped
            # (wall_clock_unix_ms > 0 is what yields a skew estimate)
            node = ms.telemetry.health()["nodes"][vs.url]
            assert node["telemetry"] and "clock_skew_ms" in node
        finally:
            await vs.stop()
            await ms.stop()
            from seaweedfs_tpu_torch.pb import close_all_channels

            await close_all_channels()

    asyncio.run(go())
    with pytest.raises(ValueError, match="deviceCacheMB"):
        server_volume.VolumeServer([], [str(tmp_path)], ec_backend="numpy",
                                   ec_device_cache_mb=16)


# --------------------------------------------------------------------- CLI


def test_cli_flags_parse_with_the_reference_spellings(tmp_path):
    p = command.parser()
    args = p.parse_args(["volume", "-dir", str(tmp_path), "-port", "0"])
    assert args.ec_backend == "cuda" and args.masters == "127.0.0.1:9333"
    assert args.grpc_port == 0 and args.pulse_seconds == 5
    assert (args.ec_rpc_hedge_quantile, args.ec_rpc_hedge_budget_pct,
            args.ec_rpc_retry_budget_pct) == (0.95, 10.0, 10.0)
    cfg = command.volume.serving_config(args)
    assert cfg == ServingConfig()
    args = p.parse_args([
        "volume", "-dir", str(tmp_path), "-ip", "0.0.0.0", "-port", "9",
        "-max", "3", "-mserver", "", "-ec.backend", "torch",
        "-ec.deviceCacheMB", "64", "-ec.serving.disable",
        "-ec.serving.maxBatch", "32", "-ec.serving.maxWaitUs", "50",
        "-ec.serving.maxInflight", "2", "-ec.serving.maxQueue", "64",
        "-ec.serving.layout", "blockdiag", "-ec.serving.overlap.disable",
        "-ec.serving.zerocopy.disable", "-ec.qos.disable",
        "-ec.qos.interactiveQueue", "40", "-ec.qos.bulkQueue", "8",
        "-ec.qos.interactiveDeadlineMs", "100", "-ec.qos.bulkDeadlineMs", "0",
        "-ec.qos.tripAfter", "5", "-ec.qos.recoverSeconds", "0.5",
        "-ec.qos.stallBudgetSeconds", "3", "-ec.qos.stallMinRateKBps", "7",
        "-ec.rpc.deadlineMs", "1500", "-port.grpc", "19009",
        "-ec.rpc.hedgeQuantile", "0.9", "-ec.rpc.hedgeBudgetPct", "5",
        "-ec.rpc.retryBudgetPct", "0",
    ])
    assert args.grpc_port == 19009
    cfg = command.volume.serving_config(args)
    assert cfg == ServingConfig(
        enabled=False, max_batch=32, max_wait_us=50, max_inflight=2,
        max_queue=64, layout="blockdiag", overlap=False, zero_copy=False,
        qos=False, qos_interactive_queue=40, qos_bulk_queue=8,
        qos_interactive_deadline_ms=100, qos_bulk_deadline_ms=0,
        qos_trip_after=5, qos_recover_seconds=0.5, stall_budget_seconds=3.0,
        stall_min_rate_kbps=7)
    vs = command.volume.build_server(args)
    from seaweedfs_tpu_torch.utils import faultpolicy

    try:
        assert vs.store.ec_backend == "torch"
        assert vs.store.ec_device_cache.pipeline.slots == 1
        assert vs.store.locations[0].max_volume_count == 3
        assert vs.masters == [] and vs.grpc_port == 19009
        assert (faultpolicy.CONFIG.hedge_quantile,
                faultpolicy.CONFIG.hedge_budget_pct,
                faultpolicy.CONFIG.retry_budget_pct) == (0.9, 5.0, 0.0)
    finally:
        vs.store.close()
        faultpolicy.configure(faultpolicy.FaultPolicyConfig())
    with pytest.raises(SystemExit):
        p.parse_args(["volume", "-ec.backend", "auto"])
    # -ec.bulk.*, -readMode and -ec.serving.mesh.*: the reference's
    # spellings, parsed by both packages to the same values
    from seaweedfs_tpu.command import volume as ref_volume_cmd
    from seaweedfs_tpu_torch.storage.ec import bulk

    argv = ["-dir", str(tmp_path), "-mserver", "", "-ec.deviceCacheMB", "16",
            "-ec.bulk.overlap.disable", "-ec.bulk.prefetch", "2",
            "-ec.bulk.strideMB", "1", "-readMode", "redirect",
            "-ec.serving.mesh.disable", "-ec.serving.mesh.devices", "2",
            "-ec.serving.mesh.minShardMB", "16"]
    ref_p = __import__("argparse").ArgumentParser()
    ref_volume_cmd.add_args(ref_p)
    ref_args = ref_p.parse_args(argv)
    args = p.parse_args(["volume", "-ec.backend", "torch"] + argv)
    for dest in ("ec_bulk_overlap_disable", "ec_bulk_prefetch",
                 "ec_bulk_stride_mb", "read_mode", "ec_serving_mesh_disable",
                 "ec_serving_mesh_devices", "ec_serving_mesh_min_shard_mb",
                 "ec_mesh_coordinator", "ec_mesh_process_id",
                 "ec_mesh_process_count"):
        assert getattr(args, dest) == getattr(ref_args, dest), dest
    cfg = command.volume.serving_config(args)
    assert (cfg.mesh, cfg.mesh_devices, cfg.mesh_min_shard_mb) == (False, 2, 16)
    vs = command.volume.build_server(args)
    try:
        # the bulk legs of VolumeEcShardsGenerate / VolumeEcShardsRebuild
        # (storage/ec/encoder.py) read this process-global config
        assert bulk.DEFAULT == bulk.BulkConfig(overlap=False, prefetch=2,
                                               stride=1 << 20)
        assert vs.read_mode == "redirect"
        assert vs.store.ec_device_cache.mesh is None
    finally:
        vs.store.close()
        bulk.configure(bulk.BulkConfig())
        faultpolicy.configure(faultpolicy.FaultPolicyConfig())
    with pytest.raises(ValueError, match="divide"):
        command.volume.build_server(p.parse_args(
            ["volume", "-dir", str(tmp_path), "-ec.backend", "torch",
             "-ec.bulk.strideMB", "3"]))
    bulk.configure(bulk.BulkConfig())
    # -ec.mesh.*: the pod rendezvous fields, validated at parse time
    pod = ["-ec.mesh.coordinator", "10.0.0.1:8476", "-ec.mesh.processId", "1",
           "-ec.mesh.processCount", "2"]
    ref_args = ref_p.parse_args(["-dir", str(tmp_path)] + pod)
    args = p.parse_args(["volume", "-dir", str(tmp_path)] + pod)
    cfg = command.volume.serving_config(args)
    assert (cfg.mesh_coordinator, cfg.mesh_process_id,
            cfg.mesh_process_count, cfg.multiprocess) == (
        ref_args.ec_mesh_coordinator, ref_args.ec_mesh_process_id,
        ref_args.ec_mesh_process_count, True)
    for bad in (["-ec.mesh.processCount", "2"],
                ["-ec.mesh.processId", "1"],
                ["-ec.mesh.coordinator", "h:1", "-ec.mesh.processCount", "2",
                 "-ec.mesh.processId", "2"]):
        with pytest.raises(ValueError):
            command.volume.serving_config(
                p.parse_args(["volume", "-dir", str(tmp_path)] + bad))
    vs = command.volume.build_server(
        p.parse_args(["volume", "-dir", str(tmp_path), "-mserver", "m:1",
                      "-ec.backend", "torch", "-metrics.address", "gw:9091",
                      "-metrics.intervalSeconds", "7"]))
    try:
        assert vs.masters == ["m:1"]
        assert (vs.metrics_address, vs.metrics_interval_seconds) == (
            "gw:9091", 7)
    finally:
        vs.store.close()
        faultpolicy.configure(faultpolicy.FaultPolicyConfig())
    _master_flags_parse_with_the_reference_spellings(p, tmp_path)


MASTER_ARGV = [
    "-obs.slo.readP99Ms", "12.5", "-obs.slo.readStage", "queue_wait",
    "-obs.slo.errorRatePct", "2", "-obs.slo.timeToHealthySeconds", "45",
    "-obs.slo.breakerOpenPct", "5", "-obs.slo.fastWindowSeconds", "3",
    "-obs.slo.slowWindowSeconds", "9", "-obs.slo.burnThreshold", "1.5",
    "-obs.incident.dir", "/var/incidents", "-obs.incident.keep", "4",
    "-obs.incident.minIntervalSeconds", "30",
    "-obs.incident.profileSeconds", "2", "-metrics.address", "gw:9091",
    "-metrics.intervalSeconds", "3", "-obs.traceRing", "64",
]


def _master_flags_parse_with_the_reference_spellings(p, tmp_path):
    """The master's -obs.slo.*, -obs.incident.*, -metrics.* and -obs.*
    flags parse to the reference's values and build the same SloConfig
    and IncidentConfig; -cpuprofile and -memprofile go before the
    command, as the reference's."""
    import argparse
    import dataclasses

    from seaweedfs_tpu.command import master as ref_master_cmd
    from seaweedfs_tpu.obs import incident as ref_incident
    from seaweedfs_tpu.obs import trace as ref_trace
    from seaweedfs_tpu_torch.obs import incident as port_incident
    from seaweedfs_tpu_torch.obs import trace as port_trace

    ref_p = argparse.ArgumentParser()
    ref_master_cmd.add_args(ref_p)
    for argv in ([], MASTER_ARGV, ["-obs.slo.disable"]):
        ref = ref_p.parse_args(argv)
        port = p.parse_args(["master"] + argv)
        for dest in vars(ref):
            if dest.startswith(("obs_", "metrics_")):
                assert getattr(port, dest) == getattr(ref, dest), dest
        saved = (port_trace.CONFIG, port_incident.CONFIG,
                 ref_trace.CONFIG, ref_incident.CONFIG)
        try:
            ms = command.master.build_server(port)
            from seaweedfs_tpu.command import common_args as ref_common

            want = ref_common.slo_incident_kwargs(ref)
            assert dataclasses.asdict(ms.slo.cfg) == dataclasses.asdict(
                want["obs_slo"].validated())
            assert dataclasses.asdict(port_incident.CONFIG) == \
                dataclasses.asdict(want["obs_incident"])
            assert (ms.metrics_address, ms.metrics_interval_seconds) == (
                ref.metrics_address, ref.metrics_interval_seconds)
            assert port_trace.CONFIG.trace_ring == ref.obs_trace_ring
        finally:
            port_trace.configure(saved[0])
            port_incident.configure(saved[1])
            ref_trace.configure(saved[2])
            ref_incident.configure(saved[3])
    args = p.parse_args(["-cpuprofile", str(tmp_path / "cpu.prof"),
                         "-memprofile", str(tmp_path / "mem.txt"), "master"])
    assert (args.cpuprofile, args.memprofile, args.command) == (
        str(tmp_path / "cpu.prof"), str(tmp_path / "mem.txt"), "master")
    assert p.parse_args(["master"]).cpuprofile == ""
    with pytest.raises(ValueError):
        command.master.build_server(p.parse_args(
            ["master", "-obs.slo.readP99Ms", "5", "-obs.slo.readStage",
             "batch_dispach"]))


def test_cli_cuda_without_a_card_fails_at_start(tmp_path):
    """`python -m seaweedfs_tpu_torch volume` with the default
    -ec.backend cuda exits non-zero at start where there is no card,
    before it serves anything."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
         "-dir", str(tmp_path), "-port", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA device" in proc.stderr
    assert "volume server up" not in proc.stderr


# --- behaviour held to the reference server ---------------------------------


async def _both_servers(tmp_path):
    """The port's and the JAX package's volume servers in process, each over
    its own directory with volume 3 placed 001 (two copies), no master."""
    from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer

    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    port = server_volume.VolumeServer([], [str(port_dir)], port=0,
                                      ec_backend="numpy")
    ref = RefVolumeServer(masters=[], directories=[str(ref_dir)], port=0,
                          grpc_port=0, ec_backend="numpy")
    for vs in (port, ref):
        vs.store.add_volume(3, replica_placement="001")
    await port.start()
    await ref.start(heartbeat=False)
    return port, ref


async def _ask(vs, method, path, headers=None, body=b""):
    c = Client("127.0.0.1", vs.port)  # one connection a request: a 500 may close it
    try:
        return await c.request(method, path, headers, body)
    finally:
        await c.close()


def test_refused_replicated_write_matches_reference(tmp_path):
    """A plain write to a volume placed 001 finds no replica without a
    master: both servers append, answer 500, and tombstone the needle again
    only when the write created it — an overwrite keeps the new bytes."""
    path = "/3,01637037d6"

    async def go():
        port, ref = await _both_servers(tmp_path)
        try:
            for vs in (port, ref):
                status, _, _ = await _ask(vs, "POST", path + "?type=replicate",
                                          body=b"first")
                assert status == 200
            got = [await _ask(vs, "POST", path, body=b"second")
                   for vs in (port, ref)]
            assert [g[0] for g in got] == [500, 500]
            assert all(b"replication failed" in g[2] for g in got)
            after = [await _ask(vs, "GET", path) for vs in (port, ref)]
            assert [(a[0], a[2]) for a in after] == [(200, b"second")] * 2
            # a create that fails its fan-out leaves the needle absent
            fresh = "/3,02637037d6"
            got = [(await _ask(vs, "POST", fresh, body=b"new"))[0]
                   for vs in (port, ref)]
            assert got == [500, 500]
            got = [(await _ask(vs, "GET", fresh))[0] for vs in (port, ref)]
            assert got == [404, 404]
        finally:
            await port.stop()
            await ref.stop()

    asyncio.run(go())


@pytest.mark.parametrize("rng", ["bytes=3-2", "bytes=0-1,3-4", "bytes=x"])
def test_malformed_range_matches_reference(tmp_path, rng):
    """A malformed Range header is a 500 from both servers: the reference's
    range parse raises outside any handler try, and the port follows it
    (a 4xx waits for a change to the reference)."""
    path = "/3,01637037d6"

    async def go():
        port, ref = await _both_servers(tmp_path)
        try:
            got = []
            for vs in (port, ref):
                await _ask(vs, "POST", path + "?type=replicate", body=b"0123456789")
                ok = await _ask(vs, "GET", path, {"Range": "bytes=2-4"})
                assert (ok[0], ok[2]) == (206, b"234")
                got.append((await _ask(vs, "GET", path, {"Range": rng}))[0])
            assert got == [500, 500]
        finally:
            await port.stop()
            await ref.stop()

    asyncio.run(go())


async def _both_traced(tmp_path):
    """The port's server on -ec.backend torch and the reference's on
    numpy, each over its own directory with volume 4 (one copy)."""
    from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer

    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    port = server_volume.VolumeServer([], [str(port_dir)], port=0,
                                      ec_backend="torch")
    ref = RefVolumeServer(masters=[], directories=[str(ref_dir)], port=0,
                          grpc_port=0, ec_backend="numpy")
    for vs in (port, ref):
        vs.store.add_volume(4)
    await port.start()
    await ref.start(heartbeat=False)
    return port, ref


def _keys(doc, depth=2):
    """The nested key set of a JSON document, `depth` dict levels deep (a
    list stands for its first element)."""
    if depth == 0:
        return None
    if isinstance(doc, list):
        return [_keys(doc[0], depth)] if doc else []
    if not isinstance(doc, dict):
        return None
    return {k: _keys(v, depth - 1) for k, v in doc.items()}


def test_traced_get_and_debug_documents_match_reference(tmp_path):
    """A GET through either server carries the trace header in the
    reference's format, and the debug documents have the reference's
    keys; a malformed Range still answers 500 from both."""
    import re

    from seaweedfs_tpu.obs import incident as ref_incident
    from seaweedfs_tpu_torch.obs import incident as port_incident

    path = "/4,01637037d6"

    async def go():
        port, ref = await _both_traced(tmp_path)
        try:
            docs = []
            for vs in (port, ref):
                await _ask(vs, "POST", path, body=b"0123456789")
                status, h, body = await _ask(vs, "GET", path)
                assert (status, body) == (200, b"0123456789")
                hdr = h["X-Seaweed-Trace-Id"]
                assert re.fullmatch(r"[0-9a-f]{16}-[0-9a-f]{8}", hdr), hdr
                tid = hdr.split("-")[0]
                # an inbound header is adopted, not replaced
                status, h, _ = await _ask(
                    vs, "GET", path, {"X-Seaweed-Trace-Id": "abcd-ef01"})
                assert h["X-Seaweed-Trace-Id"].startswith("abcd-")
                assert (await _ask(vs, "GET", path,
                                   {"Range": "bytes=3-2"}))[0] == 500
                # telemetry paths are not traced
                _, h, _ = await _ask(vs, "GET", "/status")
                assert "X-Seaweed-Trace-Id" not in h
                vs.timeline.sample()
                # one decision event in each recorder, so both rings hold
                # an event to compare
                rec = (port_incident if vs is port else ref_incident).record
                rec("stall_abort", bytes=10, budget_s=1.0)
                doc = {}
                for name, url in (
                    ("traces", f"/debug/traces?id={tid}"),
                    ("tail", "/debug/tail"),
                    ("incident", "/debug/incident"),
                    ("timeline", "/debug/timeline"),
                    ("hot", "/debug/device/hot"),
                ):
                    status, _, body = await _ask(vs, "GET", url)
                    assert status == 200, (name, status)
                    doc[name] = json.loads(body)
                assert doc["traces"]["traces"][0]["name"] == f"GET {path}"
                assert doc["traces"]["traces"][0]["status"] == "200"
                status, _, body = await _ask(vs, "GET",
                                             f"/debug/critpath?id={tid}")
                assert status == 200
                crit = json.loads(body)
                assert sum(crit["segments_us"].values()) == pytest.approx(
                    crit["total_us"], abs=6)
                doc["critpath"] = crit
                docs.append(doc)
            port_doc, ref_doc = docs
            for doc in docs:  # per-workload maps: keys are data, not schema
                for smp in doc["timeline"]["samples"]:
                    smp["busy_ms"] = smp["disp"] = {}
            for name in ("traces", "incident", "timeline", "critpath"):
                assert _keys(port_doc[name], 3) == _keys(ref_doc[name], 3), \
                    name
            assert _keys(port_doc["tail"], 1) == _keys(ref_doc["tail"], 1)
            assert _keys(port_doc["tail"]["routes"]["GET /<fid>"]) == \
                _keys(ref_doc["tail"]["routes"]["GET /<fid>"])
            assert _keys(port_doc["hot"], 1) == _keys(ref_doc["hot"], 1)
            # /debug/profile is SWFS_DEBUG-gated in both: without it the
            # path is no route (the port: 404; the reference parses it as a
            # fid: 400)
            assert (await _ask(port, "GET", "/debug/profile"))[0] == 404
            assert (await _ask(ref, "GET", "/debug/profile"))[0] == 400
        finally:
            await port.stop()
            await ref.stop()

    asyncio.run(go())


OBS_ARGV = [
    "-obs.slowMs", "12.5", "-obs.traceRing", "32", "-obs.incident.events",
    "99", "-obs.timeline.intervalSeconds", "0.25", "-obs.timeline.window",
    "7", "-obs.tail.ring", "5", "-obs.tail.alpha", "0.5",
    "-obs.tail.floorMs", "3",
]


@pytest.mark.parametrize("switches", [
    [], ["-obs.disable"], ["-obs.incident.disable", "-obs.ledger.disable"],
    ["-obs.timeline.disable", "-obs.tail.disable"],
])
def test_obs_flags_configure_like_the_reference(tmp_path, switches):
    """The -obs.* flags parse to the same ObsConfig and IncidentConfig in
    both packages (spellings, defaults, and the mapping apply_obs_args
    makes), and configure the port's process-global planes."""
    import argparse
    import dataclasses

    from seaweedfs_tpu.command import common_args as ref_args
    from seaweedfs_tpu.obs import incident as ref_incident
    from seaweedfs_tpu.obs import trace as ref_trace
    from seaweedfs_tpu_torch.obs import devledger
    from seaweedfs_tpu_torch.obs import incident as port_incident
    from seaweedfs_tpu_torch.obs import trace as port_trace

    ref_parser = argparse.ArgumentParser()
    ref_args.add_obs_args(ref_parser)
    for argv in ([], OBS_ARGV + switches):
        port = command.parser().parse_args(
            ["volume", "-dir", str(tmp_path)] + argv)
        ref = ref_parser.parse_args(argv)
        saved = (ref_trace.CONFIG, ref_incident.CONFIG)
        try:
            command.volume.apply_obs_args(port)
            ref_args.apply_obs_args(ref)
            assert dataclasses.asdict(port_trace.CONFIG) == \
                dataclasses.asdict(ref_trace.CONFIG)
            assert dataclasses.asdict(port_incident.CONFIG) == \
                dataclasses.asdict(ref_incident.CONFIG)
            assert port_trace.RING._dq.maxlen == port_trace.CONFIG.trace_ring
            assert devledger.LEDGER.enabled == (
                "-obs.ledger.disable" not in argv)
        finally:
            ref_trace.configure(saved[0])
            ref_incident.configure(saved[1])
            from seaweedfs_tpu_torch.obs import ObsConfig

            port_trace.configure(ObsConfig())
            port_incident.configure(port_incident.IncidentConfig())
            devledger.configure(enabled=True)


def test_timeline_loop_and_tail_follow_the_flags(tmp_path):
    """With a short -obs.timeline.intervalSeconds the server's loop fills
    /debug/timeline; with -obs.timeline.disable and -obs.tail.disable
    the timeline stays empty and /debug/tail answers 404."""
    from seaweedfs_tpu_torch.obs import ObsConfig
    from seaweedfs_tpu_torch.obs import trace as port_trace

    async def serve(cfg):
        port_trace.configure(cfg)
        vs = server_volume.VolumeServer([], [str(tmp_path)], port=0,
                                        ec_backend="torch")
        await vs.start()
        try:
            await asyncio.sleep(0.5)
            _, _, body = await _ask(vs, "GET", "/debug/timeline")
            status, _, _ = await _ask(vs, "GET", "/debug/tail")
            return json.loads(body)["samples"], status
        finally:
            await vs.stop()
            port_trace.configure(ObsConfig())

    samples, tail = asyncio.run(serve(ObsConfig(
        timeline_interval_seconds=0.05)))
    assert len(samples) >= 3 and tail == 200
    assert samples[-1]["t"] >= samples[0]["t"]
    samples, tail = asyncio.run(serve(ObsConfig(
        timeline_interval_seconds=0.05, timeline_enabled=False,
        tail_enabled=False)))
    assert samples == [] and tail == 404


def test_rpc_port_falls_back_when_the_derived_one_is_taken(tmp_path):
    """Without -port.grpc the RPC listener takes port + 10000, the
    reference's convention; when that port is taken (or past 65535) it
    takes a free one instead (the heartbeat tells the master which), while
    an explicit -port.grpc that is taken fails the start."""
    import socket

    from seaweedfs_tpu_torch.pb import (
        RpcError, StatusCode, Stub, channel, close_all_channels,
        volume_server_pb2)

    held = []
    while True:  # a free port whose + 10000 we can hold
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        held.append(s)
        if port + 10000 > 65535:
            continue
        blocker = socket.socket()
        try:
            blocker.bind(("127.0.0.1", port + 10000))
        except OSError:
            blocker.close()
            continue
        blocker.listen()
        held.append(blocker)
        s.close()  # the server binds `port` itself
        break

    async def go():
        vs = server_volume.VolumeServer(
            [], [str(tmp_path / "a")], port=port, ec_backend="torch")
        await vs.start()
        try:
            assert vs.grpc_port not in (0, port + 10000)
            stub = Stub(channel(vs.grpc_url), volume_server_pb2,
                        "VolumeServer")
            with pytest.raises(RpcError) as ei:
                await stub.VolumeStatus(
                    volume_server_pb2.VolumeStatusRequest(volume_id=9),
                    timeout=10)
            assert ei.value.code() == StatusCode.NOT_FOUND
        finally:
            await vs.stop()
            await close_all_channels()
        explicit = server_volume.VolumeServer(
            [], [str(tmp_path / "b")], port=0, grpc_port=port + 10000,
            ec_backend="torch")
        try:
            with pytest.raises(OSError):
                await explicit.start()
        finally:
            await explicit.stop()

    try:
        asyncio.run(go())
    finally:
        for s in held:
            s.close()
