"""The port's device-time ledger (obs/devledger.py) and its tags at every
device site the port has, held against the JAX package's ledger.

Contracts pinned here, as tests/test_devledger_timeline.py pins them for
the reference:
  1. the workload class rides a contextvar across asyncio.to_thread;
  2. conservation: the per-class busy sums equal DevicePipeline.
     total_busy_s (the resident reconstructs and the scrub run in a
     pipeline slot) plus the bulk Codec legs' busy_s, exactly;
  3. over a served read burst (interactive and bulk tiers), a bulk
     encode, a rebuild and a scrub, nothing is `untagged`;
  4. GET /debug/device/attribution has the reference's JSON shape.
"""
import asyncio
import functools
import json
import os
import shutil
import time

import numpy as np
import pytest

from seaweedfs_tpu import stats as jax_stats
from seaweedfs_tpu.obs import devledger as jax_devledger
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.obs import devledger
from seaweedfs_tpu_torch.ops import rs_resident
from seaweedfs_tpu_torch.server import volume as server_volume
from seaweedfs_tpu_torch.server.http import Client
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.ec.bulk import Codec
from seaweedfs_tpu_torch.storage.types import format_fid

from test_torch_store import EC_VID, build_dir, needles, write_volume

MIB = 1 << 20


@pytest.fixture(autouse=True)
def _fresh_ledgers():
    for led in (devledger.LEDGER, jax_devledger.LEDGER):
        led.reset_for_tests()
    yield
    for mod in (devledger, jax_devledger):
        mod.LEDGER.reset_for_tests()
        mod.LEDGER.enabled = True


def test_workload_tagging_and_to_thread_hop_equal_the_reference():
    for mod in (devledger, jax_devledger):
        assert mod.current_workload() == mod.UNTAGGED == "untagged"
        assert mod.current_device() == "default"
        with mod.workload("scrub"):
            assert mod.current_workload() == "scrub"
            with mod.device("mesh"):
                assert mod.current_device() == "mesh"
        with mod.workload("not-a-class"):
            assert mod.current_workload() == "untagged"

        async def go(mod=mod):
            with mod.workload("serving_bulk", device="3"):
                return await asyncio.to_thread(
                    lambda: (mod.current_workload(), mod.current_device()))

        assert asyncio.run(go()) == ("serving_bulk", "3")
    assert devledger.WORKLOADS == jax_devledger.WORKLOADS


def test_records_and_snapshot_equal_the_reference():
    """The same records give the same snapshot, totals and metric series in
    both packages; a disabled ledger records nothing."""
    ops = [dict(workload="ingest", busy_s=0.25, dispatches=2, nbytes=100),
           dict(workload="scrub", device="host", busy_s=0.5, dispatches=1),
           dict(busy_s=0.125, queue_wait_s=0.1),
           dict(workload="bogus", busy_s=0.0625, nbytes=7)]
    base = stats.VOLUME_SERVER_DEVICE_BUSY_SECONDS.labels(
        workload="ingest", device="default").value
    for mod in (devledger, jax_devledger):
        for kw in ops:
            mod.record(**kw)
    snap = devledger.LEDGER.snapshot()
    assert snap == jax_devledger.LEDGER.snapshot()
    assert set(snap) == {"ingest", "scrub", "untagged"}
    assert snap["untagged"]["busy_s"] == 0.1875
    assert devledger.LEDGER.total_busy_s() == jax_devledger.LEDGER.total_busy_s()
    assert devledger.LEDGER.busy_by_workload() == \
        jax_devledger.LEDGER.busy_by_workload()
    assert devledger.LEDGER.dispatches_by_workload() == \
        jax_devledger.LEDGER.dispatches_by_workload()
    got = stats.VOLUME_SERVER_DEVICE_BUSY_SECONDS.labels(
        workload="ingest", device="default").value
    assert got == base + 0.25
    assert jax_stats.REGISTRY.get_sample_value(
        "SeaweedFS_volumeServer_device_busy_seconds_total",
        {"workload": "ingest", "device": "default"}) >= 0.25
    devledger.configure(enabled=False)
    devledger.record(workload="scrub", busy_s=1.0, dispatches=1)
    assert devledger.LEDGER.snapshot() == snap


def test_pipeline_slot_conserves_into_the_ledger():
    pipe = rs_resident.DevicePipeline(slots=2)
    with devledger.workload("serving_interactive"):
        for _ in range(3):
            with pipe.slot():
                time.sleep(0.002)
    with devledger.workload("scrub"):
        with pipe.slot():
            time.sleep(0.001)
    busy = devledger.LEDGER.busy_by_workload()
    assert set(busy) == {"serving_interactive", "scrub"}
    assert sum(busy.values()) == pytest.approx(pipe.total_busy_s, rel=1e-12)
    assert devledger.LEDGER.snapshot()["scrub"]["queue_wait_s"] >= 0


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_bulk_codec_leg_conserves_into_the_ledger(backend):
    """The leg thread never sees the submitter's context: the class rides
    as a Codec attribute, and the CPU legs record on device "host"."""
    codec = Codec(np.eye(4, dtype=np.uint8), backend=backend,
                  threaded=True, workload="repair")
    shards = np.arange(4 * 64, dtype=np.uint8).reshape(4, 64)
    out = codec.resolve(codec.submit(shards))
    codec.shutdown()
    assert np.array_equal(out, shards)
    busy = devledger.LEDGER.busy_by_workload()
    assert set(busy) == {"repair"}
    assert busy["repair"] == codec.busy_s
    snap = devledger.LEDGER.snapshot()["repair"]
    assert set(snap["devices"]) == {"host"}
    assert (snap["dispatches"], snap["bytes"]) == (1, 2 * shards.nbytes)


def _served_dir(tmp_path):
    """build_dir's normal volume and degraded EC volume, plus a full EC
    volume (vid 3) for the scrub and a volume (vid 4) left to encode."""
    d = str(tmp_path / "d")
    build_dir(d)
    full = str(tmp_path / "full")
    build_dir(full, down=())
    for name in os.listdir(full):
        if name.startswith(f"{EC_VID}."):
            shutil.copy(os.path.join(full, name),
                        os.path.join(d, "3" + name[len(str(EC_VID)):]))
    return d


def test_untagged_stays_zero_and_sums_conserve(tmp_path, monkeypatch):
    """A volume server on the CPU cache serves a concurrent burst of
    degraded reads (interactive, and the bulk tier), then encodes a
    volume, rebuilds it and scrubs: every busy second lands in a class,
    and the class sums equal the pipeline's busy clock plus the codec
    legs' busy seconds."""
    monkeypatch.setattr(
        server_volume.rs_resident, "DeviceShardCache",
        functools.partial(rs_resident.DeviceShardCache, shard_quantum=MIB))
    d = _served_dir(tmp_path)
    devledger.LEDGER.reset_for_tests()  # the set-up's encodes
    coded = needles(5 + 1, 40, [100, 5000, 70000, 120000])
    bulk_stats: list[dict] = []

    async def go():
        vs = server_volume.VolumeServer([], [d], port=0, ec_backend="torch",
                                        ec_device_cache_mb=256)
        await vs.start()
        cache = vs.store.ec_device_cache
        try:
            t_end = time.monotonic() + 30
            while time.monotonic() < t_end and not (
                    cache.resident_count(EC_VID) == 12
                    and cache.resident_count(3) == 14):
                await asyncio.sleep(0.02)
            assert cache.resident_count(3) == 14

            async def client(i, tier):
                c = Client("127.0.0.1", vs.port)
                try:
                    for nid, cookie, data in coded[i::8]:
                        status, _, body = await c.request(
                            "GET", "/" + format_fid(EC_VID, nid, cookie),
                            {"X-Seaweed-QoS": tier})
                        assert (status, body) == (200, data)
                finally:
                    await c.close()

            # interactive readers, then bulk-tier readers alone (a batch
            # is bulk only when every member is)
            await asyncio.gather(*(client(i, "") for i in range(0, 8, 2)))
            await asyncio.gather(*(client(i, "bulk") for i in range(1, 8, 2)))
            r = await asyncio.to_thread(vs.store.scrub_all_resident)
            assert r[3]["parity_mismatch_bytes"] == [0, 0, 0, 0]
            r = await asyncio.to_thread(vs.store.scrub_ec_volume, 3)
            assert r["backend"] == "device_resident"
            base = write_volume(str(tmp_path), 4, needles(9, 5, [3000]))
            st: dict = {}
            await asyncio.to_thread(
                lambda: ec.write_ec_files(base, "torch", stats=st))
            bulk_stats.append(st)
            os.remove(base + ec.to_ext(3))
            st = {}
            await asyncio.to_thread(
                lambda: ec.rebuild_ec_files(base, "torch", stats=st))
            bulk_stats.append(st)
            st = {}
            await asyncio.to_thread(
                lambda: ec.verify_ec_files(base, "torch", stats=st))
            bulk_stats.append(st)
            c = Client("127.0.0.1", vs.port)
            try:
                _, _, body = await c.request("GET", "/debug/device/attribution")
            finally:
                await c.close()
            return cache.pipeline.total_busy_s, body
        finally:
            await vs.stop()

    pipe_busy, body = asyncio.run(go())
    doc = json.loads(body)
    busy = devledger.LEDGER.busy_by_workload()
    assert busy.get("untagged", 0.0) == 0.0
    assert "untagged" not in doc["workloads"]
    assert {"serving_interactive", "serving_bulk", "scrub", "bulk",
            "repair"} <= set(busy)
    codec_busy = sum(s["device_busy_s"] for s in bulk_stats)
    assert sum(busy.values()) == pytest.approx(pipe_busy + codec_busy,
                                               rel=1e-9)
    assert doc["total_busy_seconds"] == pytest.approx(sum(busy.values()))
    disp = devledger.LEDGER.dispatches_by_workload()
    assert disp["scrub"] >= 3  # two resident scrub calls + the verify legs


def test_attribution_document_has_the_reference_shape(tmp_path):
    """Both servers' GET /debug/device/attribution after the same records:
    the same keys at every level and the same values but the node."""
    from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer

    for mod in (devledger, jax_devledger):
        mod.record(workload="scrub", busy_s=0.5, dispatches=2, nbytes=160)
        mod.record(workload="serving_interactive", busy_s=0.25,
                   queue_wait_s=0.125, dispatches=1, nbytes=4096)
        mod.record(workload="bulk", device="host", busy_s=1.0, dispatches=1)

    async def go():
        (tmp_path / "p").mkdir()
        (tmp_path / "r").mkdir()
        port = server_volume.VolumeServer([], [str(tmp_path / "p")], port=0,
                                          ec_backend="numpy")
        ref = RefVolumeServer(masters=[], directories=[str(tmp_path / "r")],
                              port=0, grpc_port=0, ec_backend="numpy")
        await port.start()
        await ref.start(heartbeat=False)
        try:
            docs = []
            for vs in (port, ref):
                c = Client("127.0.0.1", vs.port)
                try:
                    status, h, body = await c.request(
                        "GET", "/debug/device/attribution")
                finally:
                    await c.close()
                assert status == 200
                assert h["Content-Type"].startswith("application/json")
                docs.append(json.loads(body))
            return docs
        finally:
            await port.stop()
            await ref.stop()

    mine, theirs = asyncio.run(go())
    assert set(mine) == set(theirs) == {"node", "enabled",
                                        "total_busy_seconds", "workloads"}
    mine.pop("node")
    theirs.pop("node")
    assert mine == theirs
    assert mine["workloads"]["bulk"]["devices"] == {
        "host": {"busy_s": 1.0, "dispatches": 1, "bytes": 0,
                 "queue_wait_s": 0.0}}
