"""The volume server's host-side admin plane, held against the JAX
package's: DeleteCollection, VolumeServerStatus, VolumeServerLeave,
ReadNeedleBlob, WriteNeedleBlob and the TTL sweep.

- One server of each package (no master) over the same volumes: every rpc
  answers the same (status codes by name, messages field by field, data
  directories masked), DeleteCollection removes that collection's normal
  volumes and leaves other collections and EC volumes, and WriteNeedleBlob
  refuses a missing volume (NOT_FOUND) and a read-only one
  (FAILED_PRECONDITION).
- A master and two servers of each package holding a volume placed `001`:
  a blob written on the first copy is read with ReadNeedleBlob and written
  to the second with WriteNeedleBlob (volume.check.disk's sync), and a GET
  of the second copy answers the same; after VolumeServerLeave the master
  drops the node's volumes and flags it stale, and the node still serves
  reads.
- The TTL sweep with the clock set past the TTL deletes the same vids on
  both: not a volume without a TTL, one inside the 10% grace, a tiered
  one, or one whose .dat changed between the first mtime read and the
  re-check after it was marked read-only.
"""
import asyncio
import json
import os
import time
from unittest import mock

import pytest

from seaweedfs_tpu.pb import Stub as RefStub
from seaweedfs_tpu.pb import channel as ref_channel
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vpb
from seaweedfs_tpu.repair import RepairConfig
from seaweedfs_tpu.server.master import MasterServer as RefMaster
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.pb import RpcError
from seaweedfs_tpu_torch.pb import Stub as PortStub
from seaweedfs_tpu_torch.pb import channel as port_channel
from seaweedfs_tpu_torch.pb import close_all_channels
from seaweedfs_tpu_torch.pb import volume_server_pb2 as port_vpb
from seaweedfs_tpu_torch.repair import RepairConfig as PortRepairConfig
from seaweedfs_tpu_torch.server.http import Client
from seaweedfs_tpu_torch.server.master import MasterServer as PortMaster
from seaweedfs_tpu_torch.server.volume import VolumeServer as PortVolumeServer

FROZEN = 1_760_000_000.0
BLOB = bytes(range(256)) * 40


def _server(kind, d, masters=(), **kw):
    if kind == "port":
        return PortVolumeServer(list(masters), [str(d)], port=0, grpc_port=0,
                                ec_backend="numpy", pulse_seconds=1, **kw)
    return RefVolumeServer(masters=list(masters), directories=[str(d)],
                           port=0, grpc_port=0, ec_backend="numpy",
                           pulse_seconds=1, **kw)


async def _rpc(kind, vs, method, **fields):
    """-> (status code name, response fields as a dict or None)."""
    stub_cls, chan, vpb = ((PortStub, port_channel, port_vpb)
                           if kind == "port"
                           else (RefStub, ref_channel, ref_vpb))
    stub = stub_cls(chan(vs.grpc_url), vpb, "VolumeServer")
    req = getattr(vpb, f"{method}Request")(**fields)
    try:
        resp = await getattr(stub, method)(req, timeout=10)
    except RpcError as e:
        return e.code().name, None
    except Exception as e:  # the reference's grpc.aio.AioRpcError
        if not hasattr(e, "code"):
            raise
        return e.code().name, None
    return "OK", {f.name: (list(v) if hasattr(v, "__iter__")
                           and not isinstance(v, (bytes, str)) else v)
                  for f, v in resp.ListFields()}


async def _get(vs, path):
    c = Client(vs.ip, vs.port)
    try:
        st, _, body = await c.request("GET", path)
    finally:
        await c.close()
    return st, body


def _fill(vs, vid, nids):
    """Write needles `nids` of BLOB slices to `vid`, the clock frozen (a
    needle stores its write time)."""
    from seaweedfs_tpu_torch.storage.needle import Needle as PortNeedle
    from seaweedfs_tpu.storage.needle import Needle as RefNeedle

    cls = PortNeedle if isinstance(vs, PortVolumeServer) else RefNeedle
    with mock.patch("time.time", return_value=FROZEN):
        for nid in nids:
            vs.store.write_needle(vid, cls(
                id=nid, cookie=0x1234, data=BLOB[: 100 * nid],
                last_modified=int(FROZEN)))


async def _admin_script(kind, base) -> list:
    vs = _server(kind, base)
    store = vs.store
    for vid, coll in ((1, "a"), (2, "b"), (3, "a"), (4, "a")):
        store.add_volume(vid, collection=coll)
        _fill(vs, vid, range(1, 6))
    # vid 4 of "a" is also an EC volume, mounted (its .dat stays)
    store.ec_generate(4)
    store.mount_ec_shards(4, list(range(14)), "a")
    await vs.start(**({} if kind == "port" else {"heartbeat": False}))
    seen = []

    def mask(fields):
        if fields and "data_dirs" in fields:
            fields["data_dirs"] = [os.path.relpath(d, base)
                                   for d in fields["data_dirs"]]
        return fields

    try:
        seen.append(("status", mask((await _rpc(
            kind, vs, "VolumeServerStatus"))[1])))
        for vid, nid in ((1, 3), (1, 99), (9, 1), (4, 2)):
            seen.append((f"read_{vid}_{nid}", *await _rpc(
                kind, vs, "ReadNeedleBlob", volume_id=vid, needle_id=nid)))
        for vid in (2, 9):
            seen.append((f"write_{vid}", *await _rpc(
                kind, vs, "WriteNeedleBlob", volume_id=vid, needle_id=77,
                needle_blob=b"blob of 77", cookie=0xabc,
                last_modified=int(FROZEN))))
        seen.append(("read_back", *await _rpc(
            kind, vs, "ReadNeedleBlob", volume_id=2, needle_id=77)))
        await _rpc(kind, vs, "VolumeMarkReadonly", volume_id=3)
        seen.append(("write_readonly", (await _rpc(
            kind, vs, "WriteNeedleBlob", volume_id=3, needle_id=78,
            needle_blob=b"x", cookie=1))[0]))
        seen.append(("delete_collection", *await _rpc(
            kind, vs, "DeleteCollection", collection="a")))
        seen.append(("volumes_left", sorted(
            v for loc in store.locations for v in loc.volumes)))
        seen.append(("ec_left", sorted(
            (v, ev.shard_bits().count()) for loc in store.locations
            for v, ev in loc.ec_volumes.items())))
        seen.append(("files_left", sorted(
            f for f in os.listdir(store.locations[0].directory)
            if f.split(".")[0] in ("a_1", "b_2", "a_3", "a_4")
            and not f.endswith((".note", ".vif")))))
        seen.append(("status_after", mask((await _rpc(
            kind, vs, "VolumeServerStatus"))[1])))
        seen.append(("delete_missing", *await _rpc(
            kind, vs, "DeleteCollection", collection="nope")))
        seen.append(("get_ec", *await _get(vs, "/4,0200001234")))
    finally:
        await vs.stop()
        if kind == "port":
            await close_all_channels()
    return seen


def test_admin_rpcs_match_the_reference(tmp_path):
    ref = asyncio.run(_admin_script("ref", str(tmp_path / "ref")))
    port = asyncio.run(_admin_script("port", str(tmp_path / "port")))
    got = dict((s[0], s[1:]) for s in ref)
    assert got["status"] == ({"data_dirs": ["."], "volume_count": 4,
                              "ec_shard_count": 14},)
    assert got["read_1_99"][0] == got["read_9_1"][0] == "NOT_FOUND"
    assert got["write_9"][0] == "NOT_FOUND"
    assert got["write_readonly"] == ("FAILED_PRECONDITION",)
    assert got["read_back"][1]["needle_blob"] == b"blob of 77"
    assert got["volumes_left"] == ([2],)
    assert got["ec_left"] == ([(4, 14)],)
    assert got["get_ec"] == (200, BLOB[:200])
    assert port == ref


async def _copy_and_leave(kind, base) -> list:
    """The 001 volume's second copy synced by blob, then the leave."""
    if kind == "port":
        master = PortMaster(port=0, pulse_seconds=1,
                            ec_repair=PortRepairConfig(enabled=False))
    else:
        master = RefMaster(port=0, pulse_seconds=1,
                           ec_repair=RepairConfig(enabled=False))
    await master.start()
    vss = []
    seen = []
    try:
        for i in (0, 1):
            vs = _server(kind, os.path.join(base, f"vs{i}"),
                         [master.advertise_url])
            vs.store.add_volume(7, replica_placement="001")
            await vs.start()
            vss.append(vs)
            for _ in range(500):
                if len(master.topo.data_nodes()) == len(vss):
                    break
                await asyncio.sleep(0.02)
        for _ in range(500):
            if len(master.topo.lookup_volume("", 7) or []) == 2:
                break
            await asyncio.sleep(0.02)
        else:
            raise AssertionError("the master never saw both copies")
        _fill(vss[0], 7, [5])
        code, blob = await _rpc(kind, vss[0], "ReadNeedleBlob", volume_id=7,
                                needle_id=5)
        seen.append(("read_first", code, blob))
        seen.append(("get_second_before", *await _get(vss[1], "/7,0500001234")))
        seen.append(("write_second", *await _rpc(
            kind, vss[1], "WriteNeedleBlob", volume_id=7, needle_id=5,
            needle_blob=blob["needle_blob"], cookie=blob["cookie"],
            last_modified=blob["last_modified"])))
        seen.append(("get_second", *await _get(vss[1], "/7,0500001234")))
        seen.append(("leave", *await _rpc(kind, vss[1], "VolumeServerLeave")))
        left = vss[1].url
        for _ in range(400):  # two pulses, then the node reads stale
            if left in master.telemetry.stale_node_urls():
                break
            await asyncio.sleep(0.05)
        else:
            raise AssertionError("the master never flagged the node stale")
        seen.append(("holders_after_leave", sorted(
            "vs0" if n.url == vss[0].url else "vs1"
            for n in master.topo.lookup_volume("", 7) or [])))
        seen.append(("get_after_leave", *await _get(vss[1], "/7,0500001234")))
        seen.append(("status_after_leave", (await _rpc(
            kind, vss[1], "VolumeServerStatus"))[0]))
    finally:
        for vs in vss:
            await vs.stop()
        await master.stop()
        if kind == "port":
            await close_all_channels()
    return seen


def test_needle_blob_sync_and_leave_match_the_reference(tmp_path):
    ref = asyncio.run(_copy_and_leave("ref", str(tmp_path / "ref")))
    port = asyncio.run(_copy_and_leave("port", str(tmp_path / "port")))
    got = dict((s[0], s[1:]) for s in ref)
    assert got["get_second_before"][0] == 404
    assert got["get_second"] == (200, BLOB[:500])
    assert got["holders_after_leave"] == (["vs0"],)
    assert got["get_after_leave"] == (200, BLOB[:500])
    assert port == ref


def _ttl_script(kind, base) -> dict:
    vs = _server(kind, base)
    store = vs.store
    now = time.time()
    for vid in (1, 3, 4, 5, 6):
        store.add_volume(vid, ttl="1m")
    store.add_volume(2)
    for vid in range(1, 7):
        _fill(vs, vid, [1])
    d = store.locations[0].directory
    # vid 6 is tiered: its .vif records a remote copy of the .dat
    with open(os.path.join(d, "6.vif"), "w") as f:
        json.dump({"files": [{"backendType": "local", "key": "k6",
                              "fileSize": "8"}]}, f)
    # both packages read a volume's tiering from its .vif at load (the
    # volume was loaded before this .vif was written)
    store.find_volume(6).remote_files = [{"key": "k6"}]

    def dat(vid):
        return store.find_volume(vid).dat_path

    for vid in (1, 2, 4, 6):
        os.utime(dat(vid), (now - 600, now - 600))
    os.utime(dat(5), (now - 63, now - 63))  # past 60 s, inside the grace
    # a write lands on vid 4 between the first mtime read and the re-check
    real_mark = store.mark_volume_readonly

    def racing_mark(vid, read_only=True):
        real_mark(vid, read_only)
        if vid == 4:
            os.utime(dat(4), (now - 1, now - 1))

    out = {}
    try:
        with mock.patch.object(store, "mark_volume_readonly", racing_mark):
            out["first"] = sorted(vs.sweep_expired_ttl_volumes())
        out["read_only"] = sorted(
            vid for vid in range(1, 7)
            if store.find_volume(vid) is not None
            and store.find_volume(vid).read_only)
        with mock.patch("time.time", return_value=now + 10):
            out["later"] = sorted(vs.sweep_expired_ttl_volumes())
        out["left"] = sorted(v for loc in store.locations
                             for v in loc.volumes)
        out["files_of_1"] = sorted(f for f in os.listdir(d)
                                   if f.startswith("1."))
    finally:
        store.close()
    return out


def test_ttl_sweep_matches_the_reference(tmp_path):
    ref = _ttl_script("ref", str(tmp_path / "ref"))
    port = _ttl_script("port", str(tmp_path / "port"))
    assert ref["first"] == [1]
    assert ref["read_only"] == [4]  # marked, then kept; 6 left alone
    assert ref["later"] == [5]  # 70 s past its write: past the grace
    assert ref["left"] == [2, 3, 4, 6]
    assert ref["files_of_1"] == []
    assert port == ref


def test_ttl_sweep_loop_starts_with_the_server(tmp_path):
    """The sweep runs every minute from start() until stop(), as the
    reference's; VolumeServerLeave ends it with the heartbeat."""

    async def go():
        vs = _server("port", tmp_path / "v")
        await vs.start()
        try:
            names = [t.get_coro().__name__ for t in vs._tasks]
            assert "_ttl_sweep_forever" in names
            code, _ = await _rpc("port", vs, "VolumeServerLeave")
            assert code == "OK" and vs._stopping
            await asyncio.sleep(0)
            assert all(t.cancelled() or t.done() for t in vs._tasks)
            assert (await _get(vs, "/status"))[0] == 200
        finally:
            await vs.stop()
            await close_all_channels()

    asyncio.run(go())
