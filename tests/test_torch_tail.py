"""The port's crash recovery and volume tail held against the JAX
package's, on the CPU.

The .note marker and the torn-tail heal at load (reference
volume_write.go:85, volume_checking.go), the tail cursor
(Volume.find_offset_since / scan_records, volume_backup.go) and the
replica catch-up over VolumeTailSender / VolumeTailReceiver
(volume_grpc_tail.go, operation/tail_volume.py).  Needles carry pinned
write times and append stamps, so both packages' files, cursors and
needles are compared with no tolerance.
"""
import asyncio
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from seaweedfs_tpu.pb import Stub as RefStub
from seaweedfs_tpu.pb import channel as ref_channel
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vpb
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu.storage import needle as jax_needle
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu_torch.pb import Stub as PortStub
from seaweedfs_tpu_torch.pb import channel as port_channel
from seaweedfs_tpu_torch.pb import volume_server_pb2 as port_vpb
from seaweedfs_tpu_torch.server import volume as server_volume
from seaweedfs_tpu_torch.storage import needle as port_needle
from seaweedfs_tpu_torch.storage import volume as port_volume

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1919
FROZEN_S = 1_760_000_000
PKGS = {"jax": (jax_volume, jax_needle), "torch": (port_volume, port_needle)}


class _LaterClock:
    """`time` stopped one second past FROZEN_S: a tombstone stamped by
    Volume.delete comes after every pinned append, the same in both
    packages."""

    def __getattr__(self, name):
        import time

        return getattr(time, name)

    @staticmethod
    def time():
        return float(FROZEN_S + 1)

    @staticmethod
    def time_ns():
        return (FROZEN_S + 1) * 10**9


@pytest.fixture
def later_clock(monkeypatch):
    for mod in (port_needle, jax_needle):
        monkeypatch.setattr(mod, "time", _LaterClock())


def _bodies(seed: int, n: int, lo: int = 200, hi: int = 2000) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(lo, hi)),
                         np.uint8).tobytes() for _ in range(n)]


def _append(pkg: str, v, nid: int, body: bytes, k: int, cookie: int = 0x5A):
    Needle = PKGS[pkg][1].Needle
    v.append_needle(Needle(id=nid, cookie=cookie, data=body,
                           last_modified=FROZEN_S,
                           append_at_ns=FROZEN_S * 10**9 + 1000 * k))


def _files(v) -> tuple:
    with open(v.dat_path, "rb") as d, open(v.idx_path, "rb") as x:
        return d.read(), x.read()


def test_note_marker_lifecycle(tmp_path):
    """An open volume is marked dirty; a clean close removes the marker;
    a reload reads the needle back.  The same in both packages."""
    seen = {}
    for pkg, (vol, _) in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        v = vol.Volume(str(d), 1)
        marked = os.path.exists(v.note_path)
        _append(pkg, v, 1, b"hello", 0)
        v.close()
        cleared = not os.path.exists(v.note_path)
        v2 = vol.Volume(str(d), 1)
        seen[pkg] = (marked, cleared, bytes(v2.read(1).data), _files(v2))
        v2.close()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][:3] == (True, True, b"hello")


def test_kill_mid_write_recovers_like_the_reference(tmp_path):
    """A process appending through the port's Volume is killed mid-write.
    Two copies of what it left: the port and the reference each reload
    one, keep every acked needle, heal the torn tail to the same .dat and
    .idx, and take a new write on a clean record boundary."""
    d = tmp_path / "w"
    d.mkdir()
    script = f"""
import os, sys
sys.path.insert(0, {REPO!r})
from seaweedfs_tpu_torch.storage.volume import Volume
v = Volume({str(d)!r}, 7)
i = 1
while True:
    v.write(i, 0xAB, os.urandom(2048))
    if i == 50:
        print("ready", flush=True)
    i += 1
"""
    p = subprocess.Popen([sys.executable, "-c", script],
                         stdout=subprocess.PIPE)
    try:
        assert b"ready" in p.stdout.readline()
    finally:
        p.kill()
        p.wait()
    assert os.path.exists(d / "7.note"), "a killed writer leaves its marker"
    seen = {}
    for pkg, (vol, _) in PKGS.items():
        copy = tmp_path / pkg
        shutil.copytree(d, copy)
        v = vol.Volume(str(copy), 7)
        acked = [bytes(v.read(i, 0xAB).data) for i in range(1, 51)]
        assert all(len(b) == 2048 for b in acked)
        healed = _files(v)
        _append(pkg, v, 100_000, b"after recovery", 0, cookie=0xCD)
        assert bytes(v.read(100_000).data) == b"after recovery"
        v.close()
        seen[pkg] = (acked, healed, len(v.nm), _files(v)[1][-16:],
                     os.path.exists(v.note_path))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][-1] is False


def test_find_offset_since_matches_the_reference(tmp_path, later_clock):
    """Ten stamped needles, then a delete: for every cursor (0, each live
    needle's stamp, the tombstone's) both packages return the same .dat
    offset, and the records newer than it are the same."""
    bodies = _bodies(SEED, 10)
    seen = {}
    for pkg, (vol, _) in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        v = vol.Volume(str(d), 2)
        for k, body in enumerate(bodies):
            _append(pkg, v, k + 1, body, k)
        v.delete(4)
        stamps = [v.read(i).append_at_ns for i in range(1, 11) if i != 4]
        assert stamps == sorted(stamps)
        cursors = {}
        for since in [0, *stamps, (FROZEN_S + 1) * 10**9]:
            off = v.find_offset_since(since)
            newer = [(o, n.id, bytes(n.data), n.append_at_ns)
                     for o, _, _, n in v.scan_records(off)
                     if since == 0 or n.append_at_ns > since]
            cursors[since] = (off, newer)
        seen[pkg] = cursors
        v.close()
    assert seen["torch"] == seen["jax"]
    cursors = seen["torch"]
    assert len(cursors[0][1]) == 11  # ten needles and the tombstone
    # past the fifth stamp: needles 6-10, then needle 4's later tombstone
    assert [r[1] for r in cursors[FROZEN_S * 10**9 + 4000][1]] == [
        6, 7, 8, 9, 10, 4]
    assert list(cursors.values())[-1][1] == []


def _server(kind: str, d):
    if kind == "port":
        return server_volume.VolumeServer([], [str(d)], port=0,
                                          ec_backend="torch")
    return RefVolumeServer(masters=[], directories=[str(d)], port=0,
                           grpc_port=0, ec_backend="numpy")


def _stub(kind: str, vs):
    stub_cls, chan, vpb = ((PortStub, port_channel, port_vpb)
                           if kind == "port"
                           else (RefStub, ref_channel, ref_vpb))
    return stub_cls(chan(vs.grpc_url), vpb, "VolumeServer"), vpb


def test_replica_catches_up_via_tail_like_the_reference(tmp_path,
                                                        later_clock):
    """Server A holds a volume of stamped needles; B allocates it empty
    and pulls A's appends through VolumeTailReceiver (idle timeout 1 s):
    first all of them, then, from B's newest stamp, five more, then a
    delete's tombstone.  Both packages' B end with the same .dat and .idx
    as each other, and the needles and cursors agree."""
    first, more = _bodies(SEED + 1, 20, 500, 1500), _bodies(SEED + 2, 5)
    big = _bodies(SEED + 3, 1, 600_000, 600_001)  # spans three messages
    vid = 91

    async def one(kind: str) -> dict:
        pkg = "torch" if kind == "port" else "jax"
        a, b = _server(kind, tmp_path / kind / "a"), _server(
            kind, tmp_path / kind / "b")
        for vs in (a, b):
            await (vs.start() if kind == "port" else vs.start(heartbeat=False))
        out = {}
        try:
            sa, vpb = _stub(kind, a)
            sb, _ = _stub(kind, b)
            for stub in (sa, sb):
                await stub.AllocateVolume(vpb.AllocateVolumeRequest(
                    volume_id=vid, collection="", replication="000", ttl=""))
            va, vb = a.store.find_volume(vid), b.store.find_volume(vid)
            for k, body in enumerate(first + big):
                _append(pkg, va, k + 1, body, k)
            source = f"{a.ip}:{a.port}.{a.grpc_port}"

            async def tail(since: int) -> None:
                await sb.VolumeTailReceiver(vpb.VolumeTailReceiverRequest(
                    volume_id=vid, since_ns=since, idle_timeout_seconds=1,
                    source_volume_server=source))

            await tail(0)
            out["first"] = {i: bytes(vb.read(i, 0x5A).data)
                            for i in range(1, len(first) + 2)}
            last_ns = max(vb.read(i).append_at_ns for i in out["first"])
            out["cursor"] = last_ns
            for k, body in enumerate(more):
                _append(pkg, va, 100 + k, body, 100 + k)
            await tail(last_ns)
            out["more"] = {i: bytes(vb.read(i, 0x5A).data)
                           for i in range(100, 105)}
            out["live"] = len(vb.nm)
            last_ns = max(vb.read(i).append_at_ns for i in range(100, 105))
            await asyncio.to_thread(va.delete, 3)
            await tail(last_ns)
            with pytest.raises(PKGS[pkg][0].NotFoundError):
                vb.read(3)
            out["after_delete"] = len(vb.nm)
            out["files"] = _files(vb)
            out["source_files"] = _files(va)
            out["missing"] = await _missing_volume_code(kind, sb, vpb, source)
        finally:
            for vs in (a, b):
                await vs.stop()
        return out

    port = asyncio.run(one("port"))
    ref = asyncio.run(one("ref"))
    assert port == ref
    assert port["first"] == {i + 1: body
                             for i, body in enumerate(first + big)}
    assert port["more"] == dict(zip(range(100, 105), more))
    assert (port["live"], port["after_delete"]) == (26, 25)


async def _missing_volume_code(kind: str, stub, vpb, source: str) -> str:
    """VolumeTailReceiver for a vid the receiver lacks: the status name."""
    try:
        await stub.VolumeTailReceiver(vpb.VolumeTailReceiverRequest(
            volume_id=12345, since_ns=0, idle_timeout_seconds=1,
            source_volume_server=source))
    except Exception as e:  # RpcError, or the reference's AioRpcError
        return e.code().name
    return "OK"
