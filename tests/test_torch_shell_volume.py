"""The port's volume.*, cluster.check and collection.* shell verbs against
the JAX package's: the same seeded needles and the same commands on the
reference's `LocalCluster` and the port's, compared step by step.

Script A runs on three servers (volumes placed by AllocateVolume, needles
POSTed with the clock frozen, so both packages' `.dat` files are the same
bytes):

    cluster.check; collection.list; volume.list
    volume.mark -readonly / -writable; volume.unmount; volume.mount
    volume.grow (the masters' growth seeded alike)
    lock; volume.copy; volume.check.disk (a needle only on the source, a
      delete only on the copy, a delete-then-re-add), each with -force
    volume.move; volume.fix.replication; volume.balance (three empty
      volumes added to one server first)
    volume.delete.empty; volume.tier.upload; volume.tier.download
    collection.delete; ec.encode, then volume.server.evacuate -force
      (volumes and EC shards); volume.server.leave

as tests/test_shell_volume_ops.py and tests/test_shell.py drive them, and
script B `volume.tier.move` over hdd and ssd directories.  After each step
the two must agree exactly: the shell's lines with addresses masked to
server indices, where each volume and EC shard lies (in the stores and in
the master's topology), and the bytes of every volume file.  Each step is
one test case.
"""
import asyncio
import contextlib
import hashlib
import io
import os
import random
import re
from unittest import mock

import numpy as np
import pytest

from seaweedfs_tpu.pb import Stub as RefStub
from seaweedfs_tpu.pb import channel as ref_channel
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vpb
from seaweedfs_tpu.repair import RepairConfig
from seaweedfs_tpu.server import cluster as ref_cluster_mod
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run
from seaweedfs_tpu_torch.operation import upload_data
from seaweedfs_tpu_torch.pb import Stub as PortStub
from seaweedfs_tpu_torch.pb import channel as port_channel
from seaweedfs_tpu_torch.pb import volume_server_pb2 as port_vpb
from seaweedfs_tpu_torch.repair import RepairConfig as PortRepairConfig
from seaweedfs_tpu_torch.server.cluster import LocalCluster as PortCluster
from seaweedfs_tpu_torch.server.http import fetch
from seaweedfs_tpu_torch.shell import CommandEnv as PortEnv
from seaweedfs_tpu_torch.shell import run_command as port_run

SEED = 20319
FROZEN = 1_760_000_000.0
PULSE = 0.1


# the files of a volume (the reference also keeps a vol_dir.uuid a
# directory); a .vif holds the tier's absolute paths
_VOLUME_FILE = re.compile(r".*\.(dat|idx|ec\d\d|ecx|ecj)$")


def _frozen():
    """The clock frozen, so that a needle record's timestamps are the same
    bytes in both packages."""
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch("time.time", return_value=FROZEN))
    stack.enter_context(mock.patch("time.time_ns",
                                   return_value=int(FROZEN * 1e9)))
    return stack


def _blobs(vid, n, seed):
    rng = np.random.default_rng(seed)
    return [(f"{vid},{i + 1:x}{int(rng.integers(0, 1 << 32)):08x}",
             rng.bytes(int(rng.integers(300, 40_000)))) for i in range(n)]


class Side:
    """One cluster of either package and what the scripts do to it."""

    def __init__(self, kind: str, base: str, n: int, dirs_per_server=1,
                 disk_types=None):
        self.kind = kind
        self.base = base
        self.n = n
        self.dirs_per_server = dirs_per_server
        self.disk_types = disk_types
        self.out = io.StringIO()

    async def start(self):
        tier = {"local.default": {"type": "local",
                                  "dir": os.path.join(self.base, "tier")}}
        if self.kind == "port":
            self.c = PortCluster(
                n_volume_servers=self.n, base_dir=self.base, pulse_seconds=PULSE,
                ec_backend="torch", dirs_per_server=self.dirs_per_server,
                disk_types=self.disk_types,
                volume_kwargs={"tier_backends": tier},
                master_kwargs={"ec_repair": PortRepairConfig(enabled=False)})
            await self.c.start()
            self.env = PortEnv([self.c.master.advertise_url], out=self.out)
            return
        # started one server at a time, so that the master's node order is
        # the servers' order, as the port's LocalCluster does
        c = ref_cluster_mod.LocalCluster(
            base_dir=self.base, n_volume_servers=self.n, pulse_seconds=PULSE,
            dirs_per_server=self.dirs_per_server, disk_types=self.disk_types,
            tier_backends=tier,
            master_kwargs={"ec_repair": RepairConfig(enabled=False)})
        await c.master.start()
        for spec in c._specs:
            vs = RefVolumeServer(masters=[c.master.advertise_url], port=0,
                                 grpc_port=0, **spec)
            await vs.start()
            c.volume_servers.append(vs)
            await c.wait_for_nodes(len(c.volume_servers))
        self.c = c
        self.env = RefEnv([c.master.advertise_url], out=self.out)

    async def stop(self):
        await self.c.stop()

    @property
    def vss(self):
        return self.c.volume_servers

    def grpc(self, i: int) -> str:
        return self.vss[i].grpc_url

    async def sh(self, line: str, frozen: bool = False) -> list:
        """Run one shell line (with the clock frozen, for a verb that
        writes needle records): -> its output lines, masked."""
        self.out.seek(0)
        self.out.truncate()
        with _frozen() if frozen else contextlib.nullcontext():
            await (port_run if self.kind == "port" else ref_run)(
                self.env, line)
        return self.mask(self.out.getvalue()).splitlines()

    def mask(self, text: str) -> str:
        for i, vs in enumerate(self.vss):
            text = text.replace(f"{vs.ip}_{vs.port}_", f"vs{i}_")
            text = text.replace(vs.grpc_url, f"vs{i}.grpc")
            text = text.replace(vs.url, f"vs{i}")
        text = text.replace(self.c.master.advertise_url, "master")
        return re.sub(r"\d+\.\d+s", "<s>", text)

    async def rpc(self, i, method, **fields):
        stub_cls, chan, vpb = ((PortStub, port_channel, port_vpb)
                               if self.kind == "port"
                               else (RefStub, ref_channel, ref_vpb))
        stub = stub_cls(chan(self.vss[i].grpc_url), vpb, "VolumeServer")
        req = getattr(vpb, f"{method}Request")(**fields)
        return await getattr(stub, method)(req)

    async def post(self, i, fid, data):
        """POST one needle to server i with the clock frozen."""
        with _frozen():
            await upload_data(f"http://{self.vss[i].url}/{fid}", data,
                              f"n-{fid}.bin")

    async def delete(self, i, fid):
        with _frozen():
            status, _, _ = await fetch(self.vss[i].url, "DELETE", f"/{fid}")
        return status

    def stored(self) -> dict:
        """server index -> ({vid: (collection, size, files, deletes,
        read-only)}, {ec vid: shard bits}) from the stores."""
        out = {}
        for i, vs in enumerate(self.vss):
            vols, ecs = {}, {}
            for loc in vs.store.locations:
                for vid, v in loc.volumes.items():
                    info = v.info()
                    vols[vid] = (v.collection, info.size, info.file_count,
                                 info.delete_count, bool(info.read_only))
                for vid, ev in loc.ec_volumes.items():
                    ecs[vid] = int(ev.shard_bits())
            out[i] = (vols, ecs)
        return out

    async def listed(self) -> dict:
        """The same, as the master's VolumeList says."""
        nodes, _ = await self.env.collect_topology()
        idx = {vs.url: i for i, vs in enumerate(self.vss)}
        out = {}
        for n in nodes:
            vols = {v["id"]: (v["collection"], v["size"], v["file_count"],
                              v["delete_count"], bool(v["read_only"]))
                    for v in n.volumes}
            ecs = {s["id"]: s["ec_index_bits"] for s in n.ec_shards}
            out[idx[n.url]] = (vols, ecs)
        return out

    async def settle(self, alive=None):
        """Until the master lists every volume and EC shard where the
        stores hold them, with their sizes and counts."""
        alive = set(range(self.n)) if alive is None else alive
        for _ in range(300):
            stored = {i: s for i, s in self.stored().items() if i in alive}
            if await self.listed() == stored:
                return stored
            await asyncio.sleep(0.05)
        raise AssertionError(
            f"{self.kind}: the master lists {await self.listed()}, the "
            f"stores hold {self.stored()}")

    def files(self) -> dict:
        """(server index, file name) -> sha256 of every volume file."""
        out = {}
        for i, vs in enumerate(self.vss):
            for loc in vs.store.locations:
                for name in sorted(os.listdir(loc.directory)):
                    if not _VOLUME_FILE.match(name):
                        continue
                    path = os.path.join(loc.directory, name)
                    with open(path, "rb") as f:
                        out[(i, loc.disk_type, name)] = hashlib.sha256(
                            f.read()).hexdigest()
        return out

    def needle(self, i, vid, nid):
        """The needle's data on server i, or None when it is absent."""
        try:
            return bytes(self.vss[i].store.read_needle(vid, nid).data)
        except Exception:  # noqa: BLE001 — deleted or missing
            return None


async def _script_a(side: Side) -> dict:
    seen: dict = {}
    await side.start()
    try:
        blobs1 = _blobs(1, 8, SEED)
        blobs2 = _blobs(2, 4, SEED + 1)
        await side.rpc(0, "AllocateVolume", volume_id=1, replication="000")
        await side.rpc(0, "AllocateVolume", volume_id=2, replication="000",
                       collection="c2")
        await side.rpc(1, "AllocateVolume", volume_id=3, replication="000")
        for fid, data in blobs1:
            await side.post(0, fid, data)
        for fid, data in blobs2:
            await side.post(0, fid, data)
        seen["setup"] = await side.settle()

        seen["cluster.check"] = await side.sh("cluster.check")
        seen["collection.list"] = await side.sh("collection.list")
        seen["volume.list"] = await side.sh("volume.list")

        g0 = side.grpc(0)
        lines = await side.sh(f"volume.mark -node {g0} -volumeId 1 -readonly")
        seen["volume.mark"] = (lines, await side.settle())
        lines = await side.sh(f"volume.mark -node {g0} -volumeId 1 -writable")
        seen["volume.mark"] += (lines, await side.settle())
        lines = await side.sh(f"volume.unmount -node {g0} -volumeId 2")
        seen["volume.unmount"] = (lines, await side.settle())
        lines = await side.sh(f"volume.mount -node {g0} -volumeId 2")
        seen["volume.mount"] = (lines, await side.settle())

        side.c.master.topo.growth.rng = random.Random(SEED)
        lines = await side.sh("volume.grow -count 1 -collection g")
        seen["volume.grow"] = (lines, await side.settle())

        await side.sh("lock")
        g1, g2 = side.grpc(1), side.grpc(2)
        lines = await side.sh(f"volume.copy -volumeId 1 -source {g0} "
                              f"-target {g1}")
        seen["volume.copy"] = (lines, await side.settle(), side.files())

        # volume.check.disk: a needle only on the source, then a delete only
        # on the copy, then a delete-then-re-add on the source
        fid = "1,999deadbeef1"
        nid = 0x999d
        check: list = []
        await side.post(0, fid, b"only-on-src")
        await side.settle()
        check.append(await side.sh("volume.check.disk -volumeId 1"))
        check.append(await side.sh("volume.check.disk -volumeId 1 -force",
                                  frozen=True))
        check.append((side.needle(0, 1, nid), side.needle(1, 1, nid)))
        check.append(await side.sh("volume.check.disk -volumeId 1"))
        check.append(await side.delete(1, fid))
        await side.settle()
        check.append(await side.sh("volume.check.disk -volumeId 1 -force",
                                  frozen=True))
        check.append((side.needle(0, 1, nid), side.needle(1, 1, nid)))
        await side.post(0, fid, b"v2-after-del")
        await side.settle()
        check.append(await side.sh("volume.check.disk -volumeId 1 -force",
                                  frozen=True))
        check.append((side.needle(0, 1, nid), side.needle(1, 1, nid)))
        check.append(await side.settle())
        seen["volume.check.disk"] = check

        lines = await side.sh(f"volume.move -volumeId 2 -source {g0} "
                              f"-target {g2}")
        seen["volume.move"] = (lines, await side.settle(), side.files())

        # vid 1 is `000` on two servers now: over-replicated
        plan = await side.sh("volume.fix.replication")
        lines = await side.sh("volume.fix.replication -force")
        seen["volume.fix.replication"] = (plan, lines, await side.settle())

        # three empty volumes more on vs0, so that the counts are uneven
        for vid in (6, 7, 8):
            await side.rpc(0, "AllocateVolume", volume_id=vid,
                           replication="000")
        await side.settle()
        plan = await side.sh("volume.balance")
        lines = await side.sh("volume.balance -force")
        seen["volume.balance"] = (plan, lines, await side.settle(),
                                  side.files())

        plan = await side.sh("volume.delete.empty -quietFor 0s")
        lines = await side.sh("volume.delete.empty -quietFor 0s -force")
        seen["volume.delete.empty"] = (plan, lines, await side.settle())

        lines = await side.sh("volume.tier.upload -volumeId 2 "
                              "-dest local.default")
        holder = next(i for i, vs in enumerate(side.vss)
                      if vs.store.find_volume(2) is not None)
        tiered = [side.needle(holder, 2, int(f.split(",")[1][:-8], 16))
                  for f, _ in blobs2]
        seen["volume.tier.upload"] = (lines, await side.settle(), tiered,
                                      [side.mask(n) for n in sorted(
                                          os.listdir(os.path.join(
                                              side.base, "tier")))])
        lines = await side.sh("volume.tier.download -volumeId 2")
        seen["volume.tier.download"] = (lines, await side.settle(),
                                        side.files())

        lines = await side.sh("collection.delete -collection c2")
        seen["collection.delete"] = (lines, await side.settle(),
                                     await side.sh("collection.list"))

        # an EC volume beside the plain ones, then the evacuation
        blobs4 = _blobs(4, 6, SEED + 4)
        await side.rpc(0, "AllocateVolume", volume_id=4, replication="000")
        for fid4, data in blobs4:
            await side.post(0, fid4, data)
        await side.settle()
        encoded = await side.sh("ec.encode -volumeId 4")
        before = await side.settle()
        victim = max(range(side.n), key=lambda i: (
            len(before[i][0]) + bin(before[i][1].get(4, 0)).count("1"), -i))
        lines = await side.sh(f"volume.server.evacuate -node "
                              f"{side.vss[victim].url} -force")
        after = await side.settle()
        seen["volume.server.evacuate"] = (encoded, victim, lines, after,
                                          side.files())

        lines = await side.sh(f"volume.server.leave -node "
                              f"{side.grpc(victim)}")
        await side.settle(alive=set(range(side.n)) - {victim})
        seen["volume.server.leave"] = (lines, sorted(
            (await side.listed()).keys()))
        await side.sh("unlock")
    finally:
        await side.stop()
    return seen


async def _script_b(side: Side) -> dict:
    """volume.tier.move over two servers with an hdd and an ssd directory
    each (tests/test_shell_volume_ops.py::test_volume_tier_move)."""
    seen: dict = {}
    await side.start()
    try:
        blobs = _blobs(5, 6, SEED + 5)
        await side.rpc(0, "AllocateVolume", volume_id=5, replication="000")
        for fid, data in blobs:
            await side.post(0, fid, data)
        await side.settle()
        await side.sh("lock")
        plan = await side.sh("volume.tier.move -fromDiskType hdd "
                             "-toDiskType ssd -fullPercent 0")
        lines = await side.sh("volume.tier.move -fromDiskType hdd "
                              "-toDiskType ssd -fullPercent 0 -force")
        stored = await side.settle()
        holders = [i for i, vs in enumerate(side.vss)
                   if vs.store.find_volume(5) is not None]
        disk = [side.vss[i].store.location_of_volume(5).disk_type
                for i in holders]
        data = [side.needle(holders[0], 5, int(f.split(",")[1][:-8], 16))
                for f, _ in blobs]
        seen["volume.tier.move"] = (plan, lines, stored, holders, disk, data,
                                    side.files())
        await side.sh("unlock")
    finally:
        await side.stop()
    return seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("shell_volume")
    out = {}
    for kind in ("ref", "port"):
        a = asyncio.run(_script_a(Side(kind, str(base / kind / "a"), 3)))
        b = asyncio.run(_script_b(Side(kind, str(base / kind / "b"), 2,
                                       dirs_per_server=2,
                                       disk_types=["hdd", "ssd"])))
        out[kind] = {**a, **b}
    return out


STEPS = ["setup", "cluster.check", "collection.list", "volume.list",
         "volume.mark", "volume.unmount", "volume.mount", "volume.grow",
         "volume.copy", "volume.check.disk", "volume.move",
         "volume.fix.replication", "volume.balance", "volume.delete.empty",
         "volume.tier.upload", "volume.tier.download", "collection.delete",
         "volume.server.evacuate", "volume.server.leave", "volume.tier.move"]


def test_the_reference_did_what_the_script_says(runs):
    ref = runs["ref"]
    assert ref["cluster.check"] == ["3/3 volume servers reachable"]
    assert ref["collection.list"] == ["  c2", "1 collections"]
    assert any("volume id:1 " in ln for ln in ref["volume.list"])
    assert ref["volume.mark"][1][0][0][1][4] is True  # read-only on vs0
    assert 2 not in ref["volume.unmount"][1][0][0]
    assert 2 in ref["volume.mount"][1][0][0]
    assert ref["volume.grow"][0] == ['{"count": 1, "vids": [4]}']
    assert ref["volume.copy"][0][0].startswith("copied volume 1: vs0.grpc "
                                               "-> vs1.grpc (")
    check = ref["volume.check.disk"]
    assert any("missing from vs1" in ln for ln in check[0])
    assert check[2] == (b"only-on-src", b"only-on-src")
    assert check[3] == ["0 needles out of sync (use -force)"]
    assert check[4] in (200, 202, 204)
    assert check[6] == (None, None)  # the delete propagated
    assert check[8] == (b"v2-after-del", b"v2-after-del")  # the re-add won
    assert ref["volume.move"][0] == ["moved volume 2: vs0 -> vs2"]
    assert ref["volume.fix.replication"][1][-1] == "1 fixes applied"
    assert ref["volume.balance"][1][-1] == "1 moves applied"
    assert ref["volume.delete.empty"][1][-1] == "5 empty volumes deleted"
    assert all(d is not None for d in ref["volume.tier.upload"][2])
    assert ref["volume.tier.upload"][3]  # the .dat sits in the tier dir
    assert ref["collection.delete"][0] == ["deleted collection c2"]
    encoded, victim, lines, after, _ = ref["volume.server.evacuate"]
    assert lines[-1].endswith(", 0 skipped") and "moves applied" in lines[-1]
    assert any(ln.startswith("move ec shard 4.") for ln in lines)
    assert after[victim] == ({}, {})
    assert bin(sum(after[i][1].get(4, 0) for i in after)).count("1") == 14
    assert ref["volume.server.leave"][1] == sorted(set(range(3)) - {victim})
    plan, lines, stored, holders, disk, data, _ = ref["volume.tier.move"]
    assert "move volume 5 (hdd -> ssd)" in plan[0]
    assert holders == [1] and disk == ["ssd"]
    assert all(d is not None for d in data)


@pytest.mark.parametrize("step", STEPS)
def test_verb_matches_the_reference(runs, step):
    assert runs["port"][step] == runs["ref"][step]


def _ec_volume_files(d, vid):
    """A small volume encoded by the port's codec on the CPU: -> the base
    path of its 14 shards, .ecx and .ecj."""
    from seaweedfs_tpu_torch.storage import ec as port_ec
    from seaweedfs_tpu_torch.storage.volume import Volume

    os.makedirs(d, exist_ok=True)
    v = Volume(d, vid)
    for nid, (_, data) in enumerate(_blobs(vid, 12, SEED + 9), 1):
        v.write(nid, 7, data)
    v.close()
    base = os.path.join(d, str(vid))
    port_ec.write_ec_files(base, backend="torch")
    port_ec.write_sorted_file_from_idx(base)
    return base


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_a_pin_skips_shards_moved_off_meanwhile(tmp_path, kind):
    """The departure: a server pins a volume's shards in shard order right
    after `ec.encode` mounts all 14, while the spread unmounts and deletes
    the shards it moves.  Here shard 3 goes while shard 0 is being pinned.
    The reference's pin dies on shard 3's deleted file (the first
    difference: FileNotFoundError ... 1.ec03) with shards 0-2 pinned and
    none after; the port's skips shard 3 and pins the other 13."""
    from seaweedfs_tpu.ops import rs_resident as ref_resident
    from seaweedfs_tpu.storage.ec import EcVolume as RefEcVolume
    from seaweedfs_tpu_torch.ops import rs_resident as port_resident
    from seaweedfs_tpu_torch.storage.ec import EcVolume as PortEcVolume

    d = str(tmp_path)
    base = _ec_volume_files(d, 1)
    if kind == "port":
        ev = PortEcVolume(d, 1)
        cache = port_resident.DeviceShardCache(device="cpu",
                                               shard_quantum=1 << 20)
    else:
        ev = RefEcVolume(d, 1)
        cache = ref_resident.DeviceShardCache(shard_quantum=1 << 20)
    try:
        for sid in range(14):
            ev.add_shard(sid)
        put = cache.put

        def put_then_move_shard_3(vid, sid, data):
            put(vid, sid, data)
            if sid == 0:  # the spread moves shard 3 off meanwhile
                ev.delete_shard(3).close()
                os.remove(base + ".ec03")

        cache.put = put_then_move_shard_3
        if kind == "ref":
            with pytest.raises(FileNotFoundError, match=r"1\.ec03"):
                ev.load_shards_to_device(cache)
            assert cache.resident_by_vid() == {1: [0, 1, 2]}
        else:
            assert ev.load_shards_to_device(cache) == 13
            assert cache.resident_by_vid() == {
                1: [s for s in range(14) if s != 3]}
    finally:
        ev.close()
