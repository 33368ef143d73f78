"""The cluster path of the port against the JAX package's: the same EC
lifecycle, driven through the same shell script, on the reference's
`LocalCluster` and the port's.

Both clusters run a master and three volume servers in this process (the
port's volume servers on the plain PyTorch versions of the kernels,
`ec_backend="torch"`).  Server 0 gets volume 1 and the same seeded blobs
under the same fids, written with the clock frozen (a needle stores its
write time), so both `.dat` files are the same bytes.  Then, mirroring
tests/test_shell.py::test_ec_encode_balance_rebuild_decode_roundtrip and
tests/test_cluster_e2e.py::test_ec_encode_spread_degraded_read:

    lock; ec.encode -volumeId 1   (generate on server 0, spread)
    GET every blob                (remote shard reads)
    lose the server with the fewest shards
    GET every blob                (degraded reads: remote survivors)
    ec.rebuild -force; GET; ec.balance -force; GET
    ec.decode -volumeId 1; GET; unlock

and after every step the two clusters must agree exactly (EC over GF(256)
is exact; there is no tolerance): every shard file's sha256 and the .ecx's,
the shard -> server-index placement the master reports, the decoded
.dat/.idx, every GET body, and the shell's output with addresses and
seconds masked.  The port must also have fetched shard bytes from peers.
"""
import asyncio
import hashlib
import io
import os
import re
from unittest import mock

import aiohttp
import numpy as np

from seaweedfs_tpu.operation import upload_data as ref_upload
from seaweedfs_tpu.pb import Stub as RefStub
from seaweedfs_tpu.pb import channel as ref_channel
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vpb
from seaweedfs_tpu.repair import RepairConfig
from seaweedfs_tpu.server import cluster as ref_cluster_mod
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.operation import upload_data as port_upload
from seaweedfs_tpu_torch.pb import Stub as PortStub
from seaweedfs_tpu_torch.pb import channel as port_channel
from seaweedfs_tpu_torch.pb import volume_server_pb2 as port_vpb
from seaweedfs_tpu_torch.repair import RepairConfig as PortRepairConfig
from seaweedfs_tpu_torch.server.cluster import LocalCluster as PortCluster
from seaweedfs_tpu_torch.server.http import Client
from seaweedfs_tpu_torch.shell import CommandEnv as PortEnv
from seaweedfs_tpu_torch.shell import run_command as port_run

VID = 1
SEED = 20260
FROZEN = 1_760_000_000.0


def _blobs():
    """(fid, data, filename): ~3 MB over needles of 1 KB..250 KB, so the
    .dat spans three data shards' small blocks."""
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(24):
        size = int(rng.integers(1000, 250_000))
        cookie = int(rng.integers(0, 1 << 32))
        fid = f"{VID},{i + 1:x}{cookie:08x}"
        out.append((fid, rng.bytes(size), f"blob{i}.bin"))
    return out


class _Side:
    """One cluster and the verbs the script needs, for either package."""

    def __init__(self, kind: str, base: str, n: int = 3):
        self.kind = kind
        self.base = base
        self.n = n
        self.out = io.StringIO()

    async def start(self):
        if self.kind == "port":
            # without the autonomous repair loop, as on the reference side
            self.c = PortCluster(
                n_volume_servers=self.n, base_dir=self.base, pulse_seconds=1,
                ec_backend="torch",
                master_kwargs={"ec_repair": PortRepairConfig(enabled=False)})
            await self.c.start()
            self.env = PortEnv([self.c.master.advertise_url], out=self.out)
            return
        # the reference's LocalCluster, started one server at a time so the
        # master's node order is the servers' order, as the port's is; on
        # both sides without the autonomous repair loop, which would
        # rebuild the lost shards before the script's ec.rebuild (repair
        # is held against the reference in tests/test_torch_repair.py)
        c = ref_cluster_mod.LocalCluster(
            base_dir=self.base, n_volume_servers=self.n, pulse_seconds=1,
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

    async def sh(self, line):
        await (port_run if self.kind == "port" else ref_run)(self.env, line)

    async def settle(self):
        """Until every server's heartbeat deltas are drained and the master
        has had time to apply the last one."""
        for _ in range(200):
            if all(
                vs.store.new_volumes.empty() and vs.store.deleted_volumes.empty()
                and vs.store.new_ec_shards.empty()
                and vs.store.deleted_ec_shards.empty()
                for vs in self.c.volume_servers
            ):
                break
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.4)

    async def rpc(self, vs, method, **fields):
        """One VolumeServer rpc on `vs`, in its package's stubs."""
        stub_cls, chan, vpb = ((PortStub, port_channel, port_vpb)
                               if self.kind == "port"
                               else (RefStub, ref_channel, ref_vpb))
        stub = stub_cls(chan(vs.grpc_url), vpb, "VolumeServer")
        req = getattr(vpb, f"{method}Request")(**fields)
        return await getattr(stub, method)(req)

    async def allocate_and_fill(self, blobs):
        vs0 = self.c.volume_servers[0]
        await self.rpc(vs0, "AllocateVolume", volume_id=VID,
                       replication="000")
        upload = port_upload if self.kind == "port" else ref_upload
        with mock.patch("time.time", return_value=FROZEN), \
                mock.patch("time.time_ns", return_value=int(FROZEN * 1e9)):
            for fid, data, name in blobs:
                await upload(f"http://{vs0.url}/{fid}", data, name)
        await self.settle()

    async def get_all(self, blobs):
        """GET every blob from the first server (by index) that holds the
        volume or some of its shards."""
        vs0 = next(vs for vs in self.c.volume_servers
                   if vs.store.find_ec_volume(VID) is not None
                   or vs.store.find_volume(VID) is not None)
        bodies = [self.index()[vs0.url]]
        if self.kind == "port":
            cl = Client(vs0.ip, vs0.port)
            try:
                for fid, _, _ in blobs:
                    status, _, body = await cl.request("GET", f"/{fid}")
                    bodies.append((status, hashlib.sha256(body).hexdigest()))
            finally:
                await cl.close()
        else:
            async with aiohttp.ClientSession() as s:
                for fid, _, _ in blobs:
                    async with s.get(f"http://{vs0.url}/{fid}") as r:
                        body = await r.read()
                        bodies.append((r.status,
                                       hashlib.sha256(body).hexdigest()))
        return bodies

    def index(self):
        return {vs.url: i for i, vs in enumerate(self.c.volume_servers)}

    def placement(self):
        locs = self.c.master.topo.lookup_ec_shards(VID)
        if locs is None:
            return None
        idx = self.index()
        return [sorted(idx[n.url] for n in nodes) for nodes in locs.locations]

    def files(self):
        """(server index, file name) -> sha256 of every file of the vid."""
        out = {}
        for i, vs in enumerate(self.c.volume_servers):
            for loc in vs.store.locations:
                for name in sorted(os.listdir(loc.directory)):
                    stem = name.split(".")[0]
                    if stem != str(VID) or name.endswith(".tmp"):
                        continue
                    with open(os.path.join(loc.directory, name), "rb") as f:
                        out[(i, name)] = hashlib.sha256(f.read()).hexdigest()
        return out

    def shell_lines(self):
        text = self.out.getvalue()
        for url, i in self.index().items():
            text = text.replace(url, f"vs{i}")
        return re.sub(r"\d+\.\d+s", "<s>", text).splitlines()


async def _script(side: _Side, blobs) -> dict:
    seen = {}
    await side.start()
    try:
        await side.allocate_and_fill(blobs)
        seen["dat"] = side.files()
        await side.sh("lock")
        await side.sh(f"ec.encode -volumeId {VID}")
        await side.settle()
        seen["encode"] = (side.files(), side.placement())
        seen["get_spread"] = await side.get_all(blobs)
        holders = [vs for vs in side.c.volume_servers
                   if vs.store.find_ec_volume(VID) is not None]
        victim = min(holders,
                     key=lambda vs: len(vs.store.find_ec_volume(VID).shards))
        seen["lost"] = (side.index()[victim.url],
                        sorted(victim.store.find_ec_volume(VID).shards))
        victim.store.destroy_ec_volume(VID)
        await side.settle()
        seen["after_loss"] = side.placement()
        seen["get_degraded"] = await side.get_all(blobs)
        await side.sh("ec.rebuild -force")
        await side.settle()
        seen["rebuild"] = (side.files(), side.placement())
        seen["get_rebuilt"] = await side.get_all(blobs)
        await side.sh("ec.balance -force")
        await side.settle()
        seen["balance"] = (side.files(), side.placement())
        seen["get_balanced"] = await side.get_all(blobs)
        await side.sh(f"ec.decode -volumeId {VID}")
        await side.settle()
        seen["decode"] = (side.files(), side.placement())
        seen["get_decoded"] = await side.get_all(blobs)
        await side.sh("unlock")
        seen["shell"] = side.shell_lines()
    finally:
        await side.stop()
    return seen


def _remote_ok() -> float:
    return stats.VOLUME_SERVER_EC_REMOTE_SHARD_READS.labels(result="ok").value


def test_ec_lifecycle_matches_the_reference(tmp_path):
    blobs = _blobs()
    want = [(200, hashlib.sha256(d).hexdigest()) for _, d, _ in blobs]
    ref = asyncio.run(_script(_Side("ref", str(tmp_path / "ref")), blobs))
    before = _remote_ok()
    port = asyncio.run(_script(_Side("port", str(tmp_path / "port")), blobs))
    assert _remote_ok() - before > 0  # the port read shards from peers

    # the script did what it says, on the reference side
    for key in ("get_spread", "get_degraded", "get_rebuilt", "get_balanced",
                "get_decoded"):
        assert ref[key][1:] == want, key
    assert len({tuple(p) for p in ref["encode"][1]}) > 1  # spread
    assert ref["lost"][1] and len(ref["lost"][1]) <= 4
    assert ref["decode"][1] is None  # no EC shards left anywhere
    assert any(name.endswith(".dat") for _, name in ref["decode"][0])
    assert "rebuilt" in "\n".join(ref["shell"])
    for key in ("dat", "encode", "get_spread", "lost", "after_loss",
                "get_degraded", "rebuild", "get_rebuilt", "balance",
                "get_balanced", "decode", "get_decoded", "shell"):
        assert port[key] == ref[key], key


# --------------------------------------------- replication and proxy reads

REPL_VID, REFUSE_VID = 2, 3
# the answer headers the two servers must agree on (aiohttp adds Date and
# Server, the port's server neither)
_HEADERS = ("Content-Type", "Content-Length", "Etag", "Last-Modified",
            "Accept-Ranges", "Content-Range", "Content-Disposition",
            "Location")


def _repl_blobs(vid, n, seed):
    rng = np.random.default_rng(seed)
    return [(f"{vid},{i + 1:x}{int(rng.integers(0, 1 << 32)):08x}",
             rng.bytes(int(rng.integers(100, 60_000)))) for i in range(n)]


async def _repl_script(side: _Side, blobs, refused) -> dict:
    """Four servers: vid 2 placed `001` on servers 0 and 1, vid 3 placed
    `002` on servers 0-2 with server 2's copy read-only.  POST each blob to
    server 0 (fanned out to server 1), GET it on both holders, then on
    server 3, which holds neither, in each -readMode (with and without a
    Range); a POST to vid 3 (server 1 acks, server 2 refuses: the rollback);
    a DELETE on server 0 (fanned out).  Every answer's status, body and
    headers, with addresses masked to server indices."""
    await side.start()
    seen: dict = {}
    try:
        vss = side.c.volume_servers
        for i in (0, 1):
            await side.rpc(vss[i], "AllocateVolume", volume_id=REPL_VID,
                           replication="001")
        for i in (0, 1, 2):
            await side.rpc(vss[i], "AllocateVolume", volume_id=REFUSE_VID,
                           replication="002")
        await side.rpc(vss[2], "VolumeMarkReadonly", volume_id=REFUSE_VID)
        await side.settle()
        topo = side.c.master.topo
        for _ in range(400):  # until the master knows every copy
            if (len(topo.lookup_volume("", REPL_VID)) == 2
                    and len(topo.lookup_volume("", REFUSE_VID)) == 3):
                break
            await asyncio.sleep(0.02)
        else:
            raise AssertionError("the master never saw the copies")
        idx = side.index()

        def mask(text):
            for url, i in idx.items():
                text = text.replace(url, f"vs{i}")
            return text

        async def call(i, method, path, body=b"", headers=None):
            vs = vss[i]
            cl = Client(vs.ip, vs.port)
            try:
                st, h, data = await cl.request(method, path, headers=headers,
                                               body=body)
            finally:
                await cl.close()
            hs = {k: mask(h[k]) for k in _HEADERS if k in h}
            if "Last-Modified" in hs:
                hs["Last-Modified"] = "<date>"
            if data[:1] in (b"{", b"r", b"v", b"4", b"3", b"5"):
                data = mask(data.decode(errors="replace"))
            else:
                data = hashlib.sha256(data).hexdigest()
            return st, hs, data

        ct = {"Content-Type": "application/x-test"}
        # the clock is not frozen here (the reference's master lookup
        # fails under a frozen clock), so Last-Modified is masked below
        seen["post"] = [await call(0, "POST", f"/{fid}", data, ct)
                        for fid, data in blobs]
        seen["post_refused"] = [await call(0, "POST", f"/{fid}", data, ct)
                                for fid, data in refused]
        for i in (0, 1):
            seen[f"get_{i}"] = [await call(i, "GET", f"/{fid}")
                                for fid, _ in blobs]
        seen["get_refused"] = [await call(i, "GET", f"/{fid}")
                               for i in (0, 1, 2) for fid, _ in refused]
        for mode in ("local", "proxy", "redirect"):
            vss[3].read_mode = mode
            seen[f"read_{mode}"] = [await call(3, "GET", f"/{fid}")
                                    for fid, _ in blobs]
            seen[f"range_{mode}"] = await call(
                3, "GET", f"/{blobs[0][0]}", headers={"Range": "bytes=5-49"})
            seen[f"missing_{mode}"] = await call(3, "GET", "/77,1deadbeef")
        seen["delete"] = await call(0, "DELETE", f"/{blobs[0][0]}")
        seen["after_delete"] = [await call(i, "GET", f"/{blobs[0][0]}")
                                for i in (0, 1)]
        vss[3].read_mode = "proxy"
        seen["after_delete_proxy"] = await call(3, "GET", f"/{blobs[0][0]}")
    finally:
        await side.stop()
    return seen


def test_replicated_writes_and_proxy_reads_match_the_reference(tmp_path):
    blobs = _repl_blobs(REPL_VID, 6, SEED + 1)
    refused = _repl_blobs(REFUSE_VID, 2, SEED + 2)
    ref = asyncio.run(_repl_script(_Side("ref", str(tmp_path / "ref"), 4),
                                   blobs, refused))
    port = asyncio.run(_repl_script(_Side("port", str(tmp_path / "port"), 4),
                                    blobs, refused))
    want = [hashlib.sha256(d).hexdigest() for _, d in blobs]
    # the script did what it says, on the reference side
    assert [st for st, _, _ in ref["post"]] == [200] * len(blobs)
    for key in ("get_0", "get_1", "read_local", "read_proxy"):
        assert [(st, b) for st, _, b in ref[key]] == [
            (200, w) for w in want], key
    assert {st for st, _, _ in ref["read_redirect"]} == {301}
    assert ref["range_proxy"][0] == 206
    assert [st for st, _, _ in ref["post_refused"]] == [500, 500]
    assert "vs2: HTTP 409" in ref["post_refused"][0][2]
    assert {st for st, _, _ in ref["get_refused"]} == {404}
    assert [st for st, _, _ in ref["after_delete"]] == [404, 404]
    assert set(port) == set(ref)
    for key in sorted(ref):
        assert port[key] == ref[key], key


def _free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_processes_run_as_users_start_them(tmp_path):
    """`python3 -m seaweedfs_tpu_torch master`, two `volume -mserver ...`
    servers and `shell -c` as separate processes (the chip smoke's phase 9
    shape, on the plain versions): the volume servers register, a blob
    written through the master's assign reads back, and the shell encodes
    and spreads its volume."""
    import json as json_mod
    import subprocess
    import sys

    from seaweedfs_tpu_torch.operation import assign, lookup_file_id

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mp, mg, p1, g1, p2, g2 = _free_ports(6)
    master = f"127.0.0.1:{mp}.{mg}"
    cmd = [sys.executable, "-m", "seaweedfs_tpu_torch"]
    procs = [subprocess.Popen(
        cmd + ["master", "-port", str(mp), "-port.grpc", str(mg),
               "-volumeSizeLimitMB", "64"],
        cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)]
    for i, (p, g) in enumerate(((p1, g1), (p2, g2))):
        procs.append(subprocess.Popen(
            cmd + ["volume", "-dir", str(tmp_path / f"v{i}"), "-port", str(p),
                   "-port.grpc", str(g), "-mserver", master,
                   "-ec.backend", "torch", "-pulseSeconds", "1"],
            cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))

    async def go():
        cl = Client("127.0.0.1", mp)
        for _ in range(600):
            try:
                st, _, body = await cl.request("GET", "/dir/status")
                nodes = [n for dc in json_mod.loads(body)["Topology"][
                    "data_centers"] for r in dc["racks"] for n in r["nodes"]]
                if len(nodes) == 2:
                    break
            except (ConnectionError, OSError):
                await cl.close()
            await asyncio.sleep(0.1)
        else:
            raise AssertionError("volume servers did not register")
        await cl.close()
        a = await assign(master)
        data = np.random.default_rng(3).bytes(300_000)
        await port_upload(f"http://{a.url}/{a.fid}", data, "b.bin")
        assert await lookup_file_id(master, a.fid) == [
            f"http://{a.url}/{a.fid}"]
        await asyncio.sleep(1.5)  # a pulse carries the volume's size
        return a, data

    try:
        a, data = asyncio.run(go())
        vid = int(a.fid.split(",")[0])
        sh = subprocess.run(
            cmd + ["shell", "-master", master, "-c",
                   f"lock; ec.encode -volumeId {vid}; unlock"],
            cwd=repo, capture_output=True, text=True, timeout=120)
        assert sh.returncode == 0, sh.stdout + sh.stderr
        assert f"ec encoded volume {vid}" in sh.stdout
        bad = subprocess.run(
            cmd + ["shell", "-master", master, "-c", "ec.encode -volumeId 1"],
            cwd=repo, capture_output=True, text=True, timeout=120)
        assert bad.returncode == 1 and "lock" in bad.stdout

        async def read_back():
            for p in (p1, p2):
                cl = Client("127.0.0.1", p)
                st, _, body = await cl.request("GET", f"/{a.fid}")
                await cl.close()
                assert st == 200 and body == data

        asyncio.run(read_back())
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
