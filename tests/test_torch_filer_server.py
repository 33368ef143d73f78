"""The port's FilerServer against the JAX package's, both over their own
package's cluster (a master, two volume servers, the filer) on the CPU:
every HTTP route (GET, HEAD, Range, conditional GETs, listings JSON and
HTML with limit / lastFileName / namePattern, PUT, POST raw and
multipart, mkdir, DELETE with recursive, the metrics port and its debug
routes), inline content, compression, manifests, the disk chunk cache,
path rules and a remote-mounted entry, and every rpc of `SeaweedFiler`.
The same requests go to both; answers are compared with file ids,
addresses and clocks masked.  Then a filer read of an `ec.encode`d volume
with two data shards gone, on the plain versions (`-ec.backend torch`).

One departure is pinned: a multipart POST to the reference's filer fails
(its `part.read(n)` is not aiohttp's `BodyPartReader.read` signature), the
port's stores the first part, as the reference's HTTP handler means to.
"""
import asyncio
import base64
import hashlib
import io
import json
import os
import re
from unittest import mock

import numpy as np
import pytest

from seaweedfs_tpu.filer.path_conf import FilerConf as RefFilerConf
from seaweedfs_tpu.filer.path_conf import PathConf as RefPathConf
from seaweedfs_tpu.pb import Stub as RefStub
from seaweedfs_tpu.pb import channel as ref_channel
from seaweedfs_tpu.pb import filer_pb2 as ref_fpb
from seaweedfs_tpu.repair import RepairConfig
from seaweedfs_tpu.server import cluster as ref_cluster_mod
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run
from seaweedfs_tpu.storage import backend as ref_backend
from seaweedfs_tpu_torch.filer.path_conf import FilerConf as PortFilerConf
from seaweedfs_tpu_torch.filer.path_conf import PathConf as PortPathConf
from seaweedfs_tpu_torch.pb import Stub as PortStub
from seaweedfs_tpu_torch.pb import channel as port_channel
from seaweedfs_tpu_torch.pb import filer_pb2 as port_fpb
from seaweedfs_tpu_torch.repair import RepairConfig as PortRepairConfig
from seaweedfs_tpu_torch.server.cluster import LocalCluster as PortCluster
from seaweedfs_tpu_torch.server.http import Client
from seaweedfs_tpu_torch.shell import CommandEnv as PortEnv
from seaweedfs_tpu_torch.shell import run_command as port_run
from seaweedfs_tpu_torch.storage import backend as port_backend

SEED = 20200
TEXT = ("the quick brown fox jumps over the lazy dog\n" * 400).encode()


class _Side:
    """One package's cluster with a filer, and the calls the tests make."""

    def __init__(self, kind: str, base: str, **filer_kwargs):
        self.kind = kind
        self.base = base
        self.filer_kwargs = {"max_mb": 1, **filer_kwargs}
        self.pb = port_fpb if kind == "port" else ref_fpb
        self.out = io.StringIO()

    async def start(self):
        if self.kind == "port":
            self.c = PortCluster(
                n_volume_servers=2, base_dir=self.base, pulse_seconds=1,
                ec_backend="torch",
                master_kwargs={"ec_repair": PortRepairConfig(enabled=False)},
                with_filer=True, filer_kwargs=self.filer_kwargs)
            await self.c.start()
            self.env = PortEnv([self.c.master.advertise_url], out=self.out)
        else:
            c = ref_cluster_mod.LocalCluster(
                base_dir=self.base, n_volume_servers=2, pulse_seconds=1,
                master_kwargs={"ec_repair": RepairConfig(enabled=False)},
                with_filer=True, filer_kwargs=self.filer_kwargs)
            await c.master.start()
            for spec in c._specs:
                vs = RefVolumeServer(masters=[c.master.advertise_url],
                                     port=0, grpc_port=0, **spec)
                await vs.start()
                c.volume_servers.append(vs)
                await c.wait_for_nodes(len(c.volume_servers))
            from seaweedfs_tpu.server.filer import FilerServer

            c.filer = FilerServer(masters=[c.master.advertise_url], port=0,
                                  grpc_port=0, **self.filer_kwargs)
            await c.filer.start()
            self.c = c
            self.env = RefEnv([c.master.advertise_url], out=self.out)
        self.f = self.c.filer
        self.stub = (PortStub if self.kind == "port" else RefStub)(
            (port_channel if self.kind == "port" else ref_channel)(
                f"{self.f.ip}:{self.f.grpc_port}"),
            self.pb, "SeaweedFiler")
        # the filer's master subscription lands a moment after its start
        await self.f.master_client.wait_connected(10)

    async def stop(self):
        await self.c.stop()

    async def http(self, method, path, headers=None, body=b"", port=None):
        cl = Client(self.f.ip, port or self.f.port)
        try:
            # a read that fails after its head went out leaves the
            # reference's connection open: bound the wait
            return await asyncio.wait_for(
                cl.request(method, path, headers=headers, body=body), 60)
        finally:
            await cl.close()

    async def sh(self, line):
        await (port_run if self.kind == "port" else ref_run)(self.env, line)


async def _both(tmp_path, fn, **filer_kwargs):
    """Run `fn(side)` on each package's cluster -> {kind: result}."""
    out = {}
    for kind in ("ref", "port"):
        side = _Side(kind, str(tmp_path / kind), **filer_kwargs)
        await side.start()
        try:
            out[kind] = await fn(side)
        finally:
            await side.stop()
    return out


_KEEP = ("Content-Type", "Content-Length", "Content-Range", "Accept-Ranges",
         "ETag", "Content-MD5", "Content-Disposition", "Cache-Control",
         "Allow", "Location")
_FID = re.compile(r"\b\d+,[0-9a-f]{9,}\b")


def _answer(resp, body_fn=None):
    status, headers, body = resp
    kept = {k: headers.get(k) for k in _KEEP if headers.get(k) is not None}
    return status, kept, body_fn(body) if body_fn else body


def _sha(body):
    return hashlib.sha256(body).hexdigest()


def _mask_listing(body):
    doc = json.loads(body)
    for e in doc.get("Entries", []):
        e["Mtime"] = e["Crtime"] = 0
    return doc


def _mask_html(body):
    return re.sub(rb"rendered [0-9: -]+|\d{4}-\d\d-\d\d \d\d:\d\d:\d\d",
                  b"<t>", body)


def _mask_entry(e, fids):
    """An Entry's bytes with clocks zeroed and file ids numbered by first
    appearance (the two clusters' fids differ)."""
    e = type(e).FromString(e.SerializeToString())
    e.attributes.mtime = e.attributes.crtime = 0
    for c in e.chunks:
        c.modified_ts_ns = 0
        c.file_id = fids.setdefault(c.file_id, f"f{len(fids)}")
        if c.cipher_key:
            c.cipher_key = b"k"
    return e.SerializeToString()


def _files(rng):
    return {
        "/docs/a.bin": rng.bytes(300_000),
        "/docs/big.bin": rng.bytes(2_500_000),  # three 1 MiB chunks
        "/docs/notes.txt": TEXT,  # compressible: stored compressed
        "/docs/sub/c.bin": rng.bytes(5_000),
        "/docs/empty.bin": b"",
    }


async def _write_tree(side):
    out = []
    for path, data in _files(np.random.default_rng(SEED)).items():
        mime = "text/plain" if path.endswith(".txt") else ""
        headers = {"Content-Type": mime} if mime else {}
        out.append(_answer(await side.http("PUT", path, headers, data)))
    return out


def test_http_routes_match_the_reference(tmp_path):
    files = _files(np.random.default_rng(SEED))
    big = files["/docs/big.bin"]

    async def routes(side):
        out = [await _write_tree(side)]
        out.append(_answer(await side.http("POST", "/docs/raw.bin",
                                           {"Content-Type": "application/octet-stream"},
                                           b"x" * 7000)))
        out.append(_answer(await side.http("POST", "/made/dir/")))
        for path in files:
            resp = await side.http("GET", path)
            out.append(_answer(resp, _sha))
            assert resp[2] == files[path], (side.kind, path)
            out.append(_answer(await side.http("HEAD", path)))
        for rng in ("bytes=0-99", "bytes=1048000-2097500", "bytes=-1000",
                    "bytes=2400000-", "bytes=9000000-", "bytes=5-3"):
            resp = await side.http("GET", "/docs/big.bin", {"Range": rng})
            out.append(_answer(resp, _sha))
        etag = (await side.http("HEAD", "/docs/a.bin"))[1].get("ETag")
        lm = (await side.http("HEAD", "/docs/a.bin"))[1].get("Last-Modified")
        out.append(_answer(await side.http(
            "GET", "/docs/a.bin", {"If-None-Match": etag})))
        out.append(_answer(await side.http(
            "GET", "/docs/a.bin", {"If-Modified-Since": lm})))
        out.append(_answer(await side.http(
            "GET", "/docs/a.bin", {"If-None-Match": '"nope"'}), _sha))
        for q in ("", "?limit=2", "?limit=2&lastFileName=a.bin",
                  "?namePattern=no*", "?limit=100&namePattern=b"):
            out.append(_answer(await side.http("GET", "/docs/" + q),
                               _mask_listing))
        out.append(_answer(await side.http(
            "GET", "/docs/?limit=3", {"Accept": "text/html"}), _mask_html))
        out.append(_answer(await side.http("GET", "/nope")))
        out.append(_answer(await side.http("PATCH", "/docs/a.bin")))
        out.append(_answer(await side.http("DELETE", "/docs")))
        out.append(_answer(await side.http("DELETE", "/docs/a.bin")))
        out.append(_answer(await side.http("GET", "/docs/a.bin")))
        out.append(_answer(await side.http("DELETE", "/docs?recursive=true")))
        out.append(_answer(await side.http("GET", "/docs/big.bin")))
        out.append(_answer(await side.http("GET", "/"), _mask_listing))
        # the metrics port: the filer's series and its debug routes
        st, _, body = await side.http("GET", "/metrics",
                                      port=side.f.metrics_port)
        series = sorted(set(re.findall(
            rb"^(SeaweedFS_filer_request_(?:total|seconds_count))\{type=\"(\w+)\"",
            body, re.M)))
        out.append((st, series))
        st, _, body = await side.http("GET", "/debug/traces?limit=2",
                                      port=side.f.metrics_port)
        out.append((st, type(json.loads(body)).__name__))
        out.append((await side.http("GET", "/debug/incident",
                                    port=side.f.metrics_port))[0])
        return out

    got = asyncio.run(_both(tmp_path, routes))
    assert got["port"] == got["ref"]
    assert len(big) == 2_500_000


def test_multipart_post_departs_from_the_reference(tmp_path):
    from seaweedfs_tpu_torch.operation.upload import multipart_body

    async def post(side):
        body, ctype = multipart_body(TEXT[:3000], "m.txt", "text/plain",
                                     False)
        resp = await side.http("POST", "/up/", {"Content-Type": ctype}, body)
        return resp[0], resp[2], await side.http("GET", "/up/m.txt")

    got = asyncio.run(_both(tmp_path, post))
    status, text, _ = got["ref"]
    assert status == 500 and b"chunk upload failed" in text
    status, text, (gst, gh, gbody) = got["port"]
    assert status == 201 and json.loads(text) == {"name": "m.txt",
                                                  "size": 3000}
    assert gst == 200 and gbody == TEXT[:3000]
    assert gh.get("Content-Type") == "text/plain"


def test_storage_options_match_the_reference(tmp_path):
    """Inline content (save_inside_limit), compression, a folded chunk
    manifest, the disk chunk cache, path rules and a remote-mounted entry
    of the `local` backend type."""
    remote_dir = tmp_path / "remote"
    remote_dir.mkdir()
    (remote_dir / "obj.bin").write_bytes(bytes(range(256)) * 40)

    async def options(side):
        fpb = side.pb
        out = []
        out.append(_answer(await side.http("PUT", "/i/small.txt", {}, b"tiny")))
        e = (await side.stub.LookupDirectoryEntry(
            fpb.LookupDirectoryEntryRequest(directory="/i", name="small.txt"))).entry
        out.append((bytes(e.content), len(e.chunks)))
        out.append(_answer(await side.http("PUT", "/i/n.txt",
                                           {"Content-Type": "text/plain"}, TEXT)))
        e = (await side.stub.LookupDirectoryEntry(
            fpb.LookupDirectoryEntryRequest(directory="/i", name="n.txt"))).entry
        out.append([c.is_compressed for c in e.chunks])
        st, _, body = await side.http("GET", "/i/n.txt")
        out.append((st, body == TEXT))
        st, _, body = await side.http("GET", "/i/n.txt", {"Range": "bytes=10-20"})
        out.append((st, body))

        # a manifest: 1001 views of one 100-byte needle fold into one
        # manifest chunk and one plain chunk, and read back through it
        needle = bytes(range(100))
        one = await side.f._upload_chunk(needle, 0, "n.bin")
        chunks = [fpb.FileChunk(file_id=one.file_id, offset=i * 100, size=100,
                                modified_ts_ns=i + 1, e_tag=one.e_tag)
                  for i in range(1001)]
        folded = await side.f._manifestize_async(chunks, "", "")
        out.append(sorted(c.is_chunk_manifest for c in folded))
        fil = __import__(("seaweedfs_tpu_torch" if side.kind == "port"
                          else "seaweedfs_tpu") + ".filer", fromlist=["x"])
        await side.f.filer.create_entry(fil.Entry(
            full_path="/i/m.bin", attr=fil.Attr(mode=0o644), chunks=folded))
        st, _, body = await side.http("GET", "/i/m.bin")
        out.append((st, body == needle * 1001))
        st, _, body = await side.http("GET", "/i/m.bin",
                                      {"Range": "bytes=99950-100049"})
        out.append((st, body))

        # path rules: a read-only prefix and a collection rule
        conf_cls, rule_cls = ((PortFilerConf, PortPathConf)
                              if side.kind == "port"
                              else (RefFilerConf, RefPathConf))
        conf = conf_cls()
        conf.upsert(rule_cls(location_prefix="/ro/", read_only=True))
        conf.upsert(rule_cls(location_prefix="/col/", collection="rulecol"))
        await side.stub.CreateEntry(fpb.CreateEntryRequest(
            directory="/etc/seaweedfs", entry=fpb.Entry(
                name="filer.conf", content=conf.to_bytes(),
                attributes=fpb.FuseAttributes(file_mode=0o644))))
        side.f._conf_cache = None
        out.append(_answer(await side.http("PUT", "/ro/x", {}, b"y")))
        resp = await side.stub.CreateEntry(fpb.CreateEntryRequest(
            directory="/ro", entry=fpb.Entry(name="z")))
        out.append(resp.error)
        resp = await side.stub.AssignVolume(fpb.AssignVolumeRequest(
            path="/ro/x", count=1))
        out.append(resp.error)
        resp = await side.stub.AssignVolume(fpb.AssignVolumeRequest(
            path="/col/x", count=1))
        out.append((resp.error, resp.collection, bool(resp.file_id)))

        # a remote-mounted entry read through the storage backend
        backend = port_backend if side.kind == "port" else ref_backend
        backend.configure({"local.rm": {"type": "local",
                                        "dir": str(remote_dir)}})
        await side.stub.CreateEntry(fpb.CreateEntryRequest(
            directory="/mnt", entry=fpb.Entry(
                name="obj.bin", extended={"remote.key": b"obj.bin",
                                          "remote.backend": b"local.rm"},
                attributes=fpb.FuseAttributes(file_mode=0o644,
                                              file_size=10240))))
        st, _, body = await side.http("GET", "/mnt/obj.bin")
        out.append((st, body == (remote_dir / "obj.bin").read_bytes()))
        st, _, body = await side.http("GET", "/mnt/obj.bin",
                                      {"Range": "bytes=300-310"})
        out.append((st, body))
        backend.clear_registry()

        # the disk tier of the chunk cache holds what a read fetched
        await side.http("PUT", "/i/c.bin", {}, needle * 50)
        await side.http("GET", "/i/c.bin")
        out.append(len(os.listdir(side.f.chunk_cache.disk_dir)) > 0)
        return out

    got = asyncio.run(_both(
        tmp_path, options, save_inside_limit=64,
        chunk_cache_dir=str(tmp_path / "cache")))
    assert got["port"] == got["ref"]


def test_filer_rpcs_match_the_reference(tmp_path):
    async def rpcs(side):
        fpb = side.pb
        stub = side.stub
        fids: dict = {}
        out = []
        await _write_tree(side)

        def masked(resp):
            if hasattr(resp, "entry"):
                return _mask_entry(resp.entry, fids)
            return resp.SerializeToString()

        out.append(masked(await stub.LookupDirectoryEntry(
            fpb.LookupDirectoryEntryRequest(directory="/docs", name="big.bin"))))
        try:
            await stub.LookupDirectoryEntry(fpb.LookupDirectoryEntryRequest(
                directory="/docs", name="nope"))
        except Exception as e:  # noqa: BLE001 — each package's RpcError
            out.append(e.code().name)
        for req in (dict(directory="/docs"), dict(directory="/docs", limit=2),
                    dict(directory="/docs", start_from_file_name="big.bin"),
                    dict(directory="/docs", start_from_file_name="big.bin",
                         inclusive_start_from=True, limit=1),
                    dict(directory="/docs", prefix="n")):
            out.append([_mask_entry(r.entry, fids) async for r in
                        stub.ListEntries(fpb.ListEntriesRequest(**req))])
        ent = fpb.Entry(name="r.bin", attributes=fpb.FuseAttributes(
            file_mode=0o644, file_size=3, mime="x/y"), content=b"abc")
        out.append(masked(await stub.CreateEntry(
            fpb.CreateEntryRequest(directory="/rpc", entry=ent))))
        out.append(masked(await stub.CreateEntry(
            fpb.CreateEntryRequest(directory="/rpc", entry=ent, o_excl=True))))
        ent2 = fpb.Entry(name="r.bin", attributes=fpb.FuseAttributes(
            file_mode=0o600, file_size=4), content=b"abcd")
        out.append(masked(await stub.UpdateEntry(
            fpb.UpdateEntryRequest(directory="/rpc", entry=ent2))))
        a = await side.f._upload_chunk(b"0123456789", 0, "p.bin")
        out.append(masked(await stub.AppendToEntry(fpb.AppendToEntryRequest(
            directory="/rpc", entry_name="p.bin", chunks=[a]))))
        st, _, body = await side.http("GET", "/rpc/p.bin")
        out.append((st, body))
        out.append(masked(await stub.AtomicRenameEntry(
            fpb.AtomicRenameEntryRequest(old_directory="/rpc", old_name="p.bin",
                                         new_directory="/rpc2", new_name="q.bin"))))
        out.append(masked(await stub.LookupDirectoryEntry(
            fpb.LookupDirectoryEntryRequest(directory="/rpc2", name="q.bin"))))
        out.append(masked(await stub.DeleteEntry(fpb.DeleteEntryRequest(
            directory="/", name="rpc2", is_recursive=False))))
        out.append(masked(await stub.DeleteEntry(fpb.DeleteEntryRequest(
            directory="/", name="rpc2", is_recursive=True,
            is_delete_data=True))))
        out.append(masked(await stub.DeleteEntry(fpb.DeleteEntryRequest(
            directory="/", name="gone"))))
        resp = await stub.AssignVolume(fpb.AssignVolumeRequest(
            count=2, collection="c1", ttl_sec=3600))
        out.append((resp.count, resp.collection, resp.error,
                    bool(resp.location.url), bool(resp.file_id)))
        vid = a.file_id.split(",")[0]
        resp = await stub.LookupVolume(fpb.LookupVolumeRequest(
            volume_ids=[vid, a.file_id]))
        out.append(sorted((k == vid, len(v.locations)) for k, v in
                          resp.locations_map.items()))
        resp = await stub.CollectionList(fpb.CollectionListRequest(
            include_normal_volumes=True))
        out.append(sorted(c.name for c in resp.collections))
        await asyncio.sleep(2.2)  # the master's sizes follow a pulse later
        resp = await stub.Statistics(fpb.StatisticsRequest())
        out.append((resp.file_count > 0, resp.used_size > 0))
        out.append(masked(await stub.DeleteCollection(
            fpb.DeleteCollectionRequest(collection="c1"))))
        resp = await stub.GetFilerConfiguration(
            fpb.GetFilerConfigurationRequest())
        out.append((resp.max_mb, resp.collection, resp.replication,
                    resp.dir_buckets, len(resp.masters)))
        out.append(masked(await stub.KvPut(fpb.KvPutRequest(key=b"k",
                                                            value=b"v"))))
        out.append(masked(await stub.KvGet(fpb.KvGetRequest(key=b"k"))))
        out.append(masked(await stub.KvGet(fpb.KvGetRequest(key=b"none"))))

        events = []

        async def take():
            async for ev in stub.SubscribeMetadata(
                    fpb.SubscribeMetadataRequest(client_name="t",
                                                 path_prefix="/rpc")):
                note = ev.event_notification
                events.append((ev.directory,
                               note.old_entry.name if note.HasField("old_entry") else "",
                               note.new_entry.name if note.HasField("new_entry") else "",
                               note.new_parent_path))
                if len(events) == 5:
                    return

        await asyncio.wait_for(take(), 10)
        out.append(events)
        return out

    got = asyncio.run(_both(tmp_path, rpcs))
    assert got["port"] == got["ref"]


def test_a_filer_read_of_an_encoded_volume_with_two_shards_gone(tmp_path):
    """Files written through the filer into one volume, the volume
    `ec.encode`d and spread, two data shards deleted on their holders:
    every file and a Range across two chunks read back through the port's
    filer equal to what was written, and its volume servers served the
    degraded chunks.  (The reference's volume servers, run after other
    clusters in one process, can find no peer for their survivors, so the
    written bytes are the oracle here.)"""
    from seaweedfs_tpu_torch import stats

    def degraded_reads():
        """The port's reconstructs so far (each is a memo miss)."""
        for line in stats.generate_latest(stats.REGISTRY).decode().splitlines():
            if line.startswith('SeaweedFS_volumeServer_ec_degraded_memo_total'
                               '{result="miss"}'):
                return float(line.rpartition(" ")[2])
        return 0.0

    async def degraded(side):
        rng = np.random.default_rng(SEED + 1)
        files = {f"/ec/d{i % 3}/f{i:02d}.bin": rng.bytes(int(
            np.exp(rng.uniform(np.log(4000), np.log(300_000)))))
            for i in range(16)}
        files["/ec/big.bin"] = rng.bytes(2_300_000)
        # one volume for every file: grow it first, then point the filer's
        # collection at it
        st, _, _ = await Client(side.c.master.ip, side.c.master.port).request(
            "GET", "/vol/grow?count=1&collection=ec20")
        assert st == 200
        side.f.collection = "ec20"
        for _ in range(100):
            if side.c.master.topo.lookup_volume("ec20", 1) or any(
                    vs.store.find_volume(1) for vs in side.c.volume_servers):
                break
            await asyncio.sleep(0.05)
        for path, data in files.items():
            st, _, _ = await side.http("PUT", path, {}, data)
            assert st == 201
        vids = set()
        for path in files:
            d, _, n = path.rpartition("/")
            e = (await side.stub.LookupDirectoryEntry(
                side.pb.LookupDirectoryEntryRequest(directory=d, name=n))).entry
            vids |= {int(c.file_id.split(",")[0]) for c in e.chunks}
        assert len(vids) == 1
        vid = vids.pop()
        await asyncio.sleep(1.5)  # a pulse carries the volume's size
        await side.sh(f"lock")
        await side.sh(f"ec.encode -volumeId {vid}")
        await side.sh("unlock")
        # the master lists every shard once, spread (a loaded host's
        # heartbeats can take long; a read before the listing finds no
        # peer for the survivors)
        for _ in range(600):
            locs = side.c.master.topo.lookup_ec_shards(vid)
            if locs is not None and all(
                    len(n) == 1 for n in locs.locations) and sum(
                    len(n) for n in locs.locations) == 14:
                break
            await asyncio.sleep(0.1)
        else:
            raise AssertionError(f"the spread of volume {vid} was not "
                                 f"listed: {locs and locs.locations}")
        # the servers' cached shard maps may predate the spread
        for vs in side.c.volume_servers:
            vs._ec_locations.clear()
        # two data shards gone on their holders
        gone = []
        for shard in (0, 1):
            for vs in side.c.volume_servers:
                ev = vs.store.find_ec_volume(vid)
                if ev is not None and shard in ev.shards:
                    path = ev.shards[shard].path
                    vs.store.unmount_ec_shards(vid, [shard])
                    os.remove(path)
                    gone.append(shard)
        assert gone == [0, 1]
        side.f.chunk_cache = type(side.f.chunk_cache)(mem_limit_bytes=0)
        before = degraded_reads()
        out = []
        for path, data in files.items():
            st, _, body = await side.http("GET", path)
            out.append((path, st, hashlib.sha256(body).hexdigest()))
            assert body == data, (side.kind, path)
        st, _, body = await side.http("GET", "/ec/big.bin",
                                      {"Range": "bytes=1048000-2097200"})
        out.append((st, body == files["/ec/big.bin"][1048000:2097201]))
        assert degraded_reads() > before
        return out

    async def port_only():
        side = _Side("port", str(tmp_path / "port"))
        await side.start()
        try:
            return await degraded(side)
        finally:
            await side.stop()

    got = asyncio.run(port_only())
    assert len(got) == 18 and all(st == 200 for _, st, _ in got[:17])
    assert got[17] == (206, True)


# ------------------------------------------------- the HTTP layer's additions


def _raw_exchange(handler, request: bytes) -> bytes:
    """Serve `handler` on a bare HTTPServer, send `request` bytes as they
    are, -> everything the server answered before it closed."""
    from seaweedfs_tpu_torch.server.http import HTTPServer

    async def go():
        srv = HTTPServer(handler, client_max_size=None)
        await srv.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           srv.port)
            writer.write(request)
            await writer.drain()
            out = await asyncio.wait_for(reader.read(-1), 10)
            writer.close()
            return out
        finally:
            await srv.stop()

    return asyncio.run(go())


def test_the_body_reads_piece_by_piece_with_no_cap():
    """A chunked body far past the volume server's cap is read by
    `request.content` in pieces of at most the asked size; so is a
    Content-Length body behind `Expect: 100-continue`."""
    from seaweedfs_tpu_torch.server.http import Response

    data = np.random.default_rng(1).bytes(3_000_000)
    pieces = []

    async def handler(req):
        h = hashlib.sha256()
        while piece := await req.content.read(65536):
            assert len(piece) <= 65536
            pieces.append(len(piece))
            h.update(piece)
        return Response(body=h.hexdigest().encode())

    chunked = b"".join(b"%x\r\n%s\r\n" % (len(c), c) for c in (
        data[i:i + 700_001] for i in range(0, len(data), 700_001))) + b"0\r\n\r\n"
    out = _raw_exchange(handler, b"PUT /x HTTP/1.1\r\nHost: h\r\n"
                        b"Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n"
                        + chunked)
    assert out.startswith(b"HTTP/1.1 200 ")
    assert out.endswith(hashlib.sha256(data).hexdigest().encode())
    assert len(pieces) > 3_000_000 // 65536
    out = _raw_exchange(handler, b"PUT /x HTTP/1.1\r\nHost: h\r\n"
                        b"Content-Length: %d\r\nExpect: 100-continue\r\n"
                        b"Connection: close\r\n\r\n" % len(data) + data)
    assert out.startswith(b"HTTP/1.1 100 Continue\r\n\r\nHTTP/1.1 200 ")
    assert out.endswith(hashlib.sha256(data).hexdigest().encode())


@pytest.mark.parametrize("piece", [1, 7, 4096])
def test_multipart_parts_read_piece_by_piece(piece):
    """Parts of a form whose data holds near-delimiters, read `piece`
    bytes at a time: names, filenames, headers and bytes as sent."""
    from seaweedfs_tpu_torch.server.http import Response

    boundary = "b0undary"
    tricky = b"--b0undar\r\n\r\n--b0undarZ\r\n-" + bytes(range(256)) * 9
    body = (f"preamble\r\n--{boundary}\r\n"
            'Content-Disposition: form-data; name="file"; filename="t.bin"\r\n'
            "Content-Type: application/x-t\r\n\r\n").encode() + tricky + (
        f"\r\n--{boundary}\r\nContent-Disposition: form-data; name=f2\r\n\r\n"
        f"two\r\n--{boundary}--\r\n").encode()
    seen = []

    async def handler(req):
        mp = await req.multipart()
        while (part := await mp.next()) is not None:
            got = b""
            while p := await part.read(piece):
                assert len(p) <= piece
                got += p
            seen.append((part.name, part.filename,
                         part.headers.get("Content-Type"), got))
        return Response(body=b"ok")

    out = _raw_exchange(handler, (
        f"POST /x HTTP/1.1\r\nHost: h\r\nContent-Type: multipart/form-data; "
        f'boundary="{boundary}"\r\nContent-Length: {len(body)}\r\n'
        "Connection: close\r\n\r\n").encode() + body)
    assert out.startswith(b"HTTP/1.1 200 ")
    assert seen == [("file", "t.bin", "application/x-t", tricky),
                    ("f2", None, None, b"two")]


def test_a_streamed_answer_cut_short_closes_the_connection():
    """A StreamResponse whose handler fails after its head went out ends
    the connection instead of sending a second answer; a whole one keeps
    it for the next request."""
    from seaweedfs_tpu_torch.server.http import StreamResponse

    async def handler(req):
        resp = StreamResponse(200, headers={"Content-Length": "10"})
        await resp.prepare(req)
        await resp.write(b"01234")
        if req.path == "/fail":
            raise RuntimeError("a chunk fetch failed")
        await resp.write(b"56789")
        await resp.write_eof()
        return resp

    out = _raw_exchange(handler, b"GET /ok HTTP/1.1\r\nHost: h\r\n\r\n"
                        b"GET /fail HTTP/1.1\r\nHost: h\r\n\r\n")
    first, _, rest = out.partition(b"0123456789")
    assert first.startswith(b"HTTP/1.1 200 OK\r\n")
    assert b"Connection: keep-alive" in first
    assert rest.startswith(b"HTTP/1.1 200 OK\r\n") and rest.endswith(b"01234")
    assert b"HTTP/1.1 500" not in out


def test_a_derived_rpc_port_past_65535_falls_back_to_a_free_one():
    """As the port's volume server does: a filer on an HTTP port above
    55535 serves its RPCs on a free port and advertises host:port.grpc;
    an RPC port given explicitly is never replaced."""
    import socket

    from seaweedfs_tpu_torch.server.filer import FilerServer

    for port in range(60000, 65536):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
                break
            except OSError:
                continue

    async def go():
        fs = FilerServer(masters=["127.0.0.1:1"], port=port,
                         metrics_port=None)
        await fs.start()
        try:
            assert fs.port == port and 0 < fs.grpc_port <= 65535
            assert fs.advertise_url == f"127.0.0.1:{port}.{fs.grpc_port}"
        finally:
            await fs.stop()
        fs = FilerServer(masters=["127.0.0.1:1"], port=0, grpc_port=70000,
                         metrics_port=None)
        with pytest.raises(OverflowError):
            await fs.start()
        await fs.stop()

    asyncio.run(go())
