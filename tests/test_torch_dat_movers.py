"""The port's `.dat` movers held against the JAX package's, on the CPU.

The movers replace or stream a volume's `.dat`: the tier moves
(storage/backend.py's local type, Store.tier_move_to_remote /
tier_move_from_remote and the volume server's VolumeTierMoveDatToRemote /
VolumeTierMoveDatFromRemote rpcs), and VolumeCopy.  The same seeded
needles go through both packages with the clock frozen, so the files are
the same bytes; statuses and bodies are compared with no tolerance.

Two departures are pinned:
  - each tier move and each VolumeCopy invalidates the volume's ingest
    pipeline (the reference's leave it valid), so the next seal runs
    offline; after a tier round trip the .dat is the same bytes, so the
    shards equal the reference's and write_ec_files' either way;
  - VolumeCopy onto a vid the server already holds is refused with
    FAILED_PRECONDITION before anything is pulled.  The reference pulls the
    files under the mounted volume, whose reads keep the old inode: a
    needle only the source holds is 404 on the destination after its
    "copy", while the destination's .dat on disk is the source's.
"""
import asyncio
import functools
import os
import shutil
import time

import numpy as np
import pytest

from seaweedfs_tpu.ingest import IngestConfig as JaxIngestConfig
from seaweedfs_tpu.ingest import IngestPlane as JaxIngestPlane
from seaweedfs_tpu.ingest import pipeline as jax_pipeline
from seaweedfs_tpu.pb import Stub as RefStub
from seaweedfs_tpu.pb import channel as ref_channel
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vpb
from seaweedfs_tpu.server import volume as jax_server_volume
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu.storage import backend as jax_backend
from seaweedfs_tpu.storage import disk_location as jax_dl
from seaweedfs_tpu.storage import needle as jax_needle
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu.storage.ec import encoder as jax_encoder
from seaweedfs_tpu_torch.ingest import IngestConfig, IngestPlane
from seaweedfs_tpu_torch.ingest import pipeline as port_pipeline
from seaweedfs_tpu_torch.pb import RpcError
from seaweedfs_tpu_torch.pb import Stub as PortStub
from seaweedfs_tpu_torch.pb import channel as port_channel
from seaweedfs_tpu_torch.pb import volume_server_pb2 as port_vpb
from seaweedfs_tpu_torch.server import volume as server_volume
from seaweedfs_tpu_torch.server.http import Client
from seaweedfs_tpu_torch.storage import backend as port_backend
from seaweedfs_tpu_torch.storage import disk_location as port_dl
from seaweedfs_tpu_torch.storage import ec as port_ec
from seaweedfs_tpu_torch.storage import needle as port_needle
from seaweedfs_tpu_torch.storage import store as port_store
from seaweedfs_tpu_torch.storage import types as port_t
from seaweedfs_tpu_torch.storage import volume as port_volume

SEED = 1717
VID = 7
FROZEN_S = 1_760_000_000
# the small stripe geometry of tests/test_torch_ingest.py: 1024x shrunk
SMALL = 1024
LARGE = 8192
ROW = 10 * SMALL
STREAMABLE = 10 * LARGE
DEADLINE_S = 30.0

PKGS = {
    "jax": dict(volume=jax_volume, needle=jax_needle, store=jax_store,
                dl=jax_dl, backend=jax_backend),
    "torch": dict(volume=port_volume, needle=port_needle, store=port_store,
                  dl=port_dl, backend=port_backend),
}


class _FrozenTime:
    """`time` with the wall clock stopped, so both packages stamp the same
    last_modified and append_at_ns into the same needles."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return float(FROZEN_S)

    @staticmethod
    def time_ns():
        return FROZEN_S * 10**9


@pytest.fixture
def frozen_clock(monkeypatch):
    for mod in (port_needle, jax_needle, server_volume, jax_server_volume):
        monkeypatch.setattr(mod, "time", _FrozenTime())


@pytest.fixture
def small_geometry(monkeypatch):
    """The stripe geometry shrunk 1024x in both packages' ingest
    pipelines, and their Store's offline seal at the same geometry."""
    for mod in (jax_pipeline, port_pipeline):
        monkeypatch.setattr(mod, "SMALL_BLOCK_SIZE", SMALL)
        monkeypatch.setattr(mod, "LARGE_BLOCK_SIZE", LARGE)
        monkeypatch.setattr(mod, "ROW_BYTES", ROW)
        monkeypatch.setattr(mod, "STREAMABLE_BYTES", STREAMABLE)
    for mod in (jax_store, port_store):
        monkeypatch.setattr(mod, "write_ec_files", functools.partial(
            mod.write_ec_files, large_block=LARGE, small_block=SMALL))


@pytest.fixture
def registries():
    """Both packages' backend registries emptied before and after."""
    for b in (jax_backend, port_backend):
        b.clear_registry()
    yield
    for b in (jax_backend, port_backend):
        b.clear_registry()


def _bodies(seed: int, total: int, lo: int = 300, hi: int = 3000) -> list:
    rng = np.random.default_rng(seed)
    out = []
    while sum(len(b) for b in out) < total:
        out.append(rng.integers(0, 256, int(rng.integers(lo, hi)),
                                np.uint8).tobytes())
    return out


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _store_with_volume(pkg: str, d, n_needles: int = 12, seed: int = SEED):
    """A Store over `d` holding a read-only volume VID of seeded needles
    with pinned stamps: -> (store, {nid: body})."""
    m = PKGS[pkg]
    os.makedirs(d, exist_ok=True)
    v = m["volume"].Volume(str(d), VID)
    payloads = {}
    for k, body in enumerate(_bodies(seed, n_needles * 1000)[:n_needles]):
        nid = k + 1
        v.append_needle(m["needle"].Needle(
            id=nid, cookie=0xABC, data=body, last_modified=FROZEN_S,
            append_at_ns=FROZEN_S * 10**9 + k))
        payloads[nid] = body
    v.read_only = True
    loc = m["dl"].DiskLocation(str(d), max_volume_count=4)
    loc.volumes[VID] = v
    kwargs = {"ec_backend": "numpy" if pkg == "jax" else "torch"}
    return m["store"].Store([loc], **kwargs), payloads


# ------------------------------------------------------------ the backend


def test_local_backend_matches_the_reference(tmp_path, registries):
    """Upload, size, ranged read, listing, download and delete on both
    packages' local backend give the same answers."""
    src = tmp_path / "f.dat"
    src.write_bytes(bytes(range(256)) * 40)
    seen = {}
    for pkg in ("jax", "torch"):
        b = PKGS[pkg]["backend"].LocalBackendStorage(
            "default", str(tmp_path / pkg / "store"))
        got = [b.upload(str(src), "1.dat"), b.size("1.dat"),
               b.pread("1.dat", 10, 20), b.list_keys(), b.get_bytes("1.dat")]
        b.put_bytes("sub/2.dat", b"two")
        got.append(b.list_keys("sub"))
        dst = tmp_path / pkg / "back.dat"
        b.download("1.dat", str(dst))
        got.append(dst.read_bytes())
        b.delete_key("1.dat")
        b.delete_key("1.dat")  # absent: no error
        with pytest.raises(FileNotFoundError):
            b.size("1.dat")
        with pytest.raises(ValueError):
            b.pread("../escape", 1, 0)
        seen[pkg] = got
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] == 10240 and seen["torch"][-1] == src.read_bytes()


def test_registry_and_the_s3_refusal(tmp_path, registries):
    """configure() registers a local section under "type.id" in both
    packages; an unknown name is a KeyError in both.  An s3 section is a
    ValueError naming A10 in the port (it has no S3 client yet), where the
    reference builds its client."""
    for pkg in ("jax", "torch"):
        b = PKGS[pkg]["backend"]
        b.configure({"local.cold": {"type": "local",
                                    "dir": str(tmp_path / pkg / "cold")}})
        assert b.get_backend("local", "cold").name == "local.cold"
        with pytest.raises(KeyError):
            b.get_backend("local", "nope")
        with pytest.raises(ValueError):
            b.configure({"ftp.x": {"type": "ftp"}})
    with pytest.raises(ValueError, match="A10"):
        port_backend.configure({"s3.cold": {
            "type": "s3", "endpoint": "127.0.0.1:1", "bucket": "tier"}})
    with pytest.raises(KeyError):
        port_backend.get_backend("s3", "cold")


# ------------------------------------------------------------ the Store


def test_keep_local_stays_tiered_and_read_only(tmp_path, registries):
    """keep_local_dat_file: both packages serve the local copy, refuse a
    write, a writable mark and a vacuum, and tier-download it back."""
    seen = {}
    for pkg in ("jax", "torch"):
        m = PKGS[pkg]
        m["backend"].configure({"local.default": {
            "type": "local", "dir": str(tmp_path / pkg / "tier")}})
        store, payloads = _store_with_volume(pkg, tmp_path / pkg / "v")
        size = store.tier_move_to_remote(VID, "local.default", keep_local=True)
        v = store.find_volume(VID)
        assert os.path.exists(v.dat_path) and v.remote_dat is None
        assert v.is_tiered and v.read_only
        with pytest.raises(m["volume"].VolumeReadOnly):
            v.write(999, 0xABC, b"divergence")
        with pytest.raises(m["volume"].VolumeReadOnly):
            v.delete(1)
        with pytest.raises(ValueError):
            store.mark_volume_readonly(VID, read_only=False)
        with pytest.raises(ValueError):
            store.vacuum_volume(VID)
        back = store.tier_move_from_remote(VID)
        v2 = store.find_volume(VID)
        assert not v2.is_tiered and v2.read_only
        assert os.listdir(tmp_path / pkg / "tier") == []
        seen[pkg] = (size, back, {nid: bytes(v2.read(nid, 0xABC).data)
                                  for nid in payloads},
                     _read(v2.dat_path), _read(v2.idx_path))
        store.close()
    assert seen["torch"] == seen["jax"]


def test_replicas_use_distinct_backend_keys(tmp_path, registries):
    """Two stores tiering the same vid to one backend hold two objects;
    one replica's download (which deletes its object) leaves the other's
    serving, in both packages."""
    seen = {}
    for pkg in ("jax", "torch"):
        m = PKGS[pkg]
        tier = tmp_path / pkg / "tier"
        m["backend"].configure({"local.default": {"type": "local",
                                                  "dir": str(tier)}})
        s1, _ = _store_with_volume(pkg, tmp_path / pkg / "r1")
        s2, p2 = _store_with_volume(pkg, tmp_path / pkg / "r2")
        s1.port, s2.port = 8081, 8082
        s1.tier_move_to_remote(VID, "local.default")
        s2.tier_move_to_remote(VID, "local.default")
        keys = sorted(os.listdir(tier))
        s1.tier_move_from_remote(VID)
        v2 = s2.find_volume(VID)
        assert v2.remote_dat is not None
        seen[pkg] = (keys, sorted(os.listdir(tier)),
                     {nid: bytes(v2.read(nid, 0xABC).data) for nid in p2})
        s1.close()
        s2.close()
    assert seen["torch"] == seen["jax"]
    assert len(seen["torch"][0]) == 2 and len(seen["torch"][1]) == 1


def test_a_volume_tiered_by_the_reference_opens_in_the_port(
        tmp_path, registries):
    """The reference tiers a volume (only the .idx and .vif stay); the
    port's DiskLocation finds it by its .vif, serves every needle from the
    tier and scans the same records; writes are refused."""
    jax_backend.configure({"local.default": {
        "type": "local", "dir": str(tmp_path / "tier")}})
    port_backend.configure({"local.default": {
        "type": "local", "dir": str(tmp_path / "tier")}})
    store, payloads = _store_with_volume("jax", tmp_path / "v", n_needles=20)
    store.tier_move_to_remote(VID, "local.default")
    ref_v = store.find_volume(VID)
    assert {f"{VID}.idx", f"{VID}.vif"} <= set(os.listdir(tmp_path / "v"))
    assert not os.path.exists(ref_v.dat_path)
    loc = port_dl.DiskLocation(str(tmp_path / "v"), max_volume_count=4)
    loc.load_existing_volumes()
    v = loc.volumes[VID]
    assert v.remote_dat is not None and v.read_only and v.is_tiered
    for nid, body in payloads.items():
        n = v.read(nid, 0xABC)
        assert bytes(n.data) == body == bytes(ref_v.read(nid, 0xABC).data)
        # the zero-copy read is one ranged read of the tier too
        assert bytes(v.read(nid, 0xABC, zero_copy=True).data) == body
    assert ([(off, n.id, bytes(n.data)) for off, n in v.scan()]
            == [(off, n.id, bytes(n.data)) for off, n in ref_v.scan()])
    assert v.content_size == ref_v.content_size
    assert v.info().__dict__ == ref_v.info().__dict__
    with pytest.raises(port_volume.VolumeReadOnly):
        v.write(99, 1, b"x")
    with pytest.raises(port_volume.VolumeReadOnly):
        v.update_replica_placement(port_t.ReplicaPlacement.parse("001"))
    loc.close()
    store.close()


# ------------------------------------------------------------ the servers


def _stub(kind: str, vs):
    stub_cls, chan, vpb = ((PortStub, port_channel, port_vpb)
                           if kind == "port"
                           else (RefStub, ref_channel, ref_vpb))
    return stub_cls(chan(vs.grpc_url), vpb, "VolumeServer"), vpb


def _server(kind: str, d, tier=None, ingest: bool = False):
    tier_backends = ({"local.default": {"type": "local", "dir": str(tier)}}
                     if tier else None)
    if kind == "port":
        return server_volume.VolumeServer(
            [], [str(d)], port=0, ec_backend="torch",
            tier_backends=tier_backends,
            ec_ingest=IngestConfig(backend="torch", enabled=ingest))
    return RefVolumeServer(
        masters=[], directories=[str(d)], port=0, grpc_port=0,
        ec_backend="numpy", tier_backends=tier_backends,
        ec_ingest=JaxIngestConfig(backend="cpu", enabled=ingest))


async def _start(kind: str, vs) -> None:
    if kind == "port":
        await vs.start()
    else:
        await vs.start(heartbeat=False)


async def _code(call) -> str:
    """The status name an awaited rpc ended with ("OK" if it returned)."""
    try:
        r = call()
        if hasattr(r, "__aiter__"):
            async for _ in r:
                pass
        else:
            await r
    except RpcError as e:
        return e.code().name
    except Exception as e:  # the reference's grpc.aio.AioRpcError
        return e.code().name
    return "OK"


async def _post_all(c: Client, fids: list, bodies: list) -> list:
    out = []
    for fid, body in zip(fids, bodies):
        st, _, _ = await c.request(
            "POST", "/" + fid, {"Content-Type": "application/octet-stream"},
            body)
        out.append(st)
    return out


async def _get_all(c: Client, fids: list) -> list:
    out = []
    for fid in fids:
        st, _, body = await c.request("GET", "/" + fid)
        out.append((st, body if st == 200 else None))
    return out


def test_tier_rpcs_match_the_reference(tmp_path, frozen_clock, registries):
    """Both packages' servers: needles POSTed, then the tier rpcs'
    refusals (a writable volume, an unknown backend, a download of a
    volume not tiered), VolumeMarkReadonly, VolumeTierMoveDatToRemote,
    every GET from the tier and a refused POST, VolumeTierMoveDatFromRemote
    and every GET again.  Statuses, bodies, the tier object and the .dat
    after the round trip are the same bytes."""
    bodies = _bodies(SEED + 1, 40_000)
    fids = [port_t.format_fid(VID, i, 0x5eed + i)
            for i in range(1, len(bodies) + 1)]

    async def one(kind: str) -> dict:
        d = tmp_path / kind
        vs = _server(kind, d / "v", tier=d / "tier")
        vs.store.add_volume(VID)
        await _start(kind, vs)
        out = {}
        c = Client("127.0.0.1", vs.port)
        try:
            stub, vpb = _stub(kind, vs)
            out["posts"] = await _post_all(c, fids, bodies)
            dat = vs.store.find_volume(VID).dat_path
            out["dat"] = _read(dat)
            to_remote = functools.partial(
                stub.VolumeTierMoveDatToRemote,
                vpb.VolumeTierMoveDatToRemoteRequest(
                    volume_id=VID, destination_backend_name="local.default"))
            out["writable"] = await _code(to_remote)
            await stub.VolumeMarkReadonly(
                vpb.VolumeMarkReadonlyRequest(volume_id=VID))
            out["unknown"] = await _code(functools.partial(
                stub.VolumeTierMoveDatToRemote,
                vpb.VolumeTierMoveDatToRemoteRequest(
                    volume_id=VID, destination_backend_name="local.nope")))
            out["not_tiered"] = await _code(functools.partial(
                stub.VolumeTierMoveDatFromRemote,
                vpb.VolumeTierMoveDatFromRemoteRequest(volume_id=VID)))
            out["no_volume"] = await _code(functools.partial(
                stub.VolumeTierMoveDatFromRemote,
                vpb.VolumeTierMoveDatFromRemoteRequest(volume_id=VID + 1)))
            up = [r async for r in to_remote()]
            out["up"] = [(r.processed, r.processedPercentage) for r in up]
            out["again"] = await _code(to_remote)
            out["local_dat"] = os.path.exists(dat)
            (key,) = os.listdir(d / "tier")
            out["object"] = _read(d / "tier" / key)
            out["tiered_gets"] = await _get_all(c, fids)
            st, _, _ = await c.request(
                "POST", "/" + port_t.format_fid(VID, 999, 1),
                {"Content-Type": "application/octet-stream"}, b"refused")
            out["tiered_post"] = st
            st, _, _ = await c.request("DELETE", "/" + fids[0])
            out["tiered_delete"] = st
            down = [r async for r in stub.VolumeTierMoveDatFromRemote(
                vpb.VolumeTierMoveDatFromRemoteRequest(volume_id=VID))]
            out["down"] = [(r.processed, r.processedPercentage) for r in down]
            out["tier_left"] = os.listdir(d / "tier")
            out["dat_back"] = _read(dat)
            out["gets"] = await _get_all(c, fids)
            status = await stub.VolumeStatus(
                vpb.VolumeStatusRequest(volume_id=VID))
            out["read_only"] = status.is_read_only
        finally:
            await c.close()
            await vs.stop()
        return out

    port = asyncio.run(one("port"))
    ref = asyncio.run(one("ref"))
    assert port == ref
    assert set(port["posts"]) == {200}
    assert port["tiered_post"] >= 400 and port["tiered_delete"] >= 400
    assert port["writable"] == port["unknown"] == "FAILED_PRECONDITION"
    assert port["not_tiered"] == port["no_volume"] == "FAILED_PRECONDITION"
    assert port["again"] == "FAILED_PRECONDITION"
    assert port["up"] == [(len(port["dat"]), 100.0)]
    assert not port["local_dat"] and port["object"] == port["dat"]
    want = [(200, b) for b in bodies]
    assert port["tiered_gets"] == want and port["gets"] == want
    assert port["dat_back"] == port["dat"] and port["tier_left"] == []
    assert port["read_only"] is True


def _seal_shards(base: str) -> list:
    return [_read(base + port_ec.to_ext(i)) for i in range(14)]


def _oracle_shards(tmp_path, dat: str, name: str) -> list:
    """The reference's write_ec_files of a copy of `dat`."""
    oracle = str(tmp_path / name)
    shutil.copyfile(dat, oracle + ".dat")
    jax_encoder.write_ec_files(oracle, backend="cpu", large_block=LARGE,
                               small_block=SMALL)
    return _seal_shards(oracle)


def _stream(pkg: str, d, n_rows: int = 6):
    """A Store over `d` with an ingest plane, a volume streamed by
    `n_rows` stripe rows at least: -> (store, volume, pipeline)."""
    m = PKGS[pkg]
    os.makedirs(d, exist_ok=True)
    store = m["store"].Store([m["dl"].DiskLocation(str(d))],
                             ec_backend="numpy" if pkg == "jax" else "torch")
    store.ingest = (JaxIngestPlane(JaxIngestConfig(backend="cpu"))
                    if pkg == "jax"
                    else IngestPlane(IngestConfig(backend="torch")))
    v = store.add_volume(VID)
    for k, body in enumerate(_bodies(SEED + 2, n_rows * ROW + ROW // 2)):
        store.write_needle(VID, m["needle"].Needle(
            id=k + 1, cookie=0x77, data=body, last_modified=FROZEN_S,
            append_at_ns=FROZEN_S * 10**9 + k))
        store.ingest.on_write(v, len(body), "interactive")
    p = store.ingest.pipelines[VID]
    t_end = time.monotonic() + DEADLINE_S
    while p.encoded_rows < p.staged_rows and time.monotonic() < t_end:
        time.sleep(0.01)
    assert p.valid and p.encoded_rows >= n_rows
    return store, v, p


def test_a_tier_round_trip_invalidates_the_pipeline_and_seals_offline(
        tmp_path, small_geometry, registries):
    """A volume whose stripe rows streamed goes to the local tier and
    back.  In the port the upload leaves the pipeline invalid with
    TIER_UPLOAD, the download with TIER_DOWNLOAD, and the seal runs
    offline; the reference's pipeline stays valid and its seal streams.
    The .dat is the same bytes after the round trip, so both packages'
    14 shards equal write_ec_files of it."""
    seen = {}
    for pkg in ("jax", "torch"):
        m = PKGS[pkg]
        m["backend"].configure({"local.default": {
            "type": "local", "dir": str(tmp_path / pkg / "tier")}})
        store, v, p = _stream(pkg, tmp_path / pkg / "v")
        try:
            before = _read(v.dat_path)
            store.mark_volume_readonly(VID)
            store.tier_move_to_remote(VID, "local.default")
            up = (p.valid, p.invalid_reason)
            reads = {nid: bytes(store.read_needle(VID, nid).data)
                     for nid in (1, 5, 9)}
            store.tier_move_from_remote(VID)
            down = (p.valid, p.invalid_reason)
            sealed = store.ingest.seal  # the plane's own verdict
            streamed = []
            store.ingest.seal = lambda *a, **kw: streamed.append(
                sealed(*a, **kw)) or streamed[-1]
            store.ec_generate(VID)
            base = v.dat_path[:-4]
            seen[pkg] = dict(up=up, down=down, streamed=streamed,
                             reads=reads, dat=_read(base + ".dat"),
                             shards=_seal_shards(base),
                             ecx=_read(base + ".ecx"))
            assert seen[pkg]["dat"] == before
        finally:
            store.close()
    port, ref = seen["torch"], seen["jax"]
    assert port["up"] == (False, port_store.TIER_UPLOAD)
    assert port["down"] == (False, port_store.TIER_DOWNLOAD)
    assert port["streamed"] == [False]
    assert ref["up"] == ref["down"] == (True, None)  # the reference's
    assert ref["streamed"] == [True]
    want = _oracle_shards(tmp_path, tmp_path / "torch" / "v" / f"{VID}.dat",
                          "oracle")
    assert port["shards"] == want and ref["shards"] == want
    for k in ("reads", "dat", "ecx"):
        assert port[k] == ref[k], k


def test_volume_copy_onto_an_empty_server_matches_the_reference(
        tmp_path, frozen_clock, small_geometry):
    """VolumeCopy from a server whose volume streamed rows onto an empty
    one, in both packages: the copy's .dat and .idx equal the source's,
    processed_bytes agree, every GET on the destination is byte-equal.
    Then needles POSTed to the copy: the port recorded VOLUME_COPY for the
    vid before the pull, so no pipeline streams them and the seal runs
    offline; the reference builds a pipeline that streams from row 0.
    Both seals equal write_ec_files of the destination's .dat."""
    bodies = _bodies(SEED + 3, 5 * ROW)
    extra = _bodies(SEED + 4, 2 * ROW)
    fids = [port_t.format_fid(VID, i, 0x5eed + i)
            for i in range(1, len(bodies) + len(extra) + 1)]

    async def one(kind: str) -> dict:
        d = tmp_path / kind
        src = _server(kind, d / "src", ingest=True)
        dst = _server(kind, d / "dst", ingest=True)
        src.store.add_volume(VID)
        for vs in (src, dst):
            await _start(kind, vs)
        out = {}
        cs, cd = Client("127.0.0.1", src.port), Client("127.0.0.1", dst.port)
        try:
            out["posts"] = await _post_all(cs, fids, bodies)
            stub, vpb = _stub(kind, dst)
            resp = [r async for r in stub.VolumeCopy(vpb.VolumeCopyRequest(
                volume_id=VID, source_data_node=src.grpc_url))]
            out["processed"] = [r.processed_bytes for r in resp]
            sv, dv = (vs.store.find_volume(VID) for vs in (src, dst))
            out["same_files"] = (_read(dv.dat_path) == _read(sv.dat_path),
                                 _read(dv.idx_path) == _read(sv.idx_path))
            out["gets"] = await _get_all(cd, fids[:len(bodies)])
            out["extra_posts"] = await _post_all(cd, fids[len(bodies):],
                                                 extra)
            p = dst.ingest.pipelines.get(VID)
            out["pipeline"] = None if p is None else p.valid
            pending = getattr(dst.ingest, "_invalidated", {}).get(VID)
            out["recorded"] = pending
            await stub.VolumeEcShardsGenerate(
                vpb.VolumeEcShardsGenerateRequest(volume_id=VID))
            base = dv.dat_path[:-4]
            out["dat"] = _read(base + ".dat")
            out["shards"] = _seal_shards(base)
            out["all_gets"] = await _get_all(cd, fids)
        finally:
            await cs.close()
            await cd.close()
            for vs in (src, dst):
                await vs.stop()
        return out

    port = asyncio.run(one("port"))
    ref = asyncio.run(one("ref"))
    assert port["same_files"] == ref["same_files"] == (True, True)
    for k in ("posts", "processed", "gets", "extra_posts", "dat", "all_gets"):
        assert port[k] == ref[k], k
    assert port["gets"] == [(200, b) for b in bodies]
    assert port["all_gets"] == [(200, b) for b in bodies + extra]
    assert len(port["processed"]) == 1 and port["processed"][0] > 5 * ROW
    assert (port["pipeline"], port["recorded"]) == (None,
                                                    port_store.VOLUME_COPY)
    assert ref["pipeline"] is True  # the reference streams the copy
    want = _oracle_shards(tmp_path, tmp_path / "port" / "dst" / f"{VID}.dat",
                          "oracle")
    assert port["shards"] == want and ref["shards"] == want


def test_volume_copy_onto_a_held_vid(tmp_path, frozen_clock):
    """The destination already mounts the vid, with a needle the source
    lacks; the source holds one the destination lacks.  The reference's
    VolumeCopy replaces the .dat and .idx under the mounted volume and
    answers OK, then serves its old inode: the source's needle is 404 and
    its own old needle 200, while its .dat on disk is the source's (the
    reference defect).  The port answers FAILED_PRECONDITION before any
    pull, and its files and answers are unchanged."""
    src_only = port_t.format_fid(VID, 1, 0x11)
    dst_only = port_t.format_fid(VID, 2, 0x22)

    async def one(kind: str) -> dict:
        d = tmp_path / kind
        src = _server(kind, d / "src")
        dst = _server(kind, d / "dst")
        for vs in (src, dst):
            vs.store.add_volume(VID)
            await _start(kind, vs)
        out = {}
        cs, cd = Client("127.0.0.1", src.port), Client("127.0.0.1", dst.port)
        try:
            await _post_all(cs, [src_only], [b"only on the source" * 50])
            await _post_all(cd, [dst_only], [b"only on the destination" * 40])
            dv = dst.store.find_volume(VID)
            before = _read(dv.dat_path)
            stub, vpb = _stub(kind, dst)
            out["copy"] = await _code(functools.partial(
                stub.VolumeCopy, vpb.VolumeCopyRequest(
                    volume_id=VID, source_data_node=src.grpc_url)))
            out["gets"] = [st for st, _ in await _get_all(
                cd, [src_only, dst_only])]
            out["disk_is_source"] = (_read(dv.dat_path) == _read(
                src.store.find_volume(VID).dat_path))
            out["disk_unchanged"] = _read(dv.dat_path) == before
        finally:
            await cs.close()
            await cd.close()
            for vs in (src, dst):
                await vs.stop()
        return out

    port = asyncio.run(one("port"))
    ref = asyncio.run(one("ref"))
    assert ref == {"copy": "OK", "gets": [404, 200],
                   "disk_is_source": True, "disk_unchanged": False}
    assert port == {"copy": "FAILED_PRECONDITION", "gets": [404, 200],
                    "disk_is_source": False, "disk_unchanged": True}


@pytest.mark.parametrize("index", ["sqlite", "native"])
def test_a_tier_round_trip_under_a_persistent_index(tmp_path, registries,
                                                    index):
    """A tier round trip of a volume whose map is persistent.  The port
    commits the map before the reload, so the reloaded volume opens the
    same db and serves every needle, tiered and back.  The reference's
    sqlite map keeps its writes uncommitted, and its reload finds the db
    locked (a reference defect, pinned): the upload raises after the
    object is stored, the .vif written and the local .dat unlinked, with
    the old volume still mounted."""
    kind = {"sqlite": "persistent", "native": "native"}[index]
    seen = {}
    for pkg in ("jax", "torch"):
        m = PKGS[pkg]
        m["backend"].configure({"local.default": {
            "type": "local", "dir": str(tmp_path / pkg / "tier")}})
        d = tmp_path / pkg / "v"
        d.mkdir(parents=True)
        loc = m["dl"].DiskLocation(str(d), needle_map_kind=kind)
        store = m["store"].Store(
            [loc], ec_backend="numpy" if pkg == "jax" else "torch")
        v = store.add_volume(VID)
        payloads = {}
        for k, body in enumerate(_bodies(SEED + 5, 20_000)):
            v.append_needle(m["needle"].Needle(
                id=k + 1, cookie=0x99, data=body, last_modified=FROZEN_S,
                append_at_ns=FROZEN_S * 10**9 + k))
            payloads[k + 1] = body
        store.mark_volume_readonly(VID)
        try:
            store.tier_move_to_remote(VID, "local.default")
        except Exception as e:  # the reference's sqlite3.OperationalError
            seen[pkg] = (type(e).__name__, str(e),
                         os.path.exists(v.dat_path),
                         len(os.listdir(tmp_path / pkg / "tier")))
            continue
        tiered = store.find_volume(VID)
        assert tiered.remote_dat is not None
        assert type(tiered.nm).__name__ == type(v.nm).__name__
        got = {nid: bytes(tiered.read(nid, 0x99).data) for nid in payloads}
        store.tier_move_from_remote(VID)
        back = store.find_volume(VID)
        got_back = {nid: bytes(back.read(nid, 0x99).data) for nid in payloads}
        assert got == got_back == payloads
        seen[pkg] = ("ok", sorted(back.nm.items()))
        store.close()
    if index == "sqlite":
        assert seen["jax"] == ("OperationalError", "database is locked",
                               False, 1)
    else:
        assert seen["jax"] == seen["torch"]
    assert seen["torch"][0] == "ok"
