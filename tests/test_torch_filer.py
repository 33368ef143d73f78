"""The port's filer/ against the JAX package's, on the CPU, with the same
seeded inputs: the chunk algebra (visible intervals, views, compaction,
total size, etag) on random chunk layouts, manifest folding, the meta log,
path rules, the chunk cache, every store kind driven through the store
matrix's operations (tests/test_filerstore_matrix.py) in both packages, a
store and a meta log written by either package read by the other, the
native store's durability case (tests/test_native_kv.py), and the Filer's
namespace operations with their meta-log events.  Equality is exact;
clocks are masked where the two runs must differ.
"""
import asyncio
import dataclasses
import os
from unittest import mock

import numpy as np
import pytest

from seaweedfs_tpu import filer as ref_filer
from seaweedfs_tpu.filer import chunk_cache as ref_cache
from seaweedfs_tpu.filer import filerstore as ref_store
from seaweedfs_tpu.filer import manifest as ref_manifest
from seaweedfs_tpu.filer import meta_log as ref_meta
from seaweedfs_tpu.filer import path_conf as ref_conf
from seaweedfs_tpu.pb import filer_pb2 as ref_pb
from seaweedfs_tpu_torch import filer as port_filer
from seaweedfs_tpu_torch.filer import chunk_cache as port_cache
from seaweedfs_tpu_torch.filer import filerstore as port_store
from seaweedfs_tpu_torch.filer import manifest as port_manifest
from seaweedfs_tpu_torch.filer import meta_log as port_meta
from seaweedfs_tpu_torch.filer import path_conf as port_conf
from seaweedfs_tpu_torch.pb import filer_pb2 as port_pb

SIDES = {"ref": (ref_filer, ref_pb), "port": (port_filer, port_pb)}


def _chunks(pb, rng, n, span):
    """n seeded chunks over [0, span): overlapping writes with distinct
    clocks, some compressed or keyed, hex and non-hex etags."""
    out = []
    for i in range(n):
        off = int(rng.integers(0, span))
        size = int(rng.integers(1, span // 3 + 2))
        out.append(pb.FileChunk(
            file_id=f"{int(rng.integers(1, 9))},{i:x}{int(rng.integers(1 << 32)):08x}",
            offset=off, size=size,
            modified_ts_ns=int(rng.integers(0, 1000)) * 1000 + i,
            e_tag=(rng.bytes(16).hex() if rng.random() < 0.7
                   else f"tag{i}"),
            cipher_key=rng.bytes(4) if rng.random() < 0.2 else b"",
            is_compressed=bool(rng.random() < 0.2),
        ))
    return out


def _view(v):
    return dataclasses.astuple(v)


@pytest.mark.parametrize("seed", range(8))
def test_chunk_algebra_matches_the_reference(seed):
    got = {}
    for side, (mod, pb) in SIDES.items():
        rng = np.random.default_rng(seed)
        chunks = _chunks(pb, rng, int(rng.integers(1, 40)), 1 << 16)
        out = [mod.total_size(chunks), mod.etag_of_chunks(chunks)]
        out.append([_view(v) for v in mod.read_resolved_chunks(chunks)])
        compacted, garbage = mod.compact_file_chunks(chunks)
        out.append([c.SerializeToString() for c in compacted])
        out.append([c.SerializeToString() for c in garbage])
        out.append([c.SerializeToString()
                    for c in mod.find_unused_file_chunks(chunks, compacted)])
        for _ in range(6):
            off = int(rng.integers(0, 1 << 16))
            size = int(rng.integers(0, 1 << 15))
            out.append([_view(v) for v in mod.view_from_chunks(chunks, off, size)])
        out.append([_view(v) for v in mod.read_resolved_chunks(
            chunks, 1000, 40000)])
        got[side] = out
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("batch,n", [(1000, 2500), (7, 30)])
def test_manifest_folding_matches_the_reference(batch, n):
    got = {}
    for side, (mod, pb) in SIDES.items():
        manifest = port_manifest if side == "port" else ref_manifest
        blobs = {}

        def save(blob):
            fid = f"9,m{len(blobs):x}"
            blobs[fid] = blob
            return pb.FileChunk(file_id=fid, e_tag="", cipher_key=b"k" * 4,
                                is_compressed=True)

        chunks = [pb.FileChunk(file_id=f"3,{i:x}", offset=i * 10, size=10,
                               modified_ts_ns=i + 1) for i in range(n)]
        folded = manifest.maybe_manifestize(save, chunks, batch=batch)
        data, mchunks = manifest.resolve_chunk_manifest(
            lambda fid: blobs[fid], folded, 0, 1 << 62)
        part, _ = manifest.resolve_chunk_manifest(
            lambda fid: blobs[fid], folded, n * 5, n * 5 + 10)
        got[side] = (
            [c.SerializeToString() for c in folded],
            sorted(blobs.items()),
            [c.SerializeToString() for c in data],
            [c.SerializeToString() for c in mchunks],
            [c.SerializeToString() for c in part],
        )
    assert got["port"] == got["ref"]

    async def expand(manifest, pb):
        blobs = {"9,1": pb.FileChunkManifest(chunks=[
            pb.FileChunk(file_id="3,a", offset=0, size=4)]
        ).SerializeToString()}

        async def fetch(c):
            return blobs[c.file_id]

        data, mchunks = await manifest.expand_manifest_chunks(fetch, [
            pb.FileChunk(file_id="9,1", size=4, is_chunk_manifest=True),
            pb.FileChunk(file_id="3,b", offset=4, size=4)])
        return ([c.SerializeToString() for c in data],
                [c.SerializeToString() for c in mchunks])

    port = asyncio.run(expand(port_manifest, port_pb))
    assert port == asyncio.run(expand(ref_manifest, ref_pb))
    assert len(port[0]) == 2 and len(port[1]) == 1


def test_path_conf_matches_the_reference():
    got = {}
    for side, conf in (("ref", ref_conf), ("port", port_conf)):
        fc = conf.FilerConf()
        fc.upsert(conf.PathConf(location_prefix="/buckets/", collection="b",
                                replication="001", ttl="1d"))
        fc.upsert(conf.PathConf(location_prefix="/buckets/hot/",
                                disk_type="ssd", read_only=True))
        fc.upsert(conf.PathConf(location_prefix="/logs/", ttl="7d"))
        fc.delete("/logs/")
        blob = fc.to_bytes()
        again = conf.FilerConf.from_bytes(blob)
        matches = [dataclasses.astuple(r) if r else None for r in (
            again.match(p) for p in ("/buckets/a", "/buckets/hot/x", "/logs/x",
                                     "/", "/bucketsX"))]
        got[side] = (blob, matches, conf.CONF_PATH)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("disk", [False, True])
def test_chunk_cache_matches_the_reference(tmp_path, disk):
    got = {}
    for side, mod in (("ref", ref_cache), ("port", port_cache)):
        rng = np.random.default_rng(5)
        cache = mod.ChunkCache(
            mem_limit_bytes=64 << 10, max_entry_bytes=24 << 10,
            disk_dir=str(tmp_path / side) if disk else None,
            disk_limit_bytes=96 << 10)
        trace = []
        for _ in range(300):
            fid = f"1,{int(rng.integers(0, 24)):x}"
            r = rng.random()
            if r < 0.45:
                cache.put(fid, rng.bytes(int(rng.integers(1, 30 << 10))))
            elif r < 0.9:
                blob = cache.get(fid)
                trace.append(None if blob is None else len(blob))
            else:
                cache.invalidate(fid)
        got[side] = (trace, cache.hits, cache.misses)
    assert got["port"] == got["ref"]


# --------------------------------------------------------------- meta log


def _events(pb, entry_cls, attr_cls):
    """Five mutations' (directory, old, new, delete_chunks, new_parent)."""
    def e(path, size):
        return entry_cls(full_path=path, attr=attr_cls(file_size=size,
                                                        mode=0o644))

    return [
        ("/d", None, e("/d/a", 1), False, ""),
        ("/d", e("/d/a", 1), e("/d/a", 2), False, ""),
        ("/d", e("/d/a", 2), e("/e/b", 2), False, "/e"),
        ("/e", e("/e/b", 2), None, True, ""),
        ("/", None, e("/f", 0), False, ""),
    ]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_meta_log_written_by_either_package_replays_in_the_other(
        tmp_path, writer):
    reader = "port" if writer == "ref" else "ref"
    mods = {"ref": (ref_meta, ref_filer), "port": (port_meta, port_filer)}
    path = str(tmp_path / "meta.log")

    async def write():
        meta, fil = mods[writer]
        log = meta.MetaLog(path)
        stamps = []
        for d, old, new, dc, np_ in _events(None, fil.Entry, fil.Attr):
            stamps.append(await log.append(d, old, new, delete_chunks=dc,
                                           new_parent_path=np_,
                                           signatures=[7]))
        log.close()
        return stamps

    async def read(which):
        meta, _ = mods[which]
        log = meta.MetaLog(path)
        out = []
        agen = log.subscribe(since_ns=0, path_prefix="")
        for _ in range(5):
            out.append((await agen.__anext__()).SerializeToString())
        await agen.aclose()
        more = []
        agen = log.subscribe(since_ns=0, path_prefix="/e")
        for _ in range(2):
            more.append((await agen.__anext__()).directory)
        await agen.aclose()
        log.close()
        return out, more

    stamps = asyncio.run(write())
    assert len(set(stamps)) == 5
    assert asyncio.run(read(reader)) == asyncio.run(read(writer))


# ------------------------------------------------------------------ stores

STORES = ["memory", "sqlite", "sqlite-onconflict", "native"]


def _make(side, kind, d):
    store = port_store if side == "port" else ref_store
    os.makedirs(d, exist_ok=True)
    if kind == "memory":
        return store.MemoryStore()
    if kind == "sqlite":
        return store.SqliteStore(os.path.join(d, "meta.db"))
    if kind == "sqlite-onconflict":
        return store.AbstractSqlStore(
            store.OnConflictSqliteDialect(os.path.join(d, "meta2.db")))
    return store.NativeKvStore(os.path.join(d, "kvdir"))


def _ent(side, path, size=1):
    fil = port_filer if side == "port" else ref_filer
    return fil.Entry(full_path=path, attr=fil.Attr(file_size=size, mode=0o644))


def _names(entries):
    return [e.name for e in entries]


def _op_crud(side, s, d):
    store = port_store if side == "port" else ref_store
    out = []
    names = [f"f{i:02d}.bin" for i in range(10)] + ["sub", "zz.log"]
    for n in names:
        s.insert_entry(_ent(side, f"/dir/{n}", size=3))
    out.append(s.find_entry("/dir/f03.bin").encode())
    s.update_entry(_ent(side, "/dir/f03.bin", size=77))
    out.append(s.find_entry("/dir/f03.bin").attr.file_size)
    try:
        s.find_entry("/dir/nope")
    except store.NotFoundError:
        out.append("missing")
    out.append(_names(s.list_directory_entries("/dir")))
    out.append(_names(s.list_directory_entries(
        "/dir", start_file_name="f03.bin", include_start=False, limit=3)))
    out.append(_names(s.list_directory_entries(
        "/dir", start_file_name="f03.bin", include_start=True, limit=2)))
    for n in ("Apple", "apple2", "we%ird_1", "we*ird_2"):
        s.insert_entry(_ent(side, f"/dir/{n}"))
    for prefix in ("zz", "apple", "A", "we%", "we*"):
        out.append(_names(s.list_directory_entries("/dir", prefix=prefix)))
    s.delete_entry("/dir/zz.log")
    out.append(_names(s.list_directory_entries("/dir")))
    s.delete_folder_children("/dir")
    out.append(_names(s.list_directory_entries("/dir")))
    return out


def _op_kv(side, s, d):
    store = port_store if side == "port" else ref_store
    s.kv_put(b"a", b"1")
    s.kv_put(b"a", b"2")
    out = [s.kv_get(b"a")]
    s.kv_delete(b"a")
    try:
        s.kv_get(b"a")
    except store.NotFoundError:
        out.append("missing")
    s.kv_delete(b"a")
    return out


def _op_transactions(side, s, d):
    store = port_store if side == "port" else ref_store
    s.begin_transaction()
    s.insert_entry(_ent(side, "/t/a"))
    s.commit_transaction()
    out = [s.find_entry("/t/a").encode()]
    s.begin_transaction()
    s.insert_entry(_ent(side, "/t/b"))
    s.rollback_transaction()
    try:
        out.append(s.find_entry("/t/b").encode())
    except store.NotFoundError:
        out.append("rolled back")
    return out


def _op_reopen(side, s, d, kind):
    s.insert_entry(_ent(side, "/d/keep.bin", size=9))
    s.kv_put(b"k", b"v")
    if kind == "memory":
        return []
    s.shutdown()
    s2 = _make(side, kind, d)
    try:
        return [s2.find_entry("/d/keep.bin").encode(), s2.kv_get(b"k"),
                _names(s2.list_directory_entries("/d"))]
    finally:
        s2.shutdown()


OPS = {"crud": _op_crud, "kv": _op_kv, "transactions": _op_transactions,
       "reopen": None}


@pytest.mark.parametrize("kind", STORES)
@pytest.mark.parametrize("op", sorted(OPS))
def test_store_matrix_matches_the_reference(tmp_path, kind, op):
    got = {}
    for side in ("ref", "port"):
        d = str(tmp_path / side)
        s = _make(side, kind, d)
        if op == "reopen":
            got[side] = _op_reopen(side, s, d, kind)
            continue
        try:
            got[side] = OPS[op](side, s, d)
        finally:
            s.shutdown()
    assert got["port"] == got["ref"]


def _tree(side, s):
    fil = port_filer if side == "port" else ref_filer
    s.insert_entry(fil.Entry(full_path="/docs",
                             attr=fil.Attr(mode=0o770 | fil.MODE_DIR)))
    for i in range(12):
        e = _ent(side, f"/docs/f{i:02d}", size=i)
        s.insert_entry(e)
    s.delete_entry("/docs/f03")
    s.kv_put(b"cursor", b"42")


def _listing(s):
    return ([e.encode() for e in s.list_directory_entries("/")],
            [e.encode() for e in s.list_directory_entries("/docs")],
            [e.encode() for e in s.list_directory_entries(
                "/docs", start_file_name="f05", limit=3)],
            s.kv_get(b"cursor"))


@pytest.mark.parametrize("kind", ["sqlite", "native"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_store_written_by_either_package_opens_in_the_other(
        tmp_path, kind, writer):
    reader = "port" if writer == "ref" else "ref"
    d = str(tmp_path / "store")
    s = _make(writer, kind, d)
    _tree(writer, s)
    want = _listing(s)
    s.shutdown()
    s2 = _make(reader, kind, d)
    try:
        assert _listing(s2) == want
        # and the reader's writes land where the writer reads them back
        s2.insert_entry(_ent(reader, "/docs/g00", size=5))
    finally:
        s2.shutdown()
    s3 = _make(writer, kind, d)
    try:
        assert s3.find_entry("/docs/g00").attr.file_size == 5
    finally:
        s3.shutdown()


def test_filer_native_store_durability(tmp_path):
    """tests/test_native_kv.py's case, on the port's store."""
    from seaweedfs_tpu_torch.filer.entry import MODE_DIR, Attr, Entry
    from seaweedfs_tpu_torch.filer.filerstore import NativeKvStore, NotFoundError

    p = str(tmp_path / "filer.kv")
    s = NativeKvStore(p)
    s.insert_entry(Entry(full_path="/docs", attr=Attr(mode=0o770 | MODE_DIR)))
    for i in range(20):
        s.insert_entry(
            Entry(full_path=f"/docs/f{i:02d}", attr=Attr(file_size=i))
        )
    s.delete_entry("/docs/f03")
    s.kv_put(b"cursor", b"42")
    s.shutdown()

    s2 = NativeKvStore(p)
    names = [e.name for e in s2.list_directory_entries("/docs")]
    assert names == sorted(f"f{i:02d}" for i in range(20) if i != 3)
    page = s2.list_directory_entries("/docs", start_file_name="f05", limit=3)
    assert [e.name for e in page] == ["f06", "f07", "f08"]
    assert s2.find_entry("/docs/f10").attr.file_size == 10
    with pytest.raises(NotFoundError):
        s2.find_entry("/docs/f03")
    assert s2.kv_get(b"cursor") == b"42"
    assert s2.compact() >= 0
    assert s2.find_entry("/docs/f10").attr.file_size == 10
    s2.shutdown()


# ------------------------------------------------------------- the Filer


def _mask_event(ev):
    """An event's bytes with its clock zeroed (the two runs' clocks
    differ)."""
    ev = type(ev).FromString(ev.SerializeToString())
    ev.ts_ns = 0
    return ev.SerializeToString()


@pytest.mark.parametrize("kind", ["memory", "sqlite", "native"])
def test_filer_namespace_ops_match_the_reference(tmp_path, kind):
    got = {}
    for side in ("ref", "port"):
        fil, pb = SIDES[side]
        deleted: list[str] = []

        async def delete_fids(fids):
            deleted.extend(fids)

        f = fil.Filer(_make(side, kind, str(tmp_path / side)),
                      delete_file_ids_fn=delete_fids)

        def chunk(fid, off, size, ts):
            return pb.FileChunk(file_id=fid, offset=off, size=size,
                                modified_ts_ns=ts, e_tag="ab" * 16)

        async def go():
            attr = fil.Attr(mtime=5, crtime=5, mode=0o644)
            await f.create_entry(fil.Entry(
                full_path="/a/b/c.txt", attr=attr,
                chunks=[chunk("3,01", 0, 10, 1)]))
            await f.create_entry(fil.Entry(
                full_path="/a/b/d.txt", attr=attr,
                chunks=[chunk("3,02", 0, 4, 2)]))
            await f.append_chunks("/a/b/d.txt", [chunk("3,03", 4, 4, 3)])
            await f.atomic_rename("/a", "b", "/x", "y")
            await f.delete_entry_meta_and_data(
                "/x/y/c.txt", is_recursive=False,
                ignore_recursive_error=False, is_delete_data=True)
            try:
                await f.delete_entry_meta_and_data(
                    "/x", is_recursive=False, ignore_recursive_error=False,
                    is_delete_data=True)
                refused = ""
            except fil.FilerError as e:
                refused = type(e).__name__
            await f.delete_entry_meta_and_data(
                "/x", is_recursive=True, ignore_recursive_error=False,
                is_delete_data=True)
            listing = [e.encode() for e in f.list_directory_entries("/")]
            events = []
            agen = f.meta_log.subscribe(since_ns=0)
            while True:
                try:
                    ev = await asyncio.wait_for(agen.__anext__(), 0.2)
                except asyncio.TimeoutError:
                    break
                events.append(_mask_event(ev))
            await agen.aclose()
            return refused, listing, events

        # the parents the filer makes carry the wall clock
        with mock.patch("time.time", return_value=1_700_000_000.0):
            refused, listing, events = asyncio.run(go())
        f.shutdown()
        got[side] = (refused, listing, events, sorted(deleted))
    assert got["port"] == got["ref"]
    assert got["port"][3] == ["3,01", "3,02", "3,03"]
