"""The port's persistent needle maps held against the JAX package's, on
the CPU: `-index sqlite` (SqliteNeedleMap) and `-index native`
(NativeNeedleMap over csrc/host/kvstore.cpp).

The cases of the reference's tests (CompactMap parity, the watermark's
incremental open, an idempotent crash replay, the rebuild after vacuum
shrank the .idx, no deleted needle back after a reopen, a Volume's life
through vacuum), each run on both packages' maps of the same kind over
the same .idx; their items and stats are compared with no tolerance.
"""
import os
import random

import pytest

from seaweedfs_tpu.storage import idx as jax_idx
from seaweedfs_tpu.storage import needle as jax_needle
from seaweedfs_tpu.storage import needle_map_persistent as jax_nmp
from seaweedfs_tpu.storage import vacuum as jax_vacuum
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu_torch.storage import idx as port_idx
from seaweedfs_tpu_torch.storage import needle as port_needle
from seaweedfs_tpu_torch.storage import needle_map_persistent as port_nmp
from seaweedfs_tpu_torch.storage import vacuum as port_vacuum
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.storage.needle_map import CompactMap

PKGS = {
    "jax": dict(nmp=jax_nmp, idx=jax_idx, volume=jax_volume,
                vacuum=jax_vacuum),
    "torch": dict(nmp=port_nmp, idx=port_idx, volume=port_volume,
                  vacuum=port_vacuum),
}
FROZEN_NS = 1_760_000_001 * 10**9
CLASSES = {"persistent": "SqliteNeedleMap", "native": "NativeNeedleMap"}


@pytest.fixture(params=["persistent", "native"])
def map_kind(request):
    return request.param


def make_map(pkg: str, map_kind: str, db, idx, version=None):
    cls = getattr(PKGS[pkg]["nmp"], CLASSES[map_kind])
    return cls(str(db), str(idx), version)


def _state(m) -> tuple:
    s = m.stats
    return (sorted(m.items()), len(m), s.file_count, s.deleted_count,
            s.file_bytes, s.deleted_bytes, s.maximum_key, m.indexed_end)


def _write_idx(path, entries, mode="ab"):
    with open(path, mode) as f:
        for nid, off, size in entries:
            f.write(port_idx.pack_entry(nid, off, size))


def random_ops(rng, n=500):
    ops = []
    for _ in range(n):
        nid = rng.randrange(1, 60)
        if rng.random() < 0.25:
            ops.append(("delete", nid))
        else:
            ops.append(("set", nid, rng.randrange(8, 1 << 30),
                        rng.randrange(1, 10_000)))
    return ops


def test_parity_with_compact_map_and_the_reference(tmp_path, map_kind):
    """500 seeded sets and deletes: the port's map answers get/has/len/
    items/stats as CompactMap does, and as the reference's map of the
    same kind."""
    ops = random_ops(random.Random(3))
    cm = CompactMap()
    maps = {pkg: make_map(pkg, map_kind, tmp_path / f"{pkg}.db",
                          tmp_path / f"{pkg}.idx") for pkg in PKGS}
    for op, *a in ops:
        for m in (cm, *maps.values()):
            getattr(m, op)(*a)
    sm = maps["torch"]
    for nid in range(1, 60):
        assert cm.get(nid) == sm.get(nid), nid
        assert cm.has(nid) == sm.has(nid)
        assert sm.get_any(nid) == maps["jax"].get_any(nid)
    assert sorted(cm.items()) == sorted(sm.items())
    s1, s2 = cm.stats, sm.stats
    assert (s1.file_count, s1.deleted_count, s1.file_bytes, s1.deleted_bytes,
            s1.maximum_key) == (s2.file_count, s2.deleted_count,
                                s2.file_bytes, s2.deleted_bytes,
                                s2.maximum_key)
    assert _state(sm) == _state(maps["jax"])
    for m in maps.values():
        m.close()


def test_incremental_open_via_watermark(tmp_path, map_kind):
    """Open replays only the .idx tail past the watermark, with the same
    state in both packages."""
    seen = {}
    for pkg in PKGS:
        idx, db = tmp_path / f"{pkg}.idx", tmp_path / f"{pkg}.db"
        _write_idx(idx, [(nid, nid * 16, 100) for nid in range(1, 101)])
        m = make_map(pkg, map_kind, db, idx)
        assert len(m) == 100 and m.get(50) == (800, 100)
        m.close()
        _write_idx(idx, [(nid, nid * 16, 200) for nid in range(101, 121)])
        m2 = make_map(pkg, map_kind, db, idx)
        assert len(m2) == 120 and m2.get(110) == (1760, 200)
        assert m2.stats.file_count == 120
        seen[pkg] = _state(m2)
        m2.close()
    assert seen["torch"] == seen["jax"]


def test_crash_replay_is_idempotent(tmp_path, map_kind):
    """A stale watermark (a crash before the flush) re-applies the tail
    without counting it twice."""
    seen = {}
    for pkg in PKGS:
        idx, db = tmp_path / f"{pkg}.idx", tmp_path / f"{pkg}.db"
        _write_idx(idx, [(nid, nid * 16, 100) for nid in range(1, 11)])
        m = make_map(pkg, map_kind, db, idx)
        m.flush()
        stats1 = (m.stats.file_count, m.stats.file_bytes, len(m))
        if map_kind == "persistent":
            m.conn.execute("UPDATE meta SET v = 0 WHERE k = 'watermark'")
            m.conn.commit()
            m.conn.close()
        else:
            m._meta_watermark = 0
            m._save_meta()
            m.kv.close()
        m2 = make_map(pkg, map_kind, db, idx)
        assert (m2.stats.file_count, m2.stats.file_bytes, len(m2)) == stats1
        seen[pkg] = _state(m2)
        m2.close()
    assert seen["torch"] == seen["jax"]


def test_rebuild_when_idx_shrinks(tmp_path, map_kind):
    """Vacuum rewrote the .idx smaller than the watermark: a full
    rebuild."""
    seen = {}
    for pkg in PKGS:
        idx, db = tmp_path / f"{pkg}.idx", tmp_path / f"{pkg}.db"
        _write_idx(idx, [(nid, nid * 16, 100) for nid in range(1, 21)])
        make_map(pkg, map_kind, db, idx).close()
        _write_idx(idx, [(nid, nid * 32, 77) for nid in range(1, 6)], "wb")
        m = make_map(pkg, map_kind, db, idx)
        assert len(m) == 5 and m.get(3) == (96, 77) and m.get(15) is None
        seen[pkg] = _state(m)
        m.close()
    assert seen["torch"] == seen["jax"]


def test_reopen_does_not_resurrect_deleted_needles(tmp_path, map_kind):
    """Write, delete, clean close, reopen: the deleted needle stays
    deleted, and the reopen appends no .idx entry (a stale indexed_end
    would re-apply the needle's live record from the .dat)."""
    seen = {}
    for pkg, m in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        v = m["volume"].Volume(str(d), 3, needle_map_kind=map_kind)
        v.write(1, 0xAA, b"first")
        v.write(2, 0xAA, b"second")
        v.delete(1, 0xAA)
        v.close()
        v2 = m["volume"].Volume(str(d), 3, needle_map_kind=map_kind)
        with pytest.raises(KeyError):
            v2.read(1)
        assert bytes(v2.read(2, 0xAA).data) == b"second"
        assert len(v2.nm) == 1
        n_entries = os.path.getsize(v2.idx_path) // m["idx"].entry_size()
        assert n_entries == 3, f"recovery duplicated idx entries: {n_entries}"
        seen[pkg] = _state(v2.nm)[:-1]
        v2.close()
    assert seen["torch"] == seen["jax"]


def test_volume_lifecycle_through_vacuum(tmp_path, map_kind, monkeypatch):
    """A Volume with a persistent map: writes, two deletes, a vacuum (the
    sqlite kind swaps in the shadow map compact() pre-built; the native
    kind rebuilds fresh), a reopen.  Every live needle reads back, the map
    comes back as its kind, and both packages' files and maps agree."""
    payloads = {i: bytes([i]) * (200 + i) for i in range(1, 40)}
    # the tombstones' stamps: one stopped clock in both packages
    for mod in (jax_needle, port_needle):
        monkeypatch.setattr(mod.time, "time_ns", lambda: FROZEN_NS)
    seen = {}
    for pkg, m in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        v = m["volume"].Volume(str(d), 9, needle_map_kind=map_kind)
        for nid, data in payloads.items():
            v.append_needle(_n(pkg, nid, data))
        v.delete(5, 0xCAFE)
        v.delete(17, 0xCAFE)
        db = v.sdx_path if map_kind == "persistent" else v.ndx_path
        assert os.path.exists(db)
        pending = m["vacuum"].compact(v)
        assert (pending[3] is not None) == (map_kind == "persistent")
        m["vacuum"].commit(v, *pending)
        assert not os.path.exists(d / "9.cpx.sdx")
        for nid, data in payloads.items():
            if nid not in (5, 17):
                assert bytes(v.read(nid, 0xCAFE).data) == data
        v.close()
        v2 = m["volume"].Volume(str(d), 9, needle_map_kind=map_kind)
        assert type(v2.nm).__name__ == CLASSES[map_kind]
        assert len(v2.nm) == len(payloads) - 2
        with open(v2.dat_path, "rb") as f:
            seen[pkg] = (_state(v2.nm), f.read(),
                         v2.super_block.compaction_revision)
        v2.destroy()
        assert not os.path.exists(db)
    assert seen["torch"] == seen["jax"]


def _n(pkg: str, nid: int, data: bytes):
    cls = (port_needle if pkg == "torch" else jax_needle).Needle
    return cls(id=nid, cookie=0xCAFE, data=data, last_modified=1_760_000_000,
               append_at_ns=1_760_000_000 * 10**9 + nid)
