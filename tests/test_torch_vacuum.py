"""The port's vacuum held against the JAX package's, on the CPU.

Vacuum reclaims the space of deleted needles: storage/vacuum.py's
compact (live records copied to .cpd/.cpx) and commit (makeupDiff: index
entries appended since the compact replayed onto the copy, then the
swap), Store.vacuum_volume, the volume server's VacuumVolumeCheck/
Compact/Commit/Cleanup and VolumeConfigure rpcs, the master's vacuum pass
(Check, Compact, Commit or Cleanup over the RPC plane) and the shell's
volume.vacuum, volume.vacuum.disable, volume.vacuum.enable and
volume.configure.replication.

The same seeded needles go through both packages with the clock frozen
(a needle stores its write time), so the .dat and .idx files are the same
bytes; no tolerance anywhere.  One case pins a departure: the master's
vacuum reaches the volume server's VacuumVolumeCompact/Commit, which in
the reference leave the volume's ingest pipeline valid, so the next
ec.encode seals from parity streamed for the old .dat.  The port's
compact invalidates the pipeline first; its shards equal write_ec_files
of the compacted .dat where the reference's parity shards do not.
"""
import asyncio
import dataclasses
import functools
import io
import json
import os
import random
import shutil
import sys
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu import stats as jax_stats
from seaweedfs_tpu.ingest import IngestConfig as JaxIngestConfig
from seaweedfs_tpu.ingest import IngestPlane as JaxIngestPlane
from seaweedfs_tpu.ingest import pipeline as jax_pipeline
from seaweedfs_tpu.pb import Stub as RefStub
from seaweedfs_tpu.pb import channel as ref_channel
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vpb
from seaweedfs_tpu.repair import RepairConfig as RefRepairConfig
from seaweedfs_tpu.server import cluster as ref_cluster_mod
from seaweedfs_tpu.server import volume as jax_server_volume
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run
from seaweedfs_tpu.storage import disk_location as jax_dl
from seaweedfs_tpu.storage import needle as jax_needle
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.storage import types as jax_t
from seaweedfs_tpu.storage import vacuum as jax_vacuum
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu.storage.ec import encoder as jax_encoder
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ingest import IngestConfig, IngestPlane
from seaweedfs_tpu_torch.ingest import pipeline as port_pipeline
from seaweedfs_tpu_torch.pb import Stub as PortStub
from seaweedfs_tpu_torch.pb import channel as port_channel
from seaweedfs_tpu_torch.pb import volume_server_pb2 as port_vpb
from seaweedfs_tpu_torch.repair import RepairConfig as PortRepairConfig
from seaweedfs_tpu_torch.server import volume as server_volume
from seaweedfs_tpu_torch.server.cluster import LocalCluster as PortCluster
from seaweedfs_tpu_torch.server.http import Client
from seaweedfs_tpu_torch.shell import CommandEnv as PortEnv
from seaweedfs_tpu_torch.shell import run_command as port_run
from seaweedfs_tpu_torch.storage import disk_location as port_dl
from seaweedfs_tpu_torch.storage import ec as port_ec
from seaweedfs_tpu_torch.storage import needle as port_needle
from seaweedfs_tpu_torch.storage import store as port_store
from seaweedfs_tpu_torch.storage import types as port_t
from seaweedfs_tpu_torch.storage import vacuum as port_vacuum
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.storage.volume import CookieMismatch, NotFoundError

SEED = 1515
VID = 5
FROZEN_S = 1_760_000_000
# the small stripe geometry of tests/test_torch_ingest.py: 1024x shrunk
SMALL = 1024
LARGE = 8192
ROW = 10 * SMALL
STREAMABLE = 10 * LARGE
DEADLINE_S = 30.0

PKGS = {
    "jax": dict(volume=jax_volume, needle=jax_needle, vacuum=jax_vacuum,
                t=jax_t, store=jax_store, dl=jax_dl),
    "torch": dict(volume=port_volume, needle=port_needle, vacuum=port_vacuum,
                  t=port_t, store=port_store, dl=port_dl),
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
    pipelines, and their Store's offline seal at the same geometry, so a
    streamed and an offline seal lay the shards out alike."""
    for mod in (jax_pipeline, port_pipeline):
        monkeypatch.setattr(mod, "SMALL_BLOCK_SIZE", SMALL)
        monkeypatch.setattr(mod, "LARGE_BLOCK_SIZE", LARGE)
        monkeypatch.setattr(mod, "ROW_BYTES", ROW)
        monkeypatch.setattr(mod, "STREAMABLE_BYTES", STREAMABLE)
    for mod in (jax_store, port_store):
        monkeypatch.setattr(mod, "write_ec_files", functools.partial(
            mod.write_ec_files, large_block=LARGE, small_block=SMALL))


def _needles(seed: int, n: int, lo: int = 200, hi: int = 3000) -> list:
    """(needle id, cookie, body): seeded sizes and bytes."""
    rng = np.random.default_rng(seed)
    return [(i + 1, int(rng.integers(0, 1 << 32)),
             rng.integers(0, 256, int(rng.integers(lo, hi)),
                          np.uint8).tobytes())
            for i in range(n)]


def _append(pkg: str, v, nid: int, cookie: int, data: bytes, k: int) -> None:
    """One pinned needle: its write time and append stamp fixed by k."""
    Needle = PKGS[pkg]["needle"].Needle
    v.append_needle(Needle(id=nid, cookie=cookie, data=data,
                           name=f"n{nid}.bin".encode(),
                           last_modified=FROZEN_S,
                           append_at_ns=FROZEN_S * 10**9 + k))


def _files(v) -> tuple[bytes, bytes]:
    with open(v.dat_path, "rb") as d, open(v.idx_path, "rb") as x:
        return d.read(), x.read()


def _check_reads(v, live: dict, gone: set) -> None:
    for nid, (cookie, data) in live.items():
        n = v.read(nid, cookie)
        assert (n.id, bytes(n.data)) == (nid, data)
    for nid in gone:
        with pytest.raises(NotFoundError if isinstance(v, port_volume.Volume)
                           else jax_volume.NotFoundError):
            v.read(nid)


# ------------------------------------------------------------ the Volume


@pytest.mark.parametrize("racing", [False, True], ids=["vacuum", "makeup_diff"])
def test_volume_vacuum_matches_the_reference(tmp_path, frozen_clock, racing):
    """Seeded needles, every third deleted, then a vacuum: the compacted
    .dat and .idx are the same bytes in both packages, with the same
    revision, garbage ratio and info.  `makeup_diff`: between compact and
    commit, new writes, a rewrite of a live id, deletes and a replica
    placement change land; commit replays them onto the copy and keeps
    the placement."""
    needles = _needles(SEED, 36)
    seen = {}
    for pkg in ("jax", "torch"):
        m = PKGS[pkg]
        d = tmp_path / pkg
        d.mkdir()
        v = m["volume"].Volume(str(d), VID)
        live = {}
        for k, (nid, cookie, data) in enumerate(needles):
            _append(pkg, v, nid, cookie, data, k)
            live[nid] = (cookie, data)
        gone = set()
        for nid, cookie, _ in needles[::3]:
            v.delete(nid, cookie)
            gone.add(nid)
            del live[nid]
        before = v.garbage_ratio
        if not racing:
            ratio = m["vacuum"].vacuum(v)
        else:
            ratio = before
            pending = m["vacuum"].compact(v)
            extra = _needles(SEED + 1, 6)
            for k, (nid, cookie, data) in enumerate(extra):
                nid += 100
                _append(pkg, v, nid, cookie, data, 100 + k)
                live[nid] = (cookie, data)
            nid, cookie, data = needles[1]
            _append(pkg, v, nid, cookie, data[::-1], 200)
            live[nid] = (cookie, data[::-1])
            for nid, cookie, _ in (needles[4], needles[7]):
                v.delete(nid, cookie)
                gone.add(nid)
                del live[nid]
            v.update_replica_placement(m["t"].ReplicaPlacement.parse("001"))
            m["vacuum"].commit(v, *pending)
        _check_reads(v, live, gone)
        with pytest.raises(CookieMismatch if pkg == "torch"
                           else jax_volume.CookieMismatch):
            nid, (cookie, _) = next(iter(live.items()))
            v.read(nid, cookie ^ 1)
        seen[pkg] = (_files(v), v.super_block.compaction_revision, before,
                     ratio, v.garbage_ratio, dataclasses.asdict(v.info()),
                     str(v.super_block.replica_placement))
        assert not any(n.endswith((".cpd", ".cpx")) for n in os.listdir(d))
        v.close()
        # a reload replays the compacted .idx to the same state
        v2 = m["volume"].Volume(str(d), VID)
        _check_reads(v2, live, gone)
        v2.close()
    assert seen["torch"] == seen["jax"]
    files, rev, before, ratio, after, info, rp = seen["torch"]
    assert rev == 1 and before > 0.25 and ratio == before
    assert info["size"] == len(files[0])
    if racing:
        # the replayed rewrite and deletes are the new file's garbage
        assert rp == "001" and 0 < after < before and info["delete_count"] == 3
    else:
        assert rp == "000" and after == 0.0 and info["delete_count"] == 0


def test_a_read_straddling_a_commit_keeps_its_state(tmp_path):
    """A commit that lands between a read's map lookup and its pread: the
    read keeps the (file, map) pair it started with, so the old offset is
    read from the old file and the needle comes back whole."""
    v = port_volume.Volume(str(tmp_path), VID)
    needles = _needles(SEED + 7, 8)
    for k, (nid, cookie, data) in enumerate(needles):
        _append("torch", v, nid, cookie, data, k)
    v.delete(needles[0][0], needles[0][1])
    pending = port_vacuum.compact(v)
    nid, cookie, data = needles[-1]
    old_nm, old_off = v.nm, v.nm.get(nid)[0]
    lookup = old_nm.get

    def get_then_commit(key):
        loc = lookup(key)
        del old_nm.get  # one straddle
        port_vacuum.commit(v, *pending)
        return loc

    old_nm.get = get_then_commit
    n = v.read(nid, cookie)
    assert (n.id, bytes(n.data)) == (nid, data)
    assert v.nm is not old_nm and v.nm.get(nid)[0] != old_off
    assert v.super_block.compaction_revision == 1
    assert bytes(v.read(nid, cookie).data) == data
    v.close()


def test_reads_hammered_across_commits_never_mix_states(tmp_path):
    """Eight reader threads read the same needles while the main thread
    vacuums twelve times, each time after deleting a filler needle that
    sits before them, so every commit moves their offsets.  A read that
    paired an old offset with the new file (or the reverse) would return
    a wrong needle or a CRC error: every read must return its needle."""
    v = port_volume.Volume(str(tmp_path), VID)
    needles = _needles(SEED + 2, 48, lo=100, hi=4000)
    want, fillers = {}, []
    for k, (nid, cookie, data) in enumerate(needles):
        _append("torch", v, nid, cookie, data, k)
        if k % 2:
            want[nid] = (cookie, data)
        else:
            fillers.append((nid, cookie))
    rounds = 12
    stop = threading.Event()
    errors, counts = [], [0] * 8

    def reader(i: int) -> None:
        rng = random.Random(i)
        ids = sorted(want)
        while not stop.is_set():
            nid = rng.choice(ids)
            cookie, data = want[nid]
            try:
                n = v.read(nid, cookie)
            except Exception as e:  # noqa: BLE001 — any failure is the finding
                errors.append(f"{nid}: {e!r}")
                return
            if n.id != nid or bytes(n.data) != data:
                errors.append(f"{nid}: read needle {n.id}")
                return
            counts[i] += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader, args=(i,)) for i in range(8)]
    try:
        for th in threads:
            th.start()
        for r in range(rounds):
            nid, cookie = fillers[r]
            v.delete(nid, cookie)
            offsets = {n: v.nm.get(n)[0] for n in want}
            port_vacuum.vacuum(v)
            moved = sum(v.nm.get(n)[0] != off for n, off in offsets.items())
            assert moved == len(want) - r  # every needle after the filler
            time.sleep(0.02)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert all(counts), counts
    assert v.super_block.compaction_revision == rounds
    v.close()


# ------------------------------------------------------------ the Store


def test_store_vacuum_invalidates_ingest_and_reopens_a_full_volume(
        tmp_path, frozen_clock, small_geometry):
    """Store.vacuum_volume in both packages: needles streamed into stripe
    rows until the volume passed its size limit (full, pushed), half of
    them deleted, then the vacuum: the pipeline is invalid with the
    vacuum's reason, the volume re-opens and its delta is pushed, and
    ec_generate seals offline to write_ec_files of the compacted .dat."""
    needles = _needles(SEED + 3, 60, lo=500, hi=2000)
    limit = 5 * ROW
    seals = "SeaweedFS_volumeServer_ingest_seals_total"
    seen = {}
    for pkg, registry in (("jax", jax_stats.REGISTRY),
                          ("torch", stats.REGISTRY)):
        m = PKGS[pkg]
        d = tmp_path / pkg
        d.mkdir()
        store = m["store"].Store([m["dl"].DiskLocation(str(d))],
                                 ec_backend="numpy" if pkg == "jax" else "torch")
        store.ingest = (JaxIngestPlane(JaxIngestConfig(backend="cpu"))
                        if pkg == "jax"
                        else IngestPlane(IngestConfig(backend="torch")))
        store.volume_size_limit = limit
        try:
            v = store.add_volume(VID)
            written = []
            for k, (nid, cookie, data) in enumerate(needles):
                n = m["needle"].Needle(id=nid, cookie=cookie, data=data,
                                       last_modified=FROZEN_S,
                                       append_at_ns=FROZEN_S * 10**9 + k)
                store.write_needle(VID, n)
                store.ingest.on_write(v, len(data), "interactive")
                written.append((nid, cookie))
                if v.full:
                    break
            assert v.full and v.content_size > limit
            p = store.ingest.pipelines[VID]
            t_end = time.monotonic() + DEADLINE_S
            while p.encoded_rows < p.staged_rows and time.monotonic() < t_end:
                time.sleep(0.01)
            assert p.valid and p.encoded_rows >= 3
            for nid, cookie in written[::2]:
                store.delete_needle(VID, nid, cookie)
            store.drain_deltas()
            ratio = store.vacuum_volume(VID)
            deltas = store.drain_deltas()[0]
            status = p.status()
            before = registry.get_sample_value(seals, {"path": "offline"}) or 0
            store.ec_generate(VID)
            after = registry.get_sample_value(seals, {"path": "offline"}) or 0
            base = str(d / str(VID))
            oracle = str(tmp_path / f"oracle_{pkg}")
            shutil.copyfile(base + ".dat", oracle + ".dat")
            port_ec.write_ec_files(oracle, backend="numpy",
                                   large_block=LARGE, small_block=SMALL)
            shards = [_read(base + port_ec.to_ext(i)) for i in range(14)]
            assert shards == [_read(oracle + port_ec.to_ext(i))
                              for i in range(14)]
            msgs = [{k: x for k, x in vars(msg).items()
                     if k != "modified_at_second"} for msg in deltas]
            seen[pkg] = (ratio, v.full, msgs, status["valid"],
                         status["reason"], after - before, shards,
                         _read(base + ".dat"))
        finally:
            store.close()
    assert seen["torch"] == seen["jax"]
    ratio, full, msgs, valid, reason, offline, _, _ = seen["torch"]
    assert ratio > 0.3 and not full and not valid and offline == 1
    assert "vacuum" in reason
    assert [(msg["id"], msg["read_only"]) for msg in msgs] == [(VID, False)]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------ the departure


def _stub(kind: str, vs):
    """(a VolumeServer stub on `vs`, its messages) in `kind`'s package."""
    stub_cls, chan, vpb = ((PortStub, port_channel, port_vpb)
                           if kind == "port"
                           else (RefStub, ref_channel, ref_vpb))
    return stub_cls(chan(vs.grpc_url), vpb, "VolumeServer"), vpb


def test_rpc_vacuum_then_seal_departs_from_the_reference(
        tmp_path, frozen_clock, small_geometry):
    """Needles POSTed to both packages' volume servers stream stripe rows
    (K1's plain version on the port); the odd ones are deleted; then the
    master's path: VacuumVolumeCompact, VacuumVolumeCommit and
    VolumeEcShardsGenerate over the RPC plane.  The compacted .dat is the
    same bytes in both.  The port's compact invalidated the pipeline, so
    its seal ran offline and its 14 shards equal write_ec_files of the
    compacted .dat.  The reference's pipeline stayed valid: it sealed
    from parity streamed for the old .dat, and its parity shards 10-13
    differ (pinned, so that a fix of the reference shows here)."""
    rng = np.random.default_rng(SEED + 4)
    bodies = []
    while sum(len(b) for b in bodies) < 6 * ROW:
        bodies.append(rng.integers(0, 256, int(rng.integers(500, 3000)),
                                   np.uint8).tobytes())
    fids = [port_t.format_fid(VID, i, 0x5eed + i)
            for i in range(1, len(bodies) + 1)]
    seals = "SeaweedFS_volumeServer_ingest_seals_total"

    async def go():
        dirs = {k: tmp_path / k for k in ("port", "ref")}
        for d in dirs.values():
            d.mkdir()
        port = server_volume.VolumeServer(
            [], [str(dirs["port"])], port=0, ec_backend="torch",
            ec_ingest=IngestConfig(backend="torch"))
        ref = RefVolumeServer(masters=[], directories=[str(dirs["ref"])],
                              port=0, grpc_port=0, ec_backend="numpy",
                              ec_ingest=JaxIngestConfig(backend="cpu"))
        for vs in (port, ref):
            vs.store.add_volume(VID)
        await port.start()
        await ref.start(heartbeat=False)
        out = {}
        try:
            for kind, vs in (("port", port), ("ref", ref)):
                c = Client("127.0.0.1", vs.port)
                try:
                    for fid, body in zip(fids, bodies):
                        st, _, _ = await c.request(
                            "POST", "/" + fid,
                            {"Content-Type": "application/octet-stream"},
                            body)
                        assert st == 200
                    for fid in fids[1::2]:
                        st, _, _ = await c.request("DELETE", "/" + fid)
                        assert st == 200
                    p = vs.ingest.pipelines[VID]
                    t_end = time.monotonic() + DEADLINE_S
                    while (p.encoded_rows < p.staged_rows
                           and time.monotonic() < t_end):
                        await asyncio.sleep(0.01)
                    rows = p.encoded_rows
                    # the master's vacuum pass, then ec.encode's generate
                    stub, vpb = _stub(kind, vs)
                    async for _ in stub.VacuumVolumeCompact(
                            vpb.VacuumVolumeCompactRequest(volume_id=VID)):
                        pass
                    await stub.VacuumVolumeCommit(
                        vpb.VacuumVolumeCommitRequest(volume_id=VID))
                    if kind == "port":
                        # the pipeline as the operator reads it
                        _, _, body = await c.request("GET", "/status")
                        out["status"] = json.loads(body)["Ingest"]
                    await stub.VolumeEcShardsGenerate(
                        vpb.VolumeEcShardsGenerateRequest(volume_id=VID))
                    gets = []
                    for fid in fids:
                        st, _, body = await c.request("GET", "/" + fid)
                        gets.append((st, body))
                finally:
                    await c.close()
                out[kind] = (rows, p.valid, p.invalid_reason, gets)
        finally:
            await port.stop()
            await ref.stop()
        return out

    streamed = [r.get_sample_value(seals, {"path": "streamed"}) or 0
                for r in (stats.REGISTRY, jax_stats.REGISTRY)]
    walls = [stats.VOLUME_SERVER_VACUUMING_SECONDS.labels(type=k)
             for k in ("compact", "commit")]
    timed = [w.count for w in walls]
    out = asyncio.run(go())
    assert [w.count - n for w, n in zip(walls, timed)] == [1, 1]
    after = [r.get_sample_value(seals, {"path": "streamed"}) or 0
             for r in (stats.REGISTRY, jax_stats.REGISTRY)]
    rows, valid, reason, gets = out["port"]
    assert rows >= 5 and out["ref"][0] == rows
    assert (valid, reason) == (False, port_store.VACUUM_REWRITE)
    assert [(st["volume"], st["encoded_rows"], st["valid"], st["reason"])
            for st in out["status"]] == [(VID, rows, False, reason)]
    assert out["ref"][1] is True  # the reference's defect
    assert [a - b for a, b in zip(after, streamed)] == [0, 1]
    want = [(200, b) if i % 2 == 0 else (404, None)
            for i, b in enumerate(bodies)]
    for kind in ("port", "ref"):
        assert [(st, body if st == 200 else None)
                for st, body in out[kind][3]] == want, kind
    base = {k: str(tmp_path / k / str(VID)) for k in ("port", "ref")}
    assert _read(base["port"] + ".dat") == _read(base["ref"] + ".dat")
    oracle = str(tmp_path / "oracle")
    shutil.copyfile(base["port"] + ".dat", oracle + ".dat")
    jax_encoder.write_ec_files(oracle, backend="cpu", large_block=LARGE,
                               small_block=SMALL)
    want_shards = [_read(oracle + port_ec.to_ext(i)) for i in range(14)]
    got = {k: [_read(b + port_ec.to_ext(i)) for i in range(14)]
           for k, b in base.items()}
    assert got["port"] == want_shards
    assert [i for i in range(14)
            if got["ref"][i] != want_shards[i]] == [10, 11, 12, 13]
    assert _read(base["port"] + ".ecx") == _read(base["ref"] + ".ecx")


def test_rpc_vacuum_with_no_pipeline_seals_the_compacted_dat(
        tmp_path, frozen_clock, small_geometry):
    """A volume whose needles landed before its server started has no
    ingest pipeline.  The master's path then runs VacuumVolumeCompact, a
    POST lands before VacuumVolumeCommit (the race makeupDiff absorbs),
    and VolumeEcShardsGenerate seals.  In the reference that POST builds
    a fresh, valid pipeline that streams rows of the pre-vacuum .dat, and
    its parity is stale after the swap.  The port's compact recorded the
    invalidation for a pipeline not built yet: no pipeline streams, the
    seal runs offline, and its 14 shards equal write_ec_files of the
    compacted .dat.  Both .dat files are the same bytes, the late needle
    included."""
    needles = _needles(SEED + 5, 40, lo=500, hi=3000)
    late = (len(needles) + 1, 0x1a7e,
            np.random.default_rng(SEED + 6).integers(
                0, 256, 1500, np.uint8).tobytes())

    async def go():
        out = {}
        for kind in ("port", "ref"):
            d = tmp_path / kind
            d.mkdir()
            if kind == "port":
                vs = server_volume.VolumeServer(
                    [], [str(d)], port=0, ec_backend="torch",
                    ec_ingest=IngestConfig(backend="torch"))
                Needle = port_needle.Needle
            else:
                vs = RefVolumeServer(masters=[], directories=[str(d)],
                                     port=0, grpc_port=0, ec_backend="numpy",
                                     ec_ingest=JaxIngestConfig(backend="cpu"))
                Needle = jax_needle.Needle
            vs.store.add_volume(VID)
            for k, (nid, cookie, data) in enumerate(needles):
                vs.store.write_needle(VID, Needle(
                    id=nid, cookie=cookie, data=data,
                    last_modified=FROZEN_S,
                    append_at_ns=FROZEN_S * 10**9 + k))
            for nid, cookie, _ in needles[1::2]:
                vs.store.delete_needle(VID, nid, cookie)
            if kind == "port":
                await vs.start()
            else:
                await vs.start(heartbeat=False)
            c = Client("127.0.0.1", vs.port)
            try:
                assert VID not in vs.ingest.pipelines
                stub, vpb = _stub(kind, vs)
                async for _ in stub.VacuumVolumeCompact(
                        vpb.VacuumVolumeCompactRequest(volume_id=VID)):
                    pass
                nid, cookie, body = late
                st, _, _ = await c.request(
                    "POST", "/" + port_t.format_fid(VID, nid, cookie),
                    {"Content-Type": "application/octet-stream"}, body)
                assert st == 200
                p = vs.ingest.pipelines.get(VID)
                t_end = time.monotonic() + DEADLINE_S
                while (p is not None and p.encoded_rows < p.staged_rows
                       and time.monotonic() < t_end):
                    await asyncio.sleep(0.01)
                rows = (p.encoded_rows, p.valid) if p is not None else None
                await stub.VacuumVolumeCommit(
                    vpb.VacuumVolumeCommitRequest(volume_id=VID))
                await stub.VolumeEcShardsGenerate(
                    vpb.VolumeEcShardsGenerateRequest(volume_id=VID))
            finally:
                await c.close()
                await vs.stop()
            out[kind] = rows
        return out

    rows = asyncio.run(go())
    assert rows["port"] is None
    assert rows["ref"][0] >= 4 and rows["ref"][1] is True  # the defect
    base = {k: str(tmp_path / k / str(VID)) for k in ("port", "ref")}
    assert _read(base["port"] + ".dat") == _read(base["ref"] + ".dat")
    oracle = str(tmp_path / "oracle")
    shutil.copyfile(base["port"] + ".dat", oracle + ".dat")
    jax_encoder.write_ec_files(oracle, backend="cpu", large_block=LARGE,
                               small_block=SMALL)
    want = [_read(oracle + port_ec.to_ext(i)) for i in range(14)]
    got = {k: [_read(b + port_ec.to_ext(i)) for i in range(14)]
           for k, b in base.items()}
    assert got["port"] == want
    assert [i for i in range(14) if got["ref"][i] != want[i]] == [
        10, 11, 12, 13]


def test_rpc_vacuum_reopens_a_full_volume(tmp_path, frozen_clock):
    """A volume written past its size limit is full and pushed so.  Half
    its needles deleted, the master's path (VacuumVolumeCompact, then
    VacuumVolumeCommit) shrinks it back under the limit: the port's
    commit re-opens it and pushes the delta, as Store.vacuum_volume does
    in both packages.  The reference's rpcs leave it full (pinned)."""
    needles = _needles(SEED + 7, 40, lo=500, hi=2000)
    limit = sum(len(data) for _, _, data in needles) // 2

    async def go():
        out = {}
        for kind in ("port", "ref"):
            d = tmp_path / kind
            d.mkdir()
            if kind == "port":
                vs = server_volume.VolumeServer([], [str(d)], port=0,
                                                ec_backend="torch")
                Needle = port_needle.Needle
            else:
                vs = RefVolumeServer(masters=[], directories=[str(d)],
                                     port=0, grpc_port=0, ec_backend="numpy")
                Needle = jax_needle.Needle
            store = vs.store
            store.volume_size_limit = limit
            v = store.add_volume(VID)
            written = []
            for k, (nid, cookie, data) in enumerate(needles):
                store.write_needle(VID, Needle(
                    id=nid, cookie=cookie, data=data,
                    last_modified=FROZEN_S,
                    append_at_ns=FROZEN_S * 10**9 + k))
                written.append((nid, cookie))
                if v.full:
                    break
            assert v.full
            for nid, cookie in written[::2]:
                store.delete_needle(VID, nid, cookie)
            store.drain_deltas()
            if kind == "port":
                await vs.start()
            else:
                await vs.start(heartbeat=False)
            try:
                stub, vpb = _stub(kind, vs)
                async for _ in stub.VacuumVolumeCompact(
                        vpb.VacuumVolumeCompactRequest(volume_id=VID)):
                    pass
                await stub.VacuumVolumeCommit(
                    vpb.VacuumVolumeCommitRequest(volume_id=VID))
                deltas = store.drain_deltas()[0]
                out[kind] = (v.full, v.content_size <= limit,
                             [(m.id, m.read_only) for m in deltas])
            finally:
                await vs.stop()
        return out

    out = asyncio.run(go())
    assert out["port"] == (False, True, [(VID, False)])
    assert out["ref"] == (True, True, [])  # the reference stays full


@pytest.mark.parametrize("index", ["sqlite", "native"])
def test_rpc_vacuum_under_a_persistent_index(tmp_path, frozen_clock, index):
    """Both packages' servers with `-index sqlite` or `-index native`:
    needles written, every third deleted, VacuumVolumeCompact, two writes
    and a delete racing it, VacuumVolumeCommit.  The compacted .dat and
    .idx are the same bytes, the map holds the same entries and stats, and
    so does the map a restart reopens from its db (under sqlite, the
    shadow db compact() pre-built, swapped in by commit)."""
    needles = _needles(SEED + 8, 30)
    extra = _needles(SEED + 9, 2)
    db_ext = ".sdx" if index == "sqlite" else ".ndx"

    def state(v) -> tuple:
        s = v.nm.stats
        return (type(v.nm).__name__, sorted(v.nm.items()), len(v.nm),
                s.file_count, s.deleted_count, s.file_bytes, s.deleted_bytes)

    async def go():
        out = {}
        for kind in ("port", "ref"):
            d = tmp_path / kind
            d.mkdir()
            if kind == "port":
                vs = server_volume.VolumeServer([], [str(d)], port=0,
                                                ec_backend="torch",
                                                index_kind=index)
                Needle, vol = port_needle.Needle, port_volume
            else:
                vs = RefVolumeServer(masters=[], directories=[str(d)],
                                     port=0, grpc_port=0, ec_backend="numpy",
                                     index_kind=index)
                Needle, vol = jax_needle.Needle, jax_volume
            store = vs.store
            v = store.add_volume(VID)

            def put(k, nid, cookie, data):
                store.write_needle(VID, Needle(
                    id=nid, cookie=cookie, data=data, last_modified=FROZEN_S,
                    append_at_ns=FROZEN_S * 10**9 + k))

            for k, (nid, cookie, data) in enumerate(needles):
                put(k, nid, cookie, data)
            for nid, cookie, _ in needles[::3]:
                store.delete_needle(VID, nid, cookie)
            if kind == "port":
                await vs.start()
            else:
                await vs.start(heartbeat=False)
            try:
                stub, vpb = _stub(kind, vs)
                async for _ in stub.VacuumVolumeCompact(
                        vpb.VacuumVolumeCompactRequest(volume_id=VID)):
                    pass
                shadow = os.path.exists(d / f"{VID}.cpx.sdx")
                for k, (nid, cookie, data) in enumerate(extra):
                    put(100 + k, nid + 100, cookie, data)
                store.delete_needle(VID, needles[1][0], needles[1][1])
                await stub.VacuumVolumeCommit(
                    vpb.VacuumVolumeCommitRequest(volume_id=VID))
                live = {nid: (cookie, data) for nid, cookie, data in needles}
                for i, (nid, _, _) in enumerate(needles):
                    if i % 3 == 0 or i == 1:
                        del live[nid]
                live.update({nid + 100: (cookie, data)
                             for nid, cookie, data in extra})
                _check_reads(v, live, set())
                got = (shadow, _files(v), state(v),
                       v.super_block.compaction_revision,
                       os.path.exists(d / f"{VID}{db_ext}"))
            finally:
                await vs.stop()  # closes the store, and so the volume
            again = vol.Volume(str(d), VID, needle_map_kind=v.needle_map_kind)
            out[kind] = (got, state(again))
            again.close()
        return out

    out = asyncio.run(go())
    assert out["port"] == out["ref"]
    (shadow, _, st, rev, has_db), reopened = out["port"]
    assert shadow == (index == "sqlite") and rev == 1 and has_db
    assert reopened == st and st[0] == {"sqlite": "SqliteNeedleMap",
                                        "native": "NativeNeedleMap"}[index]


# ------------------------------------------------------------ the cluster


class _Side:
    """One package's LocalCluster (two volume servers, repair off) and
    the verbs the vacuum script needs."""

    def __init__(self, kind: str, base: str, n: int = 2, **master_kw):
        self.kind = kind
        self.base = base
        self.n = n
        self.master_kw = master_kw
        self.out = io.StringIO()

    async def start(self) -> None:
        if self.kind == "port":
            self.c = PortCluster(
                n_volume_servers=self.n, base_dir=self.base, pulse_seconds=1,
                ec_backend="torch", master_kwargs={
                    "ec_repair": PortRepairConfig(enabled=False),
                    **self.master_kw})
            await self.c.start()
            self.env = PortEnv([self.c.master.advertise_url], out=self.out)
            return
        c = ref_cluster_mod.LocalCluster(
            base_dir=self.base, n_volume_servers=self.n, pulse_seconds=1,
            master_kwargs={"ec_repair": RefRepairConfig(enabled=False),
                           **self.master_kw})
        await c.master.start()
        for spec in c._specs:
            vs = RefVolumeServer(masters=[c.master.advertise_url], port=0,
                                 grpc_port=0, **spec)
            await vs.start()
            c.volume_servers.append(vs)
            await c.wait_for_nodes(len(c.volume_servers))
        self.c = c
        self.env = RefEnv([c.master.advertise_url], out=self.out)

    async def sh(self, line: str) -> list:
        """Run one shell line -> its output lines, addresses masked."""
        self.out.seek(0)
        self.out.truncate(0)
        await (port_run if self.kind == "port" else ref_run)(self.env, line)
        text = self.out.getvalue()
        for i, vs in enumerate(self.c.volume_servers):
            text = text.replace(vs.url, f"vs{i}")
        return text.splitlines()

    async def rpc(self, vs, method: str, **fields):
        stub, vpb = _stub(self.kind, vs)
        return await getattr(stub, method)(
            getattr(vpb, f"{method}Request")(**fields))

    async def wait_for(self, pred, what: str) -> None:
        t_end = time.monotonic() + DEADLINE_S
        while time.monotonic() < t_end:
            if pred():
                return
            await asyncio.sleep(0.05)
        raise AssertionError(f"{self.kind}: {what} within {DEADLINE_S} s")

    def volumes(self) -> list:
        return [vs.store.find_volume(VID) for vs in self.c.volume_servers]

    def revisions(self) -> list:
        return [v.super_block.compaction_revision if v else None
                for v in self.volumes()]

    def layout(self):
        return next(vl for _, vl in self.c.master.topo.layouts()
                    if VID in vl.vid2location)

    def volume_list(self) -> list:
        """The master's VolumeList (Topology.to_info): per server index,
        the volume's record as its heartbeats reported it (the write
        time left out: the port reports none)."""
        info = self.c.master.topo.to_info()
        idx = {vs.url: i for i, vs in enumerate(self.c.volume_servers)}
        out = []
        for dc in info["data_centers"]:
            for rack in dc["racks"]:
                for node in rack["nodes"]:
                    for v in node["volumes"]:
                        v = dict(v)
                        v.pop("modified_at_second", None)
                        out.append((idx[node["id"]], v))
        return sorted(out, key=lambda x: x[0])

    def listed(self) -> bool:
        """The master's view holds both replicas' current sizes."""
        sizes = {i: v["size"] for i, v in self.volume_list()
                 if v["id"] == VID}
        return sizes == {i: v.content_size for i, v in
                         enumerate(self.volumes())}


async def _cluster_case(side: _Side, needles: list) -> dict:
    seen = {}
    await side.start()
    try:
        vs0, vs1 = side.c.volume_servers
        for vs in (vs0, vs1):
            await side.rpc(vs, "AllocateVolume", volume_id=VID,
                           replication="001")
        await side.wait_for(
            lambda: len(side.c.master.topo.lookup_volume("", VID) or ()) == 2,
            "the master lists both replicas")
        c = Client(vs0.ip, vs0.port)
        try:
            for nid, cookie, data in needles:
                st, _, _ = await c.request(
                    "POST", "/" + port_t.format_fid(VID, nid, cookie),
                    {"Content-Type": "application/octet-stream"}, data)
                assert st == 200
            for nid, cookie, _ in needles[::2]:
                st, _, _ = await c.request(
                    "DELETE", "/" + port_t.format_fid(VID, nid, cookie))
                assert st == 200
        finally:
            await c.close()
        ratios = [v.garbage_ratio for v in side.volumes()]
        sizes = [v.content_size for v in side.volumes()]
        seen["vacuum"] = await side.sh("volume.vacuum -garbageThreshold 0.3")
        seen["revisions"] = side.revisions()
        shrunk = [v.content_size for v in side.volumes()]
        assert all(b < a for a, b in zip(sizes, shrunk)), (sizes, shrunk)
        assert ratios[0] == ratios[1] > 0.3
        seen["sizes"] = shrunk
        seen["disabled"] = (
            await side.sh("volume.vacuum.disable")
            + await side.sh(f"volume.vacuum -volumeId {VID}"))
        seen["revisions_disabled"] = side.revisions()
        seen["enabled"] = await side.sh("volume.vacuum.enable")
        # one replica's compact fails: its shadow .dat path is taken
        cpd = os.path.join(vs1.store.locations[0].directory, f"{VID}.cpd")
        os.mkdir(cpd)
        seen["failed"] = await side.sh(f"volume.vacuum -volumeId {VID}")
        os.rmdir(cpd)
        seen["revisions_failed"] = side.revisions()
        seen["leftovers"] = sorted(
            n for vs in (vs0, vs1)
            for n in os.listdir(vs.store.locations[0].directory)
            if n.endswith((".cpd", ".cpx")))
        seen["writable_after_cleanup"] = VID in side.layout().writables
        await side.sh("lock")
        seen["configure"] = await side.sh(
            f"volume.configure.replication -volumeId {VID} -replication 002")
        with pytest.raises(ValueError, match="not found"):
            await side.sh("volume.configure.replication -volumeId 77 "
                          "-replication 001")
        await side.sh("unlock")
        seen["placement"] = [str(v.super_block.replica_placement)
                             for v in side.volumes()]
        # a vacuum after the configure keeps the new placement on disk
        seen["after_configure"] = await side.sh(f"volume.vacuum -volumeId {VID}")
        seen["revisions_final"] = side.revisions()
        seen["placement_on_disk"] = [
            str(port_t.ReplicaPlacement.from_byte(_read(v.dat_path)[1]))
            for v in side.volumes()]
        await side.wait_for(side.listed, "the master lists the new sizes")
        seen["volume_list"] = side.volume_list()
    finally:
        await side.c.stop()
    return seen


def test_cluster_vacuum_verbs_match_the_reference(tmp_path):
    """Both packages' clusters, a `001` volume on both servers: deletes
    past the threshold, then volume.vacuum compacts and commits on both
    replicas; with vacuum disabled a pass does nothing; with one
    replica's compact failing both clean up and the volume stays
    writable; volume.configure.replication persists the placement on
    every holder and survives a later vacuum.  Every shell output, the
    revisions, the .dat sizes and the master's VolumeList are equal."""
    needles = _needles(SEED + 5, 24)
    port = asyncio.run(_cluster_case(
        _Side("port", str(tmp_path / "port")), needles))
    ref = asyncio.run(_cluster_case(
        _Side("ref", str(tmp_path / "ref")), needles))
    assert port == ref
    assert port["vacuum"] == ["vacuum pass requested"]
    assert port["revisions"] == port["revisions_disabled"] == [1, 1]
    assert port["revisions_failed"] == [1, 1]
    assert port["leftovers"] == [] and port["writable_after_cleanup"]
    assert port["disabled"] == ["vacuum disabled", "vacuum pass requested"]
    assert sorted(port["configure"]) == [
        f"vs{i}: volume {VID} -> replication 002" for i in (0, 1)]
    assert port["placement"] == port["placement_on_disk"] == ["002"] * 2
    assert port["revisions_final"] == [2, 2]


def test_auto_vacuum_compacts_on_a_short_pulse(tmp_path):
    """-autoVacuum: the master's loop (every three pulses) finds a volume
    past the garbage threshold and vacuums it with no shell verb, in both
    packages, to the same size."""
    needles = _needles(SEED + 6, 16)

    async def case(side):
        await side.start()
        try:
            vs0 = side.c.volume_servers[0]
            await side.sh("volume.vacuum.disable")
            await side.rpc(vs0, "AllocateVolume", volume_id=VID,
                           replication="000")
            c = Client(vs0.ip, vs0.port)
            try:
                for nid, cookie, data in needles:
                    await c.request(
                        "POST", "/" + port_t.format_fid(VID, nid, cookie),
                        {"Content-Type": "application/octet-stream"}, data)
                for nid, cookie, _ in needles[:10]:
                    await c.request(
                        "DELETE", "/" + port_t.format_fid(VID, nid, cookie))
            finally:
                await c.close()
            # the loop's first pass finds the volume at its final garbage
            await side.sh("volume.vacuum.enable")
            v = vs0.store.find_volume(VID)
            await side.wait_for(
                lambda: v.super_block.compaction_revision == 1,
                "the auto-vacuum loop's pass")
            return v.content_size, v.garbage_ratio, len(v.nm)
        finally:
            await side.c.stop()

    got = [asyncio.run(case(_Side(kind, str(tmp_path / kind), n=1,
                                  auto_vacuum=True)))
           for kind in ("port", "ref")]
    assert got[0] == got[1] and got[0][1:] == (0.0, 6)
