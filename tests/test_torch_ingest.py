"""The port's streaming ingest plane (seaweedfs_tpu_torch/ingest/ and
ops/rs_ingest.py) held against the JAX package's, on the CPU.

The same seeded inputs (numpy default_rng) go through both packages: the
JAX side with its host codec (`cpu`) and with K1 in Pallas interpret mode
(`pallas`, shed_cold off), the port's with K1's plain version (`torch`)
and its host codecs (`numpy`, `native`).  No tolerance: every output is
byte-equal.  The stripe geometry is shrunk 1024x in BOTH packages'
pipeline modules (their constants are read at call time), so a "10 MB
stripe row" is 10 KB.

Mirrors tests/test_ingest_pipeline.py case for case where a case applies,
as one parametrised body over both packages.  Its viewguard cases test the
JAX package's donation gate, which the port has no counterpart of; in
their place the port is held to the rule that replaces it: a slot goes
back to the pool only after its row's parity is written.  The volume
servers of both packages stream the same needles over HTTP and seal to
the same shard files, and refuse at the door with the same statuses.
"""
import argparse
import asyncio
import os
import re
import shutil
import threading
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu import stats as jax_stats
from seaweedfs_tpu.command import volume as jax_cmd_volume
from seaweedfs_tpu.ingest import GroupCommitter as JaxGroupCommitter
from seaweedfs_tpu.ingest import IngestConfig as JaxIngestConfig
from seaweedfs_tpu.ingest import IngestPipeline as JaxIngestPipeline
from seaweedfs_tpu.ingest import IngestPlane as JaxIngestPlane
from seaweedfs_tpu.ingest import pipeline as jax_pipeline
from seaweedfs_tpu.ops import rs_ingest as jax_rs_ingest
from seaweedfs_tpu.storage import needle as jax_needle
from seaweedfs_tpu.storage.ec import encoder as jax_encoder
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.command import volume as cmd_volume
from seaweedfs_tpu_torch.ingest import (
    GroupCommitter,
    IngestConfig,
    IngestPipeline,
    IngestPlane,
)
from seaweedfs_tpu_torch.ingest import pipeline as port_pipeline
from seaweedfs_tpu_torch.ops import rs_ingest
from seaweedfs_tpu_torch.server import volume as server_volume
from seaweedfs_tpu_torch.server.http import Client
from seaweedfs_tpu_torch.serving.tiering import HeatTracker, HostShardCache
from seaweedfs_tpu_torch.storage import ec as port_ec
from seaweedfs_tpu_torch.storage import needle as port_needle
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.volume import Volume

SMALL = 1024
LARGE = 8192
ROW = 10 * SMALL  # 10 KB stripe row
STREAMABLE = 10 * LARGE  # 80 KB small-row regime

# per package: its plane's classes, its registry and its host backend names
PKGS = {
    "jax": types.SimpleNamespace(
        pipeline=jax_pipeline, rs_ingest=jax_rs_ingest,
        IngestConfig=JaxIngestConfig, IngestPipeline=JaxIngestPipeline,
        IngestPlane=JaxIngestPlane, GroupCommitter=JaxGroupCommitter,
        registry=jax_stats.REGISTRY, host="cpu", seal="cpu",
    ),
    "torch": types.SimpleNamespace(
        pipeline=port_pipeline, rs_ingest=rs_ingest,
        IngestConfig=IngestConfig, IngestPipeline=IngestPipeline,
        IngestPlane=IngestPlane, GroupCommitter=GroupCommitter,
        registry=stats.REGISTRY, host="numpy", seal="numpy",
    ),
}


def _sample(pkg, name, labels=None):
    return PKGS[pkg].registry.get_sample_value(name, labels or {}) or 0.0


@pytest.fixture
def small_geometry(monkeypatch):
    """Shrink the stripe geometry 1024x in both packages' pipelines."""
    for mod in (jax_pipeline, port_pipeline):
        monkeypatch.setattr(mod, "SMALL_BLOCK_SIZE", SMALL)
        monkeypatch.setattr(mod, "LARGE_BLOCK_SIZE", LARGE)
        monkeypatch.setattr(mod, "ROW_BYTES", ROW)
        monkeypatch.setattr(mod, "STREAMABLE_BYTES", STREAMABLE)


class FakeVolume:
    """The minimal surface IngestPipeline/GroupCommitter touch."""

    def __init__(self, dat_path, vid=7):
        self.id = vid
        self.dat_path = dat_path
        self.syncs = 0

    @property
    def content_size(self):
        return os.path.getsize(self.dat_path)

    def sync(self):
        self.syncs += 1


def _append(path, nbytes, rng):
    data = rng.integers(0, 256, size=nbytes, dtype=np.uint8).tobytes()
    with open(path, "ab") as f:
        f.write(data)
    return data


def shard_bytes(base):
    out = {}
    for i in range(14):
        with open(base + port_ec.to_ext(i), "rb") as f:
            out[i] = f.read()
    return out


def offline_shards(dat, tmp_path, name):
    """Both packages' offline write_ec_files on copies of `dat`, at the
    small geometry: they must agree, and are the oracle."""
    got = []
    for pkg in ("jax", "torch"):
        base = str(tmp_path / f"{name}_{pkg}")
        shutil.copyfile(dat, base + ".dat")
        if pkg == "jax":
            jax_encoder.write_ec_files(base, backend="cpu", large_block=LARGE,
                                       small_block=SMALL)
        else:
            port_ec.write_ec_files(base, backend="numpy", large_block=LARGE,
                                   small_block=SMALL)
        got.append(shard_bytes(base))
    assert got[0] == got[1], "the two offline encodes disagree"
    return got[0]


# the arena wait a writer may take before its pipeline sheds: the cases
# that hold bytes (not backpressure) must never shed, and on a loaded CPU
# a first Pallas-interpret or plain-version encode can outlast the 2 s
# default; the starved-arena case sets its own 50 ms
NO_SHED_MS = 60_000


def _cfg(pkg, **kw):
    kw.setdefault("backend", PKGS[pkg].host)
    kw.setdefault("backpressure_ms", NO_SHED_MS)
    return PKGS[pkg].IngestConfig(**kw)


def _encoder(pkg, backend):
    if pkg == "jax":
        if backend == "pallas":
            return jax_rs_ingest.StreamEncoder("pallas", shed_cold=False)
        return jax_rs_ingest.StreamEncoder(backend)
    return rs_ingest.StreamEncoder(backend)


# (package, encoder backend, rows through K1's route): the JAX host codec,
# JAX K1 in Pallas interpret mode, the port's K1 plain version, the
# port's host codecs
CASES = [("jax", "cpu", False), ("jax", "pallas", True),
         ("torch", "torch", True), ("torch", "numpy", False),
         ("torch", "native", False)]
CASE_IDS = [f"{p}-{b}" for p, b, _ in CASES]


# ------------------------------------------------------------- the encoder


@pytest.mark.parametrize("backend", ["torch", "numpy", "native"])
def test_row_parity_equals_jax(backend):
    """One staged row's parity: the port's encoder on each backend against
    the JAX package's host codec and its Pallas K1 (interpret mode)."""
    rows = np.random.default_rng(3).integers(0, 256, (10, 1024), np.uint8)
    want = jax_rs_ingest.StreamEncoder("cpu").encode(rows)
    pallas = jax_rs_ingest.StreamEncoder("pallas", shed_cold=False)
    assert np.array_equal(pallas.encode(rows), want)
    enc = rs_ingest.StreamEncoder(backend)
    got = enc.encode(rows)
    assert got.shape == (4, 1024) and np.array_equal(got, want)
    device = backend == "torch"
    assert (enc.device_rows, enc.host_rows) == ((1, 0) if device else (0, 1))
    assert enc.failed_rows == 0


def test_unknown_ingest_backend_refused():
    with pytest.raises(ValueError, match="unknown ingest backend"):
        rs_ingest.StreamEncoder("auto")


# --------------------------------------------------- streamed == offline


@pytest.mark.parametrize("pkg,backend,device", CASES, ids=CASE_IDS)
def test_streamed_seal_matches_offline_encode(tmp_path, small_geometry, pkg,
                                              backend, device):
    """Ragged appends + feed() after each; seal() consumes the streamed
    parity and the 14 shard files equal both packages' offline
    write_ec_files on a copy of the same .dat."""
    base = str(tmp_path / "v1")
    dat = base + ".dat"
    open(dat, "wb").close()
    vol = FakeVolume(dat, vid=1)
    m = PKGS[pkg]
    p = m.IngestPipeline(vol, _encoder(pkg, backend), _cfg(pkg))
    rng = np.random.default_rng(5)
    # 3 complete rows + a ragged tail, grown in awkward chunk sizes
    for nbytes in (4097, ROW, 9999, ROW + 1, 123):
        _append(dat, nbytes, rng)
        p.feed()
    assert vol.content_size == 4097 + ROW + 9999 + ROW + 1 + 123
    assert p.staged_rows == vol.content_size // ROW == 3
    assert p.seal(backend=m.seal) is True
    assert p.encoded_rows == 3
    assert (p.rows_device, p.rows_host) == ((3, 0) if device else (0, 3))
    want = offline_shards(dat, tmp_path, "oracle")
    got = shard_bytes(base)
    for i in range(14):
        assert got[i] == want[i], f"shard {i} diverged from offline encode"
    # scratch consumed by the rename, not left behind
    assert not [f for f in os.listdir(tmp_path) if ".ing" in f]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_large_row_boundary_invalidates_and_cleans_scratch(
    tmp_path, small_geometry, pkg
):
    """One byte past DATA_SHARDS x LARGE_BLOCK the small-row layout is
    void: the pipeline invalidates, seal() reports offline, and no parity
    scratch survives."""
    base = str(tmp_path / "v9")
    dat = base + ".dat"
    open(dat, "wb").close()
    vol = FakeVolume(dat, vid=9)
    m = PKGS[pkg]
    p = m.IngestPipeline(vol, _encoder(pkg, m.host), _cfg(pkg))
    rng = np.random.default_rng(6)
    _append(dat, 2 * ROW, rng)
    p.feed()
    _append(dat, STREAMABLE, rng)  # now past the boundary
    p.feed()
    assert not p.valid
    assert "large-row" in p.invalid_reason
    assert p.seal(backend=m.seal) is False
    assert not [f for f in os.listdir(tmp_path) if ".ing" in f]


# ------------------------------------------------------- backpressure


def _blocked_encoder(pkg):
    """A host encoder that parks on an event: the arena cannot drain."""
    m = PKGS[pkg]

    class Blocked(m.rs_ingest.StreamEncoder):
        def __init__(self):
            super().__init__(m.host)
            self.release = threading.Event()

        def encode_host(self, rows):
            assert self.release.wait(10), "test forgot to release the encoder"
            return super().encode_host(rows)

    return Blocked()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_arena_stage_blocks_then_raises(pkg):
    arena = PKGS[pkg].rs_ingest.IngestArena(2, 64, slots=1)
    buf = arena.stage(timeout_s=0.01)
    assert arena.free_slots == 0
    with pytest.raises(PKGS[pkg].rs_ingest.ArenaExhausted):
        arena.stage(timeout_s=0.01)
    assert arena.waits == 1
    arena.reclaim(buf)
    assert arena.stage(timeout_s=0.01) is buf  # pool recycles the row


@pytest.mark.parametrize("pkg", list(PKGS))
def test_starved_arena_sheds_pipeline_to_offline(tmp_path, small_geometry, pkg):
    """Encode leg wedged + 1-slot arena: the second row's stage() waits out
    the backpressure budget, the pipeline invalidates (writes keep
    landing), and seal() runs offline — the upload never wedges."""
    base = str(tmp_path / "v3")
    dat = base + ".dat"
    open(dat, "wb").close()
    vol = FakeVolume(dat, vid=3)
    m = PKGS[pkg]
    enc = _blocked_encoder(pkg)
    p = m.IngestPipeline(vol, enc, _cfg(pkg, arena_slots=1, backpressure_ms=50))
    rng = np.random.default_rng(7)
    shed_before = _sample(pkg, "SeaweedFS_volumeServer_ingest_shed_total",
                          {"reason": "arena"})
    _append(dat, 2 * ROW, rng)
    t0 = time.monotonic()
    p.feed()  # row 0 stages; row 1 starves behind the wedged encoder
    assert time.monotonic() - t0 >= 0.05  # the writer genuinely waited
    assert not p.valid
    assert "arena starved" in p.invalid_reason
    assert p.arena.waits >= 1
    assert _sample(pkg, "SeaweedFS_volumeServer_ingest_shed_total",
                   {"reason": "arena"}) == shed_before + 1
    enc.release.set()  # unwedge so the worker drains and close() joins
    assert p.seal(backend=m.seal) is False
    # the volume is still perfectly encodable offline
    port_ec.write_ec_files(base, backend="numpy", large_block=LARGE,
                           small_block=SMALL)
    assert len(shard_bytes(base)) == 14


# ------------------------------------------------------- group commit


class _Counting:
    def __init__(self, vid):
        self.id = vid
        self.syncs = 0

    def sync(self):
        self.syncs += 1


@pytest.mark.parametrize("pkg", list(PKGS))
def test_group_commit_batches_and_dedups_per_volume(pkg):
    """12 writers over 2 volumes pile into shared batches: every writer is
    acked by FEWER syncs than writers (one per volume per batch)."""
    gc = PKGS[pkg].GroupCommitter(max_batch=64, max_delay_s=0.15)
    try:
        vols = [_Counting(1), _Counting(2)]
        barrier = threading.Barrier(12)
        errs = []

        def writer(i):
            try:
                barrier.wait(5)
                gc.commit(vols[i % 2], timeout_s=10)
            except BaseException as e:  # noqa: BLE001 — collected
                errs.append(e)

        threads = [threading.Thread(target=writer, args=(i,)) for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(15)
        assert not any(th.is_alive() for th in threads)
        assert not errs
        total = vols[0].syncs + vols[1].syncs
        assert vols[0].syncs >= 1 and vols[1].syncs >= 1
        assert total < 12, f"no batching: {total} syncs for 12 writers"
    finally:
        gc.close()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_group_commit_propagates_flush_error_to_writers(pkg):
    class Exploding:
        id = 5

        def sync(self):
            raise OSError("disk gone")

    gc = PKGS[pkg].GroupCommitter(max_batch=4, max_delay_s=0.01)
    try:
        with pytest.raises(OSError, match="disk gone"):
            gc.commit(Exploding(), timeout_s=5)
    finally:
        gc.close()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_group_commit_degrades_to_direct_sync_after_close(pkg):
    gc = PKGS[pkg].GroupCommitter()
    gc.close()
    v = _Counting(8)
    gc.commit(v)  # must not hang on a dead flusher
    assert v.syncs == 1


# ---------------------------------------------------------- admission


@pytest.mark.parametrize("pkg", list(PKGS))
def test_doomed_upload_refused_at_the_door(pkg):
    """10 MB at a 100 KB/s floor needs ~102 s; with 0.5 s of deadline
    budget left the PUT is refused now."""
    m = PKGS[pkg]
    plane = m.IngestPlane(_cfg(pkg, min_rate_kbps=100))
    try:
        assert plane.admit("interactive", 10 * 2**20, remaining_s=0.5) == "deadline"
        assert plane.shed_counts["deadline"] == 1
        # same body with no propagated deadline: admitted
        assert plane.admit("interactive", 10 * 2**20, remaining_s=None) is None
        plane.complete("interactive", 0.01)
        plane2 = m.IngestPlane(_cfg(pkg, min_rate_kbps=0))  # check disabled
        try:
            assert plane2.admit("interactive", 10 * 2**20, 0.5) is None
            plane2.complete("interactive", 0.01)
        finally:
            plane2.close()
    finally:
        plane.close()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_bulk_write_tier_binds_first_under_pressure(pkg):
    """Bulk queue budget exhausts while interactive keeps admitting."""
    plane = PKGS[pkg].IngestPlane(_cfg(pkg, bulk_queue=2, interactive_queue=8))
    try:
        assert plane.admit("bulk", 1024, None) is None
        assert plane.admit("bulk", 1024, None) is None
        assert plane.admit("bulk", 1024, None) == "qos"
        assert plane.shed_counts["qos"] == 1
        assert plane.admit("interactive", 1024, None) is None
        # draining a bulk writer reopens the bulk budget
        plane.complete("bulk", 0.01)
        assert plane.admit("bulk", 1024, None) is None
    finally:
        plane.close()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_on_write_counts_heats_feeds_and_commits(tmp_path, small_geometry, pkg):
    """The post-append hook: bytes counter, write heat into the ladder
    (junk tier normalized), pipeline feed, group-commit ack."""

    class Heat:
        def __init__(self):
            self.notes = []

        def note(self, vid, tier):
            self.notes.append((vid, tier))

    heat = Heat()
    plane = PKGS[pkg].IngestPlane(
        _cfg(pkg, fsync=True, fsync_max_batch=1, fsync_max_delay_ms=1.0),
        heat=heat,
    )
    try:
        dat = str(tmp_path / "v4.dat")
        open(dat, "wb").close()
        vol = FakeVolume(dat, vid=4)
        rng = np.random.default_rng(8)
        _append(dat, ROW + 5, rng)
        name = "SeaweedFS_volumeServer_ingest_bytes_total"
        before = _sample(pkg, name)
        plane.on_write(vol, ROW + 5, tier="bulk")
        assert _sample(pkg, name) == before + ROW + 5
        assert heat.notes == [(4, "bulk")]
        assert vol.syncs == 1  # group commit acked durably
        assert plane.pipelines[4].staged_rows == 1
        plane.on_write(vol, 0, tier="not-a-tier")
        assert heat.notes[-1] == (4, "interactive")
        assert plane.snapshot()["pipelines"] == 1
    finally:
        plane.close()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_plane_seal_cleans_stale_scratch_without_pipeline(tmp_path, pkg):
    """Scratch from a previous process is never trusted into .ec files:
    plane.seal of an unknown volume removes it and reports offline."""
    plane = PKGS[pkg].IngestPlane(_cfg(pkg))
    try:
        base = str(tmp_path / "v5")
        stale = base + ".ing10"
        with open(stale, "wb") as f:
            f.write(b"poison")
        assert plane.seal(55, base, backend=PKGS[pkg].seal) is False
        assert not os.path.exists(stale)
    finally:
        plane.close()


BAD_CONFIGS = [
    dict(arena_slots=0), dict(backpressure_ms=-1), dict(fsync_max_batch=0),
    dict(fsync_max_delay_ms=-1), dict(min_rate_kbps=-1),
    dict(interactive_queue=0), dict(bulk_queue=0), dict(deadline_ms=-1),
]


@pytest.mark.parametrize("bad", BAD_CONFIGS,
                         ids=[next(iter(b)) for b in BAD_CONFIGS])
def test_ingest_config_validation_matches(bad):
    """Each bad value is refused by both packages with the same message;
    the defaults are the reference's, less `backend` (None = the server's
    -ec.backend, where the reference says auto)."""
    with pytest.raises(ValueError) as ref:
        JaxIngestConfig(**bad).validated()
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        IngestConfig(**bad).validated()
    ours, theirs = vars(IngestConfig().validated()), vars(JaxIngestConfig())
    assert ours.pop("backend") is None and theirs.pop("backend") == "auto"
    assert ours == theirs


# ------------------------------------------------ the port's slot rule


def test_slot_reclaimed_only_after_parity_written(tmp_path, small_geometry):
    """The rule that replaces the reference's donation gate: a row's slot
    goes back to the pool only after that row's parity is on disk, and
    while a row is out (staged, encoding, writing) its slot is not in the
    pool for another row to stage into."""
    base = str(tmp_path / "v6")
    dat = base + ".dat"
    open(dat, "wb").close()
    vol = FakeVolume(dat, vid=6)
    p = IngestPipeline(vol, rs_ingest.StreamEncoder("torch"),
                       IngestConfig(backend="torch", arena_slots=2,
                                    backpressure_ms=NO_SHED_MS))
    events = []
    free_ids = lambda: {id(b) for b in list(p.arena._free.queue)}  # noqa: E731
    write_parity, reclaim = p._write_parity, p.arena.reclaim
    out_slot = {}

    def traced_write(row, parity):
        events.append(("write", row))
        assert out_slot[row] not in free_ids(), "slot reclaimed before its write"
        write_parity(row, parity)

    slot_row = {}  # a slot out of the pool -> the row staged in it

    def traced_reclaim(buf):
        events.append(("reclaim", slot_row.pop(id(buf))))
        reclaim(buf)

    stage = p.arena.stage

    def traced_stage(timeout_s=None):
        buf = stage(timeout_s)
        assert id(buf) not in slot_row, "a slot was staged twice"
        slot_row[id(buf)] = p.staged_rows
        out_slot[p.staged_rows] = id(buf)
        return buf

    p._write_parity, p.arena.reclaim, p.arena.stage = (
        traced_write, traced_reclaim, traced_stage)
    rng = np.random.default_rng(9)
    for _ in range(5):
        _append(dat, ROW, rng)
        p.feed()
    assert p.seal(backend="torch") is True
    assert [e for e in events if e[0] == "write"] == [("write", r) for r in range(5)]
    for r in range(5):
        assert events.index(("write", r)) < events.index(("reclaim", r))
    assert shard_bytes(base) == offline_shards(dat, tmp_path, "oracle")


def test_encode_failure_invalidates_counts_and_seals_offline(
    tmp_path, small_geometry
):
    """A failed device encode raises out of encode(): the worker logs it,
    the encoder counts it, the pipeline invalidates, and the seal runs
    offline — no row drops to the host codec by itself."""

    class Failing(rs_ingest.StreamEncoder):
        def _encode_cuda(self, rows):
            raise RuntimeError("gf2_matmul launch failed (2): out of memory")

    enc = Failing("torch")
    base = str(tmp_path / "v8")
    dat = base + ".dat"
    open(dat, "wb").close()
    vol = FakeVolume(dat, vid=8)
    p = IngestPipeline(vol, enc, IngestConfig(backend="torch"))
    enc.backend = "cuda"  # take the card's branch, whose launch fails
    _append(dat, 2 * ROW, np.random.default_rng(10))
    p.feed()
    assert p.seal(backend="torch") is False
    assert p.invalid_reason == "encode worker error"
    assert (enc.failed_rows, enc.device_rows, enc.host_rows) == (1, 0, 0)
    assert p.rows_host == 0


# ------------------------------------------------ the three-way race


def test_streamed_writes_race_zero_copy_reads_and_tier_churn(
    tmp_path, small_geometry
):
    """The whole plane under contention on ONE port volume: a writer
    appends needles and feeds K1's plain version, readers pull zero-copy
    needle views off the same .dat, and a tier thread churns write heat
    plus host-cache staging and eviction for the same vid.  Every read is
    byte-exact, and the final seal matches both packages' offline encodes
    bit for bit."""
    v = Volume(str(tmp_path), 41)
    errors: list[BaseException] = []
    blobs: dict[int, bytes] = {}
    blobs_lock = threading.Lock()
    stop = threading.Event()
    heat = HeatTracker(half_life_s=1e9)
    cache = HostShardCache(budget_bytes=1 << 20)
    p = IngestPipeline(v, rs_ingest.StreamEncoder("torch"),
                       IngestConfig(backend="torch", arena_slots=2,
                                    backpressure_ms=NO_SHED_MS))

    def writer():
        rng = np.random.default_rng(11)
        nid = 0
        try:
            while v.content_size < 4 * ROW and not stop.is_set():
                nid += 1
                data = rng.integers(0, 256, size=int(rng.integers(200, 3000)),
                                    dtype=np.uint8).tobytes()
                v.write(nid, 0xABC, data, name=b"race")
                with blobs_lock:
                    blobs[nid] = data
                p.feed()
                heat.note(v.id, "interactive")
        except BaseException as e:  # noqa: BLE001 — collected
            errors.append(e)
        finally:
            stop.set()

    def reader(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set() or rng.random() < 0.5:
                with blobs_lock:
                    nids = list(blobs)
                if not nids:
                    time.sleep(0.001)
                    continue
                nid = nids[int(rng.integers(0, len(nids)))]
                n = v.read(nid, zero_copy=True)
                if bytes(n.data) != blobs[nid]:
                    errors.append(AssertionError(f"stale bytes for needle {nid}"))
                    return
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — collected
            errors.append(e)

    def tier_churn():
        rng = np.random.default_rng(13)
        try:
            while not stop.is_set():
                heat.note(v.id, "bulk")
                shard = rng.integers(0, 256, size=2048, dtype=np.uint8)
                cache.put_volume(v.id, {0: shard, 1: shard.copy()})
                cache.evict(v.id)
        except BaseException as e:  # noqa: BLE001 — collected
            errors.append(e)

    threads = [threading.Thread(target=writer), threading.Thread(target=reader, args=(21,)),
               threading.Thread(target=reader, args=(22,)),
               threading.Thread(target=tier_churn)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    stop.set()
    assert not errors, errors[0]
    assert not any(th.is_alive() for th in threads)
    # quiesce, then seal (the seal takes the feed lock)
    v.sync()
    p.feed()
    assert p.staged_rows >= 4, (p.staged_rows, p.invalid_reason)
    base = Volume.base_name(str(tmp_path), v.id, v.collection)
    assert p.seal(backend="torch") is True and p.valid
    assert p.arena.free_slots == p.arena.slots  # every slot came back
    assert heat.value(41) > 0  # write heat registered on the ladder
    assert shard_bytes(base) == offline_shards(base + ".dat", tmp_path, "oracle")
    v.close()


# ------------------------------------------- both volume servers over HTTP


class _FrozenTime:
    """`time` with the wall clock stopped, so two servers stamp the same
    last_modified and append_at_ns into the same needles."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return 1_700_000_000.0

    @staticmethod
    def time_ns():
        return 1_700_000_000 * 10**9


@pytest.fixture
def frozen_clock(monkeypatch):
    from seaweedfs_tpu.server import volume as jax_server_volume

    for mod in (server_volume, jax_server_volume, port_needle, jax_needle):
        monkeypatch.setattr(mod, "time", _FrozenTime())


async def _both_servers(tmp_path, port_ingest, ref_ingest):
    """The port's and the JAX package's volume servers in process over
    their own directories, volume 3 each, no master, -ec.backend numpy."""
    from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer

    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    port = server_volume.VolumeServer([], [str(port_dir)], port=0,
                                      ec_backend="numpy", ec_ingest=port_ingest)
    ref = RefVolumeServer(masters=[], directories=[str(ref_dir)], port=0,
                          grpc_port=0, ec_backend="numpy", ec_ingest=ref_ingest)
    for vs in (port, ref):
        vs.store.add_volume(3)
    await port.start()
    await ref.start(heartbeat=False)
    return port, ref


def test_servers_stream_the_same_needles_and_seal_alike(tmp_path, small_geometry,
                                                        frozen_clock):
    """The same seeded needles POSTed in order through both servers fill
    several stripe rows; ec_generate then seals from the stream on both
    (one streamed seal each), and the 14 shard files and the .ecx are
    byte-equal across the servers and to the offline encodes."""
    rng = np.random.default_rng(12)
    bodies = []
    while sum(len(b) for b in bodies) < 6 * ROW:
        bodies.append(rng.integers(0, 256, int(rng.integers(500, 3000)),
                                   np.uint8).tobytes())
    seals = "SeaweedFS_volumeServer_ingest_seals_total"

    async def go():
        port, ref = await _both_servers(
            tmp_path, IngestConfig(), JaxIngestConfig(backend="cpu"))
        try:
            before = [_sample(pkg, seals, {"path": "streamed"})
                      for pkg in ("torch", "jax")]
            statuses = []
            for vs in (port, ref):
                c = Client("127.0.0.1", vs.port)
                try:
                    for i, body in enumerate(bodies, start=1):
                        status, _, _ = await c.request(
                            "POST", "/" + t.format_fid(3, i, 0x1234 + i),
                            {"Content-Type": "application/octet-stream"}, body)
                        statuses.append(status)
                finally:
                    await c.close()
            assert statuses == [200] * (2 * len(bodies))
            assert port.ingest.encoder.backend == "numpy"
            assert port.ingest.pipelines[3].staged_rows >= 5
            for vs in (port, ref):
                await asyncio.to_thread(vs.store.ec_generate, 3)
            after = [_sample(pkg, seals, {"path": "streamed"})
                     for pkg in ("torch", "jax")]
            assert [a - b for a, b in zip(after, before)] == [1, 1]
        finally:
            await port.stop()
            await ref.stop()

    asyncio.run(go())
    port_base, ref_base = str(tmp_path / "port" / "3"), str(tmp_path / "ref" / "3")
    with open(port_base + ".dat", "rb") as a, open(ref_base + ".dat", "rb") as b:
        assert a.read() == b.read(), "the servers wrote different needles"
    got = shard_bytes(port_base)
    assert got == shard_bytes(ref_base)
    assert got == offline_shards(port_base + ".dat", tmp_path, "oracle")
    with open(port_base + ".ecx", "rb") as a, open(ref_base + ".ecx", "rb") as b:
        assert a.read() == b.read()


async def _raw_post(port, path, headers, body=b""):
    """Send a POST's head (and `body`, maybe less than its Content-Length)
    -> (reader, writer); read the answer with _raw_answer."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = f"POST {path} HTTP/1.1\r\nHost: t\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n"
    writer.write(head.encode() + body)
    await writer.drain()
    return reader, writer


async def _raw_answer(reader, writer):
    head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 10)
    lines = head.decode().split("\r\n")
    hdrs = {k.lower(): v.strip() for k, _, v in
            (ln.partition(":") for ln in lines[1:] if ln)}
    writer.close()
    return int(lines[0].split()[1]), hdrs.get("retry-after")


def test_servers_refuse_at_the_door_alike(tmp_path):
    """A bulk write past a bulk queue of 1 is a 429 with Retry-After 1,
    and an upload its deadline cannot carry is a 504, from both servers,
    before either reads the body."""
    async def go():
        port, ref = await _both_servers(
            tmp_path, IngestConfig(bulk_queue=1),
            JaxIngestConfig(backend="cpu", bulk_queue=1))
        got = []
        try:
            for vs in (port, ref):
                # one bulk upload admitted, its body still on the way
                held = await _raw_post(vs.port, "/" + t.format_fid(3, 1, 0x1234), {
                    "Content-Length": "20", "X-Seaweed-QoS": "bulk"}, b"0123456789")
                for _ in range(1000):  # until its admission is counted
                    if vs.ingest._inflight["bulk"] == 1:
                        break
                    await asyncio.sleep(0.01)
                assert vs.ingest._inflight["bulk"] == 1
                shed = await _raw_post(vs.port, "/" + t.format_fid(3, 2, 0x1234), {
                    "Content-Length": "10", "X-Seaweed-QoS": "bulk"})
                qos = await _raw_answer(*shed)
                held[1].write(b"0123456789")
                ok = await _raw_answer(*held)
                doomed = await _raw_post(vs.port, "/" + t.format_fid(3, 3, 0x1234), {
                    "Content-Length": str(1 << 20),
                    "X-Seaweed-Deadline-Ms": "100"})
                got.append((qos, ok[0], await _raw_answer(*doomed)))
        finally:
            await port.stop()
            await ref.stop()
        return got

    port_got, ref_got = asyncio.run(go())
    assert port_got[0] == ref_got[0] == (429, "1")
    assert port_got[2][0] == ref_got[2][0] == 504
    assert port_got[1] == ref_got[1] == 200


# ---------------------------------------------------------------- flags


INGEST_ARGV = ["-ec.ingest.arenaSlots", "3", "-ec.ingest.backpressureMs", "500",
               "-ec.ingest.fsync", "-ec.ingest.fsyncMaxBatch", "16",
               "-ec.ingest.fsyncMaxDelayMs", "1.5", "-ec.ingest.minRateKBps", "64",
               "-ec.ingest.interactiveQueue", "32", "-ec.ingest.bulkQueue", "4",
               "-ec.ingest.deadlineMs", "900"]
TIER_ARGV = ["-ec.tier.intervalSeconds", "2", "-ec.tier.hostCacheMB", "64",
             "-ec.tier.halfLifeSeconds", "30", "-ec.tier.promoteRatio", "2.5",
             "-ec.tier.minResidencySeconds", "5", "-ec.tier.bulkWeight", "0.5"]
TIER_FIELDS = ("tier", "tier_interval_seconds", "tier_host_cache_mb",
               "tier_half_life_seconds", "tier_promote_ratio",
               "tier_min_residency_seconds", "tier_bulk_weight")


def _parse(mod, argv):
    p = argparse.ArgumentParser()
    mod.add_args(p)
    return p.parse_args(argv)


@pytest.mark.parametrize("argv", [[], INGEST_ARGV + ["-ec.ingest.disable"],
                                  INGEST_ARGV], ids=["defaults", "disabled", "set"])
def test_ingest_flags_parse_like_reference(argv):
    """The -ec.ingest.* flags give the IngestConfig the reference builds
    from the same command line (its run() reads the same dests), less the
    backend's names."""
    ref_args = _parse(jax_cmd_volume, argv)
    ours = cmd_volume.ingest_config(_parse(cmd_volume, argv))
    fields = {f: getattr(ref_args, "ec_ingest_" + f) for f in (
        "arena_slots", "backpressure_ms", "fsync", "fsync_max_batch",
        "fsync_max_delay_ms", "min_rate_kbps", "interactive_queue",
        "bulk_queue", "deadline_ms")}
    want = JaxIngestConfig(enabled=not ref_args.ec_ingest_disable,
                           backend=ref_args.ec_ingest_backend, **fields)
    assert vars(ours) == {**vars(want), "backend": None}
    assert want.backend == "auto"
    assert cmd_volume.ingest_config(_parse(
        cmd_volume, ["-ec.ingest.backend", "native"])).backend == "native"


@pytest.mark.parametrize("argv", [[], TIER_ARGV + ["-ec.tier.disable"], TIER_ARGV],
                         ids=["defaults", "disabled", "set"])
def test_tier_flags_parse_like_reference(argv):
    """The -ec.tier.* flags give the ServingConfig tier* fields the
    reference builds from the same command line."""
    from seaweedfs_tpu.serving import ServingConfig as JaxServingConfig

    ref_args = _parse(jax_cmd_volume, argv)
    want = JaxServingConfig(
        tier=not ref_args.ec_tier_disable,
        tier_interval_seconds=ref_args.ec_tier_interval_seconds,
        tier_host_cache_mb=ref_args.ec_tier_host_cache_mb,
        tier_half_life_seconds=ref_args.ec_tier_half_life_seconds,
        tier_promote_ratio=ref_args.ec_tier_promote_ratio,
        tier_min_residency_seconds=ref_args.ec_tier_min_residency_seconds,
        tier_bulk_weight=ref_args.ec_tier_bulk_weight,
    ).validated()
    ours = cmd_volume.serving_config(_parse(cmd_volume, argv))
    assert {f: getattr(ours, f) for f in TIER_FIELDS} == {
        f: getattr(want, f) for f in TIER_FIELDS}
