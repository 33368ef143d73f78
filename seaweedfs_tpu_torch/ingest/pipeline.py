"""The streaming write plane: per-volume ingest pipelines, group-commit
fsync, and QoS/deadline admission at the upload door.

Port of seaweedfs_tpu/ingest/pipeline.py.  Layout invariant the whole
plane rests on (storage/ec/layout.py): a volume smaller than DATA_SHARDS x
LARGE_BLOCK_SIZE (10 GB) is striped entirely in SMALL_BLOCK rows — row r of
the `.dat` covers bytes [r*10MB, (r+1)*10MB), shard i's block is the
contiguous 1 MB at r*10MB + i*1MB.  A COMPLETED row's shard blocks
therefore never move no matter how much the volume grows afterwards, so
parity encoded while the volume is still being written is byte-identical
to what the offline `write_ec_files` would compute at seal time.  The
moment that invariant can break — the .dat crossing the large-row
boundary, a vacuum rewriting offsets — the pipeline invalidates itself and
the seal falls back to the offline bulk encode; streaming is an
optimization with an exact escape hatch, never a second source of truth.

Per volume, the pipeline is the bulk-executor legs turned online:

  writer thread (h_write's to_thread) --feed()--> stage row in arena
        (bounded: blocks when the encode leg is behind = backpressure)
  encode worker -----------------------> K1 on the card (ops/rs_ingest.py)
  parity scratch files (.ing10-.ing13) -> renamed .ec10-.ec13 at seal

Seal then only re-reads the .dat once to emit the data shards (pure file
IO — the same read the offline encode would do) and encodes the
zero-padded tail row; all interior parity compute already happened while
the writes were arriving.

The geometry constants (SMALL_BLOCK_SIZE, LARGE_BLOCK_SIZE, ROW_BYTES,
STREAMABLE_BYTES) are read from this module's globals at call time, so a
test can shrink the stripe geometry by patching them.  A row is read from
the .dat straight into its (pinned) arena slot with one preadv.
"""
from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np

from ..ops import rs_ingest
from ..stats import metrics as stats_metrics
from ..storage.ec.bulk import read_stripe, write_or_seek
from ..storage.ec.encoder import _iter_rows, _save_vif_from_superblock
from ..storage.ec.layout import (
    DATA_SHARDS,
    LARGE_BLOCK_SIZE,
    SMALL_BLOCK_SIZE,
    TOTAL_SHARDS,
    to_ext,
)
from .config import IngestConfig

log = logging.getLogger(__name__)

# bytes of .dat covered by one small-block stripe row
ROW_BYTES = DATA_SHARDS * SMALL_BLOCK_SIZE
# a .dat at or below this is all small rows; one byte past it the first
# 10 GB reclassifies into ONE large row and every streamed small-row
# parity block is wrong (layout._iter_rows two-phase loop)
STREAMABLE_BYTES = DATA_SHARDS * LARGE_BLOCK_SIZE

_SCRATCH_EXT = ".ing"  # parity scratch: <base>.ing10 .. .ing13


def _scratch_path(base_name: str, parity_idx: int) -> str:
    return f"{base_name}{_SCRATCH_EXT}{DATA_SHARDS + parity_idx}"


def _read_row_into(fd: int, dat_size: int, row_start: int, buf) -> None:
    """Fill the staged [k, SMALL_BLOCK] arena buffer with the stripe row's
    bytes at row_start, zero-padded past EOF — the padding contract of
    bulk.read_stripe, so the streamed parity matches the offline encode's
    bit for bit.  A row is one contiguous range of the .dat: preadv
    scatters it straight into the slot, with no intermediate bytes."""
    flat = memoryview(buf.reshape(-1))
    want = min(flat.nbytes, max(0, dat_size - row_start))
    got = 0
    while got < want:
        n = os.preadv(fd, [flat[got:want]], row_start + got)
        if n <= 0:
            break
        got += n
    if got < flat.nbytes:
        buf.reshape(-1)[got:] = 0


class _Ticket:
    __slots__ = ("volume", "event", "error")

    def __init__(self, volume):
        self.volume = volume
        self.event = threading.Event()
        self.error: BaseException | None = None


class GroupCommitter:
    """Group-commit fsync: concurrent writers park on one pending batch
    and a single flusher thread issues ONE sync per volume per batch —
    the classic WAL group commit, applied to needle appends.  A batch
    fires when max_batch writers are waiting or the oldest has waited
    max_delay_s; with one lone writer the delay bound keeps the ack
    latency within max_delay_s of a bare fsync."""

    def __init__(self, max_batch: int = 64, max_delay_s: float = 0.003):
        self.max_batch = max(1, int(max_batch))
        self.max_delay_s = max(0.0, float(max_delay_s))
        self._cv = threading.Condition()
        self._batch: list[_Ticket] = []
        self._thread: threading.Thread | None = None
        self._stop = False

    def commit(self, volume, timeout_s: float = 60.0) -> None:
        """Block until an fsync covering THIS write (enqueued before the
        flush started) has completed; raises the flush's error."""
        t = _Ticket(volume)
        with self._cv:
            if self._stop:
                volume.sync()  # committer shut down: degrade to direct
                return
            self._batch.append(t)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="ingest-group-commit", daemon=True
                )
                self._thread.start()
            self._cv.notify_all()
        if not t.event.wait(timeout_s):
            raise TimeoutError("group-commit fsync did not complete in time")
        if t.error is not None:
            raise t.error

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._batch and not self._stop:
                    self._cv.wait()
                if self._stop and not self._batch:
                    return
                deadline = time.monotonic() + self.max_delay_s
                while len(self._batch) < self.max_batch and not self._stop:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
                batch, self._batch = self._batch, []
            by_vid = {t.volume.id: t.volume for t in batch}
            err: BaseException | None = None
            try:
                for v in by_vid.values():
                    v.sync()
            except BaseException as e:  # noqa: BLE001 — parked writers
                # must be released with the error, not left hanging
                err = e
            stats_metrics.VOLUME_SERVER_INGEST_FSYNCS.inc()
            stats_metrics.VOLUME_SERVER_INGEST_FSYNC_WRITES.inc(len(batch))
            for t in batch:
                t.error = err
                t.event.set()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class IngestPipeline:
    """Streaming EC state of ONE growing volume.

    feed() — called on the writer's thread after each append — stages
    every newly completed stripe row into the bounded arena and hands it
    to the encode worker; the stage() wait is the plane's backpressure.
    seal() consumes the streamed parity at ec.encode time.  Any breach
    of the layout invariant (large-row boundary, vacuum, encode error,
    arena starvation past the budget) flips `valid` off: writes keep
    landing untouched and the eventual seal simply runs offline."""

    def __init__(self, volume, encoder: rs_ingest.StreamEncoder,
                 cfg: IngestConfig):
        self.volume = volume
        self.vid = volume.id
        self.encoder = encoder
        self.cfg = cfg
        self.base_name = volume.dat_path[: -len(".dat")]
        self.arena = rs_ingest.IngestArena(
            DATA_SHARDS, SMALL_BLOCK_SIZE, cfg.arena_slots,
            pin=encoder.pinned,
        )
        self.encoded_rows = 0  # rows whose parity is on scratch disk
        self.staged_rows = 0  # rows handed to the encode worker (>= encoded)
        self.rows_device = 0
        self.rows_host = 0
        self.valid = True
        self.invalid_reason: str | None = None
        self._feed_lock = threading.Lock()  # feed is single-flight
        self._queue: "list[tuple[int, np.ndarray] | None]" = []
        self._qcv = threading.Condition()
        self._worker: threading.Thread | None = None
        self._read_fd: int | None = None
        self._parity = None  # list[file] scratch handles, opened lazily

    # ------------------------------------------------------------ feeding

    def feed(self) -> None:
        """Stage every stripe row completed by appends so far.  Called
        after write_needle on the upload's worker thread, so the arena
        wait lands on the writer — that IS the backpressure."""
        if not self.valid:
            return
        if not self._feed_lock.acquire(blocking=False):
            return  # a concurrent feed is already draining; seal catches up
        try:
            dat_size = self.volume.content_size
            if dat_size > STREAMABLE_BYTES:
                self._invalidate("large-row boundary crossed")
                return
            while self.valid and (self.staged_rows + 1) * ROW_BYTES <= dat_size:
                row = self.staged_rows
                try:
                    buf = self.arena.stage(self.cfg.backpressure_s)
                except rs_ingest.ArenaExhausted:
                    stats_metrics.VOLUME_SERVER_INGEST_SHED.labels(
                        reason="arena"
                    ).inc()
                    self._invalidate("arena starved past backpressure budget")
                    return
                _read_row_into(self._fd(), dat_size, row * ROW_BYTES, buf)
                self.staged_rows = row + 1
                with self._qcv:
                    self._queue.append((row, buf))
                    if self._worker is None:
                        self._worker = threading.Thread(
                            target=self._encode_loop,
                            name=f"ingest-encode-{self.vid}",
                            daemon=True,
                        )
                        self._worker.start()
                    self._qcv.notify()
        finally:
            self._feed_lock.release()

    def _fd(self) -> int:
        if self._read_fd is None:
            self._read_fd = os.open(self.volume.dat_path, os.O_RDONLY)
        return self._read_fd

    # ------------------------------------------------------- encode worker

    def _encode_loop(self) -> None:
        while True:
            with self._qcv:
                while not self._queue:
                    self._qcv.wait()
                item = self._queue.pop(0)
                if item is None:
                    self._qcv.notify_all()
                    return
            row, buf = item
            try:
                parity, path = self._encode_one(buf)
                self._write_parity(row, parity)
            except BaseException:  # noqa: BLE001 — a worker death would
                # silently stall feeds; invalidate so the seal runs
                # offline and the volume stays correct (the encoder
                # counts the row in failed_rows)
                log.exception(
                    "ingest encode failed for volume %d row %d; "
                    "falling back to offline encode at seal",
                    self.vid, row,
                )
                self.arena.reclaim(buf)
                self._invalidate("encode worker error")
                return
            self.arena.reclaim(buf)
            self.encoded_rows = row + 1
            if path == "device":
                self.rows_device += 1
            else:
                self.rows_host += 1
            stats_metrics.VOLUME_SERVER_INGEST_ROWS.labels(path=path).inc()

    def _encode_one(self, rows: np.ndarray):
        """(parity, path): K1's route for a device backend (a failure
        raises: no row drops to the host codec by itself), else the host
        codec."""
        if self.encoder.device:
            return self.encoder.encode(rows), "device"
        return self.encoder.encode_host(rows), "host"

    def _write_parity(self, row: int, parity: np.ndarray) -> None:
        if self._parity is None:
            self._parity = [
                open(_scratch_path(self.base_name, i), "wb")
                for i in range(TOTAL_SHARDS - DATA_SHARDS)
            ]
        for i, f in enumerate(self._parity):
            f.seek(row * SMALL_BLOCK_SIZE)
            write_or_seek(f, parity[i])

    # ------------------------------------------------------- invalidation

    def _invalidate(self, reason: str) -> None:
        self.valid = False
        self.invalid_reason = reason

    def invalidate(self, reason: str) -> None:
        """External invalidation (vacuum rewrote the .dat, shutdown)."""
        self._invalidate(reason)

    def _drain_worker(self) -> None:
        with self._qcv:
            if self._worker is None:
                return
            self._queue.append(None)
            self._qcv.notify()
        self._worker.join(timeout=60.0)
        self._worker = None

    # ------------------------------------------------------------- sealing

    def seal(self, backend: str = "cuda", fsync: bool = False) -> bool:
        """Streamed twin of encoder.write_ec_files: returns True when the
        shard files were produced consuming the streamed parity (only
        the data-shard IO pass and the tail row remained), False when
        the caller must run the offline encode.  Byte-identical output
        either way — tests/test_torch_ingest.py asserts it.  `backend` encodes
        the tail row (rs.RSCodec's names)."""
        with self._feed_lock:
            self._drain_worker()
            dat_size = self.volume.content_size
            streamable = (
                self.valid
                and self.encoded_rows > 0
                and dat_size <= STREAMABLE_BYTES
            )
            if self._parity is not None:
                for f in self._parity:
                    f.flush()
                    f.close()
                self._parity = None
            if not streamable:
                self.close(remove_scratch=True)
                return False

            from ..ops import rs

            base = self.base_name
            _save_vif_from_superblock(base + ".dat", base)
            n_parity = TOTAL_SHARDS - DATA_SHARDS
            for i in range(n_parity):
                os.replace(_scratch_path(base, i), base + to_ext(DATA_SHARDS + i))
            codec = rs.RSCodec(backend=backend)
            outputs = [
                open(base + to_ext(i), "wb") for i in range(DATA_SHARDS)
            ] + [
                open(base + to_ext(DATA_SHARDS + i), "r+b")
                for i in range(n_parity)
            ]
            try:
                with open(base + ".dat", "rb") as f:
                    row = 0
                    for row_start, block in _iter_rows(
                        dat_size, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
                    ):
                        stripe = read_stripe(
                            f, dat_size, row_start, block, 0, block
                        )
                        for i in range(DATA_SHARDS):
                            write_or_seek(outputs[i], stripe[i])
                        if row < self.encoded_rows:
                            for i in range(n_parity):
                                outputs[DATA_SHARDS + i].seek(
                                    block, os.SEEK_CUR
                                )
                        else:
                            parity = codec.apply_matrix(
                                codec.matrix[DATA_SHARDS:], stripe
                            )
                            for i in range(n_parity):
                                write_or_seek(
                                    outputs[DATA_SHARDS + i], parity[i]
                                )
                        row += 1
                for o in outputs:
                    o.truncate(o.tell())
                if fsync:
                    for o in outputs:
                        o.flush()
                        os.fsync(o.fileno())
            finally:
                for o in outputs:
                    o.close()
            self.close(remove_scratch=False)
            return True

    def close(self, remove_scratch: bool = True) -> None:
        self._drain_worker()
        if self._parity is not None:
            for f in self._parity:
                f.close()
            self._parity = None
        if self._read_fd is not None:
            os.close(self._read_fd)
            self._read_fd = None
        if remove_scratch:
            for i in range(TOTAL_SHARDS - DATA_SHARDS):
                try:
                    os.remove(_scratch_path(self.base_name, i))
                except FileNotFoundError:
                    pass

    def status(self) -> dict:
        return {
            "volume": self.vid,
            "encoded_rows": self.encoded_rows,
            "rows_device": self.rows_device,
            "rows_host": self.rows_host,
            "arena_waits": self.arena.waits,
            "arena_free": self.arena.free_slots,
            "valid": self.valid,
            "reason": self.invalid_reason or "",
        }


class IngestPlane:
    """The volume server's write plane: QoS/deadline admission at the
    door (event-loop confined, like the read dispatcher's controller),
    per-volume pipelines, the shared stream encoder, and group-commit
    durability.  server/volume.py owns one instance and consults it in
    h_write; store.ec_generate consults it at seal."""

    def __init__(self, cfg: IngestConfig, heat=None):
        from ..serving import qos as qos_mod

        self.cfg = cfg.validated()
        # backend None is "the server's -ec.backend"; the volume server
        # fills it in, and a plane built on its own takes the card
        self.encoder = rs_ingest.StreamEncoder(cfg.backend or "cuda")
        self.heat = heat  # serving.tiering.HeatTracker | None
        self.committer = (
            GroupCommitter(cfg.fsync_max_batch, cfg.fsync_max_delay_s)
            if cfg.fsync
            else None
        )
        self.pipelines: dict[int, IngestPipeline] = {}
        # volumes invalidated while they had no pipeline: none is built
        # for them until their seal or drop (vid -> reason)
        self._invalidated: dict[int, str] = {}
        self._plock = threading.Lock()
        deadline_s = cfg.deadline_ms / 1e3
        self.qos = qos_mod.QosController(
            {
                qos_mod.INTERACTIVE: qos_mod.TierPolicy(
                    qos_mod.INTERACTIVE, cfg.interactive_queue, deadline_s
                ),
                qos_mod.BULK: qos_mod.TierPolicy(
                    qos_mod.BULK, cfg.bulk_queue, deadline_s
                ),
            }
        )
        self._inflight = {qos_mod.INTERACTIVE: 0, qos_mod.BULK: 0}
        self._normalize = qos_mod.normalize_tier
        self.shed_counts = {"qos": 0, "deadline": 0, "arena": 0}

    # ---------------------------------------------------------- admission

    def admit(self, tier: str, content_length: int,
              remaining_s: float | None) -> str | None:
        """Upload admission on the event loop, BEFORE any byte lands:
        None = admitted (pair with complete()); else the shed reason.
        The doom check is the deadline budget applied to the whole
        upload: content_length at the configured floor rate already
        overruns the remaining budget => refuse at the door."""
        tier = self._normalize(tier)
        if (
            remaining_s is not None
            and self.cfg.min_rate_kbps > 0
            and content_length > 0
            and content_length / (self.cfg.min_rate_kbps * 1024.0)
            > max(0.0, remaining_s)
        ):
            self.shed_counts["deadline"] += 1
            stats_metrics.VOLUME_SERVER_INGEST_SHED.labels(
                reason="deadline"
            ).inc()
            return "deadline"
        verdict = self.qos.admit(
            tier, self._inflight[tier], max_inflight=4,
            remaining_s=remaining_s,
        )
        if verdict is not None:
            reason = "deadline" if verdict == "deadline" else "qos"
            self.shed_counts[reason] += 1
            stats_metrics.VOLUME_SERVER_INGEST_SHED.labels(
                reason=reason
            ).inc()
            return reason
        self._inflight[tier] += 1
        self.qos.enqueued(tier)
        return None

    def complete(self, tier: str, service_s: float) -> None:
        """Pair of a successful admit(), on the event loop."""
        tier = self._normalize(tier)
        self._inflight[tier] = max(0, self._inflight[tier] - 1)
        self.qos.dequeued(tier)
        if service_s > 0:
            self.qos.observe_service(service_s)

    # ------------------------------------------------------------ writing

    def pipeline_for(self, volume) -> IngestPipeline | None:
        if not self.cfg.enabled:
            return None
        with self._plock:
            p = self.pipelines.get(volume.id)
            if p is None:
                if volume.id in self._invalidated:
                    return None  # a rewrite began before any pipeline
                if volume.content_size > STREAMABLE_BYTES:
                    return None  # born past the small-row regime
                p = IngestPipeline(volume, self.encoder, self.cfg)
                self.pipelines[volume.id] = p
                stats_metrics.VOLUME_SERVER_INGEST_PIPELINES.set(
                    len(self.pipelines)
                )
            return p

    def on_write(self, volume, nbytes: int, tier: str) -> None:
        """Post-append hook on the upload's worker thread: count the
        bytes, feed write heat into the tiering ladder (write heat IS
        heat — a freshly written volume enters the promotion scan with
        a non-zero temperature), stage newly completed rows, and park
        on the group commit when durability is on."""
        stats_metrics.VOLUME_SERVER_INGEST_BYTES.inc(nbytes)
        if self.heat is not None:
            self.heat.note(volume.id, self._normalize(tier))
        p = self.pipeline_for(volume)
        if p is not None:
            p.feed()
        if self.committer is not None:
            self.committer.commit(volume)

    # ------------------------------------------------------ lifecycle/seal

    def invalidate(self, vid: int, reason: str) -> None:
        """The volume's .dat is being rewritten: its pipeline, or the one
        a write would otherwise build before the rewrite ends (whose read
        fd would hold the old inode), never streams again until the seal
        or drop."""
        with self._plock:
            p = self.pipelines.get(vid)
            if p is None:
                self._invalidated[vid] = reason
        if p is not None:
            p.invalidate(reason)

    def seal(self, vid: int, base_name: str, backend: str = "cuda",
             fsync: bool = False) -> bool:
        """Called by store.ec_generate: True = shard files already
        written from the streamed parity; False = run the offline
        encode (any stale parity scratch is cleaned either way)."""
        with self._plock:
            p = self.pipelines.pop(vid, None)
            self._invalidated.pop(vid, None)
            stats_metrics.VOLUME_SERVER_INGEST_PIPELINES.set(
                len(self.pipelines)
            )
        streamed = False
        if p is not None:
            streamed = p.seal(backend=backend, fsync=fsync)
        else:
            for i in range(TOTAL_SHARDS - DATA_SHARDS):
                try:  # scratch from a previous process: never trust it
                    os.remove(_scratch_path(base_name, i))
                except FileNotFoundError:
                    pass
        stats_metrics.VOLUME_SERVER_INGEST_STREAMED_SEALS.labels(
            path="streamed" if streamed else "offline"
        ).inc()
        return streamed

    def drop(self, vid: int) -> None:
        """Volume going away (delete/unmount): discard streaming state."""
        with self._plock:
            p = self.pipelines.pop(vid, None)
            self._invalidated.pop(vid, None)
            stats_metrics.VOLUME_SERVER_INGEST_PIPELINES.set(
                len(self.pipelines)
            )
        if p is not None:
            p.close(remove_scratch=True)

    def close(self) -> None:
        with self._plock:
            pipelines, self.pipelines = list(self.pipelines.values()), {}
            self._invalidated.clear()
            stats_metrics.VOLUME_SERVER_INGEST_PIPELINES.set(0)
        for p in pipelines:
            p.close(remove_scratch=True)
        if self.committer is not None:
            self.committer.close()

    # ------------------------------------------------------------- status

    def status(self) -> list[dict]:
        with self._plock:
            pipelines = list(self.pipelines.values())
        return sorted(
            (p.status() for p in pipelines), key=lambda s: s["volume"]
        )

    def snapshot(self) -> dict:
        """Aggregates for the heartbeat telemetry fill."""
        with self._plock:
            pipelines = list(self.pipelines.values())
        return {
            "pipelines": len(pipelines),
            "encoded_rows": sum(p.encoded_rows for p in pipelines),
            "rows_device": self.encoder.device_rows,
            "rows_host": self.encoder.host_rows,
            "rows_failed": self.encoder.failed_rows,
            "sheds": dict(self.shed_counts),
        }
