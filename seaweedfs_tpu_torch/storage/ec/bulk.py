"""Staged executor shared by the bulk EC pipelines (encode / rebuild /
verify in encoder.py), and the codec leg that runs on the card.

The three pipelines move the same shape of work: read stripe batches
from disk, push them through a GF(256) matrix multiply (device or CPU),
and write/compare the results.  The legs run on dedicated threads around
bounded queues, so wall-clock trends toward max(read, device, write):

  reader leg   -> bounded stripe queue ->  caller (submit/resolve)
                                             |  bounded result queue
                                             v
                                          writer leg

Reads use one vectored ``os.preadv`` per stripe where the stripe's rows
are contiguous on disk (full-block batches).  Staging buffers are
``np.empty`` with tail-only zeroing.

Stats contract (the dict ``run()`` fills, same keys for all three
pipelines):

  read_s / submit_s / wait_s / write_s   per-leg active seconds
  device_busy_s                          codec worker active time
  wall_s, fsync_s, batches               caller-filled wall + tail
  overlap                                the mode the run used

With ``overlap=False`` every leg runs on the caller thread, so
``read_s + submit_s + wait_s + write_s (+ fsync_s) ~= wall_s``.  With
``overlap=True`` the legs overlap and
``read_s + write_s + device_busy_s > wall_s - fsync_s`` is the measured
proof (the fsync tail follows the last write by definition, so it is
excluded from the window on both sides of the claim).
"""
from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ...obs import devledger
from ...ops import rs, rs_cuda
from .layout import DATA_SHARDS, LARGE_BLOCK_SIZE

# Per-shard stride fed to the codec in one device call: 4MB x 10 shards =
# 40MB input per batch.
DEFAULT_STRIDE = 4 * 1024 * 1024
# In-flight codec batches: the caller may run this far ahead of the codec
# worker before blocking on a resolve.  The overlapped pipeline's peak
# host footprint is ~(2*prefetch + depth + 2) batches.
PIPELINE_DEPTH = 3

_preadv = getattr(os, "preadv", None)


@dataclass
class BulkConfig:
    """Knobs for the staged bulk pipelines (the -ec.bulk.* flags).

    Process-global: bulk encode/rebuild/verify are store-level
    maintenance verbs, not per-request serving state."""

    # run the reader/writer legs on dedicated threads; False = the serial
    # baseline of the stats contract (-ec.bulk.overlap.disable)
    overlap: bool = True
    # bounded stripe-queue depth: how many read batches the reader leg
    # may run ahead of the codec (-ec.bulk.prefetch)
    prefetch: int = 3
    # per-shard bytes per codec call; 0 = DEFAULT_STRIDE
    # (-ec.bulk.strideMB)
    stride: int = 0

    def validated(self) -> "BulkConfig":
        if self.prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        if self.stride < 0:
            raise ValueError("stride must be >= 0")
        if (
            self.stride
            and self.stride < LARGE_BLOCK_SIZE
            and LARGE_BLOCK_SIZE % self.stride
        ):
            # a non-dividing stride falls back to whole-block batches in
            # the encode plan: a [10, 1 GiB] staging array per batch
            raise ValueError(
                "stride must divide the 1GB EC large block "
                "(use a power-of-two -ec.bulk.strideMB)"
            )
        return self


DEFAULT = BulkConfig()


def configure(cfg: BulkConfig) -> None:
    """Apply the -ec.bulk.* flags (process-global)."""
    global DEFAULT
    DEFAULT = cfg.validated()


class Codec:
    """Wraps the GF(256) apply so the matrix-multiply leg can run
    pipelined.  submit() returns an opaque handle; resolve() turns it into
    a numpy [m, stride] array.  `busy_s` accumulates the leg's active time
    — the device_busy_s term of the stats contract.

    backend "cuda": one worker thread owns the whole device leg — copy the
    batch into a pinned host buffer, non-blocking H2D on a dedicated
    stream, the gf2_matmul kernel through rs_cuda.apply_matrix_device_flat
    (the flat [4*8, 16*8] system: the g=4 block-diagonal packing filled the
    TPU's 128-row MXU but costs ~3x the integer work per useful byte on
    this kernel), D2H into a pinned buffer, synchronise the stream.
    backend "torch" runs the same leg on CPU tensors (the plain version);
    "numpy" runs the table oracle.  The CPU backends get the worker thread
    only when `threaded` (the overlap mode).

    Each leg is tagged `workload` in the device ledger (the reference's
    classes: "bulk" for encode, "repair" for rebuild, "scrub" for verify)
    inside the leg itself, since the worker thread never sees the
    submitter's context, and records the same seconds it adds to busy_s
    (device label "host" for the CPU backends)."""

    def __init__(self, matrix: np.ndarray, backend: str, threaded: bool = False,
                 workload: str = "bulk"):
        self.backend = rs.resolve_backend(backend)
        self.workload = workload
        self.matrix = np.asarray(matrix, dtype=np.uint8)
        self.rows = self.matrix.shape[0]
        self.busy_s = 0.0
        self._pool = None
        self._cuda = self.backend == "cuda"
        if self.backend == "numpy":
            self._codec = rs.RSCodec(backend="numpy")
            self._leg = self._host_leg
        else:
            self._device = torch.device("cuda" if self._cuda else "cpu")
            self._a_bm = rs_cuda.prepare_matrix(self.matrix, self._device)
            self._leg = self._tensor_leg
        if self._cuda:
            self._stream = torch.cuda.Stream(self._device)
            # the matrix was copied on the current stream
            self._stream.wait_stream(torch.cuda.current_stream(self._device))
            self._pinned_in = torch.empty(0, dtype=torch.uint8)
            self._pinned_out = torch.empty(0, dtype=torch.uint8)
        if self._cuda or threaded:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ec-codec"
            )

    def submit(self, shards: np.ndarray):
        if self._pool is not None:
            return self._pool.submit(self._timed_leg, shards)
        return self._timed_leg(shards)

    def _timed_leg(self, shards: np.ndarray) -> np.ndarray:
        device = None if self._cuda else "host"
        t0 = time.perf_counter()
        with devledger.workload(self.workload, device=device):
            out = self._leg(shards)
        dur = time.perf_counter() - t0
        self.busy_s += dur
        devledger.record(
            workload=self.workload, device=device, busy_s=dur, dispatches=1,
            nbytes=int(shards.nbytes) + int(out.nbytes),
        )
        return out

    def _host_leg(self, shards: np.ndarray) -> np.ndarray:
        return self._codec.apply_matrix(self.matrix, shards)

    def _pinned(self, name: str, n: int) -> torch.Tensor:
        buf = getattr(self, name)
        if buf.numel() < n:
            buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            setattr(self, name, buf)
        return buf[:n]

    def _tensor_leg(self, shards: np.ndarray) -> np.ndarray:
        k, b = shards.shape
        if not self._cuda:
            x = torch.from_numpy(np.ascontiguousarray(shards).reshape(-1))
            out = rs_cuda.apply_matrix_device_flat(self._a_bm, x, k=k, m=self.rows)
            return out.numpy().reshape(self.rows, b)
        # one worker thread runs every leg, so one pinned pair suffices:
        # the stream is synchronised and the result copied out before the
        # next batch overwrites either buffer
        pin_in = self._pinned("_pinned_in", k * b)
        pin_out = self._pinned("_pinned_out", self.rows * b)
        np.copyto(pin_in.numpy().reshape(k, b), shards)
        with torch.cuda.stream(self._stream):
            x = pin_in.to(self._device, non_blocking=True)
            out = rs_cuda.apply_matrix_device_flat(self._a_bm, x, k=k, m=self.rows)
            pin_out.copy_(out, non_blocking=True)
        self._stream.synchronize()
        return pin_out.numpy().reshape(self.rows, b).copy()

    def resolve(self, handle) -> np.ndarray:
        if isinstance(handle, Future):
            return handle.result()
        return handle

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)


# ----------------------------------------------------------------- reads


def _zero_tail(out: np.ndarray, filled: int) -> None:
    """Zero every byte of a [rows, width] batch past the first `filled`
    (row-major) — the tail-only half of the np.empty staging rule."""
    rows, width = out.shape
    row, rem = divmod(filled, width)
    if rem:
        out[row, rem:] = 0
        row += 1
    if row < rows:
        out[row:] = 0


def read_stripe(
    f, dat_size: int, row_start: int, block_size: int, stride_off: int, stride: int
) -> np.ndarray:
    """[DATA_SHARDS, stride] batch: shard i's bytes are the original volume
    at row_start + i*block_size + stride_off, zero-padded past EOF
    (encodeDataOneBatch's zero-fill, ec_encoder.go:165-177).

    Full-block batches (stride == block_size) cover one CONTIGUOUS byte
    range of the .dat, so a single vectored preadv scatters the whole
    stripe into the row buffers.  Sub-block batches have strided row
    offsets and take one pread per row."""
    out = np.empty((DATA_SHARDS, stride), dtype=np.uint8)
    fd = f.fileno()
    if _preadv is not None and stride == block_size and stride_off == 0:
        want = min(DATA_SHARDS * stride, max(0, dat_size - row_start))
        got = _preadv(fd, list(out), row_start) if want > 0 else 0
        if got >= want:
            _zero_tail(out, got)
            return out
        # short read before the known EOF: retake on the per-row path
    for i in range(DATA_SHARDS):
        start = row_start + i * block_size + stride_off
        n = min(stride, max(0, dat_size - start))
        if n > 0:
            buf = os.pread(fd, n, start)
            out[i, : len(buf)] = np.frombuffer(buf, dtype=np.uint8)
            if len(buf) < stride:
                out[i, len(buf) :] = 0
        else:
            out[i, :] = 0
    return out


def read_shard_rows(handles: dict, ids, n: int, off: int) -> np.ndarray:
    """[len(ids), n] batch from per-shard FILES (rebuild/verify inputs):
    row j is shard ids[j]'s bytes at [off, off+n), zero-padded on a short
    read."""
    out = np.empty((len(ids), n), dtype=np.uint8)
    for j, sid in enumerate(ids):
        buf = os.pread(handles[sid].fileno(), n, off)
        out[j, : len(buf)] = np.frombuffer(buf, dtype=np.uint8)
        if len(buf) < n:
            out[j, len(buf) :] = 0
    return out


def write_or_seek(fobj, row: np.ndarray) -> None:
    """Sparse-aware shard write: an all-zero chunk becomes a hole (seek)
    instead of written zeros — byte-identical on read.  Final sizes are
    fixed by the caller's truncate."""
    if row.any():
        fobj.write(row.tobytes())
    else:
        fobj.seek(len(row), os.SEEK_CUR)


# -------------------------------------------------------------- executor

_DONE = object()


class _Leg(threading.Thread):
    """One pipeline leg: runs fn to completion, parks any exception for
    the orchestrator to re-raise."""

    def __init__(self, name: str, fn):
        super().__init__(name=name, daemon=True)
        self._fn = fn
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            self._fn()
        except BaseException as e:  # noqa: BLE001 — parked for the caller
            self.error = e


def _put_checked(q: queue.Queue, item, leg: _Leg) -> None:
    """put() that cannot deadlock on a dead consumer: if the consuming
    leg died, raise its error instead of blocking on a full queue."""
    while True:
        if leg.error is not None:
            raise leg.error
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            continue


def run(
    name: str,
    plan: list,
    read_batch,
    codec: Codec,
    write_batch,
    *,
    overlap: bool | None = None,
    prefetch: int | None = None,
    depth: int = PIPELINE_DEPTH,
    to_codec=None,
) -> dict:
    """Drive one bulk pipeline over `plan` and return its stats dict.

    `read_batch(desc) -> payload` runs on the reader leg,
    `codec.submit(to_codec(payload))` / `resolve` on the caller thread
    (device/CPU work lands on the codec's own worker), and
    `write_batch(desc, payload, result)` on the writer leg, in plan
    order.  With overlap disabled everything runs inline on the caller
    thread — the serial baseline of the stats contract."""
    overlap = DEFAULT.overlap if overlap is None else bool(overlap)
    prefetch = DEFAULT.prefetch if prefetch is None else prefetch
    if prefetch < 1:
        raise ValueError("prefetch must be >= 1")
    pick = to_codec if to_codec is not None else lambda payload: payload
    t = {
        "read_s": 0.0, "submit_s": 0.0, "wait_s": 0.0, "write_s": 0.0,
        "fsync_s": 0.0, "batches": 0, "overlap": overlap,
    }
    clock = time.perf_counter

    if not overlap:
        for desc in plan:
            t0 = clock()
            payload = read_batch(desc)
            t1 = clock()
            handle = codec.submit(pick(payload))
            t2 = clock()
            result = codec.resolve(handle)
            t3 = clock()
            write_batch(desc, payload, result)
            t["read_s"] += t1 - t0
            t["submit_s"] += t2 - t1
            t["wait_s"] += t3 - t2
            t["write_s"] += clock() - t3
            t["batches"] += 1
        t["device_busy_s"] = codec.busy_s
        return t

    read_q: queue.Queue = queue.Queue(maxsize=prefetch)
    write_q: queue.Queue = queue.Queue(maxsize=prefetch)
    abort = threading.Event()

    def reader() -> None:
        try:
            for desc in plan:
                if abort.is_set():
                    return
                r0 = clock()
                payload = read_batch(desc)
                t["read_s"] += clock() - r0
                read_q.put((desc, payload))
        finally:
            read_q.put(_DONE)

    def writer() -> None:
        while True:
            item = write_q.get()
            if item is _DONE:
                return
            desc, payload, result = item
            w0 = clock()
            write_batch(desc, payload, result)
            t["write_s"] += clock() - w0

    r_leg = _Leg(f"ec-bulk-{name}-read", reader)
    w_leg = _Leg(f"ec-bulk-{name}-write", writer)
    r_leg.start()
    w_leg.start()
    pending: deque = deque()

    def flush_one() -> None:
        desc, payload, handle = pending.popleft()
        q0 = clock()
        result = codec.resolve(handle)
        t["wait_s"] += clock() - q0
        _put_checked(write_q, (desc, payload, result), w_leg)

    try:
        while True:
            item = read_q.get()
            if item is _DONE:
                # join before reading .error: the reader puts _DONE from its
                # finally while its exception is still unwinding
                r_leg.join()
                if r_leg.error is not None:
                    raise r_leg.error
                break
            desc, payload = item
            s0 = clock()
            handle = codec.submit(pick(payload))
            t["submit_s"] += clock() - s0
            t["batches"] += 1
            pending.append((desc, payload, handle))
            if len(pending) >= depth:
                flush_one()
        while pending:
            flush_one()
        _put_checked(write_q, _DONE, w_leg)
        w_leg.join()
        if w_leg.error is not None:
            raise w_leg.error
    except BaseException:
        # unblock both legs before propagating: the reader may be parked
        # on a full stripe queue, the writer on an empty result queue
        abort.set()
        while True:
            try:
                if read_q.get(timeout=0.05) is _DONE:
                    break
            except queue.Empty:
                if not r_leg.is_alive():
                    break
        while w_leg.is_alive():
            try:
                write_q.put(_DONE, timeout=0.05)
                break
            except queue.Full:
                try:
                    write_q.get_nowait()
                except queue.Empty:
                    pass
        r_leg.join(timeout=5)
        w_leg.join(timeout=5)
        raise
    t["device_busy_s"] = codec.busy_s
    return t


def publish(name: str, t: dict) -> None:
    """Record one finished run's legs as the bulk_read / bulk_device /
    bulk_write trace stages (the caller's active trace when the pipeline
    ran under a traced request; the per-stage histogram either way).
    Call after wall_s is filled.  The reference's bulk throughput series
    are not ported (the port's metrics are the serving subset)."""
    from ...obs import trace as obs_trace

    ctx = obs_trace.current()
    t0 = time.perf_counter() - float(t.get("wall_s", 0.0))
    anns = {"pipeline": name, "batches": t.get("batches", 0)}
    # stage names spelled out per leg, so each TRACE_STAGES entry has a
    # literal call site
    obs_trace.record_span(
        ctx, "bulk_read", t0, float(t.get("read_s", 0.0)), annotations=anns
    )
    obs_trace.record_span(
        ctx, "bulk_device", t0, float(t.get("device_busy_s", 0.0)),
        annotations=anns,
    )
    obs_trace.record_span(
        ctx, "bulk_write", t0, float(t.get("write_s", 0.0)), annotations=anns
    )
