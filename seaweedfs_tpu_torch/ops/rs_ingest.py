"""Streaming ingest encode: RS parity for stripe rows as they complete on
the write path.

Port of seaweedfs_tpu/ops/rs_ingest.py.  The bulk executor
(storage/ec/bulk.py) encodes a finished `.dat` after the fact; the ingest
plane (seaweedfs_tpu_torch/ingest/) encodes each stripe row — [k, block]
bytes of the still-growing `.dat` — the moment the row fills.  This module
is the device leg of that plane:

  * IngestArena: the bounded pool of staged row buffers whose exhaustion
    IS the write path's backpressure (a writer that cannot stage blocks
    until the codec drains).  With the cuda backend each slot is a pinned
    host tensor, exposed to the feed as a numpy view, so a row's H2D copy
    is one DMA straight out of the slot.
  * StreamEncoder: one row's parity through K1, the same kernel the bulk
    encode and the host degraded read launch (rs_cuda.apply_matrix_device
    -> csrc/gf2_matmul.cu: a [10, 1 MiB] row -> 4 parity rows is not a
    one-row call, so the tensor-core kernel takes it).  Each worker thread
    runs the H2D copy, the launch and the D2H copy on its own CUDA stream
    with its own device input buffer, pinned parity buffer and event, and
    waits on the event before it returns.

What the reference needs and this port does not:
  * `_encode_rows_impl` / `_encode_entry` (a `jax.jit` with donation around
    K1): the encoder calls rs_cuda.apply_matrix_device directly.
  * `_donatable` (the donation gate): the rule that replaces it is the
    arena's — a slot goes back to the free pool only after its row's
    parity is on disk, and by then the H2D copy that read it has completed
    (encode waits on the row's event before it returns).
  * `_key`, `_compile_key`, `warm`, `shape_is_warm` and the ColdShape shed:
    XLA compiles one executable per shape; the CUDA kernels take runtime
    shapes, so no row is ever shed to the host for want of a compile.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from ..obs import devledger
from ..stats import metrics as stats_metrics
from . import _build, gf256, rs, rs_cpu, rs_cuda

DATA_SHARDS = rs.DATA_SHARDS
PARITY_SHARDS = rs.PARITY_SHARDS

# K1's route: the kernel on the card (cuda), or its plain version on the
# CPU (torch).  The host codecs: the numpy oracle, or the native codec.
DEVICE_BACKENDS = ("cuda", "torch")
HOST_BACKENDS = ("numpy", "native")
BACKENDS = DEVICE_BACKENDS + HOST_BACKENDS


class ArenaExhausted(RuntimeError):
    """No staging row freed within the backpressure budget."""


class IngestArena:
    """Bounded pool of [k, block] staged row buffers for ONE pipeline.

    stage() blocks (up to the backpressure budget) until a row buffer is
    free — that wait propagates through IngestPipeline.feed() to the
    HTTP writer as honest backpressure.  A filled row's bytes stay final
    until reclaim() returns the buffer to the pool, once its row's parity
    is on disk.  `pin` allocates the slots in pinned host memory (the
    cuda backend)."""

    def __init__(self, k: int, block: int, slots: int = 2, pin: bool = False):
        if slots < 1:
            raise ValueError(f"arena needs >= 1 slot, got {slots}")
        self.k = k
        self.block = block
        self.slots = slots
        self.waits = 0  # stage() calls that had to block
        self._free: queue.Queue = queue.Queue()
        # the tensors own the (pinned) memory; the pool hands out views
        self._tensors = [
            torch.empty((k, block), dtype=torch.uint8, pin_memory=pin)
            for _ in range(slots)
        ]
        for t in self._tensors:
            self._free.put(t.numpy())

    def stage(self, timeout_s: float | None = None) -> np.ndarray:
        try:
            return self._free.get_nowait()
        except queue.Empty:
            pass
        self.waits += 1
        stats_metrics.VOLUME_SERVER_INGEST_BACKPRESSURE.inc()
        try:
            return self._free.get(timeout=timeout_s)
        except queue.Empty:
            raise ArenaExhausted(
                f"no ingest arena row freed in {timeout_s}s "
                f"({self.slots} slots of [{self.k}, {self.block}])"
            ) from None

    def reclaim(self, buf: np.ndarray) -> None:
        """Back to the pool: call only once the row's parity is on disk."""
        self._free.put(buf)

    @property
    def free_slots(self) -> int:
        return self._free.qsize()


class _Lane:
    """One encode worker thread's device resources: its stream, the
    device input buffer, the pinned parity buffer and the row's event."""

    __slots__ = ("block", "stream", "x", "parity", "done")

    def __init__(self, k: int, p: int, block: int):
        self.block = block
        self.stream = torch.cuda.Stream()
        self.x = torch.empty((k, block), dtype=torch.uint8, device="cuda")
        self.parity = torch.empty((p, block), dtype=torch.uint8,
                                  pin_memory=True)
        self.done = torch.cuda.Event()


class StreamEncoder:
    """RS(k, p) parity for one staged row.  Thread-safe: the per-volume
    pipeline workers share one encoder (one prepared matrix); each worker
    thread gets its own lane (stream, buffers, event).

    `backend` cuda raises without a card, and loads the kernel library in
    the constructor, so a build takes its seconds at server start and a
    failed build raises here; nothing falls back to the host.  A failed
    launch raises out of encode() (the pipeline then invalidates and the
    seal runs offline).  `device_rows` counts rows through K1's route,
    `host_rows` rows through the host codec, `failed_rows` encodes that
    raised."""

    def __init__(self, backend: str = "cuda"):
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown ingest backend {backend!r} (choose from {BACKENDS})"
            )
        if backend in ("cuda", "torch"):
            rs.resolve_backend(backend)  # "cuda" without a card raises
        self.backend = backend
        self.device = backend in DEVICE_BACKENDS
        self.k = DATA_SHARDS
        self.p = PARITY_SHARDS
        self.matrix = gf256.parity_matrix(self.k, self.k + self.p)
        self.host_rows = 0
        self.device_rows = 0
        self.failed_rows = 0
        self._mu = threading.Lock()
        self._local = threading.local()
        self._a_prep = None
        if self.device:
            if backend == "cuda":
                _build.kernels()  # the build happens now, not on a writer
            self._a_prep = rs_cuda.prepare_matrix(
                self.matrix, "cuda" if backend == "cuda" else "cpu"
            )

    @property
    def pinned(self) -> bool:
        """Whether staged rows should live in pinned host memory."""
        return self.backend == "cuda"

    # ------------------------------------------------------------- encoding

    def encode(self, rows: np.ndarray) -> np.ndarray:
        """rows [k, B] u8 -> parity [p, B] u8 (a fresh array: the caller
        may reclaim the row's slot as soon as the parity is written)."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        if not self.device:
            return self.encode_host(rows)
        if rows.shape[0] != self.k:
            raise ValueError(f"expected {self.k} data rows, got {rows.shape[0]}")
        if not rows.flags.writeable:  # torch.from_numpy wants a writable view
            rows = rows.copy()
        t0 = time.perf_counter()
        try:
            if self.backend == "cuda":
                parity = self._encode_cuda(rows)
            else:
                out = rs_cuda.apply_matrix_device(
                    self._a_prep, torch.from_numpy(rows), k_true=self.k
                )
                parity = out[: self.p].numpy().copy()
        except BaseException:
            with self._mu:
                self.failed_rows += 1
            raise
        # workers call encode() from their own threads, so the ingest class
        # is named here; the window runs from the H2D to the D2H's end
        devledger.record(
            workload="ingest", busy_s=time.perf_counter() - t0,
            dispatches=1, nbytes=int(rows.nbytes) + int(parity.nbytes),
        )
        with self._mu:
            self.device_rows += 1
        return parity

    def _lane(self, block: int) -> _Lane:
        lane = getattr(self._local, "lane", None)
        if lane is None or lane.block != block:
            lane = _Lane(self.k, self.p, block)
            self._local.lane = lane
        return lane

    def _encode_cuda(self, rows: np.ndarray) -> np.ndarray:
        """H2D from the (pinned) slot, K1, D2H into the lane's pinned
        parity buffer, all on the worker's own stream; waits on the row's
        event, so the slot's bytes are read and the parity is on the host
        when this returns."""
        lane = self._lane(rows.shape[1])
        # gf2_matmul launches on the current stream, which is per thread:
        # the whole sequence runs on this worker's stream
        with torch.cuda.stream(lane.stream):
            lane.x.copy_(torch.from_numpy(rows), non_blocking=True)
            out = rs_cuda.apply_matrix_device(self._a_prep, lane.x,
                                              k_true=self.k)
            lane.parity.copy_(out[: self.p], non_blocking=True)
            lane.done.record(lane.stream)
        lane.done.synchronize()
        return lane.parity.numpy().copy()

    def encode_host(self, rows: np.ndarray) -> np.ndarray:
        """The host codec: numpy for the numpy backend, else the native
        one."""
        with self._mu:
            self.host_rows += 1
        if self.backend == "numpy":
            return rs_cpu.apply_matrix_numpy(self.matrix, rows)
        return rs_cpu.apply_matrix_native(self.matrix, rows)
