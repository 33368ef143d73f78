"""Knobs for the streaming ingest plane (CLI: the -ec.ingest.* flags).

Port of seaweedfs_tpu/ingest/config.py.  Defaults are sized for the
small-block stripe geometry: one staged row is DATA_SHARDS x SMALL_BLOCK =
10 MB, so two arena slots bound staging memory at 20 MB per actively
written volume while still letting the pread of row N+1 overlap the
encode of row N.

One departure: `backend` takes the port's names (cuda, torch, numpy,
native), and its default is None, "the server's -ec.backend".  The
reference's `auto` (the device when one is visible, else the host codec)
would hide a missing card behind a CPU fallback; here a default server
encodes rows on the card, and one without a card fails at construction.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class IngestConfig:
    """Tunables for `IngestPlane` / per-volume `IngestPipeline`s."""

    # stream-encode stripe rows as writes land; False reverts every
    # volume to the after-the-fact bulk encode at ec.encode time
    # (-ec.ingest.disable)
    enabled: bool = True
    # codec backend for the streaming row encode: cuda (K1 on the card),
    # torch (K1's plain version on the CPU), numpy or native (host
    # codecs); None = the volume server's -ec.backend
    # (-ec.ingest.backend)
    backend: str | None = None
    # staged row buffers per volume pipeline; the pool is the plane's
    # backpressure — a writer that cannot stage blocks until the encode
    # leg drains (-ec.ingest.arenaSlots)
    arena_slots: int = 2
    # how long a writer may block waiting for a free staging row before
    # the pipeline gives up streaming for this volume and falls back to
    # the offline encode at seal (-ec.ingest.backpressureMs)
    backpressure_ms: int = 2000
    # group-commit durability: writers wait for an fsync batch instead
    # of acking from the page cache.  Off by default like the
    # reference's volume server (-ec.ingest.fsync)
    fsync: bool = False
    # group-commit batch bounds: an fsync fires when this many writers
    # are waiting or the oldest has waited this long
    # (-ec.ingest.fsyncMaxBatch / -ec.ingest.fsyncMaxDelayMs)
    fsync_max_batch: int = 64
    fsync_max_delay_ms: float = 3.0
    # deadline doom check at the door: an upload of N bytes is refused
    # immediately when N / (this floor rate) exceeds the request's
    # remaining X-Seaweed-Deadline-Ms budget — the client learns NOW
    # instead of at the fsync it was never going to reach
    # (-ec.ingest.minRateKBps, 0 disables the doom check)
    min_rate_kbps: int = 256
    # QoS write-tier queue budgets, gating upload admission through
    # serving/qos.py exactly like the read path: interactive PUTs keep
    # a reserved share of the door, bulk (multipart parts, batch
    # loaders) binds first under pressure
    # (-ec.ingest.interactiveQueue / -ec.ingest.bulkQueue)
    interactive_queue: int = 256
    bulk_queue: int = 64
    # per-tier admission deadline (ms) when the client sent no deadline
    # header of its own: estimated queue wait beyond this sheds the
    # write at the door (-ec.ingest.deadlineMs, 0 disables)
    deadline_ms: int = 30000

    @property
    def backpressure_s(self) -> float:
        return self.backpressure_ms / 1e3

    @property
    def fsync_max_delay_s(self) -> float:
        return self.fsync_max_delay_ms / 1e3

    def validated(self) -> "IngestConfig":
        if self.arena_slots < 1:
            raise ValueError("arena_slots must be >= 1")
        if self.backpressure_ms < 0:
            raise ValueError("backpressure_ms must be >= 0")
        if self.fsync_max_batch < 1:
            raise ValueError("fsync_max_batch must be >= 1")
        if self.fsync_max_delay_ms < 0:
            raise ValueError("fsync_max_delay_ms must be >= 0")
        if self.min_rate_kbps < 0:
            raise ValueError("min_rate_kbps must be >= 0 (0 disables)")
        if self.interactive_queue < 1 or self.bulk_queue < 1:
            raise ValueError("ingest tier queue budgets must be >= 1")
        if self.deadline_ms < 0:
            raise ValueError("deadline_ms must be >= 0 (0 disables)")
        return self
