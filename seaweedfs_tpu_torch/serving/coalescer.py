"""Admission queue packing concurrent EC needle reads into batches.

Port of seaweedfs_tpu/serving/coalescer.py.  Pure bookkeeping — no asyncio scheduling, no
device calls — so the packing, saturation and FIFO rules are testable
without a server.  The dispatcher owns timing (admission window,
pipelining); the coalescer owns what rides in each batch.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass


@dataclass
class ReadRequest:
    """One queued EC needle read awaiting a batch slot."""

    vid: int
    nid: int
    cookie: int | None
    future: asyncio.Future
    enqueued: float  # loop.time() at admission, for the queue-wait series
    # (trace, parent_span_id) captured at admission: the drain task that
    # serves this request runs outside the request's context, so the
    # trace must ride the queue with the request (obs/trace.py)
    obs_ctx: object | None = None
    # QoS tier this request was admitted under (serving/qos.py): the
    # drain loop must credit the SAME tier's budget back at take time
    tier: str = "interactive"


class Coalescer:
    """Bounded FIFO queue that packs requests into per-volume batches.

    `offer` admits a request unless the queue is saturated (backpressure:
    the caller falls back to the native path).  `take` removes up to
    `max_batch` requests in arrival order and groups them by volume id —
    each group becomes one `read_needles_batch` call.
    """

    def __init__(self, max_batch: int, max_queue: int):
        # invariants (max_batch >= 1, max_queue >= max_batch) are
        # enforced by ServingConfig.validated()
        self.max_batch = max_batch
        self.max_queue = max_queue
        self._queue: list[ReadRequest] = []

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def saturated(self) -> bool:
        return len(self._queue) >= self.max_queue

    def offer(self, req: ReadRequest) -> bool:
        """Admit `req`; False when saturated (nothing is enqueued)."""
        if self.saturated:
            return False
        self._queue.append(req)
        return True

    def take(self) -> dict[int, list[ReadRequest]]:
        """Remove up to `max_batch` oldest requests, grouped by vid.

        The slice is atomic with respect to the event loop (no awaits),
        so concurrent drain tasks never see the same request twice."""
        batch, self._queue = (
            self._queue[: self.max_batch],
            self._queue[self.max_batch :],
        )
        by_vid: dict[int, list[ReadRequest]] = {}
        for req in batch:
            by_vid.setdefault(req.vid, []).append(req)
        return by_vid
