"""Pipelined continuous-batching dispatcher for EC needle reads.

Port of seaweedfs_tpu/serving/dispatcher.py.  Sits between the volume
server's EC read handler (server/volume.py h_read) and the resident
reconstruct path (storage/ec/volume.py read_needles_batch ->
ops/rs_resident.py reconstruct_intervals -> one ragged launch of
csrc/fused_reconstruct.cu per batch).  Three rules:

  1. ROUTE: reads of a volume with enough resident shards to reconstruct
     on the card ride the batching queue; everything else (no cache, pin
     thread still running, dispatcher disabled) takes the native per-read
     path immediately — a cold volume's concurrent disk reads must not
     serialize behind a batch queue.
  2. COALESCE + PIPELINE: queued reads pack into wide
     `read_needles_batch` calls (Coalescer); up to `max_inflight` batches
     run concurrently, each on its own thread, so batch N+1's launch
     overlaps batch N's D2H and response fan-out.  A hot drain loop holds
     a µs-scale admission window open so bursts fill batches instead of
     fragmenting.
  3. SHED: past `max_queue` queued requests the dispatcher stops
     admitting and serves the overflow on the native path (counted in
     the fallback series) — saturation degrades, it never grows an
     unbounded queue.

Each in-flight lane's call holds one of the cache's DevicePipeline slots
(its own CUDA stream and pinned result buffer); the volume server sizes
the pipeline from ServingConfig.pipeline_slots.

Every decision is visible on /metrics: batch-width histogram, per-request
queue wait, in-flight batch occupancy, fallback and route counters
(stats/metrics.py), and each batch's device section is tagged
serving_interactive or serving_bulk in the device ledger
(obs/devledger.py).  Each request's trace (obs/trace.py) gets its
`queue_wait` spans (admission -> take, and its whole residency up to the
waiter's resume) and its batch's stages: the batch runs under a stage sink
and a `batch_dispatch` span, and what the sink collected is replayed onto
every member trace.  Saturation is recorded in the flight recorder
(obs/incident.py).  With a residency ladder attached (`tiering`, a
serving/tiering.TieringController), every routed EC read feeds its heat
signal before routing.  Peer shard reads (`remote_reader_factory` returns
None here: one node holds the survivors) are ROADMAP A4b.
"""
from __future__ import annotations

import asyncio
import logging
import time

from .. import obs, stats
from ..obs import devledger
from ..obs import incident as obs_incident
from ..utils import faultpolicy
from ..utils.tasks import spawn_logged
from .coalescer import Coalescer, ReadRequest
from .config import ServingConfig
from .qos import QosController, normalize_tier

log = logging.getLogger("serving")


class EcReadDispatcher:
    """Continuous-batching front of Store.read_ec_needles_batch.

    `store` needs `read_ec_needles_batch`, `read_ec_needle`, and
    `ec_volume_is_resident`; `remote_reader_factory(vid)` supplies the
    peer-shard hook both paths thread through (None on one node)."""

    def __init__(
        self,
        store,
        remote_reader_factory,
        config: ServingConfig | None = None,
    ):
        self.store = store
        self._remote_reader = remote_reader_factory
        self.cfg = (config or ServingConfig()).validated()
        self.coalescer = Coalescer(self.cfg.max_batch, self.cfg.max_queue)
        self.qos = QosController.from_config(self.cfg)
        self._inflight = 0
        # heat-tiered residency (serving/tiering.py): when a controller
        # is attached, every EC read's (vid, tier) feeds its decayed
        # popularity counters BEFORE routing
        self.tiering = None
        # strong refs to the live drain-lane tasks (the event loop only
        # holds weak ones)
        self._lanes: set = set()

    # ----------------------------------------------------------- telemetry

    @property
    def queue_depth(self) -> int:
        """Reads waiting in the coalescer right now."""
        return len(self.coalescer)

    @property
    def inflight(self) -> int:
        """Batches currently in flight on the device (occupancy)."""
        return self._inflight

    def shutdown(self) -> None:
        """Clean-shutdown zeroing of the occupancy/queue gauges: the
        registry is process-global, so a restarted server must report
        idle until its first batch."""
        stats.VOLUME_SERVER_EC_BATCH_INFLIGHT.set(0)
        stats.VOLUME_SERVER_EC_QUEUE_DEPTH.set(0)
        self.qos.shutdown()

    # ------------------------------------------------------------- admission

    def _route(self, route: str, origin: str) -> None:
        """Count the admitting route; S3-originated reads are attributed
        IN ADDITION under s3_<route>."""
        stats.VOLUME_SERVER_EC_READ_ROUTE.labels(route=route).inc()
        if origin == "s3":
            stats.VOLUME_SERVER_EC_READ_ROUTE.labels(
                route=f"s3_{route}"
            ).inc()

    async def read(
        self,
        vid: int,
        nid: int,
        cookie: int | None,
        tier: str = "interactive",
        origin: str = "",
    ):
        """Serve one EC needle read; returns a Needle or raises the
        per-needle error (NeedleNotFound / CookieMismatch / ...).
        `tier` is the QoS tier (unknown values map to interactive);
        `origin` attributes the read's source in the read_route series."""
        cfg = self.cfg
        tier = normalize_tier(tier)
        # refuse doomed work early: a spent deadline budget raises here
        # (504 at the front door) instead of burning a queue slot
        remaining_s = faultpolicy.check_remaining("ec read admission")
        if self.tiering is not None:
            self.tiering.note_read(vid, tier)
        if not cfg.enabled:
            # dispatcher disabled = the per-read behavior, device
            # reconstruct included: an idle card on a resident volume
            # still serves width-1 reads
            self._route("native", origin)
            return await self._read_native(vid, nid, cookie, use_device=True)
        if not self.store.ec_volume_is_resident(vid):
            self._route("native", origin)
            return await self._read_native(vid, nid, cookie)
        if cfg.qos and self.qos.admit(
            tier, len(self.coalescer), cfg.max_inflight,
            remaining_s=remaining_s,
        ) is not None:
            # QoS shed (tier budget / deadline / breaker): serve on the
            # host path NOW rather than join a queue this request would
            # time out inside
            self._route("native", origin)
            return await self._read_native(vid, nid, cookie)
        loop = asyncio.get_running_loop()
        req = ReadRequest(vid, nid, cookie, loop.create_future(), loop.time(),
                          obs_ctx=obs.current(), tier=tier)
        if not self.coalescer.offer(req):
            # saturated: shed to the native path rather than queue without
            # bound; QoS sees it as overload too (breaker + shed series)
            stats.VOLUME_SERVER_EC_BATCH_FALLBACK.inc()
            # flight recorder: the raw saturation decision (also visible
            # when -ec.qos.disable leaves no QoS layer to record it)
            obs_incident.record(
                "dispatch_saturated", vid=vid, tier=tier,
                queue_depth=len(self.coalescer),
            )
            if cfg.qos:
                self.qos.saturated(tier)
            self._route("native", origin)
            return await self._read_native(vid, nid, cookie)
        if cfg.qos:
            # commit the admission; req.tier is cleared with qos off so
            # the drain loop's dequeue credit stays symmetric
            self.qos.enqueued(tier)
        else:
            req.tier = ""
        self._route("batched", origin)
        stats.VOLUME_SERVER_EC_QUEUE_DEPTH.set(len(self.coalescer))
        self._maybe_spawn()
        t_resident = time.perf_counter()
        try:
            return await req.future
        finally:
            # the request's WHOLE dispatcher residency, enqueue -> waiter
            # resume, as a low-priority queue_wait span (observe=False:
            # the histogram sample is the drain loop's).  The batch stage
            # spans outrank it in critical-path attribution, so all it
            # claims is the slice nothing else covers — chiefly the
            # future-resume gap where the batch is done but the event
            # loop has not scheduled this coroutine yet.
            obs.record_span(
                req.obs_ctx, "queue_wait", t_resident,
                time.perf_counter() - t_resident, observe=False,
            )

    async def _read_native(
        self, vid: int, nid: int, cookie: int | None, use_device: bool = False
    ):
        # use_device defaults False: the shed route must be the HOST
        # reconstruct (under saturation the card is the bottleneck), and
        # for unpinned volumes the device path is a guaranteed CacheMiss
        # anyway.  Only the disabled-dispatcher route allows the device
        # per-read.
        return await asyncio.to_thread(
            self.store.read_ec_needle,
            vid,
            nid,
            cookie,
            self._remote_reader(vid),
            use_device,
            self.cfg.zero_copy,
        )

    # ------------------------------------------------------------ dispatch

    def _maybe_spawn(self) -> None:
        if len(self.coalescer) and self._inflight < self.cfg.max_inflight:
            self._inflight += 1
            stats.VOLUME_SERVER_EC_BATCH_INFLIGHT.set(self._inflight)
            # detached: the new task copies this context, and a drain
            # lane spawned from a traced request would otherwise append
            # every LATER request's batch spans to the spawner's
            # (finished) trace — member traces ride ReadRequest.obs_ctx
            # instead.  The deadline detaches for the same reason: a lane
            # outliving its spawner's budget must not doom every later
            # batch it serves.
            with obs.detached(), faultpolicy.detached():
                spawn_logged(
                    self._drain(), log, "ec-read drain lane",
                    registry=self._lanes,
                )

    async def _drain(self) -> None:
        """One pipeline lane: serve batches until the queue empties.

        A lane's first batch on an IDLE dispatcher (no other lane in
        flight) dispatches immediately, so a lone request keeps its idle
        latency.  In every other state a partial queue gets the admission
        window to fill before the take: waiting is free while the card is
        occupied, and it is how a response-triggered re-issue burst
        (closed-loop clients) packs into wide batches.  Each lane's
        blocking store call runs in its own thread while the event loop
        keeps admitting."""
        cfg = self.cfg
        first = self._inflight == 1  # idle spawn: skip the first window
        try:
            while len(self.coalescer):
                if (
                    not first
                    and cfg.max_wait_us > 0
                    and len(self.coalescer) < cfg.max_batch
                ):
                    await asyncio.sleep(cfg.max_wait_s)
                first = False
                now = asyncio.get_running_loop().time()
                now_pc = time.perf_counter()
                taken = self.coalescer.take()
                stats.VOLUME_SERVER_EC_QUEUE_DEPTH.set(len(self.coalescer))
                for vid, items in taken.items():
                    stats.VOLUME_SERVER_EC_BATCH_SIZE.observe(len(items))
                    for r in items:
                        if r.tier:  # "" = enqueued with qos off
                            self.qos.dequeued(r.tier)
                        wait = now - r.enqueued
                        stats.VOLUME_SERVER_EC_BATCH_QUEUE_WAIT.observe(wait)
                        # the trace's view of the same wait: admission ->
                        # batch take, per request
                        obs.record_span(
                            r.obs_ctx, "queue_wait", now_pc - wait, wait
                        )
                    await self._serve_batch(vid, items)
        finally:
            self._inflight -= 1
            stats.VOLUME_SERVER_EC_BATCH_INFLIGHT.set(self._inflight)
            self._maybe_spawn()  # raced with an offer after the loop check

    async def _serve_batch(self, vid: int, items: list[ReadRequest]) -> None:
        # one batch serves many traces: the worker's stage spans
        # (shard_read / batch_pack / device_execute / d2h_copy) land in a
        # sink and are replayed onto every member trace afterwards —
        # observe=False so the stage histograms count each stage once
        t0 = time.perf_counter()
        # a pin uploading during the batch makes its time no seed of
        # the QoS estimate (qos.observe_service)
        cache = getattr(self.store, "ec_device_cache", None)
        pins0 = cache.pin_activity() if cache is not None else None
        # device-ledger class for the batch: a batch is bulk-tier only when
        # every member is (a mixed batch serves an interactive reader, so it
        # attributes interactive); "" = qos off = interactive.
        # asyncio.to_thread copies the context, so the tag reaches the
        # device section in ops/rs_resident
        wl = (
            "serving_bulk"
            if items and all(r.tier == "bulk" for r in items)
            else "serving_interactive"
        )
        with obs.stage_sink() as sink:
            try:
                with devledger.workload(wl), obs.span(
                    "batch_dispatch", needles=len(items), vid=vid
                ):
                    results = await asyncio.to_thread(
                        self.store.read_ec_needles_batch,
                        vid,
                        [(r.nid, r.cookie) for r in items],
                        self._remote_reader(vid),
                        self.cfg.zero_copy,
                    )
            except Exception as e:  # noqa: BLE001 — volume-level failure
                results = [e] * len(items)
        # feed the deadline estimator: per-needle service time of THIS
        # batch (wall across the store call / width)
        self.qos.observe_service(
            (time.perf_counter() - t0) / max(1, len(items)),
            pinning=pins0 is not None and (
                pins0[0] > 0 or cache.pin_activity() != pins0),
        )
        for r in items:
            if r.obs_ctx is None:
                continue
            for stage, (dur, calls, ann) in sink.items():
                obs.record_span(
                    r.obs_ctx, stage, t0, dur, observe=False,
                    annotations={"calls": calls, **ann},
                )
        for r, res in zip(items, results):
            if r.future.done():  # client went away mid-batch
                continue
            if isinstance(res, Exception):
                r.future.set_exception(res)
            else:
                r.future.set_result(res)
