"""VolumeServer: the HTTP half of seaweedfs_tpu/server/volume.py.

Reference: weed/server/volume_server.go, volume_server_handlers*.go.  One
asyncio process per storage node, serving one node's volumes:

  - GET/HEAD/POST/PUT/DELETE on /<vid>,<fid> (server/http.py): reads serve
    normal volumes, and EC volumes through the continuous-batching
    dispatcher (serving/dispatcher.py), which coalesces concurrent reads of
    a resident volume into one ragged launch of csrc/fused_reconstruct.cu
    per batch and sends the rest down the host path;
  - GET /status (the volumes, and each EC volume's local and resident
    shards), GET /metrics (stats/metrics.py, Prometheus text format) and
    GET /debug/device/attribution (the device-time ledger,
    obs/devledger.py: busy seconds, dispatches, bytes and queue wait per
    workload class);
  - the observability plane (obs/): every data request is traced
    (obs.middleware, which is also the deadline front door) and served at
    GET /debug/traces; GET /debug/critpath?id= attributes one request's
    time to the six critical-path segments; GET /debug/tail holds the
    tail store's route stats and pinned slow trees; GET /debug/incident
    the flight recorder; GET /debug/timeline the ~1 s flight timeline;
    GET /debug/device/hot the resident calls by class; and, with
    SWFS_DEBUG=1, GET /debug/profile?seconds=N a torch.profiler capture
    of the live process;
  - with -ec.scrub.intervalSeconds, an idle loop that parity-scrubs every
    locally complete EC volume each interval: the resident ones in one
    pass of csrc/scrub.cu over the cache, the rest from their files, and
    reports the corrupt ones on a gauge;
  - the streaming ingest plane (ingest/, -ec.ingest.*): every upload is
    admitted at the door (QoS write tiers, and a doomed upload refused
    against its X-Seaweed-Deadline-Ms budget) before its body is read;
    after the append, each stripe row the write completed is staged in a
    pinned arena slot and encoded on the card (K1) while the volume still
    grows, and the writer parks on a group-commit fsync when
    -ec.ingest.fsync is on; Store.ec_generate then seals from the stream;
  - with a device cache, the residency ladder (serving/tiering.py,
    -ec.tier.*): a loop that moves EC volumes between HBM, host RAM and
    disk by the decayed read and write heat the dispatcher and the ingest
    plane feed it.

Blocking storage and device work runs via asyncio.to_thread.  A volume
that is not local answers 404, which is what the reference answers when
the master knows no other holder.  Not here (ROADMAP A4b): the gRPC admin
and EC service, the master heartbeat, proxy/redirect reads, replication
fan-out, write JWTs, TTL sweeps; image resizing waits for the images
package; the timeline's heartbeat shipping and /debug/stacks wait for the
master (A7c).
"""
from __future__ import annotations

import asyncio
import dataclasses
import functools
import gzip
import logging
import os
import time
from collections import deque

from .. import obs, stats
from ..obs import devledger
from ..obs import tailstore as tailstore_mod
from ..obs import timeline as timeline_mod
from ..obs import trace as obs_trace
from ..ingest import IngestConfig, IngestPlane
from ..ops import rs, rs_cuda, rs_resident
from ..serving import EcReadDispatcher, ServingConfig, TieringController
from ..storage import types as t
from ..storage.disk_location import DiskLocation
from ..storage.ec.layout import TOTAL_SHARDS
from ..storage.needle import FLAG_IS_COMPRESSED, CrcError, Needle
from ..storage.store import Store
from ..storage.volume import CookieMismatch, NotFoundError, VolumeReadOnly
from ..utils import faultpolicy
from ..utils.tasks import spawn_logged
from .conditional import content_disposition, format_http_date, not_modified
from .http import HTTPError, HTTPServer, Request, Response, json_response

log = logging.getLogger("volume")

# where the resident cache lives for each -ec.backend: the card, or the
# kernels' plain PyTorch versions on the CPU
_CACHE_DEVICE = {"cuda": "cuda", "torch": "cpu"}

# the kernels whose launches /metrics mirrors
_KERNELS = (
    rs_resident.fused_reconstruct,
    rs_resident.fused_reconstruct_blockdiag,
    rs_cuda.gf2_matmul,
    rs_cuda.gf2_matmul_small,
    rs_resident.scrub,
)


class ByteLimiter:
    """Bound total in-flight bytes (the reference's inFlightUploadData /
    inFlightDownloadData throttles, volume_server.go:23-53).  Admission
    is FIFO so an oversize request (> limit, which runs alone) can't be
    starved by a stream of small ones.  limit<=0 disables."""

    def __init__(self, limit_bytes: int, timeout: float = 30.0):
        self.limit = limit_bytes
        self.timeout = timeout
        self.in_flight = 0
        self._cond = asyncio.Condition()
        self._queue: deque = deque()

    def __call__(self, n: int) -> "_ByteLease":
        return _ByteLease(self, n)


class _ByteLease:
    def __init__(self, limiter: ByteLimiter, n: int):
        self.limiter = limiter
        self.n = n

    async def __aenter__(self):
        lim = self.limiter
        if lim.limit <= 0:
            return self
        ticket = object()
        async with lim._cond:
            lim._queue.append(ticket)

            def my_turn():
                return lim._queue[0] is ticket and (
                    lim.in_flight + self.n <= lim.limit
                    or lim.in_flight == 0  # oversize requests run alone
                )

            try:
                await asyncio.wait_for(
                    lim._cond.wait_for(my_turn), lim.timeout
                )
            except asyncio.TimeoutError:
                lim._queue.remove(ticket)
                lim._cond.notify_all()
                raise HTTPError(429, "too many in-flight bytes; retry later")
            lim._queue.popleft()
            lim.in_flight += self.n
            lim._cond.notify_all()  # the next ticket may also fit
        return self

    async def __aexit__(self, *exc):
        lim = self.limiter
        if lim.limit <= 0:
            return
        async with lim._cond:
            lim.in_flight -= self.n
            lim._cond.notify_all()


class VolumeServer:
    def __init__(
        self,
        masters: list[str],
        directories: list[str],
        ip: str = "127.0.0.1",
        port: int = 8080,
        max_volume_counts: int | list[int] = 8,
        ec_backend: str = "cuda",
        client_max_size_mb: int = 256,
        concurrent_upload_limit_mb: int = 0,  # 0 = unlimited
        concurrent_download_limit_mb: int = 0,
        ec_device_cache_mb: int = 0,  # >0: pin mounted EC shards on the card
        ec_serving=None,  # serving.ServingConfig | None (-ec.serving.* flags)
        ec_scrub_interval_seconds: int = 0,  # >0: periodic parity scrub
        ec_scrub_megakernel: bool = True,  # one pass over the resident
        # volumes per cycle (-ec.scrub.megakernel.disable)
        ec_ingest=None,  # ingest.IngestConfig | None (-ec.ingest.* flags)
    ):
        if masters:
            raise ValueError(
                "a master (-mserver) is not supported yet: the heartbeat "
                "and gRPC plane are ROADMAP A4b"
            )
        # "cuda" without a card fails here, before anything is served
        ec_backend = rs.resolve_backend(ec_backend)
        # validate the serving config BEFORE the Store exists: the cache
        # must carry the configured layout and pipeline depth from birth,
        # since Store.__init__ starts pinning on-disk EC volumes at once
        ec_serving = (ec_serving or ServingConfig()).validated()
        self.ec_serving = ec_serving
        device_cache = None
        if ec_device_cache_mb > 0:
            if ec_backend not in _CACHE_DEVICE:
                raise ValueError(
                    "-ec.deviceCacheMB needs -ec.backend cuda (or torch, "
                    "the plain versions on the CPU)"
                )
            device_cache = rs_resident.DeviceShardCache(
                budget_bytes=ec_device_cache_mb << 20,
                layout=ec_serving.layout,
                device=_CACHE_DEVICE[ec_backend],
            )
            # one pipeline slot per overlapping lane, as the reference
            # sizes it: otherwise max_inflight lanes queue on the default
            device_cache.pipeline.set_slots(ec_serving.pipeline_slots)
        if isinstance(max_volume_counts, int):
            max_volume_counts = [max_volume_counts] * len(directories)
        if len(max_volume_counts) != len(directories):
            raise ValueError("max_volume_counts must match directories 1:1")
        self.store = Store(
            [
                DiskLocation(d, max_volume_count=c)
                for d, c in zip(directories, max_volume_counts)
            ],
            ec_backend=ec_backend,
            ec_device_cache=device_cache,
        )
        self.ec_scrub_interval_seconds = ec_scrub_interval_seconds
        self.ec_scrub_megakernel = ec_scrub_megakernel
        self._tasks: list[asyncio.Task] = []
        self.ip = ip
        self.port = port
        self.client_max_size_mb = client_max_size_mb
        self.upload_limiter = ByteLimiter(concurrent_upload_limit_mb << 20)
        self.download_limiter = ByteLimiter(concurrent_download_limit_mb << 20)
        # one node holds the survivors: no peer shard reader (A4b)
        self.ec_dispatcher = EcReadDispatcher(
            self.store, lambda vid: None, ec_serving
        )
        # heat-tiered residency ladder (serving/tiering.py, -ec.tier.*):
        # only meaningful with a device cache; the dispatcher feeds the
        # heat signal, the QoS controller gates swap churn under overload,
        # and the tier loop started in start() runs the rebalance cycles
        self.tiering = None
        if device_cache is not None and ec_serving.tier:
            self.tiering = TieringController(self.store, ec_serving)
            self.tiering.attach_qos(self.ec_dispatcher.qos)
            self.ec_dispatcher.tiering = self.tiering
        # streaming ingest plane (ingest/, -ec.ingest.*): write admission
        # at the door, per-volume pipelines encoding stripe rows on the
        # card as appends land, group-commit fsync.  Write heat feeds the
        # ladder's HeatTracker, so a freshly written volume enters it warm.
        # Its backend defaults to -ec.backend ("cuda" without a card has
        # already failed above).
        ec_ingest = (ec_ingest or IngestConfig()).validated()
        if ec_ingest.backend is None:
            ec_ingest = dataclasses.replace(ec_ingest, backend=ec_backend)
        self.ingest = None
        if ec_ingest.enabled:
            self.ingest = IngestPlane(
                ec_ingest,
                heat=self.tiering.heat if self.tiering is not None else None,
            )
        self.store.ingest = self.ingest
        self._http: HTTPServer | None = None
        # the flight timeline (obs/timeline.py) and the tail store
        # (obs/tailstore.py), built in start() as the -obs.* flags say
        self.timeline = None
        self.tailstore = None
        # GET routes: path -> handler (/debug/profile only with
        # SWFS_DEBUG=1: a capture reveals internals and costs the card
        # attention)
        self._get_routes = {
            "/status": self.h_status,
            "/metrics": self.h_metrics,
            "/debug/traces": obs.traces_handler,
            "/debug/critpath": obs.critpath_handler(),
            "/debug/tail": self.h_debug_tail,
            "/debug/incident": obs.incident.incident_handler,
            "/debug/device/hot": obs.device_hot_handler,
            "/debug/timeline": self.h_debug_timeline,
            "/debug/device/attribution": self.h_debug_device_attribution,
        }
        if os.environ.get("SWFS_DEBUG") == "1":
            self._get_routes["/debug/profile"] = obs.profile_handler
        # the pipeline's byte totals already mirrored into the counters
        self._mirrored = {"h2d": 0, "d2h": 0}
        self._mirrored_launches = {k.__name__: 0 for k in _KERNELS}

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    # ------------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        # obs.middleware: the trace and the deadline front door around
        # every request
        self._http = HTTPServer(
            functools.partial(obs.middleware("volume"), handler=self._route),
            self.ip, self.port,
            client_max_size=self.client_max_size_mb << 20,
        )
        await self._http.start()
        self.port = self._http.port
        log.info("volume server up http=%s", self.url)
        if self.ec_scrub_interval_seconds > 0:
            self._tasks.append(
                spawn_logged(self._ec_scrub_forever(), log, "ec scrub loop")
            )
        if (
            self.tiering is not None
            and self.ec_dispatcher.cfg.tier_interval_seconds > 0
        ):
            self._tasks.append(
                spawn_logged(self._tier_loop_forever(), log, "ec tier loop")
            )
        if obs_trace.CONFIG.timeline_enabled:
            self.timeline = timeline_mod.TimelineSampler(
                node=self.url
            ).install()
            self._tasks.append(
                spawn_logged(
                    self._timeline_forever(), log, "timeline sampler loop"
                )
            )
        if obs_trace.CONFIG.tail_enabled:
            self.tailstore = tailstore_mod.TailStore(node=self.url).install()

    async def stop(self) -> None:
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        if self._http is not None:
            await self._http.stop()
            self._http = None
        # zero the occupancy/queue gauges: the registry outlives this
        # server (in-process restarts)
        self.ec_dispatcher.shutdown()
        # unhook the finished-trace taps: the process-global observer list
        # outlives this server (in-process restarts)
        if self.timeline is not None:
            self.timeline.uninstall()
        if self.tailstore is not None:
            self.tailstore.uninstall()
        if self.ingest is not None:
            # joins encode workers + the group-commit flusher
            await asyncio.to_thread(self.ingest.close)
        # off the loop: close() joins pin threads mid-upload
        await asyncio.to_thread(self.store.close)

    # ------------------------------------------------------------------ routing

    async def _route(self, request: Request) -> Response:
        """The routes above, then every other path as a needle; the
        middleware (obs.middleware) has already opened the request's trace
        and deadline scope around this."""
        if request.method in ("GET", "HEAD"):
            handler = self._get_routes.get(request.path)
            if handler is not None:
                return await handler(request)
        if request.path.startswith("/debug/"):
            # never a fid: an unknown (or SWFS_DEBUG-gated) debug route
            raise HTTPError(404, f"no route {request.path}")
        return await self.h_needle(request)

    async def _timeline_forever(self) -> None:
        """~1 s flight-timeline sampling (-obs.timeline.intervalSeconds):
        each tick snapshots the ledger/QoS/cache counters into one
        clock-aligned sample of the local ring."""
        interval = obs_trace.CONFIG.timeline_interval_seconds
        while True:  # until stop() cancels it
            await asyncio.sleep(interval)
            try:
                self.timeline.sample()
            except Exception:  # noqa: BLE001 — sampling must never die
                log.exception("timeline sample failed")

    async def h_debug_timeline(self, request: Request) -> Response:
        """GET /debug/timeline?window=S: this node's flight-timeline ring,
        oldest first (the trailing S seconds when given)."""
        window = request.query.get("window")
        try:
            window_s = float(window) if window else None
        except ValueError:
            raise HTTPError(400, "window must be numeric")
        samples = (
            self.timeline.snapshot(window_s)
            if self.timeline is not None
            else []
        )
        return json_response({"node": self.url, "samples": samples})

    async def h_debug_tail(self, request: Request) -> Response:
        """GET /debug/tail: the tail ring's per-route stats + pinned
        slow/incident span trees (?id= resolves one full tree)."""
        if self.tailstore is None:
            return json_response(
                {"error": "tail retention disabled (-obs.tail.disable)"},
                status=404,
            )
        return await obs.tail_handler(self.tailstore)(request)

    async def h_status(self, request: Request) -> Response:
        """The reference's JSON status, plus each EC volume's local and
        resident shards (its operator page shows the same)."""
        infos = await asyncio.to_thread(self.store.volume_infos)
        cache = self.store.ec_device_cache
        resident = cache.resident_by_vid() if cache is not None else {}
        ec = [
            {
                "id": ev.id,
                "collection": ev.collection,
                "shard_ids": sorted(ev.shards),
                "resident": resident.get(ev.id, []),
                "serving": self.store.ec_volume_is_resident(ev.id),
            }
            for loc in self.store.locations
            for ev in loc.ec_volumes.values()
        ]
        return json_response(
            {
                "Version": "seaweedfs-tpu",
                "Volumes": [vars(i) for i in infos],
                "EcVolumes": ec,
            }
        )

    async def h_metrics(self, request: Request) -> Response:
        self._collect_metrics()
        return Response(
            body=stats.generate_latest(stats.REGISTRY),
            content_type=stats.CONTENT_TYPE_LATEST,
        )

    async def h_needle(self, request: Request) -> Response:
        if request.method in ("GET", "HEAD"):
            with stats.time_request(
                stats.VOLUME_SERVER_REQUEST_COUNTER,
                stats.VOLUME_SERVER_REQUEST_HISTOGRAM,
                "get",
            ):
                return await self.h_read(request)
        if request.method in ("POST", "PUT"):
            with stats.time_request(
                stats.VOLUME_SERVER_REQUEST_COUNTER,
                stats.VOLUME_SERVER_REQUEST_HISTOGRAM,
                "post",
            ):
                return await self.h_write(request)
        if request.method == "DELETE":
            with stats.time_request(
                stats.VOLUME_SERVER_REQUEST_COUNTER,
                stats.VOLUME_SERVER_REQUEST_HISTOGRAM,
                "delete",
            ):
                return await self.h_delete(request)
        raise HTTPError(405, headers={"Allow": "GET, POST, PUT, DELETE"})

    async def h_debug_device_attribution(self, request: Request) -> Response:
        """GET /debug/device/attribution: the device-time ledger — busy
        seconds, dispatches, bytes and queue wait per workload class, with
        the per-device breakdown."""
        return json_response({
            "node": self.url,
            "enabled": devledger.LEDGER.enabled,
            "total_busy_seconds": devledger.LEDGER.total_busy_s(),
            "workloads": devledger.LEDGER.snapshot(),
        })

    async def _ec_scrub_forever(self) -> None:
        """Periodic parity scrub of every locally complete EC volume
        (-ec.scrub.intervalSeconds).  Resident volumes scrub on the card
        (one pass over the cache first, unless -ec.scrub.megakernel.disable),
        the rest from their files.  Corruption is logged and counted on
        SeaweedFS_volumeServer_ec_scrub_corrupt_volumes: detection, not
        repair (ec.rebuild repairs)."""
        # (location dir, vid) -> last KNOWN verdict.  A scrub that fails
        # keeps the previous verdict: a volume that was corrupt last cycle
        # and is unreadable now must not clear the alert.
        verdicts: dict[tuple[str, int], bool] = {}

        def _record(key: tuple[str, int], r: dict) -> None:
            # one home for the verdict bookkeeping, so the pass and the
            # per-volume branch can never report corruption differently
            bad = sum(r["parity_mismatch_bytes"])
            verdicts[key] = bool(bad)
            if bad:
                log.error(
                    "ec volume %d FAILED parity scrub: %s mismatch "
                    "bytes (backend=%s) — run ec.rebuild",
                    key[1], r["parity_mismatch_bytes"], r["backend"],
                )

        while True:  # until stop() cancels it
            await asyncio.sleep(self.ec_scrub_interval_seconds)
            seen: set[tuple[str, int]] = set()
            # the pass first: every fully resident volume in one launch
            # per span class; the loop below takes its verdicts and scrubs
            # only the rest (file-backed or unpinned copies) one by one
            mega: dict = {}
            if self.ec_scrub_megakernel:
                try:
                    mega = await asyncio.to_thread(
                        self.store.scrub_all_resident
                    )
                except Exception:  # noqa: BLE001 — fall back per volume
                    log.exception("ec scrub pass over the cache failed")
            for loc in self.store.locations:
                # a vid mounted in two locations is two shard sets, each
                # scrubbed
                for vid, ev in list(loc.ec_volumes.items()):
                    key = (loc.directory, vid)
                    seen.add(key)
                    if len(ev.shards) < TOTAL_SHARDS:
                        # locally incomplete: nothing to verify here
                        verdicts.pop(key, None)
                        continue
                    r = mega.get(vid)
                    if r is not None and r["dir"] == loc.directory:
                        _record(key, r)  # the pass verified these bytes
                        continue
                    try:
                        r = await asyncio.to_thread(self.store.scrub_ec, ev)
                    except FileNotFoundError:
                        verdicts.pop(key, None)  # shards went away
                        continue
                    except Exception:  # noqa: BLE001 — transient IO or an
                        # unmount mid-scrub: keep the last verdict
                        log.exception("ec scrub failed for volume %d", vid)
                        continue
                    _record(key, r)
            for key in list(verdicts):
                if key not in seen:  # unmounted since last cycle
                    del verdicts[key]
            stats.VOLUME_SERVER_SCRUB_CORRUPT_GAUGE.set(
                sum(verdicts.values())
            )

    async def _tier_loop_forever(self) -> None:
        """The residency ladder's rebalance loop
        (-ec.tier.intervalSeconds): each cycle re-ranks volumes by decayed
        heat and makes at most a couple of ladder moves — promotion pins
        (host-RAM bytes first), demotion through the claim/evict release
        path, host-tier staging.  The blocking pin/stage IO runs on a
        worker thread so the event loop keeps serving."""
        interval = self.ec_dispatcher.cfg.tier_interval_seconds
        while True:  # until stop() cancels it
            await asyncio.sleep(interval)
            try:
                moves = await asyncio.to_thread(self.tiering.rebalance)
                if moves:
                    log.info(
                        "tier rebalance: %s",
                        " ".join(f"{kind}:{vid}" for kind, vid in moves),
                    )
            except Exception:  # noqa: BLE001 — one failed cycle must
                # not end the ladder; the next cycle retries
                log.exception("tier rebalance failed")

    def _collect_metrics(self) -> None:
        """Refresh volume/EC gauges from store state at scrape time, and
        mirror the pipeline's transfer bytes and the kernels' launch
        counts into their counters."""
        stats.VOLUME_SERVER_VOLUME_GAUGE.clear()
        by_key: dict[tuple[str, str], int] = {}
        for loc in self.store.locations:
            for v in loc.volumes.values():
                key = (v.collection, "volume")
                by_key[key] = by_key.get(key, 0) + 1
            for ev in loc.ec_volumes.values():
                key = (ev.collection, "ec_shards")
                by_key[key] = by_key.get(key, 0) + len(ev.shards)
        for (collection, kind), count in by_key.items():
            stats.VOLUME_SERVER_VOLUME_GAUGE.labels(
                collection=collection, type=kind
            ).set(count)
        cache = self.store.ec_device_cache
        n_resident, n_bytes = cache.stats() if cache is not None else (0, 0)
        stats.VOLUME_SERVER_RESIDENT_SHARD_GAUGE.set(n_resident)
        stats.VOLUME_SERVER_RESIDENT_BYTES_GAUGE.set(n_bytes)
        if cache is not None:
            for key, counter, total in (
                ("h2d", stats.VOLUME_SERVER_EC_H2D_BYTES,
                 cache.pipeline.h2d_bytes),
                ("d2h", stats.VOLUME_SERVER_EC_D2H_BYTES,
                 cache.pipeline.d2h_bytes),
            ):
                counter.inc(total - self._mirrored[key])
                self._mirrored[key] = total
        for kern in _KERNELS:
            name = kern.__name__
            stats.VOLUME_SERVER_EC_KERNEL_LAUNCHES.labels(kernel=name).inc(
                max(0, kern.launches - self._mirrored_launches[name])
            )
            self._mirrored_launches[name] = kern.launches

    def _parse_fid(self, request: Request) -> tuple[int, int, int]:
        fid = request.path.strip("/").split(".")[0]
        return t.parse_fid(fid)  # raises ValueError

    async def h_read(self, request: Request) -> Response:
        """(GetOrHeadHandler volume_server_handlers_read.go:31-235)"""
        try:
            vid, nid, cookie = self._parse_fid(request)
        except ValueError as e:
            raise HTTPError(400, str(e))
        v = self.store.find_volume(vid)
        ev = self.store.find_ec_volume(vid) if v is None else None
        if v is None and ev is None:
            raise HTTPError(404, f"volume {vid} not found anywhere")
        # lease BEFORE the disk read so the throttle bounds memory; the
        # index knows the size up front for normal volumes (EC locates
        # during the read itself — those lease 0 and stay unthrottled)
        read_deleted = request.query.get("readDeleted") == "true"
        size_hint = 0
        if v is not None:
            loc = v.nm.get(nid)
            size_hint = loc[1] if loc else 0
            if loc is None and read_deleted:
                size_hint = (
                    await asyncio.to_thread(v.deleted_needle_size, nid) or 0
                )
        serving_cfg = self.ec_dispatcher.cfg
        async with self.download_limiter(size_hint):
            try:
                if v is not None:
                    n = await asyncio.to_thread(
                        self.store.read_needle,
                        vid,
                        nid,
                        cookie,
                        read_deleted,
                        serving_cfg.zero_copy,
                    )
                else:
                    # resident volumes coalesce into batched device
                    # reconstructs; the rest take the native path inside.
                    # QoS tier + origin ride in on headers
                    n = await self.ec_dispatcher.read(
                        vid, nid, cookie,
                        tier=request.headers.get("X-Seaweed-QoS", ""),
                        origin=request.headers.get(
                            "X-Seaweed-Read-Origin", ""
                        ),
                    )
            except (NotFoundError, KeyError):
                raise HTTPError(404)
            except CookieMismatch:
                raise HTTPError(403)
            except CrcError:
                raise HTTPError(500, "data corruption: CRC mismatch")
            except ValueError:
                # the volume was destroyed under us (an admin delete
                # closed the dat file mid-read)
                raise HTTPError(404, "volume is gone")
            # TTL'd needles expire at read time (GetOrHeadHandler's ttl
            # check)
            if v is not None:
                ttl_min = v.super_block.ttl.minutes
                if (
                    ttl_min
                    and n.last_modified
                    and n.last_modified + ttl_min * 60 < time.time()
                ):
                    raise HTTPError(404, "needle expired")
            return self._respond_needle(request, n)

    def _respond_needle(self, request: Request, n: Needle) -> Response:
        headers = {"Etag": f'"{n.etag}"', "Accept-Ranges": "bytes"}
        if n.last_modified:
            headers["Last-Modified"] = format_http_date(n.last_modified)
        ct = n.mime.decode() if n.mime else "application/octet-stream"
        cd = content_disposition(
            request, n.name.decode("utf-8", "replace") if n.name else ""
        )
        if cd:
            headers["Content-Disposition"] = cd
        if not_modified(request, headers["Etag"], n.last_modified):
            # a 304 exists to skip the body work; keep the validators
            return Response(304, headers=headers, content_type=ct)
        copied = 0  # response-path bytes COPIED serving this request
        body = n.data  # memoryview on the zero-copy parse, else bytes
        if isinstance(body, bytes) and body:
            copied += len(body)
        if n.is_compressed:
            if "gzip" in request.headers.get("Accept-Encoding", ""):
                headers["Content-Encoding"] = "gzip"
            else:
                body = gzip.decompress(body)
                copied += len(body)
        if request.method == "HEAD":
            stats.VOLUME_SERVER_RESPONSE_COPY_BYTES.inc(copied)
            return Response(
                200, headers={**headers, "Content-Length": str(len(body))},
                content_type=ct,
            )
        status = 200
        # a malformed Range header raises ValueError out of the handler, so
        # the server answers 500, as the reference does (its aiohttp
        # request.http_range raises outside any handler try)
        rng = request.http_range
        if rng.start is not None or rng.stop is not None:
            start = rng.start or 0
            if start < 0:  # suffix range "bytes=-N": last N bytes
                start, stop = max(len(body) + start, 0), len(body)
            else:
                stop = min(
                    rng.stop if rng.stop is not None else len(body),
                    len(body),
                )
            if start >= stop:
                raise HTTPError(
                    416, headers={"Content-Range": f"bytes */{len(body)}"}
                )
            # memoryview slice = zero-copy window; a bytes slice copies
            part = memoryview(body)[start:stop] if isinstance(
                body, memoryview
            ) else body[start:stop]
            if isinstance(part, bytes):
                copied += len(part)
            headers["Content-Range"] = (
                f"bytes {start}-{start + len(part) - 1}/{len(body)}"
            )
            body = part
            status = 206
        stats.VOLUME_SERVER_RESPONSE_COPY_BYTES.inc(copied)
        return Response(
            status, body, headers, content_type=ct,
            stall_budget=self.ec_dispatcher.cfg.stall_budget_for(len(body)),
        )

    async def h_write(self, request: Request) -> Response:
        """(PostHandler volume_server_handlers_write.go): the ingest
        plane's front door, then parse the upload and append it locally.

        Admission happens BEFORE any body byte is buffered: a QoS
        write-tier shed answers 429 with Retry-After, and an upload that
        cannot finish within its deadline budget (its Content-Length at
        -ec.ingest.minRateKBps overruns the remaining
        X-Seaweed-Deadline-Ms) answers 504 at the door instead of at the
        fsync.  The doom check binds only against a deadline the client
        sent: the server's default stamp is a backstop for in-flight
        work, not a contract the uploader agreed to."""
        try:
            vid, nid, cookie = self._parse_fid(request)
        except ValueError as e:
            raise HTTPError(400, str(e))
        v = self.store.find_volume(vid)
        if v is None:
            raise HTTPError(404, f"volume {vid} not local")
        tier = request.headers.get("X-Seaweed-QoS", "")
        if self.ingest is None:
            return await self._h_write_admitted(request, v, vid, nid, cookie,
                                                tier)
        client_ms = faultpolicy.parse_deadline_ms(
            request.headers.get(faultpolicy.DEADLINE_HEADER, "")
        )
        shed = self.ingest.admit(
            tier,
            request.content_length or 0,
            faultpolicy.remaining_s() if client_ms is not None else None,
        )
        if shed == "deadline":
            raise HTTPError(
                504, "upload cannot finish within its deadline budget"
            )
        if shed is not None:
            raise HTTPError(429, f"write admission shed ({shed})",
                            headers={"Retry-After": "1"})
        t0 = time.monotonic()
        try:
            return await self._h_write_admitted(request, v, vid, nid, cookie,
                                                tier)
        finally:
            self.ingest.complete(tier, time.monotonic() - t0)

    async def _h_write_admitted(self, request: Request, v, vid: int, nid: int,
                                cookie: int, tier: str) -> Response:
        """Append locally, run the ingest plane's post-append hook, then
        the replication check.  Replication fan-out is ROADMAP A4b:
        without a master no replica location is known, so a volume whose
        placement asks for copies answers 500 "replication failed" after
        the append, as the reference does, and tombstones the needle
        again only when the write created it (a rolled-back overwrite
        would destroy the prior version)."""
        # lease BEFORE buffering the body, or the throttle bounds nothing
        async with self.upload_limiter(request.content_length or 0):
            body = await request.read()
            name, mime, data, compressed = self._parse_upload(
                request.headers.get("Content-Type", ""), body
            )
            n = Needle(
                id=nid,
                cookie=cookie,
                data=data,
                name=name,
                mime=mime,
                last_modified=int(time.time()),
                flags=FLAG_IS_COMPRESSED if compressed else 0,
            )
            existed = v.has(nid)
            try:
                size = await asyncio.to_thread(self.store.write_needle, vid, n)
            except VolumeReadOnly:
                raise HTTPError(409, f"volume {vid} is read-only")
            if self.ingest is not None:
                # post-append hook on a worker thread: write heat, stage
                # the stripe rows this write completed (the arena wait is
                # the plane's backpressure, landing on THIS writer), and
                # park on the group commit when durability is on
                await asyncio.to_thread(self.ingest.on_write, v, size, tier)
            if (
                request.query.get("type") != "replicate"
                and v.super_block.replica_placement.copy_count > 1
            ):
                if not existed:
                    try:
                        await asyncio.to_thread(
                            self.store.delete_needle, vid, nid, cookie
                        )
                    except Exception:  # noqa: BLE001 — best effort
                        log.exception("rollback of %d,%x failed", vid, nid)
                raise HTTPError(
                    500, "replication failed: no replica locations known"
                )
        return json_response(
            {"name": name.decode() or "", "size": size, "eTag": n.etag}
        )

    @staticmethod
    def _parse_upload(
        content_type: str, body: bytes
    ) -> tuple[bytes, bytes, bytes, bool]:
        """multipart/form-data or raw body -> (filename, mime, data,
        is_gzipped) (needle_parse_upload.go)."""
        if content_type.startswith("multipart/"):
            import email
            import email.policy

            msg = email.message_from_bytes(
                b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body,
                policy=email.policy.HTTP,
            )
            for part in msg.iter_parts():
                data = part.get_payload(decode=True) or b""
                fname = (part.get_filename() or "").encode()
                pmime = (part.get_content_type() or "").encode()
                if part.get("Content-Type") is None or pmime == b"application/octet-stream":
                    pmime = b""
                gz = part.get("Content-Encoding") == "gzip"
                return fname, pmime, data, gz
            return b"", b"", b"", False
        ct = content_type.split(";")[0].strip()
        mime = ct.encode() if ct and ct != "application/octet-stream" else b""
        return b"", mime, body, False

    async def h_delete(self, request: Request) -> Response:
        try:
            vid, nid, cookie = self._parse_fid(request)
        except ValueError as e:
            raise HTTPError(400, str(e))
        v = self.store.find_volume(vid)
        if v is None:
            ev = self.store.find_ec_volume(vid)
            if ev is None:
                raise HTTPError(404)
            await asyncio.to_thread(self.store.delete_ec_needle, vid, nid)
            return json_response({"size": 0})
        try:
            size = await asyncio.to_thread(self.store.delete_needle, vid, nid, cookie)
        except CookieMismatch:
            raise HTTPError(403)
        return json_response({"size": size})
