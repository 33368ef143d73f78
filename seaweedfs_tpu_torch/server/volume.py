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
    of the live process and GET /debug/stacks every thread's stack;
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

With -mserver, the server heartbeats to the master over the RPC plane
(pb/rpc.py): one bidirectional SendHeartbeat stream carrying a full
heartbeat, then the store's deltas, with the device cache's, the ingest
plane's and the residency ladder's telemetry, the stage digests and the
flight timeline's samples on every pulse (the last two ACK-gated: what a
pulse the master never answered carried ships again).  Its own RPC
listener (-port.grpc) serves the `VolumeServer` rpcs the shell's EC verbs
and peers call: volume lifecycle (AllocateVolume, VolumeMount/Unmount/
Delete, VolumeMarkReadonly/Writable, VolumeConfigure, VolumeStatus), the
master's vacuum protocol (VacuumVolumeCheck/Compact/Commit/Cleanup; the
compact invalidates the volume's ingest pipeline first), CopyFile, and the EC
service — VolumeEcShardsGenerate and VolumeEcShardsRebuild (K1 on the
card), VolumeEcShardsCopy/Delete/Mount/Unmount, VolumeEcShardRead (raw
shard bytes to a peer), VolumeEcBlobDelete, VolumeEcShardsVerify (the
parity scrub; all_resident runs csrc/scrub.cu over the cache) and
VolumeEcShardsToVolume.  An EC read whose shard lives on a peer fetches it
through `_remote_shard_reader` (the holders from the master's
LookupEcVolume, cached), and a degraded read gathers its remote survivors
through the hedged gather.

A write to a volume placed for copies fans out to the other holders the
master lists (LookupVolume), and is rolled back when a peer refuses; a
GET of a volume held elsewhere is proxied to a holder or, with
`-readMode redirect`, redirected at it.  With a `[jwt.signing] key` every
write and delete must carry the master's token for its fid (security/);
with an `[access] white_list` a peer outside it is answered 403.  An image
GET with width/height/mode or crop_* is cropped, then resized (images/),
and `-images.fix.orientation` turns uploaded JPEGs upright.  A loop
deletes TTL volumes whose time ran out since their last write.  The admin
rpcs DeleteCollection, VolumeServerStatus, VolumeServerLeave,
ReadNeedleBlob and WriteNeedleBlob are served too.

The `.dat` movers: VolumeTierMoveDatToRemote uploads a read-only volume's
.dat to a storage backend (storage/backend.py, from master.toml's
[storage.backend] and -tier.dir) and serves it from there read-only;
VolumeTierMoveDatFromRemote brings it back; VolumeCopy pulls a volume's
.dat and .idx from a peer (CopyFile) and mounts them, and refuses a vid
this server already holds (the reference pulls the files under the live
volume and keeps serving the old inode); VolumeTailSender streams the
records appended since a timestamp, and VolumeTailReceiver appends a
peer's (operation/tail_volume.py) through Store.write_needle.  The tier
moves and VolumeCopy invalidate the volume's ingest pipeline first, so
the next seal runs offline (K1 over the whole .dat).  `-index
sqlite|native` gives every volume a persistent needle map.

Blocking storage and device work runs via asyncio.to_thread.
"""
from __future__ import annotations

import asyncio
import dataclasses
import functools
import gzip
import json
import logging
import os
import time
import urllib.parse
from collections import deque

from .. import images, obs, stats
from ..obs import devledger
from ..obs import tailstore as tailstore_mod
from ..obs import timeline as timeline_mod
from ..obs import trace as obs_trace
from ..images.orientation import fix_orientation
from ..ingest import IngestConfig, IngestPlane
from ..ops import rs, rs_cuda, rs_resident
from ..security import verify_volume_write_jwt
from ..security.guard import Guard
from ..pb import (
    RpcError,
    RpcServer,
    StatusCode,
    Stub,
    channel,
    master_pb2,
    server_address,
    sync_channel_cached,
    volume_server_pb2,
)
from ..serving import EcReadDispatcher, ServingConfig, TieringController
from ..serving import qos as qos_mod
from ..storage import types as t
from ..storage.disk_location import DiskLocation
from ..storage.ec import (
    ec_base_name,
    find_dat_file_size,
    to_ext,
    write_dat_file,
)
from ..storage.ec.decoder import write_idx_file_from_ec_index
from ..storage.ec.layout import TOTAL_SHARDS
from ..storage.ec.volume import NeedleNotFound, search_sorted_index
from ..storage.needle import FLAG_IS_COMPRESSED, CrcError, Needle
from ..storage.store import VOLUME_COPY, Store
from ..storage.volume import CookieMismatch, NotFoundError, Volume, VolumeReadOnly
from ..utils import faultpolicy
from ..utils.tasks import spawn_logged
from .conditional import content_disposition, format_http_date, not_modified
from .conversions import ec_msg_to_pb, volume_msg_to_pb
from .http import (
    HTTPError,
    HTTPServer,
    Request,
    Response,
    fetch,
    json_response,
)

log = logging.getLogger("volume")

# where the resident cache lives for each -ec.backend: the card, or the
# kernels' plain PyTorch versions on the CPU
_CACHE_DEVICE = {"cuda": "cuda", "torch": "cpu"}
# -index -> the Volume's needle map kind
_NEEDLE_MAP_KINDS = {"memory": None, "sqlite": "persistent", "native": "native"}

# the kernels whose launches /metrics mirrors
_KERNELS = (
    rs_resident.fused_reconstruct,
    rs_resident.fused_reconstruct_blockdiag,
    rs_cuda.gf2_matmul,
    rs_cuda.gf2_matmul_small,
    rs_resident.scrub,
)

# one remote shard fetch's ceiling when no request budget is tighter
_SHARD_READ_TIMEOUT_S = 10.0
# how long the master's EC shard map is trusted before a fresh lookup
_EC_LOCATION_TTL = 2.0
_EC_LOOKUP_TIMEOUT_S = 5.0
# CopyFile and VolumeEcShardRead stream in chunks of this size
_STREAM_CHUNK = 1024 * 1024
# the volume tail: a needle body goes out in messages of at most this many
# bytes, and the sender reads records on a worker thread in batches of
# about _TAIL_BATCH bytes
_TAIL_CHUNK = 256 * 1024
_TAIL_BATCH = 8 << 20


def _tail_batch(v: Volume, pos: int) -> list:
    """The records of `v` from byte offset `pos`, up to about _TAIL_BATCH
    bytes: [(offset, header, rest, Needle)]."""
    out, size = [], 0
    for rec in v.scan_records(pos):
        out.append(rec)
        size += len(rec[1]) + len(rec[2])
        if size >= _TAIL_BATCH:
            break
    return out


def _quoted_path(request: Request) -> str:
    """The request's path quoted again for a peer (its sub-delims kept,
    as the reference's URL library does)."""
    return urllib.parse.quote(request.path, safe="/:@!$&'()*+,;=~")


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
        grpc_port: int = 0,
        public_url: str = "",
        max_volume_counts: int | list[int] = 8,
        data_center: str = "",
        rack: str = "",
        pulse_seconds: int = 5,
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
        read_mode: str = "proxy",  # local | proxy | redirect (-readMode)
        metrics_address: str = "",  # pushgateway host:port (ref -metrics.address)
        metrics_interval_seconds: int = 15,  # ref -metrics.intervalSeconds
        jwt_signing_key: str = "",  # security.toml [jwt.signing] key
        white_list: list[str] | None = None,  # [access] white_list guard
        fix_jpg_orientation: bool = False,  # -images.fix.orientation
        tier_backends: dict | None = None,  # storage/backend.py configure()
        index_kind: str = "memory",  # memory | sqlite | native (-index)
        disk_types: list[str] | None = None,  # per-directory (ref -disk flag)
    ):
        if tier_backends:
            from ..storage import backend as backend_mod

            backend_mod.configure(tier_backends)
        self.metrics_address = metrics_address
        self.jwt_signing_key = jwt_signing_key
        self.guard = Guard(white_list)
        self.fix_jpg_orientation = fix_jpg_orientation
        self.metrics_interval_seconds = metrics_interval_seconds
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
                # mesh residency (-ec.serving.mesh.*): lane-shard
                # resident volumes across the local cards; None keeps
                # the one-device layout, as does a mesh of width 1
                mesh_devices=(
                    ec_serving.mesh_devices if ec_serving.mesh else None
                ),
                mesh_min_shard_bytes=ec_serving.mesh_min_shard_mb << 20,
                # pod mesh (-ec.mesh.*): residency spans every process's
                # cards; the command joined the process group first
                global_mesh=ec_serving.multiprocess,
            )
            # one pipeline slot per overlapping lane, as the reference
            # sizes it: otherwise max_inflight lanes queue on the default
            device_cache.pipeline.set_slots(ec_serving.pipeline_slots)
        if isinstance(max_volume_counts, int):
            max_volume_counts = [max_volume_counts] * len(directories)
        if disk_types is None:
            disk_types = ["hdd"] * len(directories)
        if len(disk_types) != len(directories) or len(max_volume_counts) != len(
            directories
        ):
            raise ValueError(
                "disk_types / max_volume_counts must match directories 1:1"
            )
        needle_map_kind = _NEEDLE_MAP_KINDS[index_kind]
        self.store = Store(
            [
                DiskLocation(d, max_volume_count=c, disk_type=dt,
                             needle_map_kind=needle_map_kind)
                for d, c, dt in zip(directories, max_volume_counts, disk_types)
            ],
            ip=ip,
            port=port,
            public_url=public_url,
            ec_backend=ec_backend,
            ec_device_cache=device_cache,
        )
        self.masters = masters
        self.current_master = masters[0] if masters else ""
        # a GET of a volume held elsewhere: redirect at a holder, else
        # proxy to it ("local" proxies too, as in the reference)
        self.read_mode = read_mode
        # -port.grpc, else the reference's convention, port + 10000
        self._grpc_port_given = bool(grpc_port)
        self.grpc_port = grpc_port or (port + 10000 if port else 0)
        self.data_center = data_center
        self.rack = rack
        self.pulse_seconds = pulse_seconds
        # a partition of the heartbeats: the stream stays up and no pulse
        # goes out, so the master's staleness window flags the node
        self.heartbeat_pause = False
        # vid -> (fetched at, shard id -> peer RPC addresses), from the
        # master's LookupEcVolume
        self._ec_locations: dict[int, tuple[float, dict[int, list[str]]]] = {}
        # vid -> (cpd, cpx, idx snapshot, shadow map db) between
        # VacuumVolumeCompact and its Commit or Cleanup
        self._pending_compacts: dict[int, tuple] = {}
        self._stopping = False
        self._rpc: RpcServer | None = None
        self.ec_scrub_interval_seconds = ec_scrub_interval_seconds
        self.ec_scrub_megakernel = ec_scrub_megakernel
        self._tasks: list[asyncio.Task] = []
        self.ip = ip
        self.port = port
        self.client_max_size_mb = client_max_size_mb
        self.upload_limiter = ByteLimiter(concurrent_upload_limit_mb << 20)
        self.download_limiter = ByteLimiter(concurrent_download_limit_mb << 20)
        self.ec_dispatcher = EcReadDispatcher(
            self.store, self._remote_shard_reader, ec_serving
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
        # stage-digest shipping state: deltas against _stage_snapshot
        # accrue in _digest_backlog until the heartbeat that carried
        # them is ACKED (the master answers every heartbeat in order),
        # so a stream break re-ships instead of silently dropping the
        # lost pulse's observations from the cluster's merged digests
        self._stage_snapshot: dict = {}
        self._digest_backlog: dict = {}  # stage -> [buckets, count, sum_s]
        self._digest_shipped: dict = {}  # the outstanding shipment's content
        self._digest_inflight_at: int | None = None  # its heartbeat seq
        self._hb_sent = 0  # per-stream counters (reset on reconnect)
        self._hb_acked = 0
        # flight-timeline shipping state (obs/timeline.py): samples
        # accrue in the backlog until the heartbeat that carried them is
        # ACKed — same protocol as the stage digests above; reships
        # after a stream break are safe because the master dedupes
        # samples by (node, t)
        self._timeline_backlog: list[dict] = []
        self._timeline_shipped = 0  # leading backlog entries in flight
        self._timeline_inflight_at: int | None = None
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
            from ..utils.profiling import debug_stacks_handler

            self._get_routes["/debug/profile"] = obs.profile_handler
            self._get_routes["/debug/stacks"] = debug_stacks_handler
        # the pipeline's byte totals already mirrored into the counters
        self._mirrored = {"h2d": 0, "d2h": 0}
        self._mirrored_launches = {k.__name__: 0 for k in _KERNELS}

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def grpc_url(self) -> str:
        return f"{self.ip}:{self.grpc_port}"

    # ------------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        self._stopping = False
        self._rpc = RpcServer(self.ip, self.grpc_port)
        self._rpc.add_servicer(volume_server_pb2, "VolumeServer", self)
        try:
            self.grpc_port = await self._rpc.start()
        except (OSError, OverflowError) as e:
            if self._grpc_port_given:
                raise
            # the derived port + 10000 is taken or past 65535: any free
            # port serves, since the heartbeat tells the master which
            log.warning("RPC port %d unusable (%s); taking a free one",
                        self.grpc_port, e)
            self._rpc.port = 0
            self.grpc_port = await self._rpc.start()
        # obs.middleware: the trace and the deadline front door around
        # every request
        self._http = HTTPServer(
            functools.partial(obs.middleware("volume"), handler=self._route),
            self.ip, self.port,
            client_max_size=self.client_max_size_mb << 20,
            guard=self.guard,
        )
        await self._http.start()
        self.port = self._http.port
        self.store.port = self.port
        if self.store.public_url == f"{self.ip}:0":
            self.store.public_url = self.url
        log.info("volume server up http=%s grpc=%s", self.url, self.grpc_url)
        if self.masters:
            self._tasks.append(
                spawn_logged(self._heartbeat_forever(), log, "heartbeat loop")
            )
        self._tasks.append(
            spawn_logged(self._ttl_sweep_forever(), log, "ttl sweep loop")
        )
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
        push = stats.start_push_loop(
            "volumeServer", self.url, self.metrics_address,
            self.metrics_interval_seconds, collect=self._collect_metrics,
        )
        if push is not None:
            self._tasks.append(push)

    async def stop(self) -> None:
        self._stopping = True
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        if self._rpc is not None:
            await self._rpc.stop(0.1)
            self._rpc = None
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
        resident shards (its operator page shows the same) and, with the
        ingest plane on, each volume's streaming pipeline (rows encoded
        on the card or the host, valid, and why not)."""
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
        doc = {
            "Version": "seaweedfs-tpu",
            "Volumes": [vars(i) for i in infos],
            "EcVolumes": ec,
        }
        if self.store.ingest is not None:
            doc["Ingest"] = self.store.ingest.status()
        return json_response(doc)

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
            self._check_write_jwt(request)
            with stats.time_request(
                stats.VOLUME_SERVER_REQUEST_COUNTER,
                stats.VOLUME_SERVER_REQUEST_HISTOGRAM,
                "post",
            ):
                return await self.h_write(request)
        if request.method == "DELETE":
            self._check_write_jwt(request)
            with stats.time_request(
                stats.VOLUME_SERVER_REQUEST_COUNTER,
                stats.VOLUME_SERVER_REQUEST_HISTOGRAM,
                "delete",
            ):
                return await self.h_delete(request)
        raise HTTPError(405, headers={"Allow": "GET, POST, PUT, DELETE"})

    def _check_write_jwt(self, request: Request) -> None:
        """Refuse a write or delete without the master's token for its fid
        when a signing key is set (volume_server_handlers.go write guard):
        401, as the reference answers."""
        raw_fid = request.path.strip("/").split(".")[0]
        if not verify_volume_write_jwt(self.jwt_signing_key, request, raw_fid):
            raise HTTPError(401, "missing or invalid write jwt")

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

    async def _ttl_sweep_forever(self, interval: float = 60.0) -> None:
        while not self._stopping:
            await asyncio.sleep(interval)
            try:
                await asyncio.to_thread(self.sweep_expired_ttl_volumes)
            except Exception:  # noqa: BLE001 — the next sweep retries
                log.exception("ttl sweep failed")

    def sweep_expired_ttl_volumes(self, grace: float = 0.1) -> list[int]:
        """Delete volumes whose TTL lapsed (plus `grace` of it) since their
        last write, as the reference expires whole TTL volumes.  Deletion
        goes through Store.delete_volume, which drops the volume's ingest
        pipeline too.  Returns the deleted vids."""
        deleted = []
        now = time.time()
        for loc in self.store.locations:
            for vid, v in list(loc.volumes.items()):
                ttl_min = v.super_block.ttl.minutes
                if not ttl_min or v.is_tiered:
                    continue
                try:
                    last_write = os.path.getmtime(v.dat_path)
                except OSError:
                    continue
                if last_write + ttl_min * 60 * (1 + grace) >= now:
                    continue
                # close the write window before deleting: mark read-only
                # (pushed to the master at once, so assigns stop), then
                # re-check — a write that raced the first mtime read keeps
                # the volume for its records' full TTL
                try:
                    self.store.mark_volume_readonly(vid, True)
                except NotFoundError:  # deleted since the listing
                    continue
                if os.path.getmtime(v.dat_path) != last_write:
                    continue
                log.info("ttl volume %d expired; deleting", vid)
                self.store.delete_volume(vid)
                deleted.append(vid)
        return deleted

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
            return await self._read_remote(request, vid)
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
            return await self._respond_needle(request, n)

    async def _read_remote(self, request: Request, vid: int) -> Response:
        """Volume not local: proxy to or redirect at a peer holding it
        (volume_server_handlers_read.go:65-120)."""
        locations = await self._lookup_volume_locations(vid)
        locations = [u for u in locations if u != self.url]
        if not locations:
            raise HTTPError(404, f"volume {vid} not found anywhere")
        target = locations[0]
        path_qs = _quoted_path(request) + (
            f"?{request.query_string}" if request.query_string else "")
        if self.read_mode == "redirect":
            raise HTTPError(301, headers={
                "Location": f"http://{target}{path_qs}"})
        # forward the read-semantics headers (conditionals, Range) and
        # hand the peer's validators back, so proxied reads revalidate
        # exactly like local ones; the peer records its own spans under
        # the same trace id.  The body passes verbatim (no gunzip).
        fwd = {
            k: request.headers[k]
            for k in ("Range", "If-None-Match", "If-Modified-Since",
                      "Accept-Encoding")
            if k in request.headers
        }
        fwd.update(obs.outbound_headers())
        status, h, body = await fetch(target, "GET", path_qs, fwd)
        back = {
            k: h[k]
            for k in ("Etag", "Last-Modified", "Accept-Ranges",
                      "Content-Range", "Content-Encoding",
                      "Content-Disposition")
            if k in h
        }
        ctype = h.get("Content-Type", "").split(";")[0].strip()
        return Response(status, body, back,
                        content_type=ctype or "application/octet-stream")

    async def _lookup_volume_locations(self, vid: int) -> list[str]:
        """Every server URL the master lists for `vid` (LookupVolume)."""
        if not self.masters:
            return []
        stub = Stub(channel(server_address.grpc_address(self.current_master)),
                    master_pb2, "Seaweed")
        try:
            resp = await stub.LookupVolume(
                master_pb2.LookupVolumeRequest(volume_or_file_ids=[str(vid)]),
                timeout=10.0,
            )
        except RpcError:
            return []
        return [l.url for e in resp.volume_id_locations for l in e.locations]

    async def _respond_needle(self, request: Request, n: Needle) -> Response:
        headers = {"Etag": f'"{n.etag}"', "Accept-Ranges": "bytes"}
        if n.last_modified:
            headers["Last-Modified"] = format_http_date(n.last_modified)
        ct = n.mime.decode() if n.mime else "application/octet-stream"
        is_image = ct.startswith("image/")
        resize = is_image and (
            "width" in request.query or "height" in request.query
        )
        crop = is_image and any(
            f"crop_{k}" in request.query for k in ("x1", "y1", "x2", "y2")
        )
        if resize or crop:
            try:
                rw = int(request.query.get("width") or 0)
                rh = int(request.query.get("height") or 0)
                cx1 = int(request.query.get("crop_x1") or 0)
                cy1 = int(request.query.get("crop_y1") or 0)
                cx2 = int(request.query.get("crop_x2") or 0)
                cy2 = int(request.query.get("crop_y2") or 0)
            except ValueError:
                raise HTTPError(400, "width/height/crop_* must be integers")
            rmode = request.query.get("mode", "")
            # a processed variant must not share the original's cache
            # identity; the crop suffix appears only when cropping, so
            # resize-only Etags stay as the reference's
            variant = f"{n.etag}-{rw}x{rh}{rmode}"
            if crop:
                variant += f"-{cx1},{cy1},{cx2},{cy2}"
            headers["Etag"] = f'"{variant}"'
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
            # a transform needs pixels: never hand gzip bytes to crop or
            # resize (they would pass through under the variant Etag)
            if not (resize or crop) and "gzip" in request.headers.get(
                    "Accept-Encoding", ""):
                headers["Content-Encoding"] = "gzip"
            else:
                body = gzip.decompress(body)
                copied += len(body)
        if crop:
            # the reference's order: crop first, then resize
            body = await asyncio.to_thread(
                images.cropped, bytes(body), cx1, cy1, cx2, cy2)
            copied += len(body)
        if resize:
            body = await asyncio.to_thread(
                images.resized, bytes(body), rw, rh, rmode)
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
        fan the write out to the replicas the master lists unless this
        IS a replica write.  When the fan-out fails (no replica known, a
        peer refused or is down) the answer is 500 "replication failed",
        and a write that created its needle is tombstoned here and on
        the peers that acked (a rolled-back overwrite would destroy the
        prior version)."""
        # lease BEFORE buffering the body, or the throttle bounds nothing
        async with self.upload_limiter(request.content_length or 0):
            body = await request.read()
            name, mime, data, compressed = self._parse_upload(
                request.headers.get("Content-Type", ""), body
            )
            if (
                self.fix_jpg_orientation
                and not compressed
                and (
                    mime == b"image/jpeg"
                    or (name or b"").lower().endswith((b".jpg", b".jpeg"))
                )
            ):
                # turn the pixels upright at ingest (reference needle.go
                # images.FixJpgOrientation, behind -images.fix.orientation)
                data = await asyncio.to_thread(fix_orientation, data)
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
            if request.query.get("type") != "replicate":
                err, acked = await self._replicate(request, vid, body)
                if err:
                    if not existed:
                        try:
                            await asyncio.to_thread(
                                self.store.delete_needle, vid, nid, cookie
                            )
                        except Exception:  # noqa: BLE001 — best effort
                            log.exception("rollback of %d,%x failed", vid, nid)
                        await self._rollback_acked(request, acked)
                    raise HTTPError(500, f"replication failed: {err}")
        return json_response(
            {"name": name.decode() or "", "size": size, "eTag": n.etag}
        )

    async def _replicate(
        self, request: Request, vid: int, body: bytes
    ) -> tuple[str | None, list[str]]:
        """Send the request to every other holder the master lists, with
        ?type=replicate (DistributedOperation store_replicate.go:60).
        Returns (error summary or None, peers that acked)."""
        v = self.store.find_volume(vid)
        if v is None or v.super_block.replica_placement.copy_count <= 1:
            return None, []
        peers = [u for u in await self._lookup_volume_locations(vid)
                 if u != self.url]
        if not peers:
            return "no replica locations known", []
        sep = "&" if request.query_string else ""
        path = (f"{_quoted_path(request)}?"
                f"{request.query_string}{sep}type=replicate")
        headers = {"Content-Type": request.headers.get("Content-Type", "")}
        if request.headers.get("Authorization"):
            # replicas validate the same master-issued write jwt
            headers["Authorization"] = request.headers["Authorization"]
        errors: list[str] = []
        acked: list[str] = []

        async def one(peer):
            try:
                status, _, _ = await fetch(
                    peer, request.method, path, headers, body)
            except Exception as e:  # noqa: BLE001 — reported in the 500
                errors.append(f"{peer}: {e}")
                return
            if status >= 300:
                errors.append(f"{peer}: HTTP {status}")
            else:
                acked.append(peer)

        await asyncio.gather(*(one(p) for p in peers))
        return ("; ".join(errors) if errors else None), acked

    async def _rollback_acked(self, request: Request, acked: list[str]) -> None:
        """Best-effort delete of the fresh needle on replicas that took
        the failed fan-out's write."""
        headers = {}
        if request.headers.get("Authorization"):
            headers["Authorization"] = request.headers["Authorization"]
        for peer in acked:
            try:
                await fetch(
                    peer, "DELETE",
                    f"{_quoted_path(request)}?type=replicate",
                    headers)
            except Exception:  # noqa: BLE001 — best effort
                log.warning("rollback delete on %s failed", peer)

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
        if request.query.get("type") != "replicate":
            await self._replicate(request, vid, b"")
        return json_response({"size": size})

    # ------------------------------------------------------------------ heartbeat

    @staticmethod
    def _fold_digest(dst: dict, stage, buckets, count, dsum, sign=1) -> None:
        rec = dst.setdefault(stage, [[0] * len(buckets), 0, 0.0])
        rec[0] = [a + sign * b for a, b in zip(rec[0], buckets)]
        rec[1] += sign * count
        rec[2] += sign * dsum

    def _build_telemetry(self) -> master_pb2.VolumeServerTelemetry:
        """One pulse's telemetry (the reference's _build_telemetry): the
        device cache's occupancy, evictions and pin claims, the
        dispatcher's live state and its interactive breaker (the master's
        repair plane yields while one is open), the read and shed totals,
        the resident pipeline's overlap and transfer bytes, the residency
        ladder's census and counters (TieringController.status), the
        streaming ingest plane's aggregates (IngestPlane.snapshot and its
        counters), the stage-histogram delta since the previous pulse
        (pb StageDigest — fixed buckets, so the master merges without raw
        samples) and the flight timeline's new samples.  The compile_*
        fields stay 0 and false (no compile cache here).

        Digest and timeline delivery is ack-gated: each pulse's delta
        joins the backlog, the backlog ships only while no earlier
        shipment is unconfirmed, and a shipment is confirmed (removed
        from the backlog) once its heartbeat's response arrives —
        responses are 1:1 and ordered.  A broken stream re-ships the
        unconfirmed backlog on reconnect, so observations survive blips;
        the rare cost is one pulse's digest double-counted when the
        master applied a heartbeat whose response the break ate — a
        bounded skew, versus guaranteed loss."""
        tel = master_pb2.VolumeServerTelemetry()
        tel.wall_clock_unix_ms = int(time.time() * 1e3)
        # pod rank: which member of the multi-process mesh this node is
        tel.mesh_process_id = self.ec_serving.mesh_process_id
        tel.mesh_process_count = self.ec_serving.mesh_process_count
        cache = self.store.ec_device_cache
        if cache is not None:
            n_resident, n_bytes = cache.stats()
            tel.device_budget_bytes = cache.budget
            tel.device_used_bytes = n_bytes
            tel.device_resident_shards = n_resident
            tel.device_evictions = cache.evictions
            tel.device_pin_claims = cache.pin_claims
            tel.device_bytes_per_device.extend(
                d["used_bytes"] for d in cache.device_stats())
            for vid, sids in cache.resident_by_vid().items():
                tel.resident_shards_by_volume[vid] = len(sids)
            tel.ec_h2d_bytes = cache.pipeline.h2d_bytes
            tel.ec_d2h_bytes = cache.pipeline.d2h_bytes
        tel.dispatcher_queue_depth = self.ec_dispatcher.queue_depth
        tel.dispatcher_inflight = self.ec_dispatcher.inflight
        tel.qos_breaker_open = bool(
            self.ec_dispatcher.qos.breaker_state(qos_mod.INTERACTIVE)
            == qos_mod.Breaker.OPEN
        )
        g = stats.REGISTRY.get_sample_value
        tel.dispatcher_shed = int(
            g("SeaweedFS_volumeServer_ec_batch_fallback_total") or 0)
        # admitted EC reads (batched + native partition the admissions)
        # and sheds: with QoS on, every coalescer-saturation fallback also
        # lands in qos_shed{queue_budget}, so the qos series alone is the
        # whole shed count; -ec.qos.disable leaves the fallback counter
        tel.ec_reads_total = sum(
            int(g("SeaweedFS_volumeServer_ec_read_route_total",
                  {"route": r}) or 0)
            for r in ("batched", "native"))
        qos_sheds = sum(
            int(g("SeaweedFS_volumeServer_ec_qos_shed_total",
                  {"tier": t_, "reason": r_}) or 0)
            for t_ in (qos_mod.INTERACTIVE, qos_mod.BULK)
            for r_ in ("queue_budget", "deadline", "breaker_open"))
        tel.ec_reads_shed_total = (
            qos_sheds if self.ec_dispatcher.cfg.qos else tel.dispatcher_shed)
        tel.overlap_fraction = float(
            g("SeaweedFS_volumeServer_ec_overlap_fraction") or 0.0)
        if self.tiering is not None:
            st = self.tiering.status()
            tel.tier_hbm_volumes = st["tiers"].get("hbm", 0)
            tel.tier_host_volumes = st["tiers"].get("host", 0)
            tel.tier_promotions = sum(st["promotions"].values())
            tel.tier_demotions = sum(st["demotions"].values())
            tel.tier_host_bytes = st["host_bytes"]
        if self.ingest is not None:
            ing = self.ingest.snapshot()
            tel.ingest_bytes_total = int(
                g("SeaweedFS_volumeServer_ingest_bytes_total") or 0)
            tel.ingest_fsyncs_total = int(
                g("SeaweedFS_volumeServer_ingest_fsyncs_total") or 0)
            tel.ingest_streamed_seals = int(
                g("SeaweedFS_volumeServer_ingest_seals_total",
                  {"path": "streamed"}) or 0)
            tel.ingest_rows_device = int(ing["rows_device"])
            tel.ingest_rows_host = int(ing["rows_host"])
            tel.ingest_shed_total = sum(ing["sheds"].values())
            tel.ingest_active_pipelines = int(ing["pipelines"])
        snap = stats.stage_histogram_snapshot()
        for stage, buckets, count, dsum in stats.stage_digest_deltas(
            self._stage_snapshot, snap
        ):
            self._fold_digest(self._digest_backlog, stage, buckets, count, dsum)
        self._stage_snapshot = snap
        if (
            self._digest_inflight_at is not None
            and self._hb_acked >= self._digest_inflight_at
        ):
            # the shipment's heartbeat was answered: the master applied
            # it — retire exactly what was shipped from the backlog
            for stage, (buckets, count, dsum) in self._digest_shipped.items():
                self._fold_digest(
                    self._digest_backlog, stage, buckets, count, dsum, sign=-1
                )
            self._digest_backlog = {
                s: rec for s, rec in self._digest_backlog.items() if rec[1] > 0
            }
            self._digest_shipped = {}
            self._digest_inflight_at = None
        if self._digest_inflight_at is None and self._digest_backlog:
            for stage, (buckets, count, dsum) in sorted(
                self._digest_backlog.items()
            ):
                d = tel.stage_digests.add()
                d.stage = stage
                d.bucket_counts.extend(buckets)
                d.count = count
                d.sum_seconds = dsum
            self._digest_shipped = {
                s: (list(b), c, ds)
                for s, (b, c, ds) in self._digest_backlog.items()
            }
            # pulses() bumps _hb_sent right after this build, so the
            # heartbeat carrying this shipment is number _hb_sent + 1
            self._digest_inflight_at = self._hb_sent + 1
        # flight-timeline samples ride the same ACK gate: fold the
        # ring's new suffix into the backlog, retire the in-flight
        # shipment once its heartbeat is answered, ship the backlog only
        # while nothing is unconfirmed.  The backlog is capped at one
        # ring's worth — a long partition drops the OLDEST unshipped
        # samples (bounded memory; the local /debug/timeline ring still
        # has them until they age out).
        if self.timeline is not None:
            self._timeline_backlog.extend(self.timeline.take_new())
            drop = len(self._timeline_backlog) - self.timeline.capacity
            if drop > 0:
                del self._timeline_backlog[:drop]
                self._timeline_shipped = max(0, self._timeline_shipped - drop)
            if (
                self._timeline_inflight_at is not None
                and self._hb_acked >= self._timeline_inflight_at
            ):
                del self._timeline_backlog[: self._timeline_shipped]
                self._timeline_shipped = 0
                self._timeline_inflight_at = None
            if self._timeline_inflight_at is None and self._timeline_backlog:
                tel.timeline_samples_json.extend(
                    json.dumps(s, separators=(",", ":"))
                    for s in self._timeline_backlog
                )
                self._timeline_shipped = len(self._timeline_backlog)
                self._timeline_inflight_at = self._hb_sent + 1
        return tel

    def _identity_heartbeat(self) -> master_pb2.Heartbeat:
        """Who-am-i header and this pulse's telemetry, no volume state."""
        hb = master_pb2.Heartbeat(
            ip=self.ip, port=self.port,
            public_url=self.store.public_url, grpc_port=self.grpc_port,
            data_center=self.data_center, rack=self.rack,
            # pod membership: the coordinator address is the pod id, a
            # rack-like failure domain to the master's placement
            mesh_pod=(
                self.ec_serving.mesh_coordinator
                if self.ec_serving.multiprocess else ""
            ),
        )
        hb.telemetry.CopyFrom(self._build_telemetry())
        return hb

    def _full_heartbeat(self) -> master_pb2.Heartbeat:
        hs = self.store.collect_heartbeat()
        hb = self._identity_heartbeat()
        hb.has_no_volumes = hs.has_no_volumes
        hb.has_no_ec_shards = hs.has_no_ec_shards
        hb.offset_bytes = t.OFFSET_SIZE
        for k, v in hs.max_volume_counts.items():
            hb.max_volume_counts[k] = v
        hb.volumes.extend(volume_msg_to_pb(v) for v in hs.volumes)
        hb.ec_shards.extend(ec_msg_to_pb(e) for e in hs.ec_shards)
        return hb

    def _delta_heartbeat(self) -> master_pb2.Heartbeat | None:
        new_v, del_v, new_ec, del_ec = self.store.drain_deltas()
        if not (new_v or del_v or new_ec or del_ec):
            return None
        hb = self._identity_heartbeat()
        hb.new_volumes.extend(volume_msg_to_pb(v) for v in new_v)
        hb.deleted_volumes.extend(volume_msg_to_pb(v) for v in del_v)
        hb.new_ec_shards.extend(ec_msg_to_pb(e) for e in new_ec)
        hb.deleted_ec_shards.extend(ec_msg_to_pb(e) for e in del_ec)
        return hb

    async def _heartbeat_forever(self) -> None:
        i = 0
        while not self._stopping:
            master = self.masters[i % len(self.masters)]
            i += 1
            try:
                await self._heartbeat_stream(master)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — redial below
                log.debug("heartbeat to %s failed: %s", master, e)
            await asyncio.sleep(min(self.pulse_seconds, 1))

    async def _heartbeat_stream(self, master: str) -> None:
        """One connected session: a full heartbeat, then deltas (pushed
        within 50 ms of a change) and a full re-sync every fourth pulse
        (doHeartbeat volume_grpc_client_to_master.go:92+)."""
        stub = Stub(channel(server_address.grpc_address(master)),
                    master_pb2, "Seaweed")

        async def pulses():
            hb = self._full_heartbeat()
            self._hb_sent += 1
            yield hb
            n = 0
            while not self._stopping:
                await asyncio.sleep(
                    0.05 if not self.store.new_volumes.empty()
                    or not self.store.new_ec_shards.empty()
                    or not self.store.deleted_volumes.empty()
                    or not self.store.deleted_ec_shards.empty()
                    else self.pulse_seconds
                )
                while self.heartbeat_pause and not self._stopping:
                    await asyncio.sleep(0.05)
                hb = self._delta_heartbeat()
                n += 1
                if hb is None:
                    # no state change: a periodic full re-sync, else a
                    # telemetry-only pulse
                    hb = (
                        self._full_heartbeat() if n % 4 == 0
                        else self._identity_heartbeat()
                    )
                self._hb_sent += 1
                yield hb

        try:
            # the heartbeat stream is the liveness signal: deliberately
            # unbounded; a wedged master surfaces as a broken stream
            async for resp in stub.SendHeartbeat(pulses()):
                self._hb_acked += 1
                if resp.volume_size_limit:
                    self.store.volume_size_limit = resp.volume_size_limit
                if resp.leader:
                    self.current_master = resp.leader
        finally:
            # per-stream bookkeeping dies with the stream; an
            # unconfirmed digest shipment stays in the backlog and
            # re-ships on the next connection
            self._hb_sent = 0
            self._hb_acked = 0
            self._digest_shipped = {}
            self._digest_inflight_at = None
            # unconfirmed timeline samples stay in the backlog and
            # re-ship whole on the next connection (master dedupes by t)
            self._timeline_shipped = 0
            self._timeline_inflight_at = None

    # ------------------------------------------------------------------ peer shards

    def _remote_shard_reader(self, vid: int):
        """Sync hook: shard_id, offset, size -> bytes | None, fetched from a
        peer the master's LookupEcVolume names (store_ec.go:238-337).  The
        lookup and the fetch both happen inside the hook, which runs on a
        to_thread worker — a blocking RPC on the event loop would deadlock
        against this process's own servers.  Every fetch carries a hard
        per-call timeout (the remaining deadline budget, capped at
        _SHARD_READ_TIMEOUT_S).  `read.peer_of` names the shard's primary
        holder, so the hedged gather keys its latency EWMAs per peer."""
        if not self.masters:
            return None

        def read(shard_id: int, offset: int, size: int):
            try:
                timeout = faultpolicy.rpc_timeout_s(
                    _SHARD_READ_TIMEOUT_S, what="remote_shard_read"
                )
            except faultpolicy.DeadlineExceeded:
                return None  # doomed: the gather's verdict tells the truth
            for addr in self._cached_ec_locations(vid).get(shard_id, []):
                stub = Stub(sync_channel_cached(addr), volume_server_pb2,
                            "VolumeServer")
                try:
                    chunks = []
                    for resp in stub.VolumeEcShardRead(
                        volume_server_pb2.VolumeEcShardReadRequest(
                            volume_id=vid, shard_id=shard_id,
                            offset=offset, size=size,
                        ),
                        timeout=timeout,
                    ):
                        if resp.is_deleted:
                            stats.VOLUME_SERVER_EC_REMOTE_SHARD_READS.labels(
                                result="deleted").inc()
                            return None
                        chunks.append(resp.data)
                except RpcError:
                    continue
                data = chunks[0] if len(chunks) == 1 else b"".join(chunks)
                stats.VOLUME_SERVER_EC_REMOTE_SHARD_READS.labels(
                    result="ok").inc()
                stats.VOLUME_SERVER_EC_REMOTE_SHARD_BYTES.inc(len(data))
                return data
            stats.VOLUME_SERVER_EC_REMOTE_SHARD_READS.labels(
                result="miss").inc()
            return None

        def peer_of(shard_id: int):
            return next(
                iter(self._cached_ec_locations(vid).get(shard_id, ())), None
            )

        read.peer_of = peer_of
        return read

    def _cached_ec_locations(self, vid: int) -> dict[int, list[str]]:
        """shard id -> peer RPC addresses (this server left out), from the
        master's LookupEcVolume, trusted for _EC_LOCATION_TTL seconds.  An
        unreachable master keeps the stale map rather than an empty one
        (re-stamped, so a down master costs one lookup per TTL)."""
        now = time.time()
        cached = self._ec_locations.get(vid)
        if cached and now - cached[0] < _EC_LOCATION_TTL:
            return cached[1]
        locs: dict[int, list[str]] = {}
        stub = Stub(
            sync_channel_cached(
                server_address.grpc_address(self.current_master)),
            master_pb2, "Seaweed",
        )
        try:
            # a fixed timeout, not the ambient budget: this refresh fills a
            # cache serving many requests
            resp = stub.LookupEcVolume(
                master_pb2.LookupEcVolumeRequest(volume_id=vid),
                timeout=_EC_LOOKUP_TIMEOUT_S, metadata=(),
            )
            for e in resp.shard_id_locations:
                locs[e.shard_id] = [
                    f"{l.url.rsplit(':', 1)[0]}:{l.grpc_port}"
                    for l in e.locations if l.url != self.url
                ]
        except RpcError:
            if cached:
                self._ec_locations[vid] = (now, cached[1])
                return cached[1]
        self._ec_locations[vid] = (now, locs)
        return locs

    # ------------------------------------------------------------------ RPC: lifecycle

    async def AllocateVolume(self, request, context):
        try:
            await asyncio.to_thread(
                self.store.add_volume,
                request.volume_id,
                request.collection,
                request.replication or "000",
                request.ttl or "",
                3,
                request.disk_type or "",
            )
        except (ValueError, RuntimeError) as e:
            await context.abort(StatusCode.FAILED_PRECONDITION, str(e))
        return volume_server_pb2.AllocateVolumeResponse()

    async def VolumeMount(self, request, context):
        try:
            await asyncio.to_thread(self.store.mount_volume, request.volume_id)
        except NotFoundError as e:
            await context.abort(StatusCode.NOT_FOUND, str(e))
        return volume_server_pb2.VolumeMountResponse()

    async def VolumeUnmount(self, request, context):
        try:
            await asyncio.to_thread(self.store.unmount_volume, request.volume_id)
        except NotFoundError as e:
            await context.abort(StatusCode.NOT_FOUND, str(e))
        return volume_server_pb2.VolumeUnmountResponse()

    async def VolumeDelete(self, request, context):
        try:
            await asyncio.to_thread(self.store.delete_volume, request.volume_id)
        except NotFoundError as e:
            await context.abort(StatusCode.NOT_FOUND, str(e))
        return volume_server_pb2.VolumeDeleteResponse()

    async def VolumeMarkReadonly(self, request, context):
        try:
            await asyncio.to_thread(
                self.store.mark_volume_readonly, request.volume_id, True)
        except NotFoundError as e:
            await context.abort(StatusCode.NOT_FOUND, str(e))
        return volume_server_pb2.VolumeMarkReadonlyResponse()

    async def VolumeMarkWritable(self, request, context):
        try:
            await asyncio.to_thread(
                self.store.mark_volume_readonly, request.volume_id, False)
        except NotFoundError as e:
            await context.abort(StatusCode.NOT_FOUND, str(e))
        return volume_server_pb2.VolumeMarkWritableResponse()

    async def VolumeConfigure(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return volume_server_pb2.VolumeConfigureResponse(error="not found")
        try:
            await asyncio.to_thread(
                v.update_replica_placement,
                t.ReplicaPlacement.parse(request.replication),
            )
        except ValueError as e:
            return volume_server_pb2.VolumeConfigureResponse(error=str(e))
        return volume_server_pb2.VolumeConfigureResponse()

    async def VolumeStatus(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            await context.abort(StatusCode.NOT_FOUND, "volume not found")
        info = v.info()
        return volume_server_pb2.VolumeStatusResponse(
            is_read_only=v.read_only or v.full,
            volume_size=info.size,
            file_count=info.file_count,
            file_deleted_count=info.delete_count,
            compact_revision=v.super_block.compaction_revision,
            version=v.version,
            ttl=str(v.super_block.ttl),
            replication=str(v.super_block.replica_placement),
        )

    async def DeleteCollection(self, request, context):
        """Delete every normal volume of the collection (its EC volumes
        stay, as in the reference); Store.delete_volume drops each one's
        ingest pipeline."""
        for loc in self.store.locations:
            for vid, v in list(loc.volumes.items()):
                if v.collection == request.collection:
                    await asyncio.to_thread(self.store.delete_volume, vid)
        return volume_server_pb2.DeleteCollectionResponse()

    async def VolumeServerStatus(self, request, context):
        return volume_server_pb2.VolumeServerStatusResponse(
            data_dirs=[loc.directory for loc in self.store.locations],
            volume_count=sum(len(loc.volumes) for loc in self.store.locations),
            ec_shard_count=sum(
                ev.shard_bits().count()
                for loc in self.store.locations
                for ev in loc.ec_volumes.values()
            ),
        )

    async def VolumeServerLeave(self, request, context):
        """Leave the cluster and keep serving reads, as the reference: the
        heartbeat loop ends (the stream closes, so the master drops this
        node's volumes and its telemetry goes stale), and so do the other
        asyncio loops in `_tasks` — the TTL sweep, the scrub loop, the tier
        loop, the timeline sampler and the metrics push.  None is cut
        mid-pin or mid-row: a scrub pass or a tier move runs in its worker
        thread to its end, so no volume is left half pinned in the
        DeviceShardCache, and the ingest plane's committer and encode
        workers (threads, not tasks) keep running, so acked writes still
        reach their group commit.  HTTP and RPC stay up."""
        self._stopping = True
        for task in self._tasks:
            task.cancel()
        return volume_server_pb2.VolumeServerLeaveResponse()

    async def ReadNeedleBlob(self, request, context):
        try:
            n = await asyncio.to_thread(
                self.store.read_needle, request.volume_id, request.needle_id
            )
        except (NotFoundError, KeyError):
            await context.abort(StatusCode.NOT_FOUND, "needle not found")
        return volume_server_pb2.ReadNeedleBlobResponse(
            needle_blob=n.data, cookie=n.cookie,
            last_modified=n.last_modified,
        )

    async def WriteNeedleBlob(self, request, context):
        """Append one needle to a local replica — volume.check.disk's sync
        path (reference volume_grpc_read_write.go WriteNeedleBlob).  An
        append through store.write_needle: the ingest pipeline's next seal
        reads the new rows from the file, so nothing is invalidated."""
        n = Needle(
            id=request.needle_id,
            cookie=request.cookie,
            data=request.needle_blob,
            last_modified=request.last_modified or int(time.time()),
        )
        try:
            await asyncio.to_thread(self.store.write_needle, request.volume_id, n)
        except NotFoundError:
            await context.abort(StatusCode.NOT_FOUND, "volume not found")
        except VolumeReadOnly as e:
            await context.abort(StatusCode.FAILED_PRECONDITION, str(e))
        return volume_server_pb2.WriteNeedleBlobResponse()

    # ------------------------------------------------------------------ RPC: vacuum

    async def VacuumVolumeCheck(self, request, context):
        t0 = time.perf_counter()
        v = self.store.find_volume(request.volume_id)
        if v is None:
            await context.abort(StatusCode.NOT_FOUND, "volume not found")
        ratio = v.garbage_ratio
        stats.VOLUME_SERVER_VACUUMING_SECONDS.labels(type="check").observe(
            time.perf_counter() - t0)
        return volume_server_pb2.VacuumVolumeCheckResponse(garbage_ratio=ratio)

    async def VacuumVolumeCompact(self, request, context):
        t0 = time.perf_counter()
        if self.store.find_volume(request.volume_id) is None:
            await context.abort(StatusCode.NOT_FOUND, "volume not found")
        # Departure from the reference, whose compact on this path leaves
        # the ingest pipeline valid: Store.compact_volume invalidates it
        # before the copy (and commit_compact after the swap), so the
        # next seal runs offline instead of from stale parity.  A tiered
        # volume is refused.
        try:
            pending = await asyncio.to_thread(
                self.store.compact_volume, request.volume_id)
        except ValueError as e:
            await context.abort(StatusCode.FAILED_PRECONDITION, str(e))
        self._pending_compacts[request.volume_id] = pending
        stats.VOLUME_SERVER_VACUUMING_SECONDS.labels(type="compact").observe(
            time.perf_counter() - t0)
        yield volume_server_pb2.VacuumVolumeCompactResponse(
            processed_bytes=os.path.getsize(pending[0]))

    async def VacuumVolumeCommit(self, request, context):
        t0 = time.perf_counter()
        v = self.store.find_volume(request.volume_id)
        pending = self._pending_compacts.pop(request.volume_id, None)
        if v is None or pending is None:
            await context.abort(StatusCode.FAILED_PRECONDITION,
                                "no pending compact")
        await asyncio.to_thread(
            self.store.commit_compact, request.volume_id, pending)
        stats.VOLUME_SERVER_VACUUMING_SECONDS.labels(type="commit").observe(
            time.perf_counter() - t0)
        return volume_server_pb2.VacuumVolumeCommitResponse(
            is_read_only=v.read_only)

    async def VacuumVolumeCleanup(self, request, context):
        pending = self._pending_compacts.pop(request.volume_id, None)
        if pending:
            self.store.cleanup_compact(pending)
        return volume_server_pb2.VacuumVolumeCleanupResponse()

    # ------------------------------------------------------------------ RPC: copy

    async def CopyFile(self, request, context):
        """Stream a volume or EC file to a puller (volume_grpc_copy.go
        CopyFile)."""
        v = self.store.find_volume(request.volume_id)
        if v is not None:
            base = Volume.base_name(v.dir, v.id, v.collection)
        else:
            base = await asyncio.to_thread(
                self.store._ec_base, request.volume_id, request.collection
            )
            if base is None:
                if request.ignore_source_file_not_found:
                    return
                await context.abort(StatusCode.NOT_FOUND, "volume not found")
        path = base + request.ext
        if not os.path.exists(path):
            if request.ignore_source_file_not_found:
                return
            await context.abort(StatusCode.NOT_FOUND, f"{path} not found")
        stop = request.stop_offset or os.path.getsize(path)
        # the open and the reads run on worker threads: a multi-GB shard
        # copy must not stall the loop (heartbeats, EC reads)
        f = await asyncio.to_thread(open, path, "rb")
        try:
            sent = 0
            while sent < stop:
                buf = await asyncio.to_thread(
                    f.read, min(_STREAM_CHUNK, stop - sent))
                if not buf:
                    break
                sent += len(buf)
                yield volume_server_pb2.CopyFileResponse(file_content=buf)
        finally:
            f.close()

    async def _pull_file(self, source_grpc: str, vid: int, collection: str,
                         ext: str, dest_path: str,
                         ignore_missing: bool = False) -> bool:
        stub = Stub(channel(source_grpc), volume_server_pb2, "VolumeServer")
        tmp = dest_path + ".tmp"
        got_any = False
        f = await asyncio.to_thread(open, tmp, "wb")
        try:
            async for resp in stub.CopyFile(
                volume_server_pb2.CopyFileRequest(
                    volume_id=vid,
                    collection=collection,
                    ext=ext,
                    ignore_source_file_not_found=ignore_missing,
                ),
                # whole-shard pulls ship GBs: heavy but finite, so a hung
                # source frees the copier
                timeout=600.0,
            ):
                got_any = True
                await asyncio.to_thread(f.write, resp.file_content)
        except RpcError:
            f.close()
            if os.path.exists(tmp):
                os.remove(tmp)
            if ignore_missing:
                return False
            raise
        f.close()
        if got_any or not ignore_missing:
            os.replace(tmp, dest_path)
            return True
        os.remove(tmp)
        return False

    async def VolumeCopy(self, request, context):
        """Pull a volume's .dat and .idx from a peer and mount them
        (volume_grpc_copy.go VolumeCopy); `disk_type` pins the copy onto a
        matching DiskLocation.  Departure: a vid this server already holds
        is refused before anything is pulled (the reference replaces the
        files under the mounted volume, whose reads keep the old inode).
        The ingest plane is invalidated before the first pull."""
        vid = request.volume_id
        if self.store.find_volume(vid) is not None:
            await context.abort(StatusCode.FAILED_PRECONDITION,
                                f"volume {vid} already exists")
        loc = self.store._pick_location(request.disk_type or "")
        if loc is None:
            await context.abort(StatusCode.RESOURCE_EXHAUSTED, "no free slots")
        self.store.invalidate_ingest(vid, VOLUME_COPY)
        base = Volume.base_name(loc.directory, vid, request.collection)
        n = 0
        for ext in (".dat", ".idx"):
            await self._pull_file(request.source_data_node, vid,
                                  request.collection, ext, base + ext)
            n += os.path.getsize(base + ext)
        await asyncio.to_thread(self.store.mount_volume, vid)
        yield volume_server_pb2.VolumeCopyResponse(processed_bytes=n)

    # ------------------------------------------------------------------ RPC: tier and tail

    async def VolumeTierMoveDatToRemote(self, request, context):
        """Upload the .dat to a backend and keep serving reads from it
        (volume_grpc_tier.go); Store.tier_move_to_remote invalidates the
        ingest pipeline first."""
        try:
            size = await asyncio.to_thread(
                self.store.tier_move_to_remote,
                request.volume_id,
                request.destination_backend_name,
                request.keep_local_dat_file,
            )
        except (NotFoundError, ValueError, KeyError, OSError) as e:
            await context.abort(StatusCode.FAILED_PRECONDITION, str(e))
        yield volume_server_pb2.VolumeTierMoveDatToRemoteResponse(
            processed=size, processedPercentage=100.0)

    async def VolumeTierMoveDatFromRemote(self, request, context):
        try:
            size = await asyncio.to_thread(
                self.store.tier_move_from_remote,
                request.volume_id,
                request.keep_remote_dat_file,
            )
        except (NotFoundError, ValueError, KeyError, OSError) as e:
            await context.abort(StatusCode.FAILED_PRECONDITION, str(e))
        yield volume_server_pb2.VolumeTierMoveDatFromRemoteResponse(
            processed=size, processedPercentage=100.0)

    async def VolumeTailSender(self, request, context):
        """Stream the records appended after since_ns; with a nonzero idle
        timeout, end the stream after that many idle seconds
        (volume_grpc_tail.go VolumeTailSender).  Bodies of large needles
        span several messages, each repeating the header."""
        v = self.store.find_volume(request.volume_id)
        if v is None:
            await context.abort(StatusCode.NOT_FOUND,
                                f"volume {request.volume_id} not found")
        since_ns = request.since_ns
        draining = request.idle_timeout_seconds
        # position once by timestamp, then follow appends by byte offset:
        # a cursor that advances even for v1/v2 records (no timestamps)
        pos = await asyncio.to_thread(v.find_offset_since, since_ns)
        while True:
            records = await asyncio.to_thread(_tail_batch, v, pos)
            for offset, hdr, rest, n in records:
                pos = offset + len(hdr) + len(rest)
                if 0 < n.append_at_ns <= since_ns:
                    continue  # the initial positioning backs up one record
                for i in range(0, max(len(rest), 1), _TAIL_CHUNK):
                    yield volume_server_pb2.VolumeTailSenderResponse(
                        needle_header=hdr,
                        needle_body=rest[i:i + _TAIL_CHUNK],
                        is_last_chunk=i + _TAIL_CHUNK >= len(rest),
                    )
            if not records:
                # no new data: a keepalive, and the drain countdown
                yield volume_server_pb2.VolumeTailSenderResponse(
                    is_last_chunk=True)
                if request.idle_timeout_seconds > 0:
                    draining -= 1
                    if draining <= 0:
                        return
            else:
                draining = request.idle_timeout_seconds
                if sum(len(r[1]) + len(r[2]) for r in records) >= _TAIL_BATCH:
                    continue  # more is there already: no pause
            await asyncio.sleep(1)

    async def VolumeTailReceiver(self, request, context):
        """Pull a peer's appends into the local volume, how a new or stale
        replica catches up (volume_grpc_tail.go VolumeTailReceiver).  An
        append through Store.write_needle: the ingest pipeline's next seal
        reads the new rows from the file."""
        from ..operation.tail_volume import tail_volume_from_source

        v = self.store.find_volume(request.volume_id)
        if v is None:
            await context.abort(StatusCode.NOT_FOUND,
                                f"volume {request.volume_id} not found")

        async def write(n):
            await asyncio.to_thread(self.store.write_needle,
                                    request.volume_id, n)

        await tail_volume_from_source(
            request.source_volume_server,
            request.volume_id,
            request.since_ns,
            int(request.idle_timeout_seconds),
            write,
            version=v.version,
        )
        return volume_server_pb2.VolumeTailReceiverResponse()

    # ------------------------------------------------------------------ RPC: erasure coding

    async def VolumeEcShardsGenerate(self, request, context):
        """volume_grpc_erasure_coding.go:38-81: the encode on the card (K1,
        or the streamed seal the ingest plane prepared)."""
        try:
            await asyncio.to_thread(self.store.ec_generate, request.volume_id)
        except NotFoundError as e:
            await context.abort(StatusCode.NOT_FOUND, str(e))
        return volume_server_pb2.VolumeEcShardsGenerateResponse()

    async def VolumeEcShardsRebuild(self, request, context):
        try:
            rebuilt = await asyncio.to_thread(
                self.store.ec_rebuild, request.volume_id, request.collection,
                request.fsync,
            )
        except (NotFoundError, ValueError) as e:
            await context.abort(StatusCode.FAILED_PRECONDITION, str(e))
        return volume_server_pb2.VolumeEcShardsRebuildResponse(
            rebuilt_shard_ids=rebuilt
        )

    async def VolumeEcShardsCopy(self, request, context):
        """Pull shard files (and sidecars) from source_data_node
        (volume_grpc_erasure_coding.go:126-177)."""
        loc = self.store._pick_location()
        if loc is None:
            await context.abort(StatusCode.RESOURCE_EXHAUSTED, "no free slots")
        base = ec_base_name(loc.directory, request.volume_id, request.collection)
        for sid in request.shard_ids:
            await self._pull_file(
                request.source_data_node, request.volume_id,
                request.collection, to_ext(sid), base + to_ext(sid),
            )
        if request.copy_ecx_file:
            await self._pull_file(
                request.source_data_node, request.volume_id,
                request.collection, ".ecx", base + ".ecx",
            )
        if request.copy_ecj_file:
            await self._pull_file(
                request.source_data_node, request.volume_id,
                request.collection, ".ecj", base + ".ecj", ignore_missing=True,
            )
        if request.copy_vif_file:
            await self._pull_file(
                request.source_data_node, request.volume_id,
                request.collection, ".vif", base + ".vif", ignore_missing=True,
            )
        return volume_server_pb2.VolumeEcShardsCopyResponse()

    async def VolumeEcShardsDelete(self, request, context):
        await asyncio.to_thread(
            self.store.delete_ec_shards,
            request.volume_id,
            list(request.shard_ids),
            request.collection,
        )
        return volume_server_pb2.VolumeEcShardsDeleteResponse()

    async def VolumeEcShardsMount(self, request, context):
        try:
            await asyncio.to_thread(
                self.store.mount_ec_shards,
                request.volume_id,
                list(request.shard_ids),
                request.collection,
            )
        except NotFoundError as e:
            await context.abort(StatusCode.NOT_FOUND, str(e))
        return volume_server_pb2.VolumeEcShardsMountResponse()

    async def VolumeEcShardsUnmount(self, request, context):
        await asyncio.to_thread(
            self.store.unmount_ec_shards, request.volume_id,
            list(request.shard_ids),
        )
        return volume_server_pb2.VolumeEcShardsUnmountResponse()

    async def VolumeEcShardRead(self, request, context):
        """Stream raw shard bytes to a peer
        (volume_grpc_erasure_coding.go:309-375)."""
        ev = self.store.find_ec_volume(request.volume_id)
        if ev is None or request.shard_id not in ev.shards:
            await context.abort(
                StatusCode.NOT_FOUND,
                f"ec volume {request.volume_id} shard {request.shard_id} "
                "not here",
            )
        if request.file_key:
            try:
                _, _, size = await asyncio.to_thread(
                    search_sorted_index, ev._ecx.fileno(), ev.ecx_size,
                    request.file_key,
                )
                if t.size_is_deleted(size):
                    yield volume_server_pb2.VolumeEcShardReadResponse(
                        is_deleted=True)
                    return
            except NeedleNotFound:
                pass
        remaining = request.size
        offset = request.offset
        while remaining > 0:
            buf = await asyncio.to_thread(
                self.store.read_ec_shard_interval,
                request.volume_id, request.shard_id, offset,
                min(_STREAM_CHUNK, remaining),
            )
            if not buf:
                break
            yield volume_server_pb2.VolumeEcShardReadResponse(data=buf)
            offset += len(buf)
            remaining -= len(buf)

    async def VolumeEcBlobDelete(self, request, context):
        try:
            await asyncio.to_thread(
                self.store.delete_ec_needle, request.volume_id,
                request.file_key,
            )
        except NotFoundError:
            pass
        return volume_server_pb2.VolumeEcBlobDeleteResponse()

    async def VolumeEcShardsVerify(self, request, context):
        """Parity scrub of a mounted EC volume (csrc/scrub.cu over the
        resident shards when the cache holds the whole volume, else the
        shard files through the codec).  `all_resident=True` ignores
        volume_id and scrubs every fully resident volume of this server in
        one pass over the cache; the verdicts come back in `volumes`."""
        if request.all_resident:
            results = await asyncio.to_thread(self.store.scrub_all_resident)
            # per-volume seconds are span-apportioned slices of the one
            # shared pass, so their sum is the pass's wall
            wall = sum(r["seconds"] for r in results.values())
            return volume_server_pb2.VolumeEcShardsVerifyResponse(
                backend="device_megakernel",
                seconds=wall,
                volumes=[
                    volume_server_pb2.EcVolumeScrubResult(
                        volume_id=vid,
                        parity_mismatch_bytes=r["parity_mismatch_bytes"],
                        backend=r["backend"],
                        bytes_verified=r["bytes_verified"],
                        seconds=r["seconds"],
                    )
                    for vid, r in sorted(results.items())
                ],
            )
        try:
            result = await asyncio.to_thread(
                self.store.scrub_ec_volume, request.volume_id
            )
        except NotFoundError as e:
            await context.abort(StatusCode.NOT_FOUND, str(e))
        except FileNotFoundError as e:
            # a degraded volume that is not fully resident: the scrub needs
            # all 14 inputs
            await context.abort(StatusCode.FAILED_PRECONDITION, str(e))
        return volume_server_pb2.VolumeEcShardsVerifyResponse(
            parity_mismatch_bytes=result["parity_mismatch_bytes"],
            backend=result["backend"],
            seconds=result["seconds"],
            bytes_verified=result["bytes_verified"],
        )

    async def VolumeEcShardsToVolume(self, request, context):
        """Decode EC shards back into a normal .dat/.idx volume
        (volume_grpc_erasure_coding.go:407-446)."""
        ev = self.store.find_ec_volume(request.volume_id)
        if ev is None:
            await context.abort(StatusCode.NOT_FOUND, "ec volume not found")
        base = ev.base_name

        def decode():
            dat_size = find_dat_file_size(base)
            write_dat_file(base, dat_size)
            write_idx_file_from_ec_index(base)

        await asyncio.to_thread(decode)
        await asyncio.to_thread(self.store.mount_volume, request.volume_id)
        return volume_server_pb2.VolumeEcShardsToVolumeResponse()
