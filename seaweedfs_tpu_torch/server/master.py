"""MasterServer: the port of seaweedfs_tpu/server/master.py, one master.

Reference: weed/server/master_server.go, master_grpc_server*.go.  Holds the
topology (topology/) that volume servers' heartbeats build, and answers:

  - RPC `Seaweed` (pb/rpc.py, on -port.grpc): SendHeartbeat (each volume
    server's bidirectional stream: a full heartbeat, then deltas; a broken
    stream unregisters the node), Assign, LookupVolume, LookupEcVolume,
    VolumeList (the topology as JSON, which the shell reads),
    LeaseAdminToken / ReleaseAdminToken (the shell's exclusive lock),
    PauseRepair / ResumeRepair;
  - HTTP (server/http.py): /dir/assign, /dir/lookup, /dir/status,
    /vol/grow, /cluster/health.json, /metrics, and the observability
    plane: /debug/traces (its own ring), /debug/critpath (assembled
    cluster-wide: a fan-out over every fresh node's /debug/traces, clocks
    reconciled by the heartbeat skew estimates), /debug/tail (its own
    tail store), /debug/timeline (the clock-aligned cluster flight
    timeline from heartbeat-shipped samples), /debug/incident (its own
    flight recorder), POST /cluster/incident/dump, and with SWFS_DEBUG=1
    /debug/stacks.

Every heartbeat's telemetry feeds the cluster telemetry plane
(stats/cluster.py: staleness, the SeaweedFS_cluster_* gauges, the merged
stage digests, the timeline, the health document), and the repair plane
(repair/scheduler.py) rebuilds lost or corrupt EC shards on its own, each
job ending in a VolumeEcShardsRebuild (K1 on the rebuilder's card).  The
SLO engine (obs/slo.py) judges the declared -obs.slo.* objectives every
pulse; a sustained burn fires the incident bundler (obs/incident.py),
which writes one correlated bundle under -obs.incident.dir — for a
latency SLO with a torch.profiler capture of the busiest node's card.
With -metrics.address the registry is pushed to a pushgateway.  Volume
growth allocates over the volume servers' AllocateVolume RPC.  The master
itself does no device work.  Not here (ROADMAP): raft and the leader
proxying that comes with it (A4c-5; `is_leader` is always true),
KeepConnected and the location broadcast (no client of the port
subscribes), vacuum, collection RPCs, write JWTs, the UI.
"""
from __future__ import annotations

import asyncio
import functools
import json
import logging
import math
import os
import time
import urllib.parse
from dataclasses import dataclass

from .. import obs, stats
from ..pb import RpcError, RpcServer, Stub, channel, master_pb2, volume_server_pb2
from ..pb.rpc import StatusCode
from ..repair import RepairScheduler
from ..storage import types as t
from ..storage.store import VolumeMessage
from ..topology import (
    NoFreeSpace,
    Topology,
    VolumeGrowOption,
    target_count_per_request,
)
from ..topology.node import DataNode
from ..utils.tasks import spawn_logged
from .conversions import (
    ec_msg_from_pb,
    heartbeat_state_from_pb,
    node_to_location,
    volume_msg_from_pb,
)
from .http import HTTPError, HTTPServer, Request, Response, json_response

log = logging.getLogger("master")


@dataclass
class AdminLock:
    """Exclusive admin lock leased to one shell at a time
    (LeaseAdminToken master_grpc_server_admin.go)."""

    token: int = 0
    ts_ns: int = 0
    client: str = ""
    message: str = ""

    LEASE_NS = 60 * 1_000_000_000

    def is_held(self) -> bool:
        return self.token != 0 and time.time_ns() - self.ts_ns < self.LEASE_NS


class MasterServer:
    def __init__(
        self,
        ip: str = "127.0.0.1",
        port: int = 9333,
        grpc_port: int = 0,
        volume_size_limit_mb: int = 30 * 1024,
        default_replication: str = "000",
        pulse_seconds: int = 5,
        ec_repair=None,  # repair.RepairConfig | None (-ec.repair.* flags)
        metrics_address: str = "",  # pushgateway host:port (ref -metrics.address)
        metrics_interval_seconds: int = 15,  # ref -metrics.intervalSeconds
        obs_slo=None,  # obs.SloConfig | None (-obs.slo.* flags)
        obs_incident=None,  # obs.IncidentConfig | None (-obs.incident.*)
    ):
        self.metrics_address = metrics_address
        self.metrics_interval_seconds = metrics_interval_seconds
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port or (port + 10000 if port else 0)
        self.default_replication = default_replication
        self.pulse_seconds = pulse_seconds
        self.topo = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            pulse_seconds=pulse_seconds,
        )
        # heartbeat-carried telemetry aggregated into /cluster/health.json
        # and the SeaweedFS_cluster_* series; a node missing 2 pulse
        # intervals is flagged stale (stats/cluster.py)
        self.telemetry = stats.ClusterTelemetry(pulse_seconds)
        # the repair plane: watches the EC census and the telemetry for
        # missing or corrupt shards and runs QoS-bulk rebuild fan-outs;
        # its loop runs between start() and stop()
        self.repair = RepairScheduler(self, ec_repair)
        # incident plane (obs/slo.py + obs/incident.py): declared SLOs
        # evaluated against the telemetry plane every pulse; a sustained
        # burn (fast window trips, slow window confirms) fires the
        # bundler, which snapshots every fresh node's flight recorder +
        # trace ring into one correlated bundle under -obs.incident.dir
        if obs_incident is not None:
            obs.incident.configure(obs_incident)
        self.slo = obs.SloEngine(obs_slo, self.telemetry, self.repair)
        self.incident = obs.IncidentBundler(
            self.telemetry.fresh_node_urls, self._health_doc,
            timeline_fn=self.telemetry.timeline,
            skew_ms_fn=self.telemetry.clock_skew_ms,
        )
        self.slo.on_violation.append(self._on_slo_violation)
        self._incident_captures: set = set()
        # tail-forensics retention for the master's own requests, built
        # in start() as the -obs.tail.* flags say
        self.tailstore = None
        self._tasks: list[asyncio.Task] = []
        self._growing: set[tuple] = set()
        self.locks: dict[str, AdminLock] = {}
        self._rpc: RpcServer | None = None
        self._http: HTTPServer | None = None
        self._routes = {
            "/dir/assign": self.h_assign,
            "/dir/lookup": self.h_lookup,
            "/dir/status": self.h_dir_status,
            "/vol/grow": self.h_grow,
            "/cluster/health.json": self.h_cluster_health,
            "/metrics": self.h_metrics,
            "/debug/traces": obs.traces_handler,
            # cross-node critical-path assembly: fans out to every fresh
            # node's /debug/traces and reconciles clocks against the
            # heartbeat skew estimates (volume.trace.why reads it)
            "/debug/critpath": obs.critpath_handler(
                node_urls_fn=self.telemetry.fresh_node_urls,
                skew_ms_fn=self.telemetry.clock_skew_ms,
            ),
            "/debug/tail": self.h_debug_tail,
            "/debug/timeline": self.h_debug_timeline,
            # the master's own flight-recorder ring (repair + SLO
            # events); volume servers serve the same endpoint for the
            # bundler's fan-out
            "/debug/incident": obs.incident.incident_handler,
            "/cluster/incident/dump": self.h_incident_dump,
        }
        if os.environ.get("SWFS_DEBUG") == "1":
            # stack dumps reveal internals; opt-in only (the reference
            # gates pprof handlers the same way)
            from ..utils.profiling import debug_stacks_handler

            self._routes["/debug/stacks"] = debug_stacks_handler

    @property
    def is_leader(self) -> bool:
        """Always true: one master, no raft (ROADMAP A4c-5)."""
        return True

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def grpc_url(self) -> str:
        return f"{self.ip}:{self.grpc_port}"

    @property
    def advertise_url(self) -> str:
        """host:port[.grpc] — the explicit grpc form when the +10000
        convention doesn't hold (dynamically assigned ports)."""
        if self.grpc_port == self.port + 10000:
            return self.url
        return f"{self.ip}:{self.port}.{self.grpc_port}"

    # ------------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        self._rpc = RpcServer(self.ip, self.grpc_port)
        self._rpc.add_servicer(master_pb2, "Seaweed", self)
        self.grpc_port = await self._rpc.start()
        self._http = HTTPServer(
            functools.partial(obs.middleware("master"), handler=self._route),
            self.ip, self.port,
        )
        await self._http.start()
        self.port = self._http.port
        if obs.trace.CONFIG.tail_enabled:
            self.tailstore = obs.TailStore(node=self.url).install()
        if self.slo.specs:
            self._tasks.append(
                spawn_logged(self._slo_loop(), log, "slo evaluation loop")
            )
        self.repair.start()
        push = stats.start_push_loop(
            "master", self.url, self.metrics_address,
            self.metrics_interval_seconds,
        )
        if push is not None:
            self._tasks.append(push)
        log.info("master up http=%s grpc=%s", self.url, self.grpc_url)

    async def stop(self) -> None:
        await self.repair.stop()
        captures = list(self._incident_captures)
        for task in self._tasks + captures:
            task.cancel()
        await asyncio.gather(*self._tasks, *captures, return_exceptions=True)
        self._tasks.clear()
        if self._rpc is not None:
            await self._rpc.stop(0.1)
            self._rpc = None
        if self._http is not None:
            await self._http.stop()
            self._http = None
        if self.tailstore is not None:
            # unhook the finished-trace tap: the process-global observer
            # list outlives this server (co-hosted roles, test restarts)
            self.tailstore.uninstall()
            self.tailstore = None

    # ------------------------------------------------------------------ RPC

    async def SendHeartbeat(self, request_iterator, context):
        """Volume-server registration stream (master_grpc_server.go:61-170)."""
        node: DataNode | None = None
        try:
            async for hb in request_iterator:
                if hb.offset_bytes and hb.offset_bytes != t.OFFSET_SIZE:
                    # the needle-map offset width is a deployment-wide
                    # mode: .idx/.ecx written in one are garbage in the other
                    await context.abort(
                        StatusCode.FAILED_PRECONDITION,
                        f"offset width mismatch: volume server uses "
                        f"{hb.offset_bytes}-byte needle-map offsets, "
                        f"master uses {t.OFFSET_SIZE}",
                    )
                if node is None:
                    node = self.topo.get_or_create_node(
                        hb.data_center, hb.rack, hb.ip, hb.port,
                        hb.public_url, hb.grpc_port,
                    )
                    log.info("volume server joined: %s", node.url)
                node.mesh_pod = hb.mesh_pod
                stats.MASTER_RECEIVED_HEARTBEATS.labels(type="total").inc()
                # every pulse refreshes freshness; the payload feeds the
                # cluster health plane
                self.telemetry.observe(
                    node.url,
                    hb.telemetry if hb.HasField("telemetry") else None,
                    mesh_pod=node.mesh_pod,
                )
                if hb.volumes or hb.has_no_volumes or hb.ec_shards or hb.has_no_ec_shards:
                    self.topo.sync_node(node, heartbeat_state_from_pb(hb))
                if hb.new_volumes or hb.deleted_volumes or hb.new_ec_shards or hb.deleted_ec_shards:
                    self.topo.incremental_sync_node(
                        node,
                        [volume_msg_from_pb(v) for v in hb.new_volumes],
                        [volume_msg_from_pb(v) for v in hb.deleted_volumes],
                        [ec_msg_from_pb(e) for e in hb.new_ec_shards],
                        [ec_msg_from_pb(e) for e in hb.deleted_ec_shards],
                    )
                yield master_pb2.HeartbeatResponse(
                    volume_size_limit=self.topo.volume_size_limit,
                    leader=self.advertise_url,
                )
        finally:
            if node is not None:
                # stream broke: the server is gone; drop its volumes and
                # shards (phantom cleanup :63-94)
                self.topo.unregister_node(node)
                # keep its last telemetry, flagged disconnected (age takes
                # it stale): health.json shows what a dead node last
                # looked like
                self.telemetry.disconnect(node.url)
                log.info("volume server left: %s", node.url)

    async def Assign(self, request, context):
        try:
            option = self._grow_option(
                request.collection,
                request.replication,
                request.ttl,
                request.data_center,
                request.rack,
                request.data_node,
                request.disk_type,
            )
        except ValueError as e:
            return master_pb2.AssignResponse(error=str(e))
        count = int(request.count) or 1
        for attempt in range(4):
            try:
                fid, n, nodes = self.topo.pick_for_write(count, option)
                return master_pb2.AssignResponse(
                    fid=fid,
                    count=n,
                    location=node_to_location(nodes[0]),
                    replicas=[node_to_location(x) for x in nodes[1:]],
                )
            except LookupError:
                grown = await self._grow_now(option)
                if not grown and attempt < 3:
                    # a concurrent assign may be growing this layout right
                    # now (_grow_now dedups by key): give it a beat
                    await asyncio.sleep(0.25)
        return master_pb2.AssignResponse(error="no writable volumes and growth failed")

    async def LookupVolume(self, request, context):
        resp = master_pb2.LookupVolumeResponse()
        for vof in request.volume_or_file_ids:
            entry = resp.volume_id_locations.add(volume_or_file_id=vof)
            try:
                vid_s = vof.split(",")[0]
                nodes = self.topo.lookup_volume(request.collection, int(vid_s))
                if not nodes:
                    entry.error = f"volume {vid_s} not found"
                else:
                    entry.locations.extend(node_to_location(n) for n in nodes)
            except ValueError:
                entry.error = f"bad volume id {vof!r}"
        return resp

    async def LookupEcVolume(self, request, context):
        locs = self.topo.lookup_ec_shards(request.volume_id)
        if locs is None:
            await context.abort(
                StatusCode.NOT_FOUND, f"ec volume {request.volume_id} not found"
            )
        resp = master_pb2.LookupEcVolumeResponse(volume_id=request.volume_id)
        for sid, nodes in enumerate(locs.locations):
            if nodes:
                e = resp.shard_id_locations.add(shard_id=sid)
                e.locations.extend(node_to_location(n) for n in nodes)
        return resp

    async def VolumeList(self, request, context):
        return master_pb2.VolumeListResponse(
            topology_info_json=json.dumps(self.topo.to_info()),
            volume_size_limit_mb=self.topo.volume_size_limit // (1024 * 1024),
        )

    async def LeaseAdminToken(self, request, context):
        lock = self.locks.setdefault(request.lock_name, AdminLock())
        now = time.time_ns()
        if lock.is_held() and lock.token != request.previous_token:
            await context.abort(
                StatusCode.ABORTED,
                f"lock {request.lock_name} held by {lock.client}: {lock.message}",
            )
        lock.token = now
        lock.ts_ns = now
        lock.client = request.client_name
        lock.message = request.message
        return master_pb2.LeaseAdminTokenResponse(token=now, lock_ts_ns=now)

    async def ReleaseAdminToken(self, request, context):
        lock = self.locks.get(request.lock_name)
        if lock and lock.token == request.previous_token:
            lock.token = 0
        return master_pb2.ReleaseAdminTokenResponse()

    async def PauseRepair(self, request, context):
        """volume.repair.pause: quiesce the autonomous repair loop
        (planned maintenance, debugging); detection and the status plane
        keep running, but no new repair job starts."""
        self.repair.pause()
        return master_pb2.PauseRepairResponse()

    async def ResumeRepair(self, request, context):
        self.repair.resume()
        return master_pb2.ResumeRepairResponse()

    # ------------------------------------------------------------------ growth

    def _grow_option(
        self,
        collection: str = "",
        replication: str = "",
        ttl: str = "",
        data_center: str = "",
        rack: str = "",
        data_node: str = "",
        disk_type: str = "",
    ) -> VolumeGrowOption:
        return VolumeGrowOption(
            collection=collection,
            replica_placement=t.ReplicaPlacement.parse(
                replication or self.default_replication
            ),
            ttl=t.TTL.parse(ttl or ""),
            disk_type=disk_type or "hdd",
            preferred_data_center=data_center,
            preferred_rack=rack,
            preferred_node=data_node,
        )

    async def _grow_now(self, option: VolumeGrowOption, count: int = 0) -> list[int]:
        """Grow volumes for an assign that found nothing writable
        (AutomaticGrowByType volume_growth.go:60-110)."""
        key = (option.collection, str(option.replica_placement), str(option.ttl))
        if key in self._growing:
            await asyncio.sleep(0.05)
            return []
        self._growing.add(key)
        try:
            count = count or target_count_per_request(option.replica_placement)
            allocations: list[tuple[DataNode, int]] = []

            def plan(node, vid, opt):
                allocations.append((node, vid))

            try:
                self.topo.grow_volumes(option, count, plan)
            except NoFreeSpace as e:
                log.warning("growth failed: %s", e)
                return []
            ok_vids = {vid for _, vid in allocations}
            for node, vid in allocations:
                stub = self._volume_stub(node)
                try:
                    await stub.AllocateVolume(
                        volume_server_pb2.AllocateVolumeRequest(
                            volume_id=vid,
                            collection=option.collection,
                            replication=str(option.replica_placement),
                            ttl=str(option.ttl),
                            disk_type=option.disk_type,
                        ),
                        timeout=30.0,
                    )
                except RpcError as e:
                    log.warning("allocate %d on %s failed: %s", vid, node.url, e)
                    ok_vids.discard(vid)
            # register at once so the triggering assign can succeed; the
            # heartbeat deltas confirm
            for node, vid in allocations:
                if vid in ok_vids:
                    self.topo.incremental_sync_node(
                        node,
                        [
                            VolumeMessage(
                                id=vid,
                                size=0,
                                collection=option.collection,
                                file_count=0,
                                delete_count=0,
                                deleted_byte_count=0,
                                read_only=False,
                                replica_placement=option.replica_placement.to_byte(),
                                version=3,
                                ttl=int.from_bytes(option.ttl.to_bytes(), "big"),
                                disk_type=option.disk_type,
                            )
                        ],
                        [],
                    )
            return sorted(ok_vids)
        finally:
            self._growing.discard(key)

    def _volume_stub(self, node: DataNode) -> Stub:
        return Stub(channel(node.grpc_url), volume_server_pb2, "VolumeServer")

    # ------------------------------------------------------------------ HTTP

    async def _route(self, request: Request) -> Response:
        handler = self._routes.get(request.path)
        if handler is None:
            raise HTTPError(404, f"no route {request.path}")
        return await handler(request)

    async def _params(self, request: Request) -> dict[str, str]:
        params = dict(request.query)
        if request.method == "POST":
            body = await request.read()
            if body and "form-urlencoded" in request.headers.get(
                    "Content-Type", ""):
                for k, v in urllib.parse.parse_qsl(body.decode()):
                    params.setdefault(k, v)
        return params

    async def h_assign(self, request: Request) -> Response:
        params = await self._params(request)
        req = master_pb2.AssignRequest(
            count=int(params.get("count", 1)),
            replication=params.get("replication", ""),
            collection=params.get("collection", ""),
            ttl=params.get("ttl", ""),
            data_center=params.get("dataCenter", ""),
            rack=params.get("rack", ""),
            data_node=params.get("dataNode", ""),
            disk_type=params.get("disk", ""),
        )
        resp = await self.Assign(req, None)
        if resp.error:
            return json_response({"error": resp.error}, status=404)
        return json_response({
            "fid": resp.fid,
            "url": resp.location.url,
            "publicUrl": resp.location.public_url,
            "count": resp.count,
        })

    async def h_lookup(self, request: Request) -> Response:
        vof = request.query.get("volumeId", "")
        collection = request.query.get("collection", "")
        resp = await self.LookupVolume(
            master_pb2.LookupVolumeRequest(
                volume_or_file_ids=[vof], collection=collection
            ),
            None,
        )
        entry = resp.volume_id_locations[0]
        if entry.error:
            return json_response(
                {"volumeOrFileId": vof, "error": entry.error}, status=404
            )
        return json_response({
            "volumeOrFileId": vof,
            "locations": [
                {"url": l.url, "publicUrl": l.public_url} for l in entry.locations
            ],
        })

    async def h_dir_status(self, request: Request) -> Response:
        return json_response(
            {"Topology": self.topo.to_info(), "Version": "seaweedfs-tpu"}
        )

    async def h_grow(self, request: Request) -> Response:
        params = request.query
        try:
            option = self._grow_option(
                params.get("collection", ""),
                params.get("replication", ""),
                params.get("ttl", ""),
                params.get("dataCenter", ""),
            )
        except ValueError as e:
            return json_response({"error": str(e)}, status=400)
        count = int(params.get("count", 0))
        vids = await self._grow_now(option, count)
        if not vids:
            return json_response({"error": "growth failed"}, status=500)
        return json_response({"count": len(vids), "vids": vids})

    # ---------------------------------------------------------- incident plane

    async def _slo_loop(self) -> None:
        """Evaluate the declared SLOs once per telemetry pulse — the
        judging half of the observability loop (obs/slo.py)."""
        while True:
            await asyncio.sleep(self.pulse_seconds)
            if not self.is_leader:
                continue
            try:
                self.slo.evaluate()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — one failed evaluation
                # must not end the judge; the next pulse re-samples
                log.exception("slo evaluation failed")

    def _on_slo_violation(self, verdict: dict) -> None:
        """Rising-edge hook from the SLO engine: record the verdict
        into the master's own flight recorder, then capture an incident
        bundle in the background (the evaluate() caller must not block
        on a cluster-wide fan-out)."""
        obs.incident.record("slo_violation", **verdict)
        # the bundle should cover the burn AND its lead-up: second-scale
        # windows would otherwise capture only the last pulse or two of
        # traces (the rings bound the cost either way)
        window = max(self.slo.cfg.slow_window_seconds, 30.0)
        # registry set, not _tasks: captures self-discard on completion,
        # so a flapping SLO can't grow the master's task list forever
        spawn_logged(
            self.incident.capture(verdict, window_s=window),
            log,
            f"incident bundle for {verdict.get('slo')}",
            registry=self._incident_captures,
        )

    def _health_doc(self) -> dict:
        """The /cluster/health.json document — telemetry plane + repair
        + slo blocks; also what every incident bundle embeds."""
        doc = self.telemetry.health()
        doc["repair"] = self.repair.status()
        doc["slo"] = self.slo.status()
        return doc

    async def h_incident_dump(self, request: Request) -> Response:
        """POST /cluster/incident/dump: operator-triggered incident
        bundle (shell `cluster.incident.dump`) — same fan-out and
        bundle shape as an SLO fire, skipping only the rate limit.
        ?window=S overrides the capture window (default: the slow SLO
        window)."""
        if request.method != "POST":
            raise HTTPError(405, "POST /cluster/incident/dump")
        if not obs.incident.CONFIG.dir:
            return json_response(
                {"error": "incident bundling disabled: set -obs.incident.dir"},
                status=503,
            )
        try:
            window = float(
                request.query.get("window", self.slo.cfg.slow_window_seconds)
            )
        except ValueError:
            window = math.nan
        if not math.isfinite(window) or window <= 0:
            # nan/-5 would silently produce an EMPTY bundle (every
            # since-comparison false) — the operator's manual capture
            # must fail loudly instead of capturing nothing
            return json_response(
                {"error": "window must be a positive number of seconds"},
                status=400,
            )
        summary = await self.incident.capture(
            {"slo": "manual", "latency": False},
            window_s=window,
            trigger="manual",
            force=True,
        )
        return json_response(summary)

    async def h_cluster_health(self, request: Request) -> Response:
        """Aggregated cluster health from heartbeat telemetry: per-node
        freshness and staleness, device budget/used/headroom, dispatcher
        state, the EC residency map, merged per-stage p50/p99 estimates,
        the repair plane's live view and the SLO engine's verdicts."""
        return json_response(self._health_doc())

    async def h_debug_timeline(self, request: Request) -> Response:
        """GET /debug/timeline[?window=S]: the clock-aligned cluster
        flight timeline assembled from heartbeat-shipped node samples."""
        window = request.query.get("window")
        try:
            window_s = float(window) if window else None
        except ValueError:
            return json_response({"error": f"bad window: {window!r}"},
                                 status=400)
        return json_response(self.telemetry.timeline(window_s=window_s))

    async def h_debug_tail(self, request: Request) -> Response:
        """GET /debug/tail: the master's own tail ring (route stats +
        pinned slow/incident span trees; ?id= resolves one full tree).
        Per-node by design — cluster.tail fans out over every node's
        endpoint, like the incident bundler does for /debug/traces."""
        if self.tailstore is None:
            return json_response(
                {"error": "tail retention disabled (-obs.tail.disable)"},
                status=404,
            )
        return await obs.tail_handler(self.tailstore)(request)

    async def h_metrics(self, request: Request) -> Response:
        # re-export the telemetry plane's aggregate view at scrape time
        self.telemetry.refresh_gauges()
        return Response(
            body=stats.generate_latest(stats.REGISTRY),
            content_type=stats.CONTENT_TYPE_LATEST,
        )
