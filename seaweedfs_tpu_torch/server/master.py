"""MasterServer: the port of seaweedfs_tpu/server/master.py.

Reference: weed/server/master_server.go, master_grpc_server*.go,
raft_server.go.  Holds the topology (topology/) that volume servers'
heartbeats build, and answers:

  - RPC `Seaweed` (pb/rpc.py, on -port.grpc): SendHeartbeat (each volume
    server's bidirectional stream: a full heartbeat, then deltas; a broken
    stream unregisters the node), KeepConnected (each client's
    subscription: the whole location map, then a VolumeLocation delta on
    every heartbeat change), Assign, LookupVolume, LookupEcVolume,
    VolumeList (the topology as JSON, which the shell reads), Statistics,
    CollectionList, CollectionDelete, ListClusterNodes (the clients
    KeepConnected registered), LeaseAdminToken / ReleaseAdminToken (the
    shell's exclusive lock), PauseRepair / ResumeRepair, VacuumVolume /
    DisableVacuum / EnableVacuum, RaftListClusterServers / RaftAddServer /
    RaftRemoveServer;
  - RPC `SeaweedRaft` on the same listener: RequestVote, AppendEntries and
    InstallSnapshot, each handed to the RaftNode (raft/node.py);
  - HTTP (server/http.py): /dir/assign, /dir/lookup, /dir/status,
    /vol/grow, /vol/vacuum, /col/delete, /submit, /cluster/status,
    /cluster/health.json, /metrics, and the observability plane:
    /debug/traces (its own ring), /debug/critpath (assembled cluster-wide:
    a fan-out over every fresh node's /debug/traces, clocks reconciled by
    the heartbeat skew estimates), /debug/tail (its own tail store),
    /debug/timeline (the clock-aligned cluster flight timeline from
    heartbeat-shipped samples), /debug/incident (its own flight
    recorder), POST /cluster/incident/dump, and with SWFS_DEBUG=1
    /debug/stacks.

With -peers, masters form a raft group (raft/node.py; its state in
-mdir).  Only the leader holds a topology: a follower answers a
SendHeartbeat or a KeepConnected with the leader's address and ends the
stream, proxies the control-plane rpcs to the leader, and answers the
HTTP control paths with a 307 to it.  The raft log replicates the
allocation ceilings (`max_vid` before a growth creates volumes, `seq`
after an assign passes the last one) and membership (`raft_conf`), so a
new leader never hands out a fid key or a vid again.  One departure from
the reference: the reference's master registers the raft service with
itself as the servicer but has no InstallSnapshot, so a master that fell
behind a compacted log never catches up; the port's hands InstallSnapshot
to its RaftNode like the other two rpcs (ROADMAP §C).

Every heartbeat's telemetry feeds the cluster telemetry plane
(stats/cluster.py: staleness, the SeaweedFS_cluster_* gauges, the merged
stage digests, the timeline, the health document), and the repair plane
(repair/scheduler.py) rebuilds lost or corrupt EC shards on its own while
this master leads, each job ending in a VolumeEcShardsRebuild (K1 on the
rebuilder's card).  Vacuum drives Check -> Compact (every replica) ->
Commit, or Cleanup on all when one compact failed, over the volume
servers' rpcs, on demand (VacuumVolume, /vol/vacuum) or every three
pulses with -autoVacuum.  The SLO engine (obs/slo.py) judges the declared
-obs.slo.* objectives every pulse on the leader; a sustained burn fires
the incident bundler (obs/incident.py), which writes one correlated
bundle under -obs.incident.dir — for a latency SLO with a torch.profiler
capture of the busiest node's card.  With -metrics.address the registry
is pushed to a pushgateway.  Volume growth allocates over the volume
servers' AllocateVolume RPC.  The master itself does no device work.  Not
here (ROADMAP A10): the UI page at `/`.  With a `[jwt.signing] key` in
security.toml, Assign and a full-fid LookupVolume carry a write token for
the fid (security/jwt.py), which the volume servers check; with an
`[access] white_list` a peer outside it is answered 403 over HTTP.
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
from ..pb import (
    RpcError,
    RpcServer,
    Stub,
    channel,
    master_pb2,
    raft_pb2,
    server_address,
    volume_server_pb2,
)
from ..pb.rpc import StatusCode
from ..raft import RaftNode
from ..repair import RepairScheduler
from ..security import gen_volume_write_jwt
from ..security.guard import Guard
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
        garbage_threshold: float = 0.3,
        auto_vacuum: bool = False,
        ec_repair=None,  # repair.RepairConfig | None (-ec.repair.* flags)
        metrics_address: str = "",  # pushgateway host:port (ref -metrics.address)
        metrics_interval_seconds: int = 15,  # ref -metrics.intervalSeconds
        obs_slo=None,  # obs.SloConfig | None (-obs.slo.* flags)
        obs_incident=None,  # obs.IncidentConfig | None (-obs.incident.*)
        jwt_signing_key: str = "",  # security.toml [jwt.signing] key
        jwt_expires_sec: int = 10,  # [jwt.signing] expires_after_seconds
        white_list: list[str] | None = None,  # [access] white_list guard
        peers: list[str] | None = None,  # every master's advertise url
        meta_dir: str | None = None,  # durable raft state directory
        raft_join: bool = False,  # start as non-voter until cluster.raft.add
        raft_snapshot_threshold: int = 1000,  # log entries before compaction
    ):
        self.raft_join = raft_join
        self.raft_snapshot_threshold = raft_snapshot_threshold
        self.peers = peers or []
        self.meta_dir = meta_dir
        self.metrics_address = metrics_address
        self.jwt_signing_key = jwt_signing_key
        self.jwt_expires_sec = jwt_expires_sec
        self.guard = Guard(white_list)
        self.metrics_interval_seconds = metrics_interval_seconds
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port or (port + 10000 if port else 0)
        self.default_replication = default_replication
        self.pulse_seconds = pulse_seconds
        self.garbage_threshold = garbage_threshold
        self.auto_vacuum = auto_vacuum
        self.vacuum_disabled = False
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
        # KeepConnected subscribers, each a queue of VolumeLocation pushes
        self._subscribers: dict[object, asyncio.Queue] = {}
        # (client_type, address) -> joined-at ns; fed by KeepConnected
        # streams (reference weed/cluster/cluster.go membership)
        self.cluster_nodes: dict[tuple[str, str], int] = {}
        self.raft: RaftNode | None = None  # built in start()
        self._seq_committed = 0  # highest raft-replicated sequence ceiling
        self._rpc: RpcServer | None = None
        self._http: HTTPServer | None = None
        self._routes = {
            "/dir/assign": self.h_assign,
            "/dir/lookup": self.h_lookup,
            "/dir/status": self.h_dir_status,
            "/vol/grow": self.h_grow,
            "/vol/vacuum": self.h_vacuum,
            "/col/delete": self.h_col_delete,
            "/submit": self.h_submit,
            "/cluster/status": self.h_cluster_status,
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
        # raft's rpcs delegate through self, so they register before the
        # RaftNode exists (the ports are known only after the bind)
        self._rpc.add_servicer(raft_pb2, "SeaweedRaft", self)
        self.grpc_port = await self._rpc.start()
        self._http = HTTPServer(
            functools.partial(obs.middleware("master"), handler=self._route),
            self.ip, self.port, guard=self.guard,
        )
        await self._http.start()
        self.port = self._http.port
        if obs.trace.CONFIG.tail_enabled:
            self.tailstore = obs.TailStore(node=self.url).install()
        others = [p for p in self.peers
                  if server_address.http_address(p) != self.url]
        self.raft = RaftNode(
            self.advertise_url,
            others,
            apply_fn=self._apply_raft,
            data_dir=self.meta_dir,
            dial_fn=server_address.grpc_address,
            voter=not self.raft_join,
            snapshot_fn=self._raft_snapshot,
            restore_fn=self._raft_restore,
            snapshot_threshold=self.raft_snapshot_threshold,
        )
        await self.raft.start()
        if self.slo.specs:
            self._tasks.append(
                spawn_logged(self._slo_loop(), log, "slo evaluation loop")
            )
        self.repair.start()
        if self.auto_vacuum:
            self._tasks.append(
                spawn_logged(self._vacuum_loop(), log, "auto-vacuum loop")
            )
        push = stats.start_push_loop(
            "master", self.url, self.metrics_address,
            self.metrics_interval_seconds,
        )
        if push is not None:
            self._tasks.append(push)
        log.info("master up http=%s grpc=%s peers=%s", self.url,
                 self.grpc_url, others)

    async def stop(self) -> None:
        await self.repair.stop()
        if self.raft is not None:
            await self.raft.stop()
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

    # ------------------------------------------------------------------ raft

    @property
    def is_leader(self) -> bool:
        return self.raft is None or self.raft.is_leader

    def leader_settling(self) -> bool:
        """Whether this master leads a raft group and was elected too
        recently for its topology to be whole: only the volume servers
        that have re-registered since the election are in it.  The
        window is two pulses for the telemetry plane and time for every
        volume server to dial each master in turn twice (a server
        re-dials the next master of its list every max(pulse, 1) s, and
        a follower ends its stream with the leader's address): 8 s at
        pulse 1 with 3 masters.  Never true for a master without peers,
        whose servers never re-home.  The repair plane queues no job
        while it holds (ROADMAP §C)."""
        raft = self.raft
        if (raft is None or not raft.peers or not raft.is_leader
                or raft.leader_since is None):
            return False
        pulse = self.pulse_seconds
        window = 2.0 * pulse + 2.0 * (len(raft.peers) + 1) * max(pulse, 1)
        return time.monotonic() < raft.leader_since + window

    @property
    def leader_advertise(self) -> str:
        if self.raft is None or self.raft.leader_id is None:
            return self.advertise_url
        return self.raft.leader_id

    def _raft_snapshot(self) -> dict:
        """State-machine snapshot at the raft apply point: the allocation
        ceilings every future leader must start past (membership is
        carried by the raft layer itself)."""
        return {
            "max_vid": self.topo.max_volume_id,
            "seq_ceiling": self._seq_committed,
        }

    def _raft_restore(self, st: dict) -> None:
        self.topo.max_volume_id = max(
            self.topo.max_volume_id, int(st.get("max_vid", 0))
        )
        ceiling = int(st.get("seq_ceiling", 0))
        if ceiling:
            self.topo.sequencer.set_max(ceiling)
            self._seq_committed = max(self._seq_committed, ceiling)

    def _apply_raft(self, cmd: dict, term: int = 0, own_live: bool = False) -> None:
        """Raft state machine: allocation ceilings replicated so any
        future leader starts past every id ever handed out (the reference
        replicates MaxVolumeIdCommand the same way, topology.go)."""
        op = cmd.get("op")
        if op == "max_vid":
            self.topo.max_volume_id = max(self.topo.max_volume_id, cmd["vid"])
        elif op == "seq":
            if not own_live:
                # followers and a restart's replay jump past the ceiling;
                # the live proposer keeps minting from its lower counter,
                # so the 10k batch is not burned per proposal
                self.topo.sequencer.set_max(cmd["ceiling"])
            self._seq_committed = max(self._seq_committed, cmd["ceiling"])
        elif op == "raft_conf":
            if self.raft is not None:
                self.raft.apply_config(cmd["members"])

    async def _raft_call(self, name: str, request, context):
        if self.raft is None:
            await context.abort(StatusCode.UNAVAILABLE, "raft not up")
        return await getattr(self.raft, name)(request, context)

    async def RequestVote(self, request, context):
        return await self._raft_call("RequestVote", request, context)

    async def AppendEntries(self, request, context):
        return await self._raft_call("AppendEntries", request, context)

    async def InstallSnapshot(self, request, context):
        """A departure: the reference's master has no InstallSnapshot, so
        its raft service answers UNIMPLEMENTED and a master behind the
        leader's compacted log never catches up (ROADMAP §C)."""
        return await self._raft_call("InstallSnapshot", request, context)

    def _leader_stub(self) -> Stub:
        return Stub(
            channel(server_address.grpc_address(self.leader_advertise)),
            master_pb2,
            "Seaweed",
        )

    async def _proxy_to_leader(self, method: str, request):
        """Followers forward control-plane calls: only the leader holds
        topology state, since volume servers heartbeat to it alone
        (masterclient proxyToMaster in the reference)."""
        if self.leader_advertise == self.advertise_url:
            raise RuntimeError("no raft leader elected yet")
        return await getattr(self._leader_stub(), method)(request)

    async def _maybe_proxy(self, name: str, request, context):
        """None when leader (the caller answers); else the leader's answer,
        or the leader's failure as this call's status."""
        if self.is_leader:
            return None
        try:
            return await self._proxy_to_leader(name, request)
        except RpcError as e:
            await context.abort(e.code(), e.details())
        except RuntimeError as e:
            await context.abort(StatusCode.UNAVAILABLE, str(e))

    async def _replicate_seq_ceiling(self) -> None:
        """After minting fids: make sure a crash or a failover cannot
        re-mint them.  Batched: most assigns find the ceiling covers them."""
        if self.raft is None or not self.raft.peers:
            return
        seq = self.topo.sequencer
        if getattr(seq, "peek", None) is None:
            return  # snowflake ids are collision-free without consensus
        if seq.peek() <= self._seq_committed:
            return
        ceiling = seq.peek() + 10_000
        await self.raft.propose({"op": "seq", "ceiling": ceiling})

    # ------------------------------------------------------------------ RPC

    async def SendHeartbeat(self, request_iterator, context):
        """Followers end the stream with a leader hint, so volume servers
        re-dial the leader (the only master holding a topology)."""
        if not self.is_leader:
            yield master_pb2.HeartbeatResponse(
                volume_size_limit=self.topo.volume_size_limit,
                leader=self.leader_advertise,
            )
            return
        async for resp in self._send_heartbeat_leader(request_iterator, context):
            yield resp

    async def _send_heartbeat_leader(self, request_iterator, context):
        """Volume-server registration stream (master_grpc_server.go:61-170).
        A departure: a master deposed while the stream is open answers the
        next heartbeat with the new leader's address and ends it, as the
        reference's Go master does (IsLeader on every heartbeat); the
        JAX package checks only when the stream opens, so its servers stay
        on a deposed leader (ROADMAP §C)."""
        node: DataNode | None = None
        try:
            async for hb in request_iterator:
                if not self.is_leader:
                    yield master_pb2.HeartbeatResponse(
                        volume_size_limit=self.topo.volume_size_limit,
                        leader=self.leader_advertise,
                    )
                    return
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
                    new_v, del_v, new_ec, del_ec = self.topo.sync_node(
                        node, heartbeat_state_from_pb(hb)
                    )
                    self._broadcast_location(node, new_v, del_v, new_ec, del_ec)
                if hb.new_volumes or hb.deleted_volumes or hb.new_ec_shards or hb.deleted_ec_shards:
                    self.topo.incremental_sync_node(
                        node,
                        [volume_msg_from_pb(v) for v in hb.new_volumes],
                        [volume_msg_from_pb(v) for v in hb.deleted_volumes],
                        [ec_msg_from_pb(e) for e in hb.new_ec_shards],
                        [ec_msg_from_pb(e) for e in hb.deleted_ec_shards],
                    )
                    self._broadcast_location(
                        node,
                        [v.id for v in hb.new_volumes],
                        [v.id for v in hb.deleted_volumes],
                        [e.id for e in hb.new_ec_shards],
                        [e.id for e in hb.deleted_ec_shards],
                    )
                yield master_pb2.HeartbeatResponse(
                    volume_size_limit=self.topo.volume_size_limit,
                    leader=self.advertise_url,
                )
        finally:
            if node is not None:
                # stream broke: the server is gone; drop its volumes and
                # shards and tell every subscribed client (phantom cleanup
                # :63-94)
                dead_vids = list(node.volumes)
                dead_ec = list(node.ec_shards)
                self.topo.unregister_node(node)
                self._broadcast_location(node, [], dead_vids, [], dead_ec)
                # keep its last telemetry, flagged disconnected (age takes
                # it stale): health.json shows what a dead node last
                # looked like
                self.telemetry.disconnect(node.url)
                log.info("volume server left: %s", node.url)

    async def KeepConnected(self, request_iterator, context):
        """Client subscription stream: the whole location map, then
        VolumeLocation deltas (master_grpc_server.go broadcastToClients).
        The first request names the client, for ListClusterNodes."""
        if not self.is_leader:
            # hint, then close: the client re-dials the leader
            yield master_pb2.KeepConnectedResponse(leader=self.leader_advertise)
            return
        q: asyncio.Queue = asyncio.Queue()
        key = object()
        self._subscribers[key] = q
        for n in self.topo.data_nodes():
            loc = master_pb2.VolumeLocation(
                url=n.url,
                public_url=n.public_url,
                grpc_port=n.grpc_port,
                data_center=n.rack.data_center.name if n.rack else "",
                new_vids=sorted(set(list(n.volumes) + list(n.ec_shards))),
                new_ec_vids=sorted(n.ec_shards),
            )
            yield master_pb2.KeepConnectedResponse(
                volume_location=loc, leader=self.advertise_url
            )

        registered: tuple[str, str] | None = None
        registered_ts = 0

        async def drain_requests():
            nonlocal registered, registered_ts
            try:
                async for req in request_iterator:
                    if registered is None and req.client_address:
                        registered = (req.client_type, req.client_address)
                        registered_ts = time.time_ns()
                        self.cluster_nodes[registered] = registered_ts
            except Exception as e:  # noqa: BLE001 — a broken stream is
                # routine (a client's restart); the finally ends the call
                log.debug("keep-connected drain from %s ended: %s",
                          registered, e)
            finally:
                q.put_nowait(None)

        drainer = asyncio.create_task(drain_requests())
        try:
            while True:
                try:
                    item = await asyncio.wait_for(q.get(), self.pulse_seconds)
                except asyncio.TimeoutError:
                    if self.is_leader:
                        continue
                    # deposed (a departure, as in SendHeartbeat): hint the
                    # new leader and close, so the client re-dials it
                    yield master_pb2.KeepConnectedResponse(
                        leader=self.leader_advertise)
                    break
                if item is None:
                    break
                yield item
        finally:
            drainer.cancel()
            self._subscribers.pop(key, None)
            if (
                registered is not None
                # a reconnect may have re-registered under the same key;
                # only the stream that owns the entry may remove it
                and self.cluster_nodes.get(registered) == registered_ts
            ):
                self.cluster_nodes.pop(registered, None)

    def _broadcast_location(
        self,
        node: DataNode,
        new_vids: list[int],
        deleted_vids: list[int],
        new_ec_vids: list[int] = (),
        deleted_ec_vids: list[int] = (),
    ) -> None:
        if not (new_vids or deleted_vids or new_ec_vids or deleted_ec_vids):
            return
        msg = master_pb2.KeepConnectedResponse(
            volume_location=master_pb2.VolumeLocation(
                url=node.url,
                public_url=node.public_url,
                grpc_port=node.grpc_port,
                data_center=node.rack.data_center.name if node.rack else "",
                new_vids=sorted(set(new_vids) | set(new_ec_vids)),
                deleted_vids=sorted(set(deleted_vids) | set(deleted_ec_vids)),
                new_ec_vids=sorted(set(new_ec_vids)),
                deleted_ec_vids=sorted(set(deleted_ec_vids)),
            ),
            leader=self.advertise_url,
        )
        for q in self._subscribers.values():
            q.put_nowait(msg)

    async def ListClusterNodes(self, request, context):
        # membership registers on the leader (clients follow leader hints)
        proxied = await self._maybe_proxy("ListClusterNodes", request, context)
        if proxied is not None:
            return proxied
        resp = master_pb2.ListClusterNodesResponse()
        for (ctype, addr), ts in sorted(self.cluster_nodes.items()):
            if request.client_type and ctype != request.client_type:
                continue
            resp.cluster_nodes.append(
                master_pb2.ClusterNodeInfo(
                    address=addr, client_type=ctype, created_at_ns=ts
                )
            )
        return resp

    async def Assign(self, request, context):
        if not self.is_leader:
            try:
                return await self._proxy_to_leader("Assign", request)
            except Exception as e:  # noqa: BLE001 — the answer carries it
                return master_pb2.AssignResponse(error=str(e))
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
                await self._replicate_seq_ceiling()
                return master_pb2.AssignResponse(
                    fid=fid,
                    count=n,
                    location=node_to_location(nodes[0]),
                    replicas=[node_to_location(x) for x in nodes[1:]],
                    auth=gen_volume_write_jwt(
                        self.jwt_signing_key, fid, self.jwt_expires_sec
                    ),
                )
            except LookupError:
                grown = await self._grow_now(option)
                if not grown and attempt < 3:
                    # a concurrent assign may be growing this layout right
                    # now (_grow_now dedups by key): give it a beat
                    await asyncio.sleep(0.25)
        return master_pb2.AssignResponse(error="no writable volumes and growth failed")

    async def LookupVolume(self, request, context):
        proxied = await self._maybe_proxy("LookupVolume", request, context)
        if proxied is not None:
            return proxied
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
                    if "," in vof:
                        # a full-fid lookup gets a write token, so the
                        # client may delete or overwrite it
                        entry.auth = gen_volume_write_jwt(
                            self.jwt_signing_key, vof, self.jwt_expires_sec
                        )
            except ValueError:
                entry.error = f"bad volume id {vof!r}"
        return resp

    async def LookupEcVolume(self, request, context):
        proxied = await self._maybe_proxy("LookupEcVolume", request, context)
        if proxied is not None:
            return proxied
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

    async def Statistics(self, request, context):
        proxied = await self._maybe_proxy("Statistics", request, context)
        if proxied is not None:
            return proxied
        total = used = files = 0
        for n in self.topo.data_nodes():
            for v in n.volumes.values():
                if request.collection and v.collection != request.collection:
                    continue
                used += v.size
                files += v.file_count
            total += n.max_volume_count() * self.topo.volume_size_limit
        return master_pb2.StatisticsResponse(
            total_size=total, used_size=used, file_count=files
        )

    async def CollectionList(self, request, context):
        proxied = await self._maybe_proxy("CollectionList", request, context)
        if proxied is not None:
            return proxied
        return master_pb2.CollectionListResponse(
            collections=[
                master_pb2.Collection(name=c)
                for c in sorted(self.topo.collections) if c
            ]
        )

    async def CollectionDelete(self, request, context):
        proxied = await self._maybe_proxy("CollectionDelete", request, context)
        if proxied is not None:
            return proxied
        vids = set()
        for col_name, vl in self.topo.layouts():
            if col_name == request.name:
                vids.update(vl.vid2location)
        for vid in vids:
            for node in self.topo.lookup_volume(request.name, vid):
                try:
                    await self._volume_stub(node).VolumeDelete(
                        volume_server_pb2.VolumeDeleteRequest(volume_id=vid),
                        timeout=30.0,
                    )
                except RpcError as e:
                    log.warning("delete %d on %s failed: %s", vid, node.url, e)
        self.topo.collections.pop(request.name, None)
        return master_pb2.CollectionDeleteResponse()

    async def VolumeList(self, request, context):
        proxied = await self._maybe_proxy("VolumeList", request, context)
        if proxied is not None:
            return proxied
        return master_pb2.VolumeListResponse(
            topology_info_json=json.dumps(self.topo.to_info()),
            volume_size_limit_mb=self.topo.volume_size_limit // (1024 * 1024),
        )

    async def LeaseAdminToken(self, request, context):
        proxied = await self._maybe_proxy("LeaseAdminToken", request, context)
        if proxied is not None:
            return proxied
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
        proxied = await self._maybe_proxy("ReleaseAdminToken", request, context)
        if proxied is not None:
            return proxied
        lock = self.locks.get(request.lock_name)
        if lock and lock.token == request.previous_token:
            lock.token = 0
        return master_pb2.ReleaseAdminTokenResponse()

    async def PauseRepair(self, request, context):
        """volume.repair.pause: quiesce the autonomous repair loop
        (planned maintenance, debugging); detection and the status plane
        keep running, but no new repair job starts.  The pause is this
        master's: a new leader's plane starts running."""
        proxied = await self._maybe_proxy("PauseRepair", request, context)
        if proxied is not None:
            return proxied
        self.repair.pause()
        return master_pb2.PauseRepairResponse()

    async def ResumeRepair(self, request, context):
        proxied = await self._maybe_proxy("ResumeRepair", request, context)
        if proxied is not None:
            return proxied
        self.repair.resume()
        return master_pb2.ResumeRepairResponse()

    async def VacuumVolume(self, request, context):
        proxied = await self._maybe_proxy("VacuumVolume", request, context)
        if proxied is not None:
            return proxied
        await self._vacuum_pass(
            request.garbage_threshold or self.garbage_threshold,
            request.volume_id or 0,
        )
        return master_pb2.VacuumVolumeResponse()

    async def DisableVacuum(self, request, context):
        """volume.vacuum.disable (reference master_grpc_server_volume.go
        DisableVacuum): stops the periodic scan AND manual passes until
        re-enabled."""
        proxied = await self._maybe_proxy("DisableVacuum", request, context)
        if proxied is not None:
            return proxied
        self.vacuum_disabled = True
        return master_pb2.DisableVacuumResponse()

    async def EnableVacuum(self, request, context):
        proxied = await self._maybe_proxy("EnableVacuum", request, context)
        if proxied is not None:
            return proxied
        self.vacuum_disabled = False
        return master_pb2.EnableVacuumResponse()

    # -------------------------------------------------- raft administration

    async def RaftListClusterServers(self, request, context):
        """cluster.raft.ps (reference master_grpc_server_raft.go)."""
        resp = master_pb2.RaftListClusterServersResponse()
        if self.raft is None:
            resp.cluster_servers.append(
                master_pb2.ClusterServer(id=self.advertise_url, is_leader=True)
            )
            return resp
        resp.term = self.raft.term
        for sid in [self.raft.id, *self.raft.peers]:
            resp.cluster_servers.append(
                master_pb2.ClusterServer(
                    id=sid, is_leader=sid == self.raft.leader_id
                )
            )
        return resp

    async def RaftAddServer(self, request, context):
        """One server at a time, replicated through the log, so every
        node (and any future leader) converges on the new peer set."""
        proxied = await self._maybe_proxy("RaftAddServer", request, context)
        if proxied is not None:
            return proxied
        if self.raft is None:
            await context.abort(StatusCode.FAILED_PRECONDITION,
                                "raft not enabled")
        members = [self.raft.id, *self.raft.peers]
        if not any(self.raft.same_node(m, request.id) for m in members):
            members.append(request.id)
        await self.raft.propose({"op": "raft_conf", "members": sorted(members)})
        return master_pb2.RaftAddServerResponse()

    async def RaftRemoveServer(self, request, context):
        proxied = await self._maybe_proxy("RaftRemoveServer", request, context)
        if proxied is not None:
            return proxied
        if self.raft is None:
            await context.abort(StatusCode.FAILED_PRECONDITION,
                                "raft not enabled")
        if self.raft.same_node(request.id, self.raft.id):
            await context.abort(
                StatusCode.FAILED_PRECONDITION,
                "cannot remove the current leader; transfer leadership first",
            )
        members = sorted(
            m for m in [self.raft.id, *self.raft.peers]
            if not self.raft.same_node(m, request.id)
        )
        await self.raft.propose({"op": "raft_conf", "members": members})
        return master_pb2.RaftRemoveServerResponse()

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
            # replicate the ceiling BEFORE creating the volumes: a leader
            # failover after this point starts past every allocated vid
            if self.raft is not None and self.raft.peers:
                try:
                    await self.raft.propose(
                        {"op": "max_vid", "vid": self.topo.max_volume_id}
                    )
                except Exception as e:  # noqa: BLE001 — lost leadership mid-grow
                    log.warning("vid reservation not committed: %s", e)
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

    def _redirect_if_follower(self, request: Request) -> None:
        if self.is_leader:
            return
        if self.leader_advertise == self.advertise_url:
            # mid-election (or a partitioned minority): redirecting to
            # ourselves would loop; tell the client to retry instead
            raise HTTPError(503, "no raft leader elected yet")
        leader = server_address.http_address(self.leader_advertise)
        qs = f"?{request.query_string}" if request.query_string else ""
        raise HTTPError(307, headers={
            "Location": f"http://{leader}{request.path}{qs}"})

    async def h_assign(self, request: Request) -> Response:
        self._redirect_if_follower(request)
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
        out = {
            "fid": resp.fid,
            "url": resp.location.url,
            "publicUrl": resp.location.public_url,
            "count": resp.count,
        }
        if resp.auth:
            out["auth"] = resp.auth
        return json_response(out)

    async def h_lookup(self, request: Request) -> Response:
        self._redirect_if_follower(request)
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
        self._redirect_if_follower(request)
        return json_response(
            {"Topology": self.topo.to_info(), "Version": "seaweedfs-tpu"}
        )

    async def h_grow(self, request: Request) -> Response:
        self._redirect_if_follower(request)
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

    async def h_vacuum(self, request: Request) -> Response:
        self._redirect_if_follower(request)
        threshold = float(
            request.query.get("garbageThreshold", self.garbage_threshold)
        )
        n = await self._vacuum_pass(threshold)
        return json_response({"vacuumed": n})

    async def h_col_delete(self, request: Request) -> Response:
        self._redirect_if_follower(request)
        name = request.query.get("collection", "")
        await self.CollectionDelete(
            master_pb2.CollectionDeleteRequest(name=name), None
        )
        return json_response({"deleted": name})

    async def h_submit(self, request: Request) -> Response:
        """One-shot upload: assign, then re-post the body to the volume
        server (master_server_handlers.go submit).  A departure: the body
        goes on with its whole Content-Type, boundary included, where the
        reference passes aiohttp's bare mime type and the volume server
        stores an empty needle (ROADMAP §C)."""
        if request.method != "POST":
            raise HTTPError(405, "POST /submit")
        self._redirect_if_follower(request)
        from ..operation.upload import upload_multipart_body

        params = request.query
        resp = await self.Assign(
            master_pb2.AssignRequest(
                count=1,
                replication=params.get("replication", ""),
                collection=params.get("collection", ""),
                ttl=params.get("ttl", ""),
            ),
            None,
        )
        if resp.error:
            return json_response({"error": resp.error}, status=500)
        body = await request.read()
        result = await upload_multipart_body(
            f"http://{resp.location.url}/{resp.fid}",
            body,
            content_type=request.headers.get("Content-Type", ""),
            jwt=resp.auth,
        )
        result["fid"] = resp.fid
        result["fileUrl"] = f"{resp.location.public_url}/{resp.fid}"
        return json_response(result)

    async def h_cluster_status(self, request: Request) -> Response:
        return json_response({
            "IsLeader": self.is_leader,
            "Leader": server_address.http_address(self.leader_advertise),
            "Peers": self.peers,
            "MaxVolumeId": self.topo.max_volume_id,
        })

    # ------------------------------------------------------------------ vacuum

    async def _vacuum_loop(self) -> None:
        while True:
            await asyncio.sleep(self.pulse_seconds * 3)
            try:
                await self._vacuum_pass(self.garbage_threshold)
            except Exception:
                log.exception("vacuum pass failed")

    async def _vacuum_pass(self, threshold: float, only_vid: int = 0) -> int:
        """Drive Check -> Compact -> Commit over the RPC plane
        (topology_vacuum.go:220-269).  With `only_vid` that volume is
        vacuumed whatever its garbage ratio.  The volume is read-only in
        its layout for the duration; it commits on every replica only
        when every compact succeeded, else cleans up on all."""
        if self.vacuum_disabled:
            return 0
        done = 0
        for _, vl in self.topo.layouts():
            for vid, loc in list(vl.vid2location.items()):
                if only_vid and vid != only_vid:
                    continue
                nodes = list(loc.nodes)
                if not nodes:
                    continue
                ratios = []
                for n in nodes:
                    try:
                        r = await self._volume_stub(n).VacuumVolumeCheck(
                            volume_server_pb2.VacuumVolumeCheckRequest(
                                volume_id=vid)
                        )
                        ratios.append(r.garbage_ratio)
                    except RpcError:
                        ratios.append(0.0)
                if not only_vid and (not ratios or min(ratios) <= threshold):
                    continue
                vl.set_readonly(vid, True)
                try:
                    ok = True
                    for n in nodes:
                        try:
                            async for _ in self._volume_stub(n).VacuumVolumeCompact(
                                volume_server_pb2.VacuumVolumeCompactRequest(
                                    volume_id=vid)
                            ):
                                pass
                        except RpcError:
                            ok = False
                    for n in nodes:
                        verb = "VacuumVolumeCommit" if ok else "VacuumVolumeCleanup"
                        try:
                            await getattr(self._volume_stub(n), verb)(
                                getattr(volume_server_pb2, verb + "Request")(
                                    volume_id=vid)
                            )
                        except RpcError:
                            pass
                    done += ok
                finally:
                    vl.set_readonly(vid, False)
        return done

    # ---------------------------------------------------------- incident plane

    async def _slo_loop(self) -> None:
        """Evaluate the declared SLOs once per telemetry pulse — the
        judging half of the observability loop (obs/slo.py).  Runs only
        while this master leads: heartbeat telemetry lands on the leader
        alone, so a follower's windows would judge silence."""
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
        self._redirect_if_follower(request)
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
        the repair plane's live view and the SLO engine's verdicts.
        Telemetry lands on the leader alone, so followers redirect."""
        self._redirect_if_follower(request)
        return json_response(self._health_doc())

    async def h_debug_timeline(self, request: Request) -> Response:
        """GET /debug/timeline[?window=S]: the clock-aligned cluster
        flight timeline assembled from heartbeat-shipped node samples."""
        self._redirect_if_follower(request)
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
