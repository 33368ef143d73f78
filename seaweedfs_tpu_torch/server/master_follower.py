"""Read-only master follower: the port of
seaweedfs_tpu/server/master_follower.py.

Reference: weed/command/master_follower.go — a lookup-only master that
does NOT join raft: it mirrors the leader's volume locations over the
KeepConnected stream (wdclient/ VidMap) and serves /dir/lookup (HTTP) and
LookupVolume (RPC) locally, offloading read traffic from the leader;
/cluster/status names the leader its client follows.  Assign, Statistics,
VolumeList and ListClusterNodes proxy to the leader.  HTTP rides
server/http.py and the RPCs pb/rpc.py.
"""
from __future__ import annotations

import logging

from ..pb import RpcServer, Stub, channel, master_pb2, server_address
from ..wdclient import MasterClient
from .http import HTTPError, HTTPServer, Request, Response, json_response

log = logging.getLogger("master-follower")


class MasterFollowerServer:
    def __init__(
        self,
        masters: list[str],
        ip: str = "127.0.0.1",
        port: int = 9334,
        grpc_port: int = 0,
    ):
        self.masters = masters
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port or (port + 10000 if port else 0)
        self.master_client = MasterClient(
            masters, client_type="master_follower",
            client_address=f"{ip}:{port}",
        )
        self._rpc: RpcServer | None = None
        self._http: HTTPServer | None = None
        self._routes = {
            "/dir/lookup": self.h_lookup,
            "/cluster/status": self.h_cluster_status,
        }

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def advertise_url(self) -> str:
        return f"{self.ip}:{self.port}.{self.grpc_port}"

    async def start(self) -> None:
        self._rpc = RpcServer(self.ip, self.grpc_port)
        self._rpc.add_servicer(master_pb2, "Seaweed", self)
        self.grpc_port = await self._rpc.start()
        self._http = HTTPServer(self._route, self.ip, self.port)
        await self._http.start()
        self.port = self._http.port
        await self.master_client.start()
        log.info(
            "master follower on %s (following %s)", self.url, self.masters
        )

    async def stop(self) -> None:
        await self.master_client.stop()
        if self._rpc is not None:
            await self._rpc.stop(0.5)
            self._rpc = None
        if self._http is not None:
            await self._http.stop()
            self._http = None

    async def _route(self, request: Request) -> Response:
        handler = self._routes.get(request.path)
        if handler is None:
            raise HTTPError(404, f"no route {request.path}")
        if request.method not in ("GET", "HEAD"):
            raise HTTPError(405, f"GET {request.path}")
        return await handler(request)

    # ---------------------------------------------------------------- reads

    def _lookup(self, vof: str):
        vid = int(str(vof).split(",")[0])
        return self.master_client.vid_map.lookup(vid)

    async def LookupVolume(self, request, context):
        resp = master_pb2.LookupVolumeResponse()
        for vof in request.volume_or_file_ids:
            entry = resp.volume_id_locations.add()
            entry.volume_or_file_id = str(vof)
            try:
                locs = self._lookup(vof)
            except ValueError:
                entry.error = f"invalid volume id {vof!r}"
                continue
            if not locs:
                entry.error = f"volume {vof} not found"
                continue
            for l in locs:
                entry.locations.add(url=l.url, public_url=l.public_url or l.url)
        return resp

    async def h_lookup(self, request: Request) -> Response:
        vof = request.query.get("volumeId", "")
        try:
            locs = self._lookup(vof)
        except ValueError:
            locs = []
        if not locs:
            return json_response(
                {"volumeOrFileId": vof, "error": "not found"}, status=404
            )
        return json_response({
            "volumeOrFileId": vof,
            "locations": [
                {"url": l.url, "publicUrl": l.public_url or l.url}
                for l in locs
            ],
        })

    async def h_cluster_status(self, request: Request) -> Response:
        return json_response({
            "IsLeader": False,
            "Leader": self.master_client.current_master,
            "Peers": self.masters,
        })

    # ------------------------------------------------- control-plane proxy

    def _leader_stub(self) -> Stub:
        return Stub(
            channel(
                server_address.grpc_address(self.master_client.current_master)
            ),
            master_pb2,
            "Seaweed",
        )

    async def Assign(self, request, context):
        return await self._leader_stub().Assign(request)

    async def Statistics(self, request, context):
        return await self._leader_stub().Statistics(request)

    async def VolumeList(self, request, context):
        return await self._leader_stub().VolumeList(request)

    async def ListClusterNodes(self, request, context):
        return await self._leader_stub().ListClusterNodes(request)
