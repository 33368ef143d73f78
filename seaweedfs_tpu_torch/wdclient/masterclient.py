"""MasterClient: stay subscribed to the master, keep the vidMap fresh.

The port of seaweedfs_tpu/wdclient/masterclient.py over the port's RPC
plane.  Reference: weed/wdclient/masterclient.go:126-307 —
KeepConnectedToMaster retries across masters, follows leader redirects,
and applies incremental VolumeLocation updates.  A follower master
answers the stream with the leader's address and ends it; a dead master
ends it with an RpcError; either way the client dials the next master of
its list half a second later.
"""
from __future__ import annotations

import asyncio
import logging

from ..pb import RpcError, Stub, channel, master_pb2, server_address
from .vid_map import Location, VidMap

log = logging.getLogger("wdclient")


class MasterClient:
    def __init__(
        self,
        masters: list[str],
        client_type: str = "client",
        client_address: str = "",
        data_center: str = "",
    ):
        self.masters = masters
        self.client_type = client_type
        self.client_address = client_address
        self.vid_map = VidMap(data_center)
        self.current_master = masters[0] if masters else ""
        self._task: asyncio.Task | None = None
        self._connected = asyncio.Event()

    async def start(self) -> None:
        self._task = asyncio.create_task(self._keep_connected())

    async def wait_connected(self, timeout: float = 5.0) -> None:
        await asyncio.wait_for(self._connected.wait(), timeout)

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception as e:  # noqa: BLE001
                log.debug("keep-connected task ended with: %s", e)

    async def _keep_connected(self) -> None:
        i = 0
        while True:
            master = self.masters[i % len(self.masters)]
            i += 1
            try:
                await self._subscribe(master)
            except asyncio.CancelledError:
                # stop() cancelled us (it awaits and eats the
                # CancelledError itself): propagate the true state
                raise
            except Exception as e:
                log.debug("keepConnected to %s: %s", master, e)
            self._connected.clear()
            await asyncio.sleep(0.5)

    async def _subscribe(self, master: str) -> None:
        stub = Stub(
            channel(server_address.grpc_address(master)), master_pb2, "Seaweed"
        )

        async def requests():
            yield master_pb2.KeepConnectedRequest(
                client_type=self.client_type, client_address=self.client_address
            )
            while True:
                await asyncio.sleep(30)
                yield master_pb2.KeepConnectedRequest(
                    client_type=self.client_type, client_address=self.client_address
                )

        # KeepConnected is the deliberately long-lived master
        # subscription; a hung master surfaces as a broken stream and a
        # redial in the outer loop
        async for resp in stub.KeepConnected(requests()):
            if resp.leader:
                self.current_master = resp.leader
            if resp.HasField("volume_location"):
                self._apply(resp.volume_location)
            self._connected.set()

    def _apply(self, vl: master_pb2.VolumeLocation) -> None:
        loc = Location(
            url=vl.url,
            public_url=vl.public_url,
            grpc_port=vl.grpc_port,
            data_center=vl.data_center,
        )
        ec_new = set(vl.new_ec_vids)
        ec_del = set(vl.deleted_ec_vids)
        for vid in vl.new_vids:
            self.vid_map.add_location(vid, loc, is_ec=vid in ec_new)
        for vid in vl.deleted_vids:
            self.vid_map.delete_location(vid, vl.url)
        for vid in ec_new - set(vl.new_vids):
            self.vid_map.add_location(vid, loc, is_ec=True)
        for vid in ec_del - set(vl.deleted_vids):
            self.vid_map.delete_location(vid, vl.url)

    # -- lookups (GetLookupFileIdFunction masterclient.go) -------------------

    def lookup_file_id(self, fid: str) -> list[str]:
        return self.vid_map.lookup_file_id(fid)

    async def lookup_or_fetch(self, vid: int) -> list[Location]:
        """vidMap first; on miss ask the master directly and cache."""
        locs = self.vid_map.lookup(vid)
        if locs:
            return locs
        stub = Stub(
            channel(server_address.grpc_address(self.current_master)),
            master_pb2,
            "Seaweed",
        )
        try:
            resp = await stub.LookupVolume(
                master_pb2.LookupVolumeRequest(volume_or_file_ids=[str(vid)]),
                timeout=10.0,  # master metadata round-trip (GL114)
            )
        except RpcError:
            return []
        for e in resp.volume_id_locations:
            for l in e.locations:
                self.vid_map.add_location(
                    vid,
                    Location(l.url, l.public_url, l.grpc_port, l.data_center),
                )
        return self.vid_map.lookup(vid)
