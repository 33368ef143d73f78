"""In-process cluster: a master and N volume servers on one asyncio loop.

The port of seaweedfs_tpu/server/cluster.py (reference: weed/command/
server.go) for the tests, without the filer, S3, WebDAV or IAM gateways.
Volume servers start one at a time, each waiting until the master has
registered it, so server i is always the i-th node of the master's
topology: placement decisions that break ties by node order then repeat
from run to run.
"""
from __future__ import annotations

import asyncio
import os

from .master import MasterServer
from .volume import VolumeServer


class LocalCluster:
    def __init__(
        self,
        n_volume_servers: int = 1,
        base_dir: str = "/tmp/seaweedfs-tpu-torch",
        pulse_seconds: int = 1,
        ec_backend: str = "cuda",
        volume_kwargs: dict | None = None,  # extra VolumeServer kwargs,
        # all servers (e.g. ec_device_cache_mb=...)
        master_kwargs: dict | None = None,  # extra MasterServer kwargs
        # (e.g. ec_repair=RepairConfig(...))
    ):
        # the reference LocalCluster's defaults: 1 GiB volumes, 16 slots a
        # server, every server in dc1/r1
        self.master = MasterServer(
            port=0, volume_size_limit_mb=1024, pulse_seconds=pulse_seconds,
            **(master_kwargs or {}),
        )
        self.base_dir = base_dir
        self._specs = [
            dict(
                directories=[os.path.join(base_dir, f"vs{i}", "d0")],
                max_volume_counts=16,
                pulse_seconds=pulse_seconds,
                ec_backend=ec_backend,
                data_center="dc1",
                rack="r1",
                **(volume_kwargs or {}),
            )
            for i in range(n_volume_servers)
        ]
        self.volume_servers: list[VolumeServer] = []

    async def start(self) -> None:
        await self.master.start()
        for spec in self._specs:
            # the explicit host:port.grpc form: dynamically assigned ports
            # break the +10000 convention
            vs = VolumeServer(masters=[self.master.advertise_url], port=0,
                              grpc_port=0, **spec)
            await vs.start()
            self.volume_servers.append(vs)
            await self.wait_for_nodes(len(self.volume_servers))

    async def wait_for_nodes(self, n: int, timeout: float = 10.0) -> None:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while loop.time() < deadline:
            if len(self.master.topo.data_nodes()) >= n:
                return
            await asyncio.sleep(0.02)
        raise TimeoutError(
            f"only {len(self.master.topo.data_nodes())}/{n} nodes joined")

    async def stop(self) -> None:
        for vs in self.volume_servers:
            await vs.stop()
        await self.master.stop()
        from ..pb.rpc import close_all_channels

        await close_all_channels()
