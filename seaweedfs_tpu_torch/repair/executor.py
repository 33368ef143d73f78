"""Repair execution: one job's gather -> rebuild -> remount -> spread.

The port of seaweedfs_tpu/repair/executor.py over the port's RPC plane
(pb/rpc.py).  This is the shell's `ec.rebuild` fan-out
(shell/command_ec.py) driven by the master instead of a human: the
rebuild itself is one VolumeEcShardsRebuild, K1 on the rebuilder's card.
Every RPC is awaited on the master's event loop; the file work runs on
the volume servers.  Every borrowed shard set is pulled onto the
rebuilder CONCURRENTLY (bounded, per-RPC retry/timeout/budget via the
shared utils/faultpolicy.retry_rpc),
the missing shards are rebuilt in one VolumeEcShardsRebuild, and any
excess above the rebuilder's fair share is re-spread with the same
copy->mount->unmount->delete choreography `ec.encode` uses.

Every RPC leaves the master stamped QoS BULK (`x-seaweed-qos` RPC
metadata, merged with the active trace id): repair traffic must be
attributable — and deniable — as background work at every hop, so it
can never masquerade as the interactive front door.
"""
from __future__ import annotations

import math

from ..pb import Stub, volume_server_pb2
from ..pb.rpc import channel
from ..shell.command_ec import (
    ec_nodes_by_freeness,
    gather_ec_shards,
    node_shards,
    spread_ec_shards,
)
from ..utils.faultpolicy import retry_rpc
from ..shell.command_env import TopoNode
from ..storage.ec import TOTAL_SHARDS
from .planner import RepairJob

QOS_METADATA_KEY = "x-seaweed-qos"
BULK = "bulk"


class BulkQosStub:
    """Stub proxy stamping every outbound RPC with the bulk QoS tier.

    The underlying descriptor stub attaches the active trace id and
    deadline budget only when no explicit metadata is passed, so this
    wrapper rebuilds the merged metadata itself: caller's -> trace id
    -> deadline budget -> the tier stamp."""

    def __init__(self, stub: Stub):
        self._stub = stub

    def __getattr__(self, name: str):
        call = getattr(self._stub, name)

        def invoke(request, **kw):
            md = list(kw.pop("metadata", ()) or ())
            from ..obs import trace as obs_trace
            from ..utils import faultpolicy

            tmd = obs_trace.grpc_metadata()
            if tmd is not None:
                md.extend(tmd)
            dmd = faultpolicy.grpc_metadata()
            if dmd is not None:
                md.extend(dmd)
            md.append((QOS_METADATA_KEY, BULK))
            return call(request, metadata=tuple(md), **kw)

        return invoke


class RepairEnv:
    """The minimal CommandEnv surface the shell's fan-out helpers need
    (`env.volume_stub`), with bulk stamping on every stub."""

    def volume_stub(self, grpc_address: str) -> BulkQosStub:
        return BulkQosStub(
            Stub(channel(grpc_address), volume_server_pb2, "VolumeServer")
        )


def shard_map_from_nodes(
    nodes: list[TopoNode],
    prefer_not: set[str] | frozenset[str] = frozenset(),
) -> tuple[dict[int, dict[int, str]], dict[int, str]]:
    """(vid -> {shard_id -> holder url}, vid -> collection) from a
    topology snapshot — the scheduler's census input.  A shard with
    several copies maps to ONE holder; any holder outside `prefer_not`
    (the stale set) wins over one inside it, so a shard already
    re-established on a fresh node counts healthy even while the stale
    original still advertises a copy."""
    shard_map: dict[int, dict[int, str]] = {}
    collections: dict[int, str] = {}
    for n in nodes:
        for s in n.ec_shards:
            collections.setdefault(s["id"], s.get("collection", ""))
            vol = shard_map.setdefault(s["id"], {})
            for sid in range(TOTAL_SHARDS):
                if not s["ec_index_bits"] >> sid & 1:
                    continue
                cur = vol.get(sid)
                if cur is None or (
                    cur in prefer_not and n.url not in prefer_not
                ):
                    vol[sid] = n.url
    return shard_map, collections


async def drop_corrupt_shards(
    env: RepairEnv, nodes: list[TopoNode], job: RepairJob
) -> list[int]:
    """Unmount + delete each corrupt shard at its holder BEFORE the
    rebuild, so the bad bytes can never be gathered as rebuild input.
    Idempotent (a re-run finds them already gone)."""
    by_url = {n.url: n for n in nodes}
    dropped: list[int] = []
    for sid, url in sorted(job.corrupt.items()):
        holder = by_url.get(url)
        if holder is None:
            continue  # the holder died since the verdict; already gone
        stub = env.volume_stub(holder.grpc_address)
        await retry_rpc(
            lambda: stub.VolumeEcShardsUnmount(
                volume_server_pb2.VolumeEcShardsUnmountRequest(
                    volume_id=job.vid, shard_ids=[sid]
                )
            ),
            f"unmount corrupt shard {job.vid}.{sid} at {url}",
            peer=holder.grpc_address,
        )
        await retry_rpc(
            lambda: stub.VolumeEcShardsDelete(
                volume_server_pb2.VolumeEcShardsDeleteRequest(
                    volume_id=job.vid, collection=job.collection,
                    shard_ids=[sid],
                )
            ),
            f"delete corrupt shard {job.vid}.{sid} at {url}",
            peer=holder.grpc_address,
        )
        dropped.append(sid)
    return dropped


async def repair_volume(
    env: RepairEnv,
    nodes: list[TopoNode],
    job: RepairJob,
    concurrency: int = 4,
    stale_nodes: set[str] | frozenset[str] = frozenset(),
) -> dict:
    """Execute one planned repair against a live topology snapshot.
    `stale_nodes` holders are never gathered from (a partitioned node
    may be dying: its copies don't count, so the rebuild regenerates
    fresh ones on live nodes).  Returns a result dict for the
    scheduler's per-volume verdict."""
    dropped = await drop_corrupt_shards(env, nodes, job)
    # census AFTER the corrupt drop: fresh holders are the preferred
    # rebuild input; stale copies are suspect but still rescuable
    shard_map, _ = shard_map_from_nodes(nodes, prefer_not=set(stale_nodes))
    holders = {
        sid: url
        for sid, url in shard_map.get(job.vid, {}).items()
        if sid not in job.corrupt and url not in stale_nodes
    }
    ranked = ec_nodes_by_freeness(
        [n for n in nodes if n.url not in stale_nodes]
    )
    if not ranked:
        raise RuntimeError(f"no volume servers to rebuild {job.vid} on")
    rebuilder = ranked[0]
    stub = env.volume_stub(rebuilder.grpc_address)
    by_url = {n.url: n for n in nodes}
    local = {
        sid for sid in node_shards(rebuilder, job.vid)
        if sid not in job.corrupt
    }
    # RESCUE pass: shards whose only copy sits on a SUSPECT (stale)
    # holder are re-established the cheap way — copied off the suspect
    # onto the rebuilder and KEPT (mounted), while the suspect still
    # answers.  A suspect that is truly dead fails the copy and the
    # job retries/backs off; a sid with no reachable holder at all is
    # regenerated by the rebuild below.
    rescue = {
        sid: url for sid, url in job.rescue.items()
        if sid not in holders and sid not in local and url in by_url
    }
    rescue_copy: dict[str, list[int]] = {}
    for sid, url in sorted(rescue.items()):
        rescue_copy.setdefault(by_url[url].grpc_address, []).append(sid)
    if rescue_copy:
        await gather_ec_shards(
            stub, job.vid, job.collection, rescue_copy,
            concurrency=concurrency,
        )
        rescued = sorted(
            sid for sids in rescue_copy.values() for sid in sids
        )
        await retry_rpc(
            lambda: stub.VolumeEcShardsMount(
                volume_server_pb2.VolumeEcShardsMountRequest(
                    volume_id=job.vid, collection=job.collection,
                    shard_ids=rescued,
                )
            ),
            f"mount rescued shards {rescued} of {job.vid}",
            peer=rebuilder.grpc_address,
        )
        local = local | set(rescued)
    else:
        rescued = []
    to_copy: dict[str, list[int]] = {}
    for sid, url in sorted(holders.items()):
        if sid in local or url == rebuilder.url:
            continue
        holder = by_url.get(url)
        if holder is None:
            continue
        to_copy.setdefault(holder.grpc_address, []).append(sid)
    if to_copy:
        await gather_ec_shards(
            stub, job.vid, job.collection, to_copy, concurrency=concurrency
        )
    resp = await retry_rpc(
        lambda: stub.VolumeEcShardsRebuild(
            volume_server_pb2.VolumeEcShardsRebuildRequest(
                volume_id=job.vid, collection=job.collection
            )
        ),
        f"rebuild missing shards of {job.vid} on {rebuilder.url}",
        peer=rebuilder.grpc_address,
    )
    rebuilt = sorted(resp.rebuilt_shard_ids)
    if rebuilt:
        await retry_rpc(
            lambda: stub.VolumeEcShardsMount(
                volume_server_pb2.VolumeEcShardsMountRequest(
                    volume_id=job.vid, collection=job.collection,
                    shard_ids=rebuilt,
                )
            ),
            f"mount rebuilt shards {rebuilt} of {job.vid}",
            peer=rebuilder.grpc_address,
        )
    # drop the shards borrowed only as rebuild input
    borrowed = [sid for sids in to_copy.values() for sid in sids]
    if borrowed:
        await retry_rpc(
            lambda: stub.VolumeEcShardsUnmount(
                volume_server_pb2.VolumeEcShardsUnmountRequest(
                    volume_id=job.vid, shard_ids=borrowed
                )
            ),
            f"unmount borrowed shards of {job.vid}",
            peer=rebuilder.grpc_address,
        )
        await retry_rpc(
            lambda: stub.VolumeEcShardsDelete(
                volume_server_pb2.VolumeEcShardsDeleteRequest(
                    volume_id=job.vid, collection=job.collection,
                    shard_ids=borrowed,
                )
            ),
            f"delete borrowed shards of {job.vid}",
            peer=rebuilder.grpc_address,
        )
    # re-spread: the rebuilder now holds its prior shards + everything
    # rebuilt; anything beyond its fair share moves to the least-loaded
    # peers so one node failure can't take out the redundancy the
    # rebuild just restored (the ec.balance instinct, applied narrowly
    # to the shards this job created)
    spread: dict[str, list[int]] = {}
    others = ranked[1:]
    created = sorted(set(rescued) | set(rebuilt))
    if created and others:
        fair = math.ceil(TOTAL_SHARDS / len(ranked))
        held = sorted(local | set(rebuilt))
        excess = len(held) - fair
        if excess > 0:
            movable = created[-excess:]
            for i, sid in enumerate(movable):
                node = others[i % len(others)]
                spread.setdefault(node.url, []).append(sid)
            targets = [
                (n, spread[n.url]) for n in others if n.url in spread
            ]
            await spread_ec_shards(
                env, job.vid, job.collection, rebuilder, targets,
                concurrency=concurrency,
            )
    return {
        "rebuilder": rebuilder.url,
        "rebuilt": rebuilt,
        "rescued": rescued,
        "dropped_corrupt": dropped,
        "spread": spread,
    }
