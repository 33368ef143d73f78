"""ec.* commands: encode / rebuild / balance / decode orchestration.

Reference: weed/shell/command_ec_encode.go:57-269 (mark readonly →
generate → spread with balancedEcDistribution → delete original),
command_ec_rebuild.go:99-176, command_ec_balance.go, command_ec_decode.go,
command_ec_common.go:19-58 (moveMountedShardToEcNode).

A copy of seaweedfs_tpu/shell/command_ec.py over the port's RPC plane.
The GF(256) math itself runs wherever VolumeEcShardsGenerate and
VolumeEcShardsRebuild land — on the volume server's configured backend
(the card's K1 kernel by default) — and ec.scrub's all_resident pass runs
csrc/scrub.cu over the server's resident shards.
"""
from __future__ import annotations

import asyncio
import math

from ..pb import volume_server_pb2
from ..storage.ec import DATA_SHARDS, TOTAL_SHARDS
from ..utils.faultpolicy import retry_rpc
from .command_env import CommandEnv, TopoNode
from .commands import command, parse_flags


def ec_nodes_by_freeness(nodes: list[TopoNode]) -> list[TopoNode]:
    return sorted(nodes, key=lambda n: n.free_slots(), reverse=True)


def node_shards(node: TopoNode, vid: int) -> list[int]:
    for s in node.ec_shards:
        if s["id"] == vid:
            return [i for i in range(TOTAL_SHARDS) if s["ec_index_bits"] >> i & 1]
    return []


def rack_of(node: TopoNode) -> tuple[str, str]:
    return (node.data_center, node.rack)


def held_shard_count(n: TopoNode) -> int:
    """Total EC shards a node holds across all volumes."""
    return sum(bin(s["ec_index_bits"]).count("1") for s in n.ec_shards)


def rack_cap(n_shards: int, racks) -> int:
    """Per-rack shard ceiling: ceil(n_shards / n_racks)."""
    return math.ceil(n_shards / len(racks)) if racks else n_shards


def free_shard_slots(n: TopoNode) -> int:
    """Receive capacity in SHARD units: volume slots not taken by regular
    volumes, times 14, minus EC shards already held.  (free_slots() is in
    volume-slot units and counts one held shard as a whole slot — using it
    directly would declare a receiver full after one shard.)"""
    return (
        sum(n.max_volume_counts.values()) - len(n.volumes)
    ) * TOTAL_SHARDS - held_shard_count(n)


def group_by_rack(nodes: list[TopoNode]) -> dict[tuple[str, str], list[TopoNode]]:
    racks: dict[tuple[str, str], list[TopoNode]] = {}
    for n in nodes:
        racks.setdefault(rack_of(n), []).append(n)
    return racks


def balanced_ec_distribution(nodes: list[TopoNode], n_shards: int = TOTAL_SHARDS):
    """Spread shards rack-aware: each (dc, rack) holds at most
    ceil(n_shards / n_racks) shards, minimising how many shards one rack
    failure takes out (with >=4 racks and free capacity that stays within
    the 4-shard RS tolerance; fewer racks or a full cluster can exceed it
    — the capacity fallbacks below prefer placing somewhere over failing);
    within a rack,
    shards round-robin over nodes by free slots (the reference balances
    across racks in command_ec_common.go pickRackToBalanceShardsInto and
    within them via balancedEcDistribution, command_ec_encode.go:253-269).
    Returns [(node, [shard ids])]."""
    ranked = ec_nodes_by_freeness(nodes)
    if not ranked:
        return []
    racks = group_by_rack(ranked)
    rack_limit = rack_cap(n_shards, racks)
    rack_count = {r: 0 for r in racks}
    rack_rr = {r: 0 for r in racks}  # round-robin cursor within the rack
    alloc = {n.url: [] for n in ranked}
    free = {n.url: max(0, free_shard_slots(n)) for n in ranked}

    def rack_free(r):
        return sum(free[n.url] for n in racks[r])

    for sid in range(n_shards):
        # least-loaded rack under the cap with free space; fall back to
        # ignoring the cap, then to ignoring free space, so every shard
        # lands somewhere even on tiny clusters
        candidates = [
            r for r in racks if rack_count[r] < rack_limit and rack_free(r) > 0
        ] or [r for r in racks if rack_free(r) > 0] or list(racks)
        r = min(candidates, key=lambda r: (rack_count[r], -rack_free(r)))
        members = racks[r]
        for _ in range(len(members)):
            n = members[rack_rr[r] % len(members)]
            rack_rr[r] += 1
            if free[n.url] > 0 or all(free[m.url] <= 0 for m in members):
                alloc[n.url].append(sid)
                free[n.url] -= 1
                rack_count[r] += 1
                break
    return [(n, alloc[n.url]) for n in ranked if alloc[n.url]]


# shell fan-out knobs: shard-set copies ship tens of MB each, so the
# concurrency bound keeps a wide cluster from saturating the source's
# uplink, and the per-RPC timeout/retry keeps one wedged peer from
# hanging the whole verb (the reference's parallelCopyEcShardsFromSource
# runs one goroutine per target with an ErrorWaitGroup).  The retry
# policy itself — backoff, jitter, per-peer retry budget — is the one
# shared implementation in utils/faultpolicy.py; `retry_rpc`'s defaults
# match the knobs here.
FANOUT_CONCURRENCY = 4
RPC_ATTEMPTS = 3
RPC_TIMEOUT_S = 300.0
# generate/rebuild/decode re-stripe whole volumes: heavy but FINITE
RPC_HEAVY_TIMEOUT_S = 600.0


async def spread_ec_shards(
    env: CommandEnv,
    vid: int,
    collection: str,
    source: TopoNode,
    targets: list[tuple[TopoNode, list[int]]],
    concurrency: int = FANOUT_CONCURRENCY,
) -> None:
    """Copy+mount each target's shard set from source CONCURRENTLY
    (bounded), then unmount the moved shards at the source
    (parallelCopyEcShardsFromSource → unmountEcShards,
    command_ec_encode.go:145-188).  The `.vif` sidecar ships with exactly
    ONE copy target — decided before the fan-out starts, so concurrent
    copies can't race it — and each target's copy→mount→source-unmount→
    source-delete sequence stays ordered within its own task."""
    real = [
        (node, shard_ids)
        for node, shard_ids in targets
        if node.url != source.url and shard_ids
    ]
    vif_url = real[0][0].url if real else None
    sem = asyncio.Semaphore(max(1, concurrency))

    async def ship(node: TopoNode, shard_ids: list[int]) -> None:
        async with sem:
            stub = env.volume_stub(node.grpc_address)
            await retry_rpc(
                lambda: stub.VolumeEcShardsCopy(
                    volume_server_pb2.VolumeEcShardsCopyRequest(
                        volume_id=vid,
                        collection=collection,
                        shard_ids=shard_ids,
                        copy_ecx_file=True,
                        copy_ecj_file=True,
                        copy_vif_file=node.url == vif_url,
                        source_data_node=source.grpc_address,
                    )
                ),
                f"copy shards {shard_ids} of {vid} to {node.url}",
                peer=node.grpc_address,
            )
            await retry_rpc(
                lambda: stub.VolumeEcShardsMount(
                    volume_server_pb2.VolumeEcShardsMountRequest(
                        volume_id=vid, collection=collection,
                        shard_ids=shard_ids,
                    )
                ),
                f"mount shards {shard_ids} of {vid} on {node.url}",
                peer=node.grpc_address,
            )
            src_stub = env.volume_stub(source.grpc_address)
            await retry_rpc(
                lambda: src_stub.VolumeEcShardsUnmount(
                    volume_server_pb2.VolumeEcShardsUnmountRequest(
                        volume_id=vid, shard_ids=shard_ids
                    )
                ),
                f"unmount shards {shard_ids} of {vid} at source",
                peer=source.grpc_address,
            )
            await retry_rpc(
                lambda: src_stub.VolumeEcShardsDelete(
                    volume_server_pb2.VolumeEcShardsDeleteRequest(
                        volume_id=vid, collection=collection,
                        shard_ids=shard_ids,
                    )
                ),
                f"delete shards {shard_ids} of {vid} at source",
                peer=source.grpc_address,
            )

    await _gather_strict(ship(node, sids) for node, sids in real)


async def _gather_strict(coros) -> None:
    """gather that lets every sibling RUN TO COMPLETION, then raises the
    first failure.  Plain gather() re-raises early while the surviving
    tasks keep mutating cluster state (unmounting/deleting source shards)
    after the verb has already 'failed' — and their own exceptions die as
    never-retrieved warnings.  Cancelling siblings instead would strand a
    peer mid copy→mount→unmount move, which is worse than finishing it."""
    results = await asyncio.gather(*coros, return_exceptions=True)
    for r in results:
        if isinstance(r, BaseException):
            raise r


@command("ec.encode")
async def cmd_ec_encode(env, args):
    """-volumeId N [-collection c] : erasure-code a volume (RS 10+4 on the
    card) and spread the shards across the cluster"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    collection = flags.get("collection", "")
    vids: list[int] = []
    if "volumeId" in flags:
        vids = [int(flags["volumeId"])]
    nodes, _ = await env.collect_topology()
    if not vids and collection:
        vids = sorted(
            {
                v["id"]
                for n in nodes
                for v in n.volumes
                if v["collection"] == collection
            }
        )
    if not vids:
        raise ValueError("usage: ec.encode -volumeId N | -collection c")
    for vid in vids:
        await _encode_one(env, nodes, vid, collection)
        env.write(f"ec encoded volume {vid}")


async def _encode_one(env, nodes: list[TopoNode], vid: int, collection: str):
    holders = [n for n in nodes if any(v["id"] == vid for v in n.volumes)]
    if not holders:
        raise ValueError(f"volume {vid} not found")
    # 1. freeze all replicas (markVolumeReplicasWritable false)
    for n in holders:
        await env.volume_stub(n.grpc_address).VolumeMarkReadonly(
            volume_server_pb2.VolumeMarkReadonlyRequest(volume_id=vid),
            timeout=RPC_TIMEOUT_S,
        )
    source = holders[0]
    src_stub = env.volume_stub(source.grpc_address)
    collection = next(
        (v["collection"] for v in source.volumes if v["id"] == vid), collection
    )
    # 2. generate shards on the source (the card's kernels server-side)
    await src_stub.VolumeEcShardsGenerate(
        volume_server_pb2.VolumeEcShardsGenerateRequest(
            volume_id=vid, collection=collection
        ),
        timeout=RPC_HEAVY_TIMEOUT_S,
    )
    await src_stub.VolumeEcShardsMount(
        volume_server_pb2.VolumeEcShardsMountRequest(
            volume_id=vid, collection=collection,
            shard_ids=list(range(TOTAL_SHARDS)),
        ),
        timeout=RPC_TIMEOUT_S,
    )
    # 3. spread with balanced distribution
    targets = balanced_ec_distribution(nodes)
    await spread_ec_shards(env, vid, collection, source, targets)
    # 4. drop the original volume from every replica
    for n in holders:
        await env.volume_stub(n.grpc_address).VolumeDelete(
            volume_server_pb2.VolumeDeleteRequest(volume_id=vid),
            timeout=RPC_TIMEOUT_S,
        )


async def collect_ec_volume_shards(env) -> dict[int, dict[int, TopoNode]]:
    """vid -> shard_id -> node holding it, from the topology snapshot."""
    nodes, _ = await env.collect_topology()
    out: dict[int, dict[int, TopoNode]] = {}
    for n in nodes:
        for s in n.ec_shards:
            for sid in range(TOTAL_SHARDS):
                if s["ec_index_bits"] >> sid & 1:
                    out.setdefault(s["id"], {})[sid] = n
    return out


def _fmt_scrub_row(env, vid, mism, backend, bytes_verified, seconds):
    bad = sum(mism)
    # ONE byte basis for both figures: data bytes covered (shard span
    # x DATA_SHARDS, the same basis bench.py's scrub GB/s uses), so
    # the printed rate actually equals size/seconds
    data_bytes = bytes_verified * DATA_SHARDS
    mb = data_bytes / 1e6
    rate = data_bytes / seconds / 1e9 if seconds else 0.0
    status = (
        "OK" if bad == 0
        else f"CORRUPT: {list(mism)} mismatch bytes"
    )
    env.write(
        f"ec volume {vid}: {status} backend={backend} "
        f"{mb:.0f}MB data in {seconds:.2f}s ({rate:.2f} GB/s)"
    )


@command("ec.scrub")
async def cmd_ec_scrub(env, args):
    """[-volumeId <id>] : verify parity consistency of mounted EC volumes
    (VolumeEcShardsVerify).  Runs on nodes holding all 14 shards of a
    volume — device-resident volumes scrub first in one pass per node
    (all_resident: the whole device cache in one launch per span class),
    the rest per volume over the shard files; spread volumes are reported
    skipped."""
    flags = parse_flags(args)
    target = int(flags.get("volumeId", 0) or 0)
    shard_map = await collect_ec_volume_shards(env)
    # pick each volume's scrub node up front so the megakernel pre-pass
    # knows which nodes are worth one all_resident RPC
    chosen: dict[int, str] = {}
    for vid, shards in sorted(shard_map.items()):
        if target and vid != target:
            continue
        holders: dict[str, set[int]] = {}
        for sid, node in shards.items():
            holders.setdefault(node.grpc_address, set()).add(sid)
        full = [a for a, sids in holders.items() if len(sids) == TOTAL_SHARDS]
        if not full:
            env.write(
                f"ec volume {vid}: shards spread over {len(holders)} "
                f"node(s), none holds all {TOTAL_SHARDS} — skipped"
            )
            continue
        chosen[vid] = full[0]
    # megakernel pre-pass (skipped for a targeted scrub — one volume
    # doesn't justify sweeping a node's whole cache): per-vid verdicts
    # land in `mega`, and anything it didn't cover (not fully resident)
    # falls through to the per-volume RPC below
    mega: dict[tuple[str, int], object] = {}
    if not target:
        for addr in sorted(set(chosen.values())):
            try:
                r = await env.volume_stub(addr).VolumeEcShardsVerify(
                    volume_server_pb2.VolumeEcShardsVerifyRequest(
                        all_resident=True
                    ),
                    timeout=RPC_HEAVY_TIMEOUT_S,
                )
            except Exception:  # noqa: BLE001 — the per-volume path
                # below still covers everything
                continue
            for row in r.volumes:
                mega[(addr, row.volume_id)] = row
    for vid, addr in chosen.items():
        row = mega.get((addr, vid))
        if row is not None:
            _fmt_scrub_row(
                env, vid, row.parity_mismatch_bytes, row.backend,
                row.bytes_verified, row.seconds,
            )
            continue
        r = await env.volume_stub(addr).VolumeEcShardsVerify(
            volume_server_pb2.VolumeEcShardsVerifyRequest(volume_id=vid),
            timeout=RPC_HEAVY_TIMEOUT_S,
        )
        _fmt_scrub_row(
            env, vid, r.parity_mismatch_bytes, r.backend,
            r.bytes_verified, r.seconds,
        )


async def gather_ec_shards(
    stub,
    vid: int,
    collection: str,
    to_copy: dict[str, list[int]],
    concurrency: int = FANOUT_CONCURRENCY,
) -> None:
    """Pull every borrowed shard set onto the rebuilder CONCURRENTLY
    (bounded, per-RPC retry/timeout).  All copies land on the SAME node,
    so the sidecars (.ecx/.ecj/.vif) ship with exactly one of them —
    concurrent pulls writing the same sidecar path would race."""
    sidecar_src = next(iter(to_copy), None)
    sem = asyncio.Semaphore(max(1, concurrency))

    async def pull(src_addr: str, sids: list[int]) -> None:
        async with sem:
            await retry_rpc(
                lambda: stub.VolumeEcShardsCopy(
                    volume_server_pb2.VolumeEcShardsCopyRequest(
                        volume_id=vid,
                        collection=collection,
                        shard_ids=sids,
                        copy_ecx_file=src_addr == sidecar_src,
                        copy_ecj_file=src_addr == sidecar_src,
                        copy_vif_file=src_addr == sidecar_src,
                        source_data_node=src_addr,
                    )
                ),
                f"gather shards {sids} of {vid} from {src_addr}",
                peer=src_addr,
            )

    await _gather_strict(pull(src, sids) for src, sids in to_copy.items())


@command("ec.rebuild")
async def cmd_ec_rebuild(env, args):
    """[-force] [-fsync] : rebuild missing EC shards onto a rebuilder node
    (command_ec_rebuild.go:99-176); -fsync makes the rebuilt shards
    durable before the RPC returns"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    apply = "force" in flags
    fsync = "fsync" in flags
    shard_map = await collect_ec_volume_shards(env)
    nodes, _ = await env.collect_topology()
    for vid, shards in sorted(shard_map.items()):
        missing = [sid for sid in range(TOTAL_SHARDS) if sid not in shards]
        if not missing:
            continue
        if len(shards) < 10:
            env.write(f"ec volume {vid}: only {len(shards)} shards left, unrecoverable")
            continue
        env.write(f"ec volume {vid}: rebuilding shards {missing}")
        if not apply:
            continue
        rebuilder = ec_nodes_by_freeness(nodes)[0]
        collection = next(
            (
                s["collection"]
                for n in nodes
                for s in n.ec_shards
                if s["id"] == vid
            ),
            "",
        )
        stub = env.volume_stub(rebuilder.grpc_address)
        # gather every available shard onto the rebuilder (prepareToRecoverMissingEcShard)
        local = set(node_shards(rebuilder, vid))
        to_copy: dict[str, list[int]] = {}
        for sid, holder in shards.items():
            if sid not in local and holder.url != rebuilder.url:
                to_copy.setdefault(holder.grpc_address, []).append(sid)
        await gather_ec_shards(stub, vid, collection, to_copy)
        resp = await stub.VolumeEcShardsRebuild(
            volume_server_pb2.VolumeEcShardsRebuildRequest(
                volume_id=vid, collection=collection, fsync=fsync
            ),
            timeout=RPC_HEAVY_TIMEOUT_S,
        )
        await stub.VolumeEcShardsMount(
            volume_server_pb2.VolumeEcShardsMountRequest(
                volume_id=vid, collection=collection,
                shard_ids=list(resp.rebuilt_shard_ids),
            ),
            timeout=RPC_TIMEOUT_S,
        )
        # drop the borrowed shards it only needed as rebuild input
        borrowed = [sid for sids in to_copy.values() for sid in sids]
        if borrowed:
            await stub.VolumeEcShardsUnmount(
                volume_server_pb2.VolumeEcShardsUnmountRequest(
                    volume_id=vid, shard_ids=borrowed
                ),
                timeout=RPC_TIMEOUT_S,
            )
            await stub.VolumeEcShardsDelete(
                volume_server_pb2.VolumeEcShardsDeleteRequest(
                    volume_id=vid, collection=collection, shard_ids=borrowed
                ),
                timeout=RPC_TIMEOUT_S,
            )
        env.write(f"ec volume {vid}: rebuilt {list(resp.rebuilt_shard_ids)}")


def plan_rack_moves(nodes: list[TopoNode]) -> list[tuple[int, str, int, TopoNode, TopoNode]]:
    """Per EC volume: move shards out of racks holding more than
    ceil(14 / n_racks) of its shards, into the rack holding fewest
    (balanceEcShardsAcrossRacks, command_ec_common.go).  Mutates the
    nodes' ec_index_bits to reflect planned moves; returns
    [(vid, collection, shard_id, src_node, dst_node)]."""
    racks = group_by_rack(nodes)
    if len(racks) <= 1:
        return []
    rack_limit = rack_cap(TOTAL_SHARDS, racks)
    moves = []
    vids = sorted(
        {s["id"] for n in nodes for s in n.ec_shards}
    )
    for vid in vids:
        collection = next(
            (s["collection"] for n in nodes for s in n.ec_shards if s["id"] == vid),
            "",
        )
        # one scan per volume; maintained incrementally across its moves
        holders = {n.url: node_shards(n, vid) for n in nodes}
        loads = {
            r: sum(len(holders[n.url]) for n in racks[r]) for r in racks
        }
        while True:
            over = [r for r in racks if loads[r] > rack_limit]
            if not over:
                break
            src_rack = max(over, key=lambda r: loads[r])
            # only racks with free EC capacity can receive
            # (pickRackToBalanceShardsInto's freeEcSlot requirement)
            open_racks = [
                r
                for r in racks
                if r != src_rack
                and any(free_shard_slots(n) > 0 for n in racks[r])
            ]
            if not open_racks:
                break
            dst_rack = min(open_racks, key=lambda r: loads[r])
            if loads[dst_rack] >= rack_limit:
                break
            src_node = next(
                n for n in reversed(racks[src_rack]) if holders[n.url]
            )
            sid = holders[src_node.url][-1]
            # within the destination rack, the freest node without this
            # volume's shards
            dst_node = min(
                (n for n in racks[dst_rack] if free_shard_slots(n) > 0),
                key=lambda n: (len(holders[n.url]), -free_shard_slots(n)),
            )
            moves.append((vid, collection, sid, src_node, dst_node))
            _move_shard_bits(src_node, dst_node, vid, collection, sid)
            holders[src_node.url].remove(sid)
            holders[dst_node.url].append(sid)
            loads[src_rack] -= 1
            loads[dst_rack] += 1
    return moves


def _move_shard_bits(src: TopoNode, dst: TopoNode, vid, collection, sid) -> None:
    """Update the in-memory topology snapshot to reflect a planned move."""
    for s in src.ec_shards:
        if s["id"] == vid:
            s["ec_index_bits"] &= ~(1 << sid)
    for s in dst.ec_shards:
        if s["id"] == vid:
            s["ec_index_bits"] |= 1 << sid
            return
    dst.ec_shards.append(
        {"id": vid, "collection": collection, "ec_index_bits": 1 << sid}
    )


def plan_node_moves(nodes: list[TopoNode]) -> list[tuple[int, str, int, TopoNode, TopoNode]]:
    """Even aggregate shard counts across nodes (the reference's
    balanceEcShardsWithinRacks + balanceEcRacks rolled into one hi/lo
    loop) — a cross-rack move is only allowed while it keeps the
    destination rack under the per-volume cap plan_rack_moves enforces.
    Mutates the nodes' ec_index_bits; returns
    [(vid, collection, shard_id, src_node, dst_node)]."""
    racks = group_by_rack(nodes)
    rack_limit = rack_cap(TOTAL_SHARDS, racks)

    def vid_rack_load(rack: tuple[str, str], vid: int) -> int:
        return sum(len(node_shards(n, vid)) for n in racks[rack])

    counts = {
        n.url: held_shard_count(n) for n in nodes
    }
    by_url = {n.url: n for n in nodes}
    moves: list[tuple[int, str, int, TopoNode, TopoNode]] = []

    def try_move(hi: str, lo: str) -> bool:
        src, dst = by_url[hi], by_url[lo]
        if free_shard_slots(dst) <= 0:
            # receivers need free EC capacity (the reference's freeEcSlot
            # requirement, command_ec_common.go)
            return False
        for s in src.ec_shards:
            vid = s["id"]
            cross_rack = rack_of(src) != rack_of(dst)
            if cross_rack and vid_rack_load(rack_of(dst), vid) >= rack_limit:
                continue
            sids = [i for i in range(TOTAL_SHARDS) if s["ec_index_bits"] >> i & 1]
            dst_held = node_shards(dst, vid)
            movable = [sid for sid in sids if sid not in dst_held]
            if movable:
                moves.append((vid, s["collection"], movable[0], src, dst))
                _move_shard_bits(src, dst, vid, s["collection"], movable[0])
                counts[hi] -= 1
                counts[lo] += 1
                return True
        return False

    while counts:
        # try every donor (fullest first) against every recipient
        # (emptiest first): the top pair may be blocked by the rack cap
        # while e.g. a same-rack move still improves balance
        moved = False
        for hi in sorted(counts, key=counts.get, reverse=True):
            for lo in sorted(counts, key=counts.get):
                if counts[hi] - counts[lo] <= 1:
                    break  # later recipients are even fuller
                if try_move(hi, lo):
                    moved = True
                    break
            if moved:
                break
        if not moved:
            break
    return moves


@command("ec.balance")
async def cmd_ec_balance(env, args):
    """[-force] : even EC shards across racks, then across nodes
    (command_ec_balance.go, command_ec_common.go)"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    apply = "force" in flags
    nodes, _ = await env.collect_topology()

    # pass 1: rack dimension — no rack holds more of a volume's shards
    # than ceil(14 / n_racks)
    rack_moves = plan_rack_moves(nodes)
    for vid, collection, sid, src, dst in rack_moves:
        env.write(
            f"move ec shard {vid}.{sid}: {src.url} -> {dst.url} (rack balance)"
        )
        if apply:
            await move_ec_shard(env, vid, collection, sid, src, dst)

    # pass 2: aggregate node counts across the cluster
    moves = plan_node_moves(nodes)
    for vid, collection, sid, src, dst in moves:
        env.write(f"move ec shard {vid}.{sid}: {src.url} -> {dst.url}")
        if apply:
            await move_ec_shard(env, vid, collection, sid, src, dst)
    total = len(rack_moves) + len(moves)
    env.write(
        f"{total} shard moves{' applied' if apply else ' planned (use -force)'}"
    )


async def move_ec_shard(env, vid, collection, sid, src, dst):
    """copy → mount → unmount+delete at source (moveMountedShardToEcNode
    command_ec_common.go:19-58)."""
    stub = env.volume_stub(dst.grpc_address)
    await stub.VolumeEcShardsCopy(
        volume_server_pb2.VolumeEcShardsCopyRequest(
            volume_id=vid, collection=collection, shard_ids=[sid],
            copy_ecx_file=True, copy_ecj_file=True, copy_vif_file=True,
            source_data_node=src.grpc_address,
        ),
        timeout=RPC_TIMEOUT_S,
    )
    await stub.VolumeEcShardsMount(
        volume_server_pb2.VolumeEcShardsMountRequest(
            volume_id=vid, collection=collection, shard_ids=[sid]
        ),
        timeout=RPC_TIMEOUT_S,
    )
    src_stub = env.volume_stub(src.grpc_address)
    await src_stub.VolumeEcShardsUnmount(
        volume_server_pb2.VolumeEcShardsUnmountRequest(volume_id=vid, shard_ids=[sid]),
        timeout=RPC_TIMEOUT_S,
    )
    await src_stub.VolumeEcShardsDelete(
        volume_server_pb2.VolumeEcShardsDeleteRequest(
            volume_id=vid, collection=collection, shard_ids=[sid]
        ),
        timeout=RPC_TIMEOUT_S,
    )


@command("ec.decode")
async def cmd_ec_decode(env, args):
    """-volumeId N : convert an EC volume back to a normal volume
    (command_ec_decode.go)"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    shard_map = await collect_ec_volume_shards(env)
    shards = shard_map.get(vid)
    if not shards:
        raise ValueError(f"ec volume {vid} not found")
    # choose the node already holding the most shards as the decoder
    holders: dict[str, list[int]] = {}
    for sid, n in shards.items():
        holders.setdefault(n.url, []).append(sid)
    nodes, _ = await env.collect_topology()
    by_url = {n.url: n for n in nodes}
    decoder = by_url[max(holders, key=lambda u: len(holders[u]))]
    collection = next(
        (s["collection"] for n in nodes for s in n.ec_shards if s["id"] == vid), ""
    )
    stub = env.volume_stub(decoder.grpc_address)
    local = set(holders.get(decoder.url, []))
    to_copy: dict[str, list[int]] = {}
    for sid, holder in shards.items():
        if sid not in local and holder.url != decoder.url:
            to_copy.setdefault(holder.grpc_address, []).append(sid)
    for src_addr, sids in to_copy.items():
        await stub.VolumeEcShardsCopy(
            volume_server_pb2.VolumeEcShardsCopyRequest(
                volume_id=vid, collection=collection, shard_ids=sids,
                copy_ecx_file=True, copy_ecj_file=True, copy_vif_file=True,
                source_data_node=src_addr,
            ),
            timeout=RPC_TIMEOUT_S,
        )
    await stub.VolumeEcShardsToVolume(
        volume_server_pb2.VolumeEcShardsToVolumeRequest(
            volume_id=vid, collection=collection
        ),
        timeout=RPC_HEAVY_TIMEOUT_S,
    )
    # remove EC shards everywhere
    for n in {n.url: n for n in shards.values()}.values():
        sids = node_shards(n, vid)
        if sids:
            s_stub = env.volume_stub(n.grpc_address)
            await s_stub.VolumeEcShardsUnmount(
                volume_server_pb2.VolumeEcShardsUnmountRequest(
                    volume_id=vid, shard_ids=sids
                ),
                timeout=RPC_TIMEOUT_S,
            )
            await s_stub.VolumeEcShardsDelete(
                volume_server_pb2.VolumeEcShardsDeleteRequest(
                    volume_id=vid, collection=collection, shard_ids=sids
                ),
                timeout=RPC_TIMEOUT_S,
            )
    await env.volume_stub(decoder.grpc_address).VolumeEcShardsDelete(
        volume_server_pb2.VolumeEcShardsDeleteRequest(
            volume_id=vid, collection=collection,
            shard_ids=list(range(TOTAL_SHARDS)),
        ),
        timeout=RPC_TIMEOUT_S,
    )
    env.write(f"decoded ec volume {vid} back to a normal volume on {decoder.url}")
