"""volume.* commands (reference: weed/shell/command_volume_list.go,
command_volume_balance.go, command_volume_fix_replication.go,
command_volume_move.go, command_volume_vacuum.go, command_volume_mark.go
and the other command_volume_*.go).

The port of seaweedfs_tpu/shell/command_volume.py, every verb of it, with
the reference's flags and printed lines: volume.list, volume.mark,
volume.delete, volume.mount, volume.unmount, volume.move, volume.balance,
volume.fix.replication, volume.grow, volume.tier.upload,
volume.tier.download, volume.copy, volume.server.leave,
volume.delete.empty, volume.check.disk, volume.server.evacuate (volumes
and EC shards) and volume.tier.move over the volume servers' rpcs;
volume.vacuum, volume.vacuum.disable and volume.vacuum.enable over the
master's; volume.configure.replication (VolumeConfigure on every holder);
and the readers of the device planes' telemetry: volume.device.status
[-hot], volume.device.attribution, volume.tier.status,
volume.ingest.status, volume.trace and volume.trace.why.  HTTP calls
(volume.grow's /vol/grow, volume.check.disk's deletes and the readers'
/cluster/health.json, /debug/device/hot, /debug/device/attribution,
/debug/traces and /debug/critpath) go over the port's HTTP client;
volume.trace.why asks the master's /debug/critpath (the cross-node
assembly) unless -node names one server.
"""
from __future__ import annotations

import itertools
import json
import urllib.parse

from ..pb import master_pb2, server_address, volume_server_pb2
from ..server.http import fetch, fetch_following
from ..storage import types as t
from .command_cluster import fetch_cluster_health, fmt_bytes, http_get_json
from .command_env import TopoNode
from .commands import command, parse_flags


@command("volume.list")
async def cmd_volume_list(env, args):
    """list volumes per node (like the reference's topology dump)"""
    nodes, _ = await env.collect_topology()
    total_vols = 0
    for n in nodes:
        env.write(f"{n.data_center}/{n.rack}/{n.url}")
        for v in sorted(n.volumes, key=lambda v: v["id"]):
            env.write(
                f"  volume id:{v['id']} size:{v['size']}"
                f" collection:{v['collection']!r} file_count:{v['file_count']}"
                f" delete_count:{v['delete_count']}"
                f" replica_placement:{v['replica_placement']:03d}"
                f"{' readonly' if v['read_only'] else ''}"
            )
            total_vols += 1
        for s in sorted(n.ec_shards, key=lambda s: s["id"]):
            bits = s["ec_index_bits"]
            shard_ids = [i for i in range(14) if bits >> i & 1]
            env.write(f"  ec volume id:{s['id']} shards:{shard_ids}")
    env.write(f"total {total_vols} volumes on {len(nodes)} nodes")


@command("volume.vacuum")
async def cmd_volume_vacuum(env, args):
    """-garbageThreshold 0.3 [-volumeId N] : trigger a master vacuum pass"""
    flags = parse_flags(args)
    await env.master_stub.VacuumVolume(
        master_pb2.VacuumVolumeRequest(
            garbage_threshold=float(flags.get("garbageThreshold", 0.3)),
            volume_id=int(flags.get("volumeId", 0)),
        )
    )
    env.write("vacuum pass requested")


@command("volume.mark")
async def cmd_volume_mark(env, args):
    """-node <host:port.grpc> -volumeId N -readonly|-writable"""
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    stub = env.volume_stub(flags["node"])
    if "writable" in flags:
        await stub.VolumeMarkWritable(
            volume_server_pb2.VolumeMarkWritableRequest(volume_id=vid)
        )
        env.write(f"volume {vid} writable")
    else:
        await stub.VolumeMarkReadonly(
            volume_server_pb2.VolumeMarkReadonlyRequest(volume_id=vid)
        )
        env.write(f"volume {vid} readonly")


@command("volume.delete")
async def cmd_volume_delete(env, args):
    """-node <grpc addr> -volumeId N : delete one volume replica"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    await env.volume_stub(flags["node"]).VolumeDelete(
        volume_server_pb2.VolumeDeleteRequest(volume_id=int(flags["volumeId"]))
    )
    env.write("deleted")


@command("volume.mount")
async def cmd_volume_mount(env, args):
    """-node <grpc addr> -volumeId N"""
    flags = parse_flags(args)
    await env.volume_stub(flags["node"]).VolumeMount(
        volume_server_pb2.VolumeMountRequest(volume_id=int(flags["volumeId"]))
    )


@command("volume.unmount")
async def cmd_volume_unmount(env, args):
    """-node <grpc addr> -volumeId N"""
    flags = parse_flags(args)
    await env.volume_stub(flags["node"]).VolumeUnmount(
        volume_server_pb2.VolumeUnmountRequest(volume_id=int(flags["volumeId"]))
    )


async def move_volume(env, vid: int, collection: str, src: TopoNode, dst: TopoNode):
    """Copy a volume to dst then delete from src (command_volume_move.go)."""
    async for _ in env.volume_stub(dst.grpc_address).VolumeCopy(
        volume_server_pb2.VolumeCopyRequest(
            volume_id=vid, collection=collection, source_data_node=src.grpc_address
        )
    ):
        pass
    await env.volume_stub(src.grpc_address).VolumeDelete(
        volume_server_pb2.VolumeDeleteRequest(volume_id=vid)
    )


@command("volume.move")
async def cmd_volume_move(env, args):
    """-volumeId N -source <grpc> -target <grpc>"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    nodes, _ = await env.collect_topology()
    by_grpc = {n.grpc_address: n for n in nodes}
    src = by_grpc[flags["source"]]
    dst = by_grpc[flags["target"]]
    collection = next(
        (v["collection"] for v in src.volumes if v["id"] == vid), ""
    )
    await move_volume(env, vid, collection, src, dst)
    env.write(f"moved volume {vid}: {src.url} -> {dst.url}")


@command("volume.balance")
async def cmd_volume_balance(env, args):
    """[-force] : even out volume counts across nodes
    (command_volume_balance.go — balanceVolumeServers by ratio)"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    apply = "force" in flags
    nodes, _ = await env.collect_topology()
    if len(nodes) < 2:
        env.write("nothing to balance")
        return
    moves = plan_balance_moves(nodes)
    for vid, collection, src, dst in moves:
        env.write(f"move volume {vid}: {src.url} -> {dst.url}")
        if apply:
            await move_volume(env, vid, collection, src, dst)
    env.write(f"{len(moves)} moves{' applied' if apply else ' planned (use -force)'}")


def plan_balance_moves(nodes: list[TopoNode]):
    """Greedy: move volumes from the fullest node to the emptiest until the
    spread is <=1 (the reference balances by fullness ratio; with uniform
    max counts that reduces to this)."""
    moves = []
    counts = {n.url: len(n.volumes) for n in nodes}
    vols = {n.url: sorted(n.volumes, key=lambda v: v["size"]) for n in nodes}
    by_url = {n.url: n for n in nodes}
    replica_urls = {}
    for n in nodes:
        for v in n.volumes:
            replica_urls.setdefault(v["id"], set()).add(n.url)
    while True:
        hi = max(counts, key=counts.get)
        lo = min(counts, key=counts.get)
        if counts[hi] - counts[lo] <= 1 or not vols[hi]:
            return moves
        # pick a volume whose replicas don't already sit on `lo`
        pick = None
        for i, v in enumerate(vols[hi]):
            if lo not in replica_urls.get(v["id"], set()):
                pick = vols[hi].pop(i)
                break
        if pick is None:
            return moves
        moves.append((pick["id"], pick["collection"], by_url[hi], by_url[lo]))
        replica_urls[pick["id"]].discard(hi)
        replica_urls[pick["id"]].add(lo)
        counts[hi] -= 1
        counts[lo] += 1


@command("volume.fix.replication")
async def cmd_volume_fix_replication(env, args):
    """[-force] : re-replicate under-replicated volumes, delete
    over-replicated ones (command_volume_fix_replication.go)"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    apply = "force" in flags
    nodes, _ = await env.collect_topology()
    plan = plan_replication_fixes(nodes)
    for action, vid, collection, src, dst in plan:
        if action == "copy":
            env.write(f"replicate volume {vid}: {src.url} -> {dst.url}")
            if apply:
                async for _ in env.volume_stub(dst.grpc_address).VolumeCopy(
                    volume_server_pb2.VolumeCopyRequest(
                        volume_id=vid,
                        collection=collection,
                        source_data_node=src.grpc_address,
                    )
                ):
                    pass
        else:
            env.write(f"delete over-replicated volume {vid} from {src.url}")
            if apply:
                await env.volume_stub(src.grpc_address).VolumeDelete(
                    volume_server_pb2.VolumeDeleteRequest(volume_id=vid)
                )
    env.write(f"{len(plan)} fixes{' applied' if apply else ' planned (use -force)'}")


def placement_feasible(
    locations: list[tuple[str, str, str]], rp: t.ReplicaPlacement
) -> bool:
    """Can `locations` [(dc, rack, url), ...] be completed to (or exactly
    form) a valid XYZ placement?  Mirrors the reference's
    satisfyReplicaPlacement (command_volume_fix_replication.go): one main
    rack holds 1+same_rack replicas on distinct servers, diff_rack other
    racks in the main DC hold one each, diff_dc other DCs hold one each."""
    if len({loc[2] for loc in locations}) != len(locations):
        return False  # two replicas on one server is never valid
    if len(locations) > rp.copy_count:
        return False
    mains = {(dc, rack) for dc, rack, _ in locations} or {("", "")}
    for main_dc, main_rack in mains:
        other_dcs: dict[str, int] = {}
        other_racks: dict[str, int] = {}
        main_count = 0
        for dc, rack, _ in locations:
            if dc != main_dc:
                other_dcs[dc] = other_dcs.get(dc, 0) + 1
            elif rack != main_rack:
                other_racks[rack] = other_racks.get(rack, 0) + 1
            else:
                main_count += 1
        if (
            main_count <= 1 + rp.same_rack
            and len(other_dcs) <= rp.diff_dc
            and all(c == 1 for c in other_dcs.values())
            and len(other_racks) <= rp.diff_rack
            and all(c == 1 for c in other_racks.values())
        ):
            return True
    return False


def plan_replication_fixes(nodes: list[TopoNode]):
    """-> [(action, vid, collection, src_node, dst_node|None)].
    New-replica targets must keep the XYZ ReplicaPlacement satisfiable
    (placement_feasible above); among valid targets the freest wins,
    mirroring fixUnderReplicatedVolumes' placement scoring."""
    by_vid: dict[int, list[tuple[TopoNode, dict]]] = {}
    for n in nodes:
        for v in n.volumes:
            by_vid.setdefault(v["id"], []).append((n, v))
    plan = []
    for vid, replicas in by_vid.items():
        v = replicas[0][1]
        rp = t.ReplicaPlacement.from_byte(v["replica_placement"])
        want = rp.copy_count
        have = len(replicas)
        holder_urls = {n.url for n, _ in replicas}
        if have < want:
            holders = [(n.data_center, n.rack, n.url) for n, _ in replicas]
            src = replicas[0][0]
            for _ in range(want - have):
                valid = [
                    n
                    for n in nodes
                    if n.url not in holder_urls
                    and n.free_slots() > 0
                    and placement_feasible(
                        holders + [(n.data_center, n.rack, n.url)], rp
                    )
                ]
                if not valid:
                    break  # no target can satisfy the placement; skip, don't violate
                dst = max(valid, key=lambda n: n.free_slots())
                plan.append(("copy", vid, v["collection"], src, dst))
                holders.append((dst.data_center, dst.rack, dst.url))
                holder_urls.add(dst.url)
        elif have > want:
            # Pick the SET of deletions whose remainder keeps the placement
            # satisfiable (reference fixOverReplicatedVolumes checks
            # satisfyReplicaPlacement on what stays); among valid sets,
            # prefer deleting from the fullest nodes.  Replica counts are
            # tiny, so exhaustive combinations are fine.
            best = None
            for combo in itertools.combinations(range(have), have - want):
                rest = [
                    (n.data_center, n.rack, n.url)
                    for j, (n, _) in enumerate(replicas)
                    if j not in combo
                ]
                fullness = sum(len(replicas[j][0].volumes) for j in combo)
                if placement_feasible(rest, rp) and (
                    best is None or fullness > best[0]
                ):
                    best = (fullness, combo)
            if best is None:
                # placement unsatisfiable either way; trim fullest-first
                order = sorted(
                    range(have),
                    key=lambda j: len(replicas[j][0].volumes),
                    reverse=True,
                )
                best = (0, tuple(order[: have - want]))
            for j in best[1]:
                plan.append(("delete", vid, v["collection"], replicas[j][0], None))
    return plan


@command("volume.grow")
async def cmd_volume_grow(env, args):
    """-count N [-collection c] [-replication XYZ] : pre-grow volumes"""
    flags = parse_flags(args)
    master = server_address.http_address(env.masters[0])
    qs = urllib.parse.urlencode({
        "count": flags.get("count", 1),
        "collection": flags.get("collection", ""),
        "replication": flags.get("replication", ""),
    })
    _, _, body = await fetch_following(master, "GET", f"/vol/grow?{qs}")
    env.write(body.decode())


async def _tier_nodes_for(env, vid: int):
    """Every node holding volume `vid` (tiering runs on each replica)."""
    nodes, _ = await env.collect_topology()
    holders = [
        n for n in nodes if any(v["id"] == vid for v in n.volumes)
    ]
    if not holders:
        raise ValueError(f"volume {vid} not found in topology")
    return holders


@command("volume.tier.upload")
async def cmd_volume_tier_upload(env, args):
    """-volumeId N -dest <type.id> [-keepLocalDatFile] : move the volume's
    .dat onto a storage backend; reads keep working via ranged fetches
    (command_volume_tier_upload.go)"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    dest = flags.get("dest", "local.default")
    for node in await _tier_nodes_for(env, vid):
        # tiered volumes must be readonly first (the reference marks them)
        await env.volume_stub(node.grpc_address).VolumeMarkReadonly(
            volume_server_pb2.VolumeMarkReadonlyRequest(volume_id=vid)
        )
        async for resp in env.volume_stub(node.grpc_address).VolumeTierMoveDatToRemote(
            volume_server_pb2.VolumeTierMoveDatToRemoteRequest(
                volume_id=vid,
                destination_backend_name=dest,
                keep_local_dat_file="keepLocalDatFile" in flags,
            )
        ):
            env.write(
                f"volume {vid} @ {node.url}: uploaded {resp.processed} bytes "
                f"to {dest}"
            )


@command("volume.tier.download")
async def cmd_volume_tier_download(env, args):
    """-volumeId N [-keepRemoteDatFile] : bring a tiered volume's .dat back
    to local disk (command_volume_tier_download.go)"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    for node in await _tier_nodes_for(env, vid):
        async for resp in env.volume_stub(node.grpc_address).VolumeTierMoveDatFromRemote(
            volume_server_pb2.VolumeTierMoveDatFromRemoteRequest(
                volume_id=vid,
                keep_remote_dat_file="keepRemoteDatFile" in flags,
            )
        ):
            env.write(
                f"volume {vid} @ {node.url}: downloaded {resp.processed} bytes"
            )


def parse_duration(s: str) -> float:
    """'24h' / '30m' / '90s' / bare seconds -> seconds."""
    s = str(s).strip()
    mult = {"s": 1, "m": 60, "h": 3600, "d": 86400}.get(s[-1:], None)
    if mult is None:
        return float(s)
    return float(s[:-1]) * mult


@command("volume.copy")
async def cmd_volume_copy(env, args):
    """-volumeId N -source <grpc> -target <grpc> : copy a volume replica
    to another server without deleting the source (command_volume_copy.go)"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    nodes, _ = await env.collect_topology()
    by_grpc = {n.grpc_address: n for n in nodes}
    src = by_grpc[flags["source"]]
    collection = next((v["collection"] for v in src.volumes if v["id"] == vid), "")
    n = 0
    async for resp in env.volume_stub(flags["target"]).VolumeCopy(
        volume_server_pb2.VolumeCopyRequest(
            volume_id=vid, collection=collection, source_data_node=flags["source"]
        )
    ):
        n = resp.processed_bytes
    env.write(f"copied volume {vid}: {flags['source']} -> {flags['target']} ({n} bytes)")


@command("volume.vacuum.disable")
async def cmd_volume_vacuum_disable(env, args):
    """pause master vacuum (periodic + manual) — command_volume_vacuum_disable.go"""
    await env.master_stub.DisableVacuum(master_pb2.DisableVacuumRequest())
    env.write("vacuum disabled")


@command("volume.vacuum.enable")
async def cmd_volume_vacuum_enable(env, args):
    """resume master vacuum — command_volume_vacuum_enable.go"""
    await env.master_stub.EnableVacuum(master_pb2.EnableVacuumRequest())
    env.write("vacuum enabled")


@command("volume.server.leave")
async def cmd_volume_server_leave(env, args):
    """-node <grpc addr> : ask one volume server to stop heartbeating and
    leave the cluster (command_volume_server_leave.go)"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    await env.volume_stub(flags["node"]).VolumeServerLeave(
        volume_server_pb2.VolumeServerLeaveRequest()
    )
    env.write(f"volume server {flags['node']} asked to leave")


@command("volume.delete.empty")
async def cmd_volume_delete_empty(env, args):
    """[-quietFor 24h] [-force] : delete volumes holding no live files that
    have been quiet for the period (command_volume_delete_empty.go)"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    quiet_s = parse_duration(flags.get("quietFor", "24h"))
    apply = "force" in flags
    import time as _time

    now = _time.time()
    nodes, _ = await env.collect_topology()
    deleted = 0
    for n in nodes:
        for v in n.volumes:
            live = v["file_count"] - v["delete_count"]
            quiet = now - v.get("modified_at_second", 0) >= quiet_s
            if live > 0 or not quiet:
                continue
            env.write(f"delete empty volume {v['id']} on {n.url}")
            if apply:
                await env.volume_stub(n.grpc_address).VolumeDelete(
                    volume_server_pb2.VolumeDeleteRequest(volume_id=v["id"])
                )
            deleted += 1
    env.write(f"{deleted} empty volumes{' deleted' if apply else ' found (use -force)'}")


async def _fetch_needle_states(
    env, node: TopoNode, vid: int, collection: str
) -> tuple[dict, set, set]:
    """Pull a replica's .idx and fold it in file order to
    ({needle_id: size} live, {needle_id} ending deleted, {needle_id}
    deleted-then-re-added).  Any negative idx size is a deletion marker
    (TOMBSTONE_FILE_SIZE is -1, but reference-written volumes may carry
    other negative encodings); offset 0 + size 0 records deletions of
    absent needles and is neither alive nor a tombstone."""
    from ..storage import idx as idx_mod

    buf = bytearray()
    async for resp in env.volume_stub(node.grpc_address).CopyFile(
        volume_server_pb2.CopyFileRequest(
            volume_id=vid, collection=collection, ext=".idx"
        )
    ):
        buf.extend(resp.file_content)
    ids, offs, sizes = idx_mod.parse_buffer(bytes(buf))
    alive: dict[int, int] = {}
    deleted: set[int] = set()
    resurrected: set[int] = set()
    for i in range(len(ids)):
        nid, off, size = int(ids[i]), int(offs[i]), int(sizes[i])
        if size < 0:
            alive.pop(nid, None)
            deleted.add(nid)
            resurrected.discard(nid)
        elif size == 0 and off == 0:
            pass  # delete-of-absent record: no state change
        else:
            if nid in deleted:
                deleted.discard(nid)
                resurrected.add(nid)
            alive[nid] = size
    return alive, deleted, resurrected


async def _check_disk_one_volume(env, vid, replicas, apply) -> int:
    """Cross-check ONE volume's replicas and (with apply) sync them.
    Returns the number of out-of-sync needles found."""
    synced = 0
    collection = replicas[0][1]["collection"]
    states = [
        await _fetch_needle_states(env, n, vid, collection)
        for n, _ in replicas
    ]
    alive = [s[0] for s in states]
    # deletions win: if ANY replica tombstoned a needle, propagate the
    # delete (reference doVolumeCheckDisk syncs deletions, not just
    # additions — an add-only sync would resurrect deleted files).
    # EXCEPT when some replica shows a delete-then-re-add history for
    # the id: the re-add is causally after the delete that the stale
    # tombstone echoes, so the newest write must not be destroyed.
    all_resurrected = set().union(*(s[2] for s in states))
    all_deleted = set().union(*(s[1] for s in states)) - all_resurrected
    for j, (dst_node, _) in enumerate(replicas):
        for nid in sorted(all_deleted & set(alive[j])):
            env.write(
                f"volume {vid}: needle {nid:x} deleted elsewhere, "
                f"still alive on {dst_node.url}"
            )
            if apply:
                blob = await env.volume_stub(
                    dst_node.grpc_address
                ).ReadNeedleBlob(
                    volume_server_pb2.ReadNeedleBlobRequest(
                        volume_id=vid, needle_id=nid
                    )
                )
                fid = f"{vid},{nid:x}{blob.cookie:08x}"
                await fetch(dst_node.url, "DELETE", f"/{fid}")
                del alive[j][nid]
            synced += 1
    for i, (src_node, _) in enumerate(replicas):
        for j, (dst_node, _) in enumerate(replicas):
            if i == j:
                continue
            missing = set(alive[i]) - set(alive[j]) - all_deleted
            for nid in sorted(missing):
                env.write(
                    f"volume {vid}: needle {nid:x} on {src_node.url} "
                    f"missing from {dst_node.url}"
                )
                if apply:
                    blob = await env.volume_stub(
                        src_node.grpc_address
                    ).ReadNeedleBlob(
                        volume_server_pb2.ReadNeedleBlobRequest(
                            volume_id=vid, needle_id=nid
                        )
                    )
                    await env.volume_stub(
                        dst_node.grpc_address
                    ).WriteNeedleBlob(
                        volume_server_pb2.WriteNeedleBlobRequest(
                            volume_id=vid,
                            needle_id=nid,
                            needle_blob=blob.needle_blob,
                            cookie=blob.cookie,
                            last_modified=blob.last_modified,
                        )
                    )
                    alive[j][nid] = alive[i][nid]
                synced += 1
    return synced


@command("volume.check.disk")
async def cmd_volume_check_disk(env, args):
    """[-volumeId N] [-force] : cross-check replicas of each volume and sync
    missing needles both ways (command_volume_check_disk.go)"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    only_vid = int(flags.get("volumeId", 0))
    apply = "force" in flags
    nodes, _ = await env.collect_topology()
    by_vid: dict[int, list[tuple[TopoNode, dict]]] = {}
    for n in nodes:
        for v in n.volumes:
            by_vid.setdefault(v["id"], []).append((n, v))
    synced = 0
    for vid, replicas in sorted(by_vid.items()):
        if only_vid and vid != only_vid:
            continue
        if len(replicas) < 2:
            continue
        synced += await _check_disk_one_volume(env, vid, replicas, apply)
    env.write(
        f"{synced} needles {'synced' if apply else 'out of sync (use -force)'}"
    )


@command("volume.server.evacuate")
async def cmd_volume_server_evacuate(env, args):
    """-node <url> [-force] : move every volume and EC shard off a server
    before decommissioning it (command_volume_server_evacuate.go)"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    target_url = flags["node"]
    apply = "force" in flags
    nodes, _ = await env.collect_topology()
    victim = next(
        (n for n in nodes if n.url == target_url or n.grpc_address == target_url),
        None,
    )
    if victim is None:
        raise ValueError(f"volume server {target_url} not found in topology")
    others = [n for n in nodes if n is not victim]
    replica_urls: dict[int, set[str]] = {}
    for n in nodes:
        for v in n.volumes:
            replica_urls.setdefault(v["id"], set()).add(n.url)
    moved = skipped = 0
    for v in list(victim.volumes):
        vid = v["id"]
        rp = t.ReplicaPlacement.from_byte(v["replica_placement"])
        rest = [
            (n.data_center, n.rack, n.url)
            for n in others
            if n.url in replica_urls.get(vid, set())
        ]
        valid = [
            n
            for n in others
            if n.url not in replica_urls.get(vid, set())
            and n.free_slots() > 0
            and placement_feasible(rest + [(n.data_center, n.rack, n.url)], rp)
        ]
        if not valid:
            env.write(f"volume {vid}: no placement-feasible target — skipped")
            skipped += 1
            continue
        dst = max(valid, key=lambda n: n.free_slots())
        env.write(f"move volume {vid}: {victim.url} -> {dst.url}")
        if apply:
            try:
                await move_volume(env, vid, v["collection"], victim, dst)
            except Exception as e:  # stale topology (already moved/deleted)
                env.write(f"volume {vid}: move failed, skipped ({e})")
                skipped += 1
                continue
        replica_urls.setdefault(vid, set()).discard(victim.url)
        replica_urls[vid].add(dst.url)
        moved += 1
    # EC shards ride along too (evacuate moves both kinds); capacity is in
    # SHARD units, not volume slots (command_ec.free_shard_slots)
    from ..storage.ec import TOTAL_SHARDS
    from .command_ec import free_shard_slots, move_ec_shard

    for s in list(victim.ec_shards):
        bits = s["ec_index_bits"]
        for sid in [i for i in range(TOTAL_SHARDS) if bits >> i & 1]:
            candidates = [n for n in others if free_shard_slots(n) > 0]
            if not candidates:
                env.write(f"ec shard {s['id']}.{sid}: no target — skipped")
                skipped += 1
                continue
            dst = max(candidates, key=free_shard_slots)
            env.write(f"move ec shard {s['id']}.{sid}: {victim.url} -> {dst.url}")
            if apply:
                try:
                    await move_ec_shard(
                        env, s["id"], s["collection"], sid, victim, dst
                    )
                except Exception as e:
                    env.write(
                        f"ec shard {s['id']}.{sid}: move failed, skipped ({e})"
                    )
                    skipped += 1
                    continue
            moved += 1
    env.write(
        f"{moved} moves{' applied' if apply else ' planned (use -force)'}, "
        f"{skipped} skipped"
    )


@command("volume.tier.move")
async def cmd_volume_tier_move(env, args):
    """-fromDiskType hdd -toDiskType ssd [-collectionPattern p] [-fullPercent 95]
    [-quietFor 0s] [-force] : re-home volumes onto a different disk type.
    Only one replica is moved and the others are dropped — follow with
    volume.fix.replication + volume.balance (command_volume_tier_move.go)."""
    env.confirm_is_locked()
    import fnmatch
    import time as _time

    flags = parse_flags(args)
    src_type = flags["fromDiskType"]
    dst_type = flags["toDiskType"]
    if src_type == dst_type:
        raise ValueError("source and target disk types are the same")
    pattern = flags.get("collectionPattern", "")
    full_pct = float(flags.get("fullPercent", 95))
    quiet_s = parse_duration(flags.get("quietFor", "0s"))
    apply = "force" in flags
    now = _time.time()
    nodes, size_limit_mb = await env.collect_topology()
    by_vid: dict[int, list[tuple[TopoNode, dict]]] = {}
    for n in nodes:
        for v in n.volumes:
            by_vid.setdefault(v["id"], []).append((n, v))
    moved = 0
    planned: dict[str, int] = {}  # url -> slots consumed by this run's moves
    for vid, replicas in sorted(by_vid.items()):
        # pick a replica actually sitting on the source tier (replicas can
        # be tier-mixed after an interrupted move or a manual copy)
        src_pair = next(
            (
                (n, v)
                for n, v in replicas
                if v.get("disk_type", "hdd") == src_type
            ),
            None,
        )
        if src_pair is None:
            continue
        src, v = src_pair
        if pattern and not fnmatch.fnmatch(v["collection"], pattern):
            continue
        if full_pct and v["size"] < size_limit_mb * 1024 * 1024 * full_pct / 100:
            continue
        if quiet_s and now - v.get("modified_at_second", 0) < quiet_s:
            continue
        holder_urls = {n.url for n, _ in replicas}
        targets = [
            n
            for n in nodes
            if n.free_slots(dst_type) - planned.get(n.url, 0) > 0
            and n.url not in holder_urls
        ]
        if not targets:
            env.write(f"volume {vid}: no {dst_type} capacity — skipped")
            continue
        dst = max(
            targets, key=lambda n: n.free_slots(dst_type) - planned.get(n.url, 0)
        )
        env.write(
            f"move volume {vid} ({src_type} -> {dst_type}): {src.url} -> {dst.url}"
        )
        if apply:
            try:
                async for _ in env.volume_stub(dst.grpc_address).VolumeCopy(
                    volume_server_pb2.VolumeCopyRequest(
                        volume_id=vid,
                        collection=v["collection"],
                        source_data_node=src.grpc_address,
                        disk_type=dst_type,
                    )
                ):
                    pass
            except Exception as e:  # keep draining the rest of the queue
                env.write(f"volume {vid}: move failed, skipped ({e})")
                continue
            # drop the old-tier replicas (ref semantics: one replica changes
            # tier, the rest are dropped); replicas already on the target
            # tier are kept
            for n, rv in replicas:
                if rv.get("disk_type", "hdd") == dst_type:
                    continue
                await env.volume_stub(n.grpc_address).VolumeDelete(
                    volume_server_pb2.VolumeDeleteRequest(volume_id=vid)
                )
        planned[dst.url] = planned.get(dst.url, 0) + 1
        moved += 1
    env.write(f"{moved} volumes{' moved' if apply else ' planned (use -force)'}")


@command("volume.configure.replication")
async def cmd_volume_configure_replication(env, args):
    """-volumeId N -replication XYZ : change a volume's replica placement
    on every holder (command_volume_configure_replication.go); persists
    into the on-disk superblock"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    replication = flags["replication"]
    nodes, _ = await env.collect_topology()
    holders = [n for n in nodes if any(v["id"] == vid for v in n.volumes)]
    if not holders:
        raise ValueError(f"volume {vid} not found in topology")
    failures = []
    for node in holders:
        resp = await env.volume_stub(node.grpc_address).VolumeConfigure(
            volume_server_pb2.VolumeConfigureRequest(
                volume_id=vid, replication=replication
            )
        )
        if resp.error:
            env.write(f"{node.url}: {resp.error}")
            failures.append(node.url)
        else:
            env.write(f"{node.url}: volume {vid} -> replication {replication}")
    if failures:
        # a partial application leaves replicas with divergent superblocks
        # — that must fail loudly, not read as success
        raise ValueError(
            f"replication change failed on {', '.join(failures)}; "
            f"replicas may now disagree"
        )


@command("volume.device.status")
async def cmd_volume_device_status(env, args):
    """[-node <host:port>] [-hot [N]] : per-node device shard-cache
    status from the master's telemetry plane — HBM used/budget/
    headroom (aggregate AND one row per mesh device under the
    lane-sharded layout), resident shard counts per EC volume, compile-cache
    hit/miss, evictions, pin claims.  -hot additionally fetches each
    node's /debug/device/hot: the per-call-shape dispatch counters and
    latency EWMAs, hottest first — "what shape is the device actually
    spending its time in" as one command"""
    flags = parse_flags(args)
    want = flags.get("node") or flags.get("")
    health = await fetch_cluster_health(env)
    nodes = health["nodes"]
    if want:
        if want not in nodes:
            raise ValueError(
                f"node {want!r} not in telemetry plane (known: "
                f"{', '.join(sorted(nodes)) or 'none'})"
            )
        nodes = {want: nodes[want]}
    hot_limit = 0
    if "hot" in flags:
        hot_limit = 10 if flags["hot"] == "true" else int(flags["hot"])
    for url, n in nodes.items():
        state = "STALE" if n["stale"] else "fresh"
        dev = n.get("device")
        if not dev:
            env.write(
                f"{url} [{state}] no device telemetry "
                "(cache disabled or pre-telemetry server)"
            )
            continue
        env.write(
            f"{url} [{state}] hbm {fmt_bytes(dev['used_bytes'])}"
            f"/{fmt_bytes(dev['budget_bytes'])} "
            f"(headroom {fmt_bytes(dev['headroom_bytes'])}) "
            f"shards={dev['resident_shards']} "
            f"evictions={dev['evictions']} pin_claims={dev['pin_claims']} "
            f"compile hit/miss={dev['compile_hits']}/{dev['compile_misses']} "
            # the reference's compile-cache columns: the port compiles
            # nothing per shape, so they read 0/0 and OFF (ROADMAP §C)
            f"compile_cache="
            f"{'on' if dev.get('compile_cache_enabled') else 'OFF'}"
        )
        # per-device breakdown (mesh residency): a lopsided mesh —
        # whole-pins crowding one chip while the lane-sharded volumes
        # spread evenly — shows as one row per device, not an aggregate
        for row in dev.get("per_device", []):
            env.write(
                f"  device {row['device']}: "
                f"{fmt_bytes(row['used_bytes'])}"
                f"/{fmt_bytes(row['budget_bytes'])} "
                f"(headroom {fmt_bytes(row['headroom_bytes'])})"
            )
        for vid, count in dev["resident_shards_by_volume"].items():
            env.write(f"  ec volume {vid}: {count} resident shards")
        if hot_limit and not n["stale"]:
            await _print_hot_shapes(env, url, hot_limit)


@command("volume.device.attribution")
async def cmd_volume_device_attribution(env, args):
    """[-node <host:port>] [-json] : per-workload device-time
    attribution from each node's ledger (/debug/device/attribution) —
    busy seconds, dispatches, bytes, and queue wait per workload class
    (serving_interactive/serving_bulk/ingest/scrub/repair/warmup/bulk),
    with the per-device-label breakdown.  "Who is burning the
    accelerator" as one command"""
    flags = parse_flags(args)
    want = flags.get("node") or flags.get("")
    health = await fetch_cluster_health(env)
    urls = sorted(health["nodes"])
    if want:
        if want not in urls:
            raise ValueError(
                f"node {want!r} not in telemetry plane (known: "
                f"{', '.join(urls) or 'none'})"
            )
        urls = [want]
    docs = []
    for url in urls:
        try:
            status, doc = await http_get_json(
                url, "/debug/device/attribution")
            if status != 200:
                raise ValueError(f"HTTP {status}")
            docs.append(doc)
        except Exception as e:  # noqa: BLE001 — one unreachable node
            # must not kill the whole sweep
            env.write(f"{url}: unavailable ({e})")
    if "json" in flags:
        env.write(json.dumps(docs, indent=2, sort_keys=True))
        return
    for doc in docs:
        total = doc.get("total_busy_seconds", 0.0)
        env.write(
            f"{doc['node']} device busy {total:.3f}s"
            + ("" if doc.get("enabled", True)
               else "  [ledger DISABLED: -obs.ledger.disable]")
        )
        workloads = doc.get("workloads", {})
        if not workloads:
            env.write("  nothing dispatched yet")
            continue
        env.write(
            "  {:<20} {:>10} {:>10} {:>8} {:>10} {:>10}".format(
                "workload", "busy_s", "share", "calls", "bytes", "qwait_s"
            )
        )
        for wl, row in sorted(
            workloads.items(), key=lambda kv: -kv[1]["busy_s"]
        ):
            share = row["busy_s"] / total if total > 0 else 0.0
            env.write(
                "  {:<20} {:>10.3f} {:>9.1%} {:>8} {:>10} {:>10.3f}".format(
                    wl, row["busy_s"], share, row["dispatches"],
                    fmt_bytes(row["bytes"]), row["queue_wait_s"],
                )
            )
            devices = row.get("devices", {})
            if len(devices) > 1:
                for dev, d in sorted(devices.items()):
                    env.write(
                        f"    device {dev}: {d['busy_s']:.3f}s "
                        f"calls={d['dispatches']} "
                        f"bytes={fmt_bytes(d['bytes'])}"
                    )


async def _print_hot_shapes(env, url: str, limit: int) -> None:
    """Fetch + print one node's /debug/device/hot view (the
    rs_resident per-call-shape dispatch counters/latency EWMAs)."""
    try:
        status, payload = await http_get_json(
            url, "/debug/device/hot", {"limit": str(limit)})
        if status != 200:
            raise ValueError(f"HTTP {status}")
    except Exception as e:  # noqa: BLE001 — one unreachable node must
        # not kill the whole status sweep
        env.write(f"  hot shapes: unavailable ({e})")
        return
    shapes = payload.get("shapes", [])
    aot = payload.get("aot", {})
    env.write(
        f"  hot shapes (aot compiled={aot.get('compiled', 0)} "
        f"pending={aot.get('pending', 0)} failed={aot.get('failed', 0)}):"
    )
    if not shapes:
        env.write("    none dispatched yet")
    for s in shapes:
        env.write(
            f"    {s['kernel']}{' g' + str(s['groups']) if s['groups'] > 1 else ''}"
            f" fetch={s['fetch']} tile={s['tile']}"
            f" count={s['count_bucket']}: {s['dispatches']} dispatches,"
            f" ewma {s['ewma_ms']}ms,"
            f" last {s['last_dispatch_age_s']}s ago"
        )


@command("volume.tier.status")
async def cmd_volume_tier_status(env, args):
    """[-node <host:port>] : per-node residency-ladder view from the
    master's telemetry plane — EC volume census by tier (hbm / host RAM
    / disk), cumulative promotion/demotion counters (the thrash
    signal), and host-RAM warm-tier occupancy"""
    flags = parse_flags(args)
    want = flags.get("node") or flags.get("")
    health = await fetch_cluster_health(env)
    nodes = health["nodes"]
    if want:
        if want not in nodes:
            raise ValueError(
                f"node {want!r} not in telemetry plane (known: "
                f"{', '.join(sorted(nodes)) or 'none'})"
            )
        nodes = {want: nodes[want]}
    for url, n in nodes.items():
        state = "STALE" if n["stale"] else "fresh"
        tiers = n.get("tiering")
        if not tiers:
            env.write(
                f"{url} [{state}] no tiering telemetry "
                "(ladder disabled or pre-telemetry server)"
            )
            continue
        env.write(
            f"{url} [{state}] hbm={tiers['hbm_volumes']} "
            f"host={tiers['host_volumes']} volumes; "
            f"host tier {fmt_bytes(tiers['host_bytes'])}; "
            # promotions vs demotions: a demotion rate chasing the
            # promotion rate means the ladder is thrashing — widen
            # -ec.tier.promoteRatio / -ec.tier.minResidencySeconds
            f"promotions={tiers['promotions_total']} "
            f"demotions={tiers['demotions_total']}"
        )
    cluster = health.get("cluster", {})
    tv = cluster.get("tier_volumes")
    if tv:
        env.write(
            f"cluster: hbm={tv['hbm']} host={tv['host']} volumes, "
            f"host tier {fmt_bytes(cluster.get('tier_host_bytes', 0))}, "
            f"promotions={cluster.get('tier_promotions_total', 0)} "
            f"demotions={cluster.get('tier_demotions_total', 0)}"
        )


@command("volume.ingest.status")
async def cmd_volume_ingest_status(env, args):
    """[-node <host:port>] : per-node streaming-ingest view from the
    master's telemetry plane — write bytes accepted, stripe rows
    encoded online (device vs host codec), writes shed at the door,
    group-commit fsyncs, live per-volume pipelines, and seals that
    skipped the offline encode"""
    flags = parse_flags(args)
    want = flags.get("node") or flags.get("")
    health = await fetch_cluster_health(env)
    nodes = health["nodes"]
    if want:
        if want not in nodes:
            raise ValueError(
                f"node {want!r} not in telemetry plane (known: "
                f"{', '.join(sorted(nodes)) or 'none'})"
            )
        nodes = {want: nodes[want]}
    for url, n in nodes.items():
        state = "STALE" if n["stale"] else "fresh"
        ing = n.get("ingest")
        if not ing:
            env.write(
                f"{url} [{state}] no ingest telemetry "
                "(plane disabled or pre-telemetry server)"
            )
            continue
        env.write(
            f"{url} [{state}] {fmt_bytes(ing['bytes_total'])} written; "
            f"rows device={ing['rows_device']} host={ing['rows_host']}; "
            # every shed here was refused AT THE DOOR — the client got a
            # fast 429/504 instead of a doomed slow upload
            f"shed={ing['shed_total']} fsyncs={ing['fsyncs_total']} "
            f"pipelines={ing['active_pipelines']} "
            f"streamed_seals={ing['streamed_seals']}"
        )
    ci = health.get("cluster", {}).get("ingest")
    if ci:
        env.write(
            f"cluster: {fmt_bytes(ci['bytes_total'])} written, rows "
            f"device={ci['rows_device']} host={ci['rows_host']}, "
            f"shed={ci['shed_total']} fsyncs={ci['fsyncs_total']} "
            f"pipelines={ci['active_pipelines']} "
            f"streamed_seals={ci['streamed_seals']}"
        )


@command("volume.trace")
async def cmd_volume_trace(env, args):
    """-node <host:port> [-limit N] [-id <trace_id>] [-since <seconds>]
    : fetch /debug/traces from a running volume server and pretty-print
    the recent request traces (trace id, per-span stage durations,
    annotations) newest-first; -id fetches one trace instead of the
    ring, -since only traces still active in the last N seconds (the
    burn window an incident bundle covers; a long-stalled request
    finishing inside it counts) — both filter before the limit"""
    flags = parse_flags(args)
    node = flags.get("node") or flags.get("")
    if not node:
        raise ValueError(
            "volume.trace -node <host:port(http)> [-limit N] "
            "[-id <trace_id>] [-since <seconds>]"
        )
    limit = int(flags.get("limit", 10))
    params = {"limit": str(limit)}
    if flags.get("id"):
        params["id"] = flags["id"]
    if flags.get("since"):
        params["since"] = flags["since"]
    status, payload = await http_get_json(node, "/debug/traces", params)
    if status == 404 and flags.get("id"):
        # the endpoint's JSON error body carries the contract wording;
        # keep the shell line identical either way
        env.write(
            f"{node}: trace {flags['id']!r} not found "
            "(evicted or never traced)"
        )
        return
    if status != 200:
        raise ValueError(f"{node}/debug/traces returned HTTP {status}")
    traces = payload.get("traces", [])
    if not traces:
        env.write(f"{node}: no traces recorded")
        return
    for t in traces:
        env.write(
            f"trace {t['trace_id']} [{t['role']}] {t['name']} "
            f"{t['duration_us'] / 1000:.2f}ms status={t.get('status', '')}"
        )
        for sp in t.get("spans", []):
            ann = " ".join(
                f"{k}={v}" for k, v in (sp.get("annotations") or {}).items()
            )
            env.write(
                f"  +{sp['offset_us']:>8}us {sp['duration_us']:>8}us "
                f"{sp['name']}{'  ' + ann if ann else ''}"
            )


@command("volume.trace.why")
async def cmd_volume_trace_why(env, args):
    """-id <trace_id> [-node <host:port>] [-json] : critical-path
    attribution for one request — fetch /debug/critpath?id= (from the
    master by default, which stitches the cross-node DAG from every
    node's ring + tail pins and reconciles clocks; -node asks one
    server for its local view instead) and print where the
    client-visible wall time went: queue_wait / device_execute /
    host_reconstruct / disk / network_gap / untraced"""
    from ..pb import server_address

    flags = parse_flags(args)
    trace_id = flags.get("id") or flags.get("")
    if not trace_id:
        raise ValueError(
            "volume.trace.why -id <trace_id> [-node <host:port(http)>] "
            "[-json]"
        )
    node = flags.get("node") or server_address.http_address(env.masters[0])
    url = f"http://{node}/debug/critpath"
    status, doc = await http_get_json(node, "/debug/critpath",
                                      {"id": trace_id})
    if status == 404:
        env.write(
            f"{node}: trace {trace_id!r} not found "
            "(evicted or never traced)"
        )
        return
    if status != 200:
        raise ValueError(f"{url} returned HTTP {status}")
    if "json" in flags:
        env.write(json.dumps(doc, indent=2, sort_keys=True))
        return
    total_us = doc.get("total_us", 0)
    env.write(
        f"trace {doc['trace_id']} {doc.get('name', '?')} "
        f"(route {doc.get('route', '?')}) "
        f"{total_us / 1000:.2f}ms status={doc.get('status', '')}"
    )
    parts = ", ".join(
        f"{p['server']}[{p['role']}]" for p in doc.get("participants", [])
    )
    env.write(
        f"participants: {parts or '-'}"
        + (f"  coverage: {doc['coverage_pct']:.1f}%"
           if doc.get("coverage_pct") is not None else "")
    )
    segs = doc.get("segments_us", {})
    pcts = doc.get("segments_pct", {})
    for seg, us in segs.items():
        bar = "#" * int(round((pcts.get(seg, 0.0)) / 5))
        env.write(
            f"  {seg:<16} {us:>10}us {pcts.get(seg, 0.0):>6.2f}%  {bar}"
        )
    for u, err in sorted(doc.get("fetch_errors", {}).items()):
        env.write(f"  (fan-out {u}: {err})")

    def _walk(n, depth):
        env.write(
            f"  {'  ' * depth}[{n.get('server', '?')}] {n.get('name', '?')} "
            f"+{n.get('offset_us', 0)}us {n.get('duration_us', 0)}us"
        )
        for c in n.get("children", []):
            _walk(c, depth + 1)

    tree = doc.get("tree")
    if tree:
        _walk(tree, 0)
