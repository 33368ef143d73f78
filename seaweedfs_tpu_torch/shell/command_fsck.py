"""volume.fsck: cross-check filer chunk references against volume
contents.

Reference: weed/shell/command_volume_fsck.go — collect every fid the
filer's entries reference (manifest chunks resolved), fetch each
volume's .idx (CopyFile RPC), and report needles no filer entry points
at (orphans) plus filer chunks whose needle is missing (broken
references).  `-reallyDeleteFromVolume` purges orphans older than
`-cutoffMinutes` (recent needles may simply not be committed to filer
metadata yet — the reference applies the same cutoff guard).

A copy of seaweedfs_tpu/shell/command_fsck.py on the port's planes: the
`.idx` files come over the port's CopyFile rpc, manifest chunks and purges
go through server/http.py's client.
"""
from __future__ import annotations

import time
import urllib.parse

from ..filer.client import list_all_entries
from ..pb import filer_pb2, volume_server_pb2
from ..server.http import fetch
from ..storage import idx as idx_mod
from ..storage import types as t
from .commands import command, parse_flags


async def _fetch_manifest_fids(env, file_id, cipher_key, is_compressed, out):
    """Expand one manifest chunk's referenced fids (recursively)."""
    from ..operation import lookup_file_id

    from ..pb import server_address

    master = env.masters[0]
    urls = await lookup_file_id(server_address.http_address(master), file_id)
    blob = None
    for url in urls:
        parts = urllib.parse.urlsplit(url)
        try:
            status, _, body = await fetch(parts.netloc, "GET", parts.path)
        except (OSError, EOFError):
            continue
        if status < 300:
            blob = body
            break
    if blob is None:
        return
    if cipher_key:
        from ..utils.cipher import decrypt

        blob = decrypt(blob, bytes(cipher_key))
    if is_compressed:
        from ..utils.compression import decompress

        blob = decompress(blob)
    manifest = filer_pb2.FileChunkManifest.FromString(blob)
    for c in manifest.chunks:
        await _collect_chunk(env, c, out)


async def _collect_chunk(env, c, out) -> None:
    try:
        vid, nid, _ = t.parse_fid(c.file_id)
    except ValueError:
        return
    out.setdefault(vid, set()).add(nid)
    if c.is_chunk_manifest:
        await _fetch_manifest_fids(
            env, c.file_id, c.cipher_key, c.is_compressed, out
        )


async def _collect_filer_fids(env, stub, directory: str, out: dict) -> None:
    """fid references per volume: {vid: set(needle_id)} across the tree,
    manifest chunks expanded to the data chunks they hold."""
    for e in await list_all_entries(stub, directory):
        path = f"{directory.rstrip('/')}/{e.name}"
        if e.is_directory:
            await _collect_filer_fids(env, stub, path, out)
            continue
        for c in e.chunks:
            await _collect_chunk(env, c, out)


async def _volume_needles(env, node, vid: int, collection: str) -> set[int]:
    """Live needle ids of one volume, from its .idx via CopyFile."""
    blob = bytearray()
    async for resp in env.volume_stub(node.grpc_address).CopyFile(
        volume_server_pb2.CopyFileRequest(
            volume_id=vid, collection=collection, ext=".idx",
        )
    ):
        blob += resp.file_content
    ids, offs, sizes = idx_mod.parse_buffer(bytes(blob))
    live: set[int] = set()
    for i in range(len(ids)):
        if t.size_is_valid(int(sizes[i])):
            live.add(int(ids[i]))
        else:
            live.discard(int(ids[i]))
    return live


@command("volume.fsck")
async def cmd_volume_fsck(env, args):
    """[-reallyDeleteFromVolume] [-cutoffMinutes N] : find needles no
    filer entry references (orphans) and filer chunks whose needle is
    gone (command_volume_fsck.go)"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    purge = "reallyDeleteFromVolume" in flags
    cutoff_sec = int(flags.get("cutoffMinutes", "60")) * 60

    filer = await env.find_filer()
    fstub = env.filer_stub(filer)
    referenced: dict[int, set[int]] = {}
    await _collect_filer_fids(env, fstub, "/", referenced)

    nodes, _ = await env.collect_topology()
    orphans = purged = missing = 0
    seen_volumes: set[int] = set()
    ec_vids = {s["id"] for n in nodes for s in n.ec_shards}
    now = time.time()
    for node in nodes:
        for vinfo in node.volumes:
            vid = vinfo["id"]
            if vid in seen_volumes:
                continue  # replicas hold the same needles
            seen_volumes.add(vid)
            live = await _volume_needles(
                env, node, vid, vinfo["collection"]
            )
            refs = referenced.get(vid, set())
            lost = refs - live
            missing += len(lost)
            for nid in sorted(lost):
                env.write(
                    f"  missing: filer references {vid},{nid:x} "
                    f"but the volume lacks it"
                )
            for nid in sorted(live - refs):
                blob = await env.volume_stub(
                    node.grpc_address
                ).ReadNeedleBlob(
                    volume_server_pb2.ReadNeedleBlobRequest(
                        volume_id=vid, needle_id=nid
                    )
                )
                fid = t.format_fid(vid, nid, blob.cookie)
                if blob.last_modified and now - blob.last_modified < cutoff_sec:
                    env.write(
                        f"  orphan (recent, skipped): {fid} — younger "
                        f"than the {cutoff_sec // 60}m cutoff"
                    )
                    continue
                orphans += 1
                env.write(f"  orphan: {fid} not referenced by any filer entry")
                if purge:
                    _, jwt = await _fid_auth(env, fid)
                    headers = (
                        {"Authorization": f"BEARER {jwt}"} if jwt else {}
                    )
                    status, _, _ = await fetch(
                        node.url, "DELETE", f"/{fid}", headers=headers
                    )
                    if status < 300:
                        purged += 1
                    else:
                        env.write(
                            f"  purge of {fid} failed: HTTP {status}"
                        )
    # volumes the filer references but the topology no longer has
    for vid in sorted(set(referenced) - seen_volumes):
        if vid in ec_vids:
            env.write(
                f"  note: volume {vid} is EC-encoded; its needles are "
                "not cross-checked by this command"
            )
            continue
        missing += len(referenced[vid])
        env.write(
            f"  missing: volume {vid} is gone but the filer still "
            f"references {len(referenced[vid])} needles in it"
        )
    env.write(
        f"fsck: {len(seen_volumes)} volumes, {orphans} orphan needles"
        + (f" ({purged} purged)" if purge else "")
        + f", {missing} broken references"
    )


async def _fid_auth(env, fid: str):
    from ..operation.lookup import lookup_file_id_with_auth

    try:
        return await lookup_file_id_with_auth(env.masters[0], fid)
    except Exception:  # noqa: BLE001 — no auth configured
        return [], ""
