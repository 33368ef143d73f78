"""fs.* commands: filer namespace operations from the admin shell.

Reference: weed/shell/command_fs_ls.go, _cat.go, _du.go, _rm.go,
_mkdir.go, _mv.go — the shell resolves a filer via the master's cluster
registry and drives its RPC surface.

A copy of seaweedfs_tpu/shell/command_fs.py on the port's planes (RPCs on
pb/rpc.py, HTTP on server/http.py's client).  `fs.meta.notify` waits for
replication/'s notifiers (ROADMAP A10).
"""
from __future__ import annotations

import time
import urllib.parse

from ..filer.client import list_all_entries
from ..pb import RpcError, StatusCode, filer_pb2, server_address
from ..server.http import fetch
from .commands import command


def _split(path: str) -> tuple[str, str]:
    path = "/" + path.strip("/")
    d, _, name = path.rpartition("/")
    return d or "/", name


def _cwd(env) -> str:
    return env.option.get("fs_cwd", "/")


def _resolve(env, p: str | None) -> str:
    """Join a (possibly relative) shell path against fs.cd's cwd, with
    `.`/`..` normalization (the reference shell keeps the same state in
    commandEnv.option.Directory)."""
    if not p:
        return _cwd(env)
    base = "/" if p.startswith("/") else _cwd(env)
    out = [x for x in base.strip("/").split("/") if x]
    for x in p.split("/"):
        if not x or x == ".":
            continue
        if x == "..":
            if out:
                out.pop()
        else:
            out.append(x)
    return "/" + "/".join(out)


async def _stub(env):
    return env.filer_stub(await env.find_filer())


async def _lookup(stub, path: str):
    d, name = _split(path)
    try:
        resp = await stub.LookupDirectoryEntry(
            filer_pb2.LookupDirectoryEntryRequest(directory=d, name=name)
        )
    except RpcError as e:
        if e.code() == StatusCode.NOT_FOUND:
            return None
        raise
    return resp.entry if resp.HasField("entry") else None


def _fmt_size(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024


def _entry_size(e: filer_pb2.Entry) -> int:
    extent = max((c.offset + int(c.size) for c in e.chunks), default=0)
    return max(e.attributes.file_size, extent, len(e.content))


async def _walk_entries(stub, directory: str):
    """DFS over a filer subtree; yields (dir, entry) with parents before
    children (shared by fs.du and fs.meta.save)."""
    for e in await list_all_entries(stub, directory):
        yield directory, e
        if e.is_directory:
            async for pair in _walk_entries(
                stub, f"{directory.rstrip('/')}/{e.name}"
            ):
                yield pair


def _positional(args: list[str], value_flags: set[str] = frozenset()) -> list[str]:
    """Non-flag tokens; tokens consumed as a value flag's argument (e.g.
    `-o FILE`) are excluded."""
    out = []
    skip = False
    for i, a in enumerate(args):
        if skip:
            skip = False
            continue
        if a.startswith("-"):
            name = a.lstrip("-").partition("=")[0]
            if name in value_flags and "=" not in a and i + 1 < len(args):
                skip = True
            continue
        out.append(a)
    return out


@command("fs.ls")
async def cmd_fs_ls(env, args):
    """[-l] /dir : list a filer directory"""
    long_form = "-l" in args
    pos = _positional(args)
    path = _resolve(env, pos[0] if pos else None)
    stub = await _stub(env)
    for e in await list_all_entries(stub, path or "/"):
        if long_form:
            a = e.attributes
            kind = "d" if e.is_directory else "-"
            env.write(
                f"{kind}{a.file_mode & 0o777:03o} "
                f"{_fmt_size(_entry_size(e)):>10} "
                f"{time.strftime('%Y-%m-%d %H:%M', time.localtime(a.mtime or 0))} "
                f"{e.name}{'/' if e.is_directory else ''}"
            )
        else:
            env.write(e.name + ("/" if e.is_directory else ""))


@command("fs.cat")
async def cmd_fs_cat(env, args):
    """/path/to/file : print a filer file's contents"""
    pos = _positional(args)
    if not pos:
        env.write("usage: fs.cat /path")
        return
    path = _resolve(env, pos[0])
    filer = await env.find_filer()
    status, _, body = await fetch(
        server_address.http_address(filer), "GET", urllib.parse.quote(path))
    if status >= 300:
        env.write(f"fs.cat {path}: HTTP {status}")
        return
    env.write(body.decode(errors="replace"))


@command("fs.du")
async def cmd_fs_du(env, args):
    """/dir : disk usage of a filer subtree"""
    pos = _positional(args)
    path = _resolve(env, pos[0] if pos else None)
    stub = await _stub(env)
    files = dirs = size = 0
    async for _, e in _walk_entries(stub, path or "/"):
        if e.is_directory:
            dirs += 1
        else:
            files += 1
            size += _entry_size(e)
    env.write(
        f"{path or '/'}: {_fmt_size(size)} in {files} files, {dirs} dirs"
    )


@command("fs.mkdir")
async def cmd_fs_mkdir(env, args):
    """/dir/path : create a filer directory (and parents)"""
    pos = _positional(args)
    if not pos:
        env.write("usage: fs.mkdir /dir")
        return
    path = _resolve(env, pos[0])
    stub = await _stub(env)
    existing = await _lookup(stub, path)
    if existing is not None:
        if existing.is_directory:
            env.write(f"{path} already exists")
        else:
            env.write(f"fs.mkdir {path}: a file is in the way")
        return
    # one leaf create: the filer auto-creates parents and refuses to
    # thread a directory through an existing file
    d, name = _split(path)
    resp = await stub.CreateEntry(
        filer_pb2.CreateEntryRequest(
            directory=d,
            entry=filer_pb2.Entry(
                name=name, is_directory=True,
                attributes=filer_pb2.FuseAttributes(
                    file_mode=0o770, mtime=int(time.time()),
                ),
            ),
        )
    )
    if resp.error:
        env.write(f"fs.mkdir {path}: {resp.error}")
    else:
        env.write(f"created {path}")


@command("fs.rm")
async def cmd_fs_rm(env, args):
    """[-r] /path : delete a filer file or (with -r) directory tree"""
    recursive = "-r" in args
    pos = _positional(args)
    if not pos:
        env.write("usage: fs.rm [-r] /path")
        return
    path = _resolve(env, pos[0])
    d, name = _split(path)
    stub = await _stub(env)
    if await _lookup(stub, path) is None:
        env.write(f"fs.rm {path}: no such file or directory")
        return
    resp = await stub.DeleteEntry(
        filer_pb2.DeleteEntryRequest(
            directory=d, name=name, is_delete_data=True,
            is_recursive=recursive, ignore_recursive_error=False,
        )
    )
    if resp.error:
        env.write(f"fs.rm {path}: {resp.error}")
    else:
        env.write(f"deleted {path}")


@command("fs.mv")
async def cmd_fs_mv(env, args):
    """/src /dst : move/rename within the filer"""
    parts = _positional(args)
    if len(parts) != 2:
        env.write("usage: fs.mv /src /dst")
        return
    src, dst = (_resolve(env, p) for p in parts)
    sd, sn = _split(src)
    dd, dn = _split(dst)
    stub = await _stub(env)
    await stub.AtomicRenameEntry(
        filer_pb2.AtomicRenameEntryRequest(
            old_directory=sd, old_name=sn,
            new_directory=dd, new_name=dn,
        )
    )
    env.write(f"moved {src} -> {dst}")


@command("fs.meta.save")
async def cmd_fs_meta_save(env, args):
    """[-o file] [/dir] : dump the filer metadata tree as length-prefixed
    FullEntry protos (command_fs_meta_save.go wire shape)"""
    import struct

    from .commands import parse_flags

    flags = parse_flags(args)
    pos = _positional(args, value_flags={"o"})
    root = _resolve(env, pos[0] if pos else None)
    out_path = flags.get("o", "filer-meta.bin")
    stub = await _stub(env)
    n = 0
    import asyncio

    from ..utils.aiofile import open_in_thread

    # file IO via to_thread: the shell shares its loop with the
    # in-flight ListEntries stream feeding _walk_entries.  Records are
    # buffered and flushed in ~1MB slabs — one executor hop per slab,
    # not two per entry
    buf = bytearray()
    async with open_in_thread(out_path, "wb") as f:
        async for d, e in _walk_entries(stub, root or "/"):
            fe = filer_pb2.FullEntry(dir=d, entry=e)
            blob = fe.SerializeToString()
            # big-endian length prefix: byte-compatible with the
            # reference's fs.meta.save files (util.Uint32toBytes)
            buf += struct.pack(">I", len(blob)) + blob
            n += 1
            if len(buf) >= 1 << 20:
                await asyncio.to_thread(f.write, bytes(buf))
                buf.clear()
        if buf:
            await asyncio.to_thread(f.write, bytes(buf))
    env.write(f"saved {n} entries from {root or '/'} to {out_path}")


@command("fs.meta.load")
async def cmd_fs_meta_load(env, args):
    """-i file : restore filer metadata saved by fs.meta.save (entries
    only — chunk data must still exist in the cluster)"""
    import struct

    from .commands import parse_flags

    flags = parse_flags(args)
    pos = _positional(args, value_flags={"i"})
    in_path = flags.get("i") or (pos[0] if pos else "")
    if not in_path:
        env.write("usage: fs.meta.load -i file")
        return
    stub = await _stub(env)
    n = 0
    import asyncio

    from ..utils.aiofile import open_in_thread

    # stream in ~1MB slabs through to_thread and parse records from the
    # rolling buffer: one executor hop per slab (not two per entry) and
    # constant memory even for multi-GB backups
    async with open_in_thread(in_path, "rb") as f:
        buf = b""
        eof = False
        while True:
            while not eof and (
                len(buf) < 4 or len(buf) < 4 + struct.unpack(
                    ">I", buf[:4]
                )[0]
            ):
                chunk = await asyncio.to_thread(f.read, 1 << 20)
                if not chunk:
                    eof = True
                    break
                buf += chunk
            if len(buf) < 4:
                break
            (size,) = struct.unpack(">I", buf[:4])
            blob, buf = buf[4 : 4 + size], buf[4 + size :]
            if len(blob) < size:
                env.write(
                    f"warning: truncated backup — last record dropped"
                )
                break
            fe = filer_pb2.FullEntry.FromString(blob)
            resp = await stub.CreateEntry(
                filer_pb2.CreateEntryRequest(directory=fe.dir, entry=fe.entry)
            )
            if resp.error:
                env.write(f"{fe.dir}/{fe.entry.name}: {resp.error}")
                continue
            n += 1
    env.write(f"restored {n} entries from {in_path}")


@command("fs.pwd")
async def cmd_fs_pwd(env, args):
    """print the shell's current filer directory (command_fs_pwd.go)"""
    env.write(_cwd(env))


@command("fs.cd")
async def cmd_fs_cd(env, args):
    """/dir | relative/dir | .. : change the shell's current filer
    directory (command_fs_cd.go)"""
    pos = _positional(args)
    path = _resolve(env, pos[0] if pos else "/")
    if path != "/":
        stub = await _stub(env)
        e = await _lookup(stub, path)
        if e is None or not e.is_directory:
            env.write(f"fs.cd {path}: no such directory")
            return
    env.option["fs_cwd"] = path


@command("fs.tree")
async def cmd_fs_tree(env, args):
    """[/dir] : recursively print the filer subtree (command_fs_tree.go)"""
    pos = _positional(args)
    root = _resolve(env, pos[0] if pos else None)
    stub = await _stub(env)
    files = dirs = 0

    async def walk(directory: str, depth: int):
        nonlocal files, dirs
        for e in await list_all_entries(stub, directory):
            env.write("  " * depth + e.name + ("/" if e.is_directory else ""))
            if e.is_directory:
                dirs += 1
                await walk(f"{directory.rstrip('/')}/{e.name}", depth + 1)
            else:
                files += 1

    env.write(root)
    await walk(root, 1)
    env.write(f"{dirs} directories, {files} files")


@command("fs.meta.cat")
async def cmd_fs_meta_cat(env, args):
    """/path : print one entry's metadata as the raw pb text
    (command_fs_meta_cat.go)"""
    pos = _positional(args)
    if not pos:
        env.write("usage: fs.meta.cat /path")
        return
    path = _resolve(env, pos[0])
    stub = await _stub(env)
    e = await _lookup(stub, path)
    if e is None:
        env.write(f"fs.meta.cat {path}: not found")
        return
    env.write(str(e))


@command("fs.verify")
async def cmd_fs_verify(env, args):
    """[-v] [/dir] : check that every file chunk under the subtree is
    readable from some volume server (command_fs_verify.go)"""
    from ..operation.lookup import lookup_file_id

    verbose = "-v" in args
    pos = _positional(args)
    root = _resolve(env, pos[0] if pos else None)
    stub = await _stub(env)
    master = env.masters[0]
    ok = broken = 0
    vol_locations: dict[str, list[str]] = {}  # vid -> server urls (cached)
    async for d, e in _walk_entries(stub, root):
        if e.is_directory:
            continue
        for c in e.chunks:
            fid = c.file_id
            vid = fid.partition(",")[0]
            try:
                if vid not in vol_locations:
                    urls = await lookup_file_id(master, fid)
                    vol_locations[vid] = [
                        u.rsplit("/", 1)[0] for u in urls
                    ]
                servers = vol_locations[vid]
                if not servers:
                    raise RuntimeError("no locations")
                status, _, _ = await fetch(
                    urllib.parse.urlsplit(servers[0]).netloc, "HEAD",
                    f"/{fid}")
                if status >= 300:
                    raise RuntimeError(f"HTTP {status}")
                ok += 1
                if verbose:
                    env.write(f"  ok {d}/{e.name} chunk {fid}")
            except Exception as err:  # noqa: BLE001
                broken += 1
                env.write(
                    f"  BROKEN {d}/{e.name} chunk {fid}: {err}"
                )
    env.write(f"verified {ok} chunks, {broken} broken")


@command("fs.configure")
async def cmd_fs_configure(env, args):
    """[-locationPrefix /p/ -collection c -replication XYZ -ttl 1h
    -disk ssd -readOnly] [-delete] [-apply] : view or edit per-path
    storage rules in /etc/seaweedfs/filer.conf (command_fs_configure.go).
    Without -apply the resulting conf is printed but not saved."""
    from .commands import parse_flags
    from ..filer.path_conf import CONF_DIR, CONF_NAME, CONF_PATH, FilerConf, PathConf

    flags = parse_flags(args)
    stub = await _stub(env)
    existing = await _lookup(stub, CONF_PATH)
    conf = FilerConf.from_bytes(
        bytes(existing.content) if existing is not None else b""
    )
    prefix = flags.get("locationPrefix", "")
    if prefix:
        if "delete" in flags:
            if not conf.delete(prefix):
                env.write(f"no rule for {prefix}")
        else:
            # merge into any existing rule: fields not passed on THIS
            # invocation survive (so editing the ttl can't silently clear
            # a quota lock's read_only flag, and vice versa)
            rule = next(
                (
                    l
                    for l in conf.locations
                    if l.location_prefix == prefix
                ),
                PathConf(location_prefix=prefix),
            )
            if "collection" in flags:
                rule.collection = flags["collection"]
            if "replication" in flags:
                rule.replication = flags["replication"]
            if "ttl" in flags:
                rule.ttl = flags["ttl"]
            if "disk" in flags:
                rule.disk_type = flags["disk"]
            if "readOnly" in flags:
                rule.read_only = flags["readOnly"] != "false"
            conf.upsert(rule)
    env.write(conf.to_bytes().decode())
    if "apply" not in flags:
        if prefix:
            env.write("(not saved — add -apply)")
        return
    from ..filer.path_conf import save_conf_entry

    await save_conf_entry(stub, CONF_DIR, CONF_NAME, conf.to_bytes())
    env.write(f"saved {CONF_PATH}")


@command("fs.meta.change.volume.id")
async def cmd_fs_meta_change_volume_id(env, args):
    """-from N -to M [-force] [/dir] : rewrite chunk volume ids in filer
    metadata after a volume id migration (command_fs_meta_change_volume_id.go)"""
    from .commands import parse_flags

    env.confirm_is_locked()
    flags = parse_flags(args)
    vid_from = int(flags["from"])
    vid_to = int(flags["to"])
    apply = "force" in flags
    pos = _positional(args, value_flags={"from", "to"})
    root = _resolve(env, pos[0] if pos else None)
    stub = await _stub(env)
    changed = skipped = 0
    async for d, e in _walk_entries(stub, root):
        if e.is_directory:
            continue
        if any(c.is_chunk_manifest for c in e.chunks):
            # nested chunk ids live in a serialized manifest blob this
            # command can't rewrite — claiming success would leave reads
            # pointing at the old volume
            env.write(
                f"{d.rstrip('/')}/{e.name}: has manifest chunks — "
                f"skipped (re-write the file to re-home it)"
            )
            skipped += 1
            continue
        hit = False
        for c in e.chunks:
            vid_s, _, rest = c.file_id.partition(",")
            if vid_s and int(vid_s) == vid_from:
                hit = True
                if apply:
                    c.file_id = f"{vid_to},{rest}"
        if not hit:
            continue
        env.write(f"{d.rstrip('/')}/{e.name}: volume {vid_from} -> {vid_to}")
        if apply:
            await stub.UpdateEntry(
                filer_pb2.UpdateEntryRequest(directory=d, entry=e)
            )
        changed += 1
    env.write(
        f"{changed} entries{' rewritten' if apply else ' affected (use -force)'}"
        + (f", {skipped} skipped (manifest chunks)" if skipped else "")
    )
