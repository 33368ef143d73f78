"""`filer.backup` — mirror filer DATA to a local directory or an
object-store backend (reference: weed/command/filer_backup.go, which
streams metadata events into local-disk/S3/GCS/... sinks).  First run
replays the subtree from the filer; the metadata subscription then
applies live creates/updates/deletes.  Progress (the last applied event
timestamp) persists in the target (dir or store), so a restart resumes
from where it stopped instead of re-copying.

The port of seaweedfs_tpu/command/filer_backup.py on server/http.py's
client.  `-remote` takes the port's storage backends: the `local` type (an
`s3` section is refused until the port has an S3 client)."""
from __future__ import annotations

import os

NAME = "filer.backup"
HELP = "continuously mirror a filer path to a local dir or object store"


def add_args(p) -> None:
    p.add_argument("-filer", required=True, help="filer host:port")
    p.add_argument("-path", default="/", help="filer subtree to mirror")
    p.add_argument("-dir", dest="target", default="", help="local target dir")
    p.add_argument(
        "-remote", default="",
        help="object-store target instead of a local dir: "
        "<type.id>[/keyPrefix] from master.toml [storage.backend] "
        "(s3.x backs up into a bucket, the reference's S3 sink)",
    )
    p.add_argument(
        "-oneTime", action="store_true",
        help="stop after the initial replay instead of tailing forever",
    )


PROGRESS_FILE = ".filer_backup_progress"


def _rel(root: str, full: str) -> str:
    return full[len(root):].strip("/")


class _LocalTarget:
    """Filesystem sink (the original filer.backup behavior)."""

    def __init__(self, target: str):
        self.target = target
        os.makedirs(target, exist_ok=True)
        self._progress = os.path.join(target, PROGRESS_FILE)

    def _path(self, rel: str) -> str:
        return os.path.join(self.target, rel) if rel else self.target

    def read_progress(self) -> int:
        if os.path.exists(self._progress):
            with open(self._progress) as f:
                return int(f.read().strip() or 0)
        return 0

    async def write_progress(self, ts_ns: int) -> None:
        from ..utils.aiofile import write_file_text

        await write_file_text(self._progress, str(ts_ns))

    async def mkdir(self, rel: str) -> None:
        os.makedirs(self._path(rel), exist_ok=True)

    async def store_file(self, rel: str, tmp_path: str) -> None:
        p = self._path(rel)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        os.replace(tmp_path, p)

    async def delete(self, rel: str) -> None:
        import shutil

        p = self._path(rel)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        elif os.path.exists(p):
            os.remove(p)

    def describe(self) -> str:
        return self.target


class _RemoteTarget:
    """Object-store sink over a storage backend (s3/local) — the
    reference's S3 backup sink role, minus the SDK."""

    def __init__(self, remote: str):
        from ..storage import backend as backend_mod

        self.storage, self.prefix = backend_mod.backend_from_spec(remote)

    def _key(self, rel: str) -> str:
        return f"{self.prefix}/{rel}" if self.prefix else rel

    def read_progress(self) -> int:
        try:
            return int(self.storage.get_bytes(self._key(PROGRESS_FILE)) or 0)
        except (FileNotFoundError, ValueError):
            return 0

    async def write_progress(self, ts_ns: int) -> None:
        import asyncio

        await asyncio.to_thread(
            self.storage.put_bytes, self._key(PROGRESS_FILE),
            str(ts_ns).encode(),
        )

    async def mkdir(self, rel: str) -> None:
        pass  # object stores have no directories

    async def store_file(self, rel: str, tmp_path: str) -> None:
        import asyncio

        try:
            # upload() streams from the file (multipart for big objects)
            await asyncio.to_thread(
                self.storage.upload, tmp_path, self._key(rel)
            )
        finally:
            if os.path.exists(tmp_path):
                os.remove(tmp_path)

    async def delete(self, rel: str) -> None:
        import asyncio

        key = self._key(rel)
        keys = await asyncio.to_thread(self.storage.list_keys, key)
        for k, _ in keys or [(key, 0)]:
            if k == key or k.startswith(key + "/"):
                await asyncio.to_thread(self.storage.delete_key, k)

    def describe(self) -> str:
        return self.storage.name + (f"/{self.prefix}" if self.prefix else "")


async def run(args) -> None:
    import time

    from ..pb import Stub, channel, filer_pb2, server_address
    from ..server.http import Client

    if bool(args.target) == bool(args.remote):
        raise SystemExit("exactly one of -dir / -remote required")
    import asyncio

    target = _RemoteTarget(args.remote) if args.remote else _LocalTarget(args.target)

    root = "/" + args.path.strip("/") if args.path != "/" else "/"
    filer_http = server_address.http_address(args.filer)
    # progress read may be a network call (s3): off-loop
    since_ns = await asyncio.to_thread(target.read_progress)

    stub = Stub(
        channel(server_address.grpc_address(args.filer)),
        filer_pb2,
        "SeaweedFiler",
    )

    host, _, port = filer_http.rpartition(":")
    client = Client(host, int(port))
    try:

        async def backup_file(full: str) -> bool:
            """Stream the file to a local temp, then hand it to the target
            (local: rename into place; remote: streamed/multipart upload)
            — never the whole file in memory."""
            import tempfile
            import urllib.parse

            fd, tmp = tempfile.mkstemp(prefix=".filer_backup_")
            f = os.fdopen(fd, "wb")  # takes fd ownership immediately
            try:
                status, _ = await client.request_into(
                    "GET", urllib.parse.quote(full), f.write)
                if status >= 300:
                    print(f"skip {full}: HTTP {status}")
                    f.close()
                    os.remove(tmp)
                    return False
                f.close()
                await target.store_file(_rel(root, full), tmp)
                return True
            except BaseException:
                f.close()
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise

        async def replay(directory: str) -> int:
            from ..filer.client import list_all_entries

            n = 0
            for e in await list_all_entries(stub, directory):
                full = f"{directory.rstrip('/')}/{e.name}"
                if e.is_directory:
                    await target.mkdir(_rel(root, full))
                    n += await replay(full)
                elif await backup_file(full):
                    n += 1
            return n

        if since_ns == 0:
            start_ns = time.time_ns()
            n = await replay(root)
            since_ns = start_ns
            await target.write_progress(since_ns)
            print(f"initial replay: {n} files into {target.describe()}")
        if args.oneTime:
            return

        print(f"tailing {root} on {filer_http} from ts {since_ns}")
        async for ev in stub.SubscribeMetadata(
            filer_pb2.SubscribeMetadataRequest(
                client_name="filer.backup",
                path_prefix=root if root != "/" else "",
                since_ns=since_ns,
            )
        ):
            note = ev.event_notification
            directory = ev.directory
            if note.HasField("old_entry") and (
                not note.HasField("new_entry") or note.new_parent_path
            ):
                old_full = f"{directory.rstrip('/')}/{note.old_entry.name}"
                await target.delete(_rel(root, old_full))
                print(f"- {old_full}")
            if note.HasField("new_entry"):
                new_dir = note.new_parent_path or directory
                full = f"{new_dir.rstrip('/')}/{note.new_entry.name}"
                if note.new_entry.is_directory:
                    await target.mkdir(_rel(root, full))
                else:
                    await backup_file(full)
                print(f"+ {full}")
            await target.write_progress(ev.ts_ns)
    finally:
        await client.close()
