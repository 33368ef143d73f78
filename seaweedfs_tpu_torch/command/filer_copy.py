"""`filer.copy` — copy local files/directories into the filer
(reference: weed/command/filer_copy.go; the port of
seaweedfs_tpu/command/filer_copy.py on server/http.py's client).  Uploads go through the filer's
HTTP auto-chunking endpoint, so large files are chunked and small ones
inlined exactly as browser/API uploads are."""
from __future__ import annotations

import os

NAME = "filer.copy"
HELP = "copy local files or directories to the filer"


def add_args(p) -> None:
    p.add_argument("sources", nargs="+", help="local files/directories")
    p.add_argument(
        "dest",
        help="filer destination: http://host:port/dir/ (trailing slash = into dir)",
    )
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttl", default="")
    p.add_argument(
        "-include", default="",
        help="fnmatch pattern; only matching file names are copied",
    )


def _dest_parts(dest: str) -> tuple[str, str]:
    """'http://host:port/path/' -> (host:port, /path/)."""
    rest = dest.partition("://")[2] or dest
    host, slash, path = rest.partition("/")
    return host, "/" + path


async def run(args) -> None:
    import fnmatch
    import urllib.parse

    from ..server.http import Client
    from ..utils.aiofile import open_in_thread

    filer, dest_path = _dest_parts(args.dest)
    into_dir = dest_path.endswith("/")
    q = {}
    if args.collection:
        q["collection"] = args.collection
    if args.replication:
        q["replication"] = args.replication
    if args.ttl:
        q["ttl"] = args.ttl
    qs = "&".join(f"{k}={v}" for k, v in q.items())
    copied = 0
    host, _, port = filer.rpartition(":")
    client = Client(host, int(port))

    async def put_file(local: str, remote: str) -> None:
        nonlocal copied
        path = urllib.parse.quote(remote) + (f"?{qs}" if qs else "")
        # the file streams from a worker thread's reads (open and
        # close too), never whole in memory
        async with open_in_thread(local, "rb") as f:
            status, _, text = await client.request("PUT", path, body=f)
        if status >= 300:
            raise RuntimeError(
                f"{local} -> {remote}: HTTP {status} "
                f"{text.decode(errors='replace')}"
            )
        copied += 1
        print(f"{local} -> {remote}")

    for src in args.sources:
        if os.path.isdir(src):
            base = os.path.basename(os.path.abspath(src))
            for root, _, files in os.walk(src):
                rel_root = os.path.relpath(root, src)
                for name in sorted(files):
                    if args.include and not fnmatch.fnmatch(
                        name, args.include
                    ):
                        continue
                    rel = (
                        name if rel_root == "."
                        else f"{rel_root}/{name}"
                    )
                    remote = (
                        f"{dest_path.rstrip('/')}/{base}/{rel}"
                    )
                    await put_file(os.path.join(root, name), remote)
        else:
            if args.include and not fnmatch.fnmatch(
                os.path.basename(src), args.include
            ):
                continue
            remote = (
                f"{dest_path.rstrip('/')}/{os.path.basename(src)}"
                if into_dir
                else dest_path
            )
            await put_file(src, remote)
    await client.close()
    print(f"copied {copied} files to http://{filer}{dest_path}")
