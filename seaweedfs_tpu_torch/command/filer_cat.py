"""`filer.cat` — stream one filer file to stdout
(reference: weed/command/filer_cat.go; the port of
seaweedfs_tpu/command/filer_cat.py on server/http.py's client)."""
from __future__ import annotations

import sys

NAME = "filer.cat"
HELP = "write a filer file's bytes to stdout"
STDOUT_STREAM = True  # piping into head/less is expected


def add_args(p) -> None:
    p.add_argument("url", help="filer file url: http://host:port/path/to/file")


async def run(args) -> None:
    import urllib.parse

    from ..server.http import Client
    from .filer_copy import _dest_parts

    filer, path = _dest_parts(args.url)
    host, _, port = filer.rpartition(":")
    c = Client(host, int(port))
    try:
        status, _ = await c.request_into(
            "GET", urllib.parse.quote(path), sys.stdout.buffer.write)
    finally:
        await c.close()
    if status >= 300:
        raise RuntimeError(f"{path}: HTTP {status}")
    sys.stdout.buffer.flush()
