"""`download` — fetch files by fid
(reference: weed/command/download.go; the port of
seaweedfs_tpu/command/download.py on server/http.py's client instead of
aiohttp)."""
from __future__ import annotations

import os
import urllib.parse

NAME = "download"
HELP = "download files by fid via master lookup"


def add_args(p) -> None:
    p.add_argument("fids", nargs="+", help="file ids (vid,key...)")
    p.add_argument(
        "-master", dest="master", default="127.0.0.1:9333", help="master host:port"
    )
    p.add_argument("-dir", default=".", help="output directory")


async def run(args) -> None:
    from ..operation import lookup_file_id
    from ..server.http import fetch_following
    from ..utils.aiofile import write_file_bytes

    os.makedirs(args.dir, exist_ok=True)
    for fid in args.fids:
        urls = await lookup_file_id(args.master, fid)
        if not urls:
            raise SystemExit(f"{fid}: no locations")
        data = None
        last = None
        for url in urls:
            parts = urllib.parse.urlsplit(url)
            try:
                status, _, body = await fetch_following(
                    parts.netloc, "GET", parts.path)
                if status < 300:
                    data = body
                    break
                last = f"HTTP {status}"
            except (ConnectionError, OSError) as e:
                last = str(e)
        if data is None:
            raise SystemExit(f"{fid}: all replicas failed ({last})")
        out = os.path.join(args.dir, fid.replace(",", "_"))
        await write_file_bytes(out, data)
        print(f"{fid} -> {out} ({len(data)} bytes)")
