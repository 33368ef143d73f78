"""Delete files by fid (reference: operation/delete_content.go); a copy of
seaweedfs_tpu/operation/delete.py on server/http.py's client instead of
aiohttp."""
from __future__ import annotations

import asyncio
import urllib.parse

from ..server.http import fetch
from .lookup import lookup_file_id_with_auth
from .upload import auth_headers


async def delete_file(master: str, fid: str) -> bool:
    urls, auth = await lookup_file_id_with_auth(master, fid)
    if not urls:
        return False
    parts = urllib.parse.urlsplit(urls[0])
    status, _, _ = await fetch(parts.netloc, "DELETE", parts.path,
                               auth_headers(auth))
    return status < 300


async def delete_files(master: str, fids: list[str]) -> int:
    results = await asyncio.gather(
        *(delete_file(master, fid) for fid in fids), return_exceptions=True
    )
    return sum(1 for r in results if r is True)
