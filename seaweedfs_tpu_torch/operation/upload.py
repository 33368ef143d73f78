"""Upload needle bytes to a volume server (reference:
operation/upload_content.go): the port of seaweedfs_tpu/operation/upload.py
on server/http.py's client instead of aiohttp.

The body is multipart/form-data with one `file` part, gzipped for
compressible types as the reference does, so the volume server stores the
same name, mime and data either way.
"""
from __future__ import annotations

import gzip
import json
import urllib.parse
import uuid

from ..server.http import Client

_COMPRESSIBLE = ("text/", "application/json", "application/xml", "application/javascript")


def _should_gzip(mime: str, data: bytes) -> bool:
    if len(data) < 128:
        return False
    return any(mime.startswith(p) for p in _COMPRESSIBLE)


def multipart_body(data: bytes, filename: str, mime: str,
                   gzipped: bool) -> tuple[bytes, str]:
    """-> (body, content type) of a one-part form upload."""
    boundary = uuid.uuid4().hex
    head = (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="file"; filename="{filename}"\r\n'
        f"Content-Type: {mime or 'application/octet-stream'}\r\n"
        + ("Content-Encoding: gzip\r\n" if gzipped else "")
        + "\r\n"
    ).encode()
    tail = f"\r\n--{boundary}--\r\n".encode()
    return head + data + tail, f"multipart/form-data; boundary={boundary}"


async def upload_data(
    url: str,
    data: bytes,
    filename: str = "",
    mime: str = "",
    retries: int = 2,
    client: Client | None = None,
) -> dict:
    """POST to http://volume/fid as multipart/form-data; returns the volume
    server's JSON ({name, size, eTag}).  `client` reuses a keep-alive
    connection to the same server."""
    body = data
    gzipped = False
    if _should_gzip(mime, data):
        gz = gzip.compress(data)
        if len(gz) < len(data) * 0.9:
            body = gz
            gzipped = True
    payload, ctype = multipart_body(body, filename or uuid.uuid4().hex, mime,
                                    gzipped)
    parts = urllib.parse.urlsplit(url)
    path = parts.path + (f"?{parts.query}" if parts.query else "")
    last_err: Exception | None = None
    for _ in range(retries + 1):
        c = client if client is not None else Client(parts.hostname, parts.port)
        try:
            status, _, resp = await c.request(
                "POST", path, {"Content-Type": ctype}, payload,
            )
            if status >= 300:
                raise RuntimeError(f"upload {url}: HTTP {status} {resp[:200]!r}")
            return json.loads(resp)
        except Exception as e:  # noqa: BLE001 — retry any transport error
            last_err = e
            if client is not None:
                await client.close()  # reconnect on the next try
        finally:
            if client is None:
                await c.close()
    raise RuntimeError(f"upload {url} failed after {retries + 1} tries: {last_err}")
