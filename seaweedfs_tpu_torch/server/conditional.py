"""Conditional GET/HEAD evaluation (If-None-Match / If-Modified-Since ->
304): a copy of seaweedfs_tpu/server/conditional.py, taking the port's
request object (server/http.py Request: `headers`, `query`).  The
reference's checkPreconditions at
weed/server/filer_server_handlers_read.go:60-80 and the needle ETag check
at volume_server_handlers_read.go:160-175: If-None-Match wins when
present; If-Modified-Since only consulted otherwise.
"""
from __future__ import annotations

import calendar
import time


def _canonical_etag(tag: str) -> str:
    tag = tag.strip()
    if tag.startswith("W/"):
        tag = tag[2:]
    return tag.strip('"')


def format_http_date(mtime: int | float) -> str:
    """unix seconds -> IMF-fixdate (the one formatter every server path
    shares)."""
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(mtime))


def parse_http_date(value: str) -> int | None:
    """IMF-fixdate -> unix seconds, or None when unparseable.  timegm, not
    mktime: the header is GMT by definition and the server's local
    timezone/DST must not skew comparisons."""
    try:
        return calendar.timegm(
            time.strptime(value, "%a, %d %b %Y %H:%M:%S GMT")
        )
    except ValueError:
        return None


def etag_matches(header_value: str, ours: str, weak: bool = True) -> bool:
    """Does any candidate in an If-(None-)Match header match our ETag?

    weak=True is RFC 7232's weak comparison (If-None-Match); weak=False is
    the STRONG comparison If-Match requires — a W/ candidate never
    matches."""
    ours_c = _canonical_etag(ours)
    for candidate in header_value.split(","):
        candidate = candidate.strip()
        if candidate == "*":
            return True
        if not weak and candidate.startswith("W/"):
            continue
        if _canonical_etag(candidate) == ours_c:
            return True
    return False


PERSISTED_HEADERS = ("Cache-Control", "Expires", "Content-Disposition")


def canonical_header(name: str) -> str:
    """HTTP header names are case-insensitive; canonicalize like Go's
    textproto (Cache-Control, Seaweed-Origin) so matching and storage
    never depend on the client's spelling."""
    return "-".join(p.capitalize() for p in name.split("-"))


def is_persisted_header(name: str) -> bool:
    ck = canonical_header(name)
    return ck in PERSISTED_HEADERS or ck.startswith("Seaweed-")


def persistable_headers(headers) -> dict[str, str]:
    """The upload headers an entry should carry and replay on reads
    (reference SaveAmzMetaData shape): caching/presentation headers plus
    Seaweed-* pairs, keys canonicalized.  ONE predicate shared by the
    filer write path, its read replay, and the S3 gateway's forward."""
    out: dict[str, str] = {}
    for k, v in headers.items():
        if is_persisted_header(k):
            out[canonical_header(k)] = v
    return out


def content_disposition(request, filename: str) -> str | None:
    """`inline; filename=...` for named entities, `attachment` when the
    ?dl= query flag asks for a download (reference
    adjustHeaderContentDisposition, server/common.go:268-282)."""
    if not filename:
        return None
    import urllib.parse

    kind = "inline"
    dl = request.query.get("dl", "")
    if dl.lower() in ("1", "true", "yes"):
        kind = "attachment"
    quoted = urllib.parse.quote(filename)
    return f'{kind}; filename="{quoted}"'


def not_modified(request, etag: str, mtime: int | float | None) -> bool:
    """True when the client's validators prove its cached copy is current.

    `etag` is the response's ETag value (quoted or not — canonicalized
    here); `mtime` is the entity's last-modified unix time (None/0 =
    unknown)."""
    inm = request.headers.get("If-None-Match", "")
    if inm:
        return etag_matches(inm, etag, weak=True)
    ims = request.headers.get("If-Modified-Since", "")
    if ims and mtime:
        since = parse_http_date(ims)
        if since is None:
            return False
        return int(mtime) <= since
    return False
