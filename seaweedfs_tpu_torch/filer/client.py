"""Shared filer gRPC client helpers used by the gateways (WebDAV, FUSE
mount, S3) — the pieces of weed/pb/filer_pb_helper.go they all need.

A copy of seaweedfs_tpu/filer/client.py; it imports nothing of that
package.
"""
from __future__ import annotations

from ..pb import filer_pb2

_PAGE = 1024


async def list_all_entries(stub, directory: str) -> list[filer_pb2.Entry]:
    """Full paginated sweep of one directory (ListEntries pages by
    start_from_file_name, exclusive)."""
    out: list[filer_pb2.Entry] = []
    last = ""
    while True:
        n = 0
        async for resp in stub.ListEntries(
            filer_pb2.ListEntriesRequest(
                directory=directory, start_from_file_name=last, limit=_PAGE
            ),
            timeout=60.0,  # one page off a healthy filer is ms (GL114)
        ):
            out.append(resp.entry)
            last = resp.entry.name
            n += 1
        if n < _PAGE:
            return out
