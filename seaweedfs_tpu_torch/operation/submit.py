"""assign + upload in one call (reference: operation/submit.go); a copy of
seaweedfs_tpu/operation/submit.py."""
from __future__ import annotations

from .assign import assign
from .upload import upload_data


async def submit_data(
    master: str,
    data: bytes,
    filename: str = "",
    mime: str = "",
    collection: str = "",
    replication: str = "",
    ttl: str = "",
) -> str:
    """Returns the fid of the stored blob."""
    a = await assign(
        master, collection=collection, replication=replication, ttl=ttl
    )
    await upload_data(f"http://{a.url}/{a.fid}", data, filename, mime, jwt=a.auth)
    return a.fid
