"""Chunk manifests: chunks-of-chunks for very large files.

A file that accumulates more than MANIFEST_BATCH chunks gets ranges of
them folded into manifest chunks whose data (stored as a normal blob on a
volume server) is a serialized FileChunkManifest; readers expand them
on demand.  Reference: weed/filer/filechunk_manifest.go
(maybeManifestize :136-192, ResolveChunkManifest :40-81).

A copy of seaweedfs_tpu/filer/manifest.py; it imports nothing of that
package.  The raw-fetch helpers of the gateways (`decoded_chunk_fetcher`,
`fetch_chunk_via_lookup`, `expand_data_chunks`) come with the first port
module that calls them.
"""
from __future__ import annotations

from ..pb import filer_pb2
from .filechunks import total_size

MANIFEST_BATCH = 1000


def resolve_chunk_manifest(lookup_fn, chunks, start_offset: int, stop_offset: int):
    """Expand manifest chunks overlapping [start, stop).

    lookup_fn(file_id) -> bytes — fetches a manifest blob.
    Returns (data_chunks, manifest_chunks).
    """
    data_chunks: list = []
    manifest_chunks: list = []
    for c in chunks:
        if not c.is_chunk_manifest:
            data_chunks.append(c)
            continue
        manifest_chunks.append(c)
        if c.offset + int(c.size) <= start_offset or c.offset >= stop_offset:
            continue
        m = filer_pb2.FileChunkManifest.FromString(lookup_fn(c.file_id))
        sub, sub_manifests = resolve_chunk_manifest(
            lookup_fn, list(m.chunks), start_offset, stop_offset
        )
        data_chunks.extend(sub)
        manifest_chunks.extend(sub_manifests)
    return data_chunks, manifest_chunks


async def expand_manifest_chunks(fetch_decoded, chunks):
    """Async manifest expansion: -> (data_chunks, manifest_chunks), with
    manifest chunks resolved recursively through `fetch_decoded` (async
    FileChunk -> decoded manifest blob; see decoded_chunk_fetcher).  The
    async counterpart of resolve_chunk_manifest for callers whose chunk
    fetch is a network call (sinks, mounts, the filer's GC)."""
    data: list = []
    meta: list = []
    for c in chunks:
        if not c.is_chunk_manifest:
            data.append(c)
            continue
        meta.append(c)
        m = filer_pb2.FileChunkManifest.FromString(await fetch_decoded(c))
        sub_data, sub_meta = await expand_manifest_chunks(
            fetch_decoded, m.chunks
        )
        data.extend(sub_data)
        meta.extend(sub_meta)
    return data, meta


async def maybe_manifestize_async(save_async, chunks, batch: int = MANIFEST_BATCH):
    """maybe_manifestize with an async blob saver: first pass collects the
    manifest blobs to store, they upload via `save_async(bytes) ->
    FileChunk`, and a second identical pass folds with the real chunks."""
    pending: list[bytes] = []

    def collect(blob: bytes) -> filer_pb2.FileChunk:
        pending.append(blob)
        return filer_pb2.FileChunk(file_id="pending")

    maybe_manifestize(collect, chunks, batch)
    if not pending:
        return list(chunks)
    uploaded = {}
    for blob in pending:
        uploaded[blob] = await save_async(blob)
    return maybe_manifestize(lambda b: uploaded[b], chunks, batch)


def maybe_manifestize(save_fn, chunks, batch: int = MANIFEST_BATCH):
    """If too many non-manifest chunks, fold batches of them into manifest
    chunks.  save_fn(bytes) -> FileChunk for the stored manifest blob."""
    unmergeable = [c for c in chunks if c.is_chunk_manifest]
    mergeable = [c for c in chunks if not c.is_chunk_manifest]
    if len(mergeable) <= batch:
        return chunks
    out = list(unmergeable)
    for i in range(0, len(mergeable) - len(mergeable) % batch, batch):
        out.append(_manifestize(save_fn, mergeable[i : i + batch]))
    out.extend(mergeable[len(mergeable) - len(mergeable) % batch :])
    return out


def _manifestize(save_fn, group) -> filer_pb2.FileChunk:
    group = sorted(group, key=lambda c: c.offset)
    blob = filer_pb2.FileChunkManifest(chunks=group).SerializeToString()
    start = min(c.offset for c in group)
    saved = save_fn(blob)
    return filer_pb2.FileChunk(
        file_id=saved.file_id,
        offset=start,
        size=max(c.offset + int(c.size) for c in group) - start,
        modified_ts_ns=max(c.modified_ts_ns for c in group),
        e_tag=saved.e_tag,
        is_chunk_manifest=True,
        # the manifest blob itself may be encrypted/compressed by the
        # uploader — readers need these to decode it
        cipher_key=saved.cipher_key,
        is_compressed=saved.is_compressed,
    )
