"""Chunk interval algebra: overlapping FileChunk lists → visible intervals
→ ChunkViews.

A file is a list of FileChunks, each covering [offset, offset+size) of the
logical file and stamped with modified_ts_ns; later writes shadow earlier
ones.  `read_resolved_chunks` computes the non-overlapping visible
intervals; `view_from_chunks` clips them to a read range, producing the
(fid, offset-in-chunk, size) fetch plan.

Reference behavior: weed/filer/filechunks.go:183-291 (ViewFromChunks /
NonOverlappingVisibleIntervals), filechunks_read.go (readResolvedChunks).
The implementation here is an interval-overwrite list rather than the
reference's sweep-line queue: chunks are applied oldest-first to a sorted
list of disjoint intervals, each new chunk clipping whatever it overlaps.

A copy of seaweedfs_tpu/filer/filechunks.py; it imports nothing of that
package.
"""
from __future__ import annotations

import hashlib
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, replace

from ..pb import filer_pb2

MAX_INT64 = (1 << 63) - 1


@dataclass
class VisibleInterval:
    start: int
    stop: int
    modified_ts_ns: int
    file_id: str
    offset_in_chunk: int  # where `start` falls inside the chunk
    chunk_size: int
    cipher_key: bytes
    is_gzipped: bool


@dataclass
class ChunkView:
    file_id: str
    offset_in_chunk: int
    view_size: int
    view_offset: int  # offset within the logical file
    chunk_size: int
    cipher_key: bytes
    is_gzipped: bool
    modified_ts_ns: int

    @property
    def is_full_chunk(self) -> bool:
        return self.view_size == self.chunk_size


def total_size(chunks) -> int:
    """Logical file size implied by a chunk list (filechunks.go TotalSize)."""
    size = 0
    for c in chunks:
        size = max(size, c.offset + int(c.size))
    return size


def file_size(entry) -> int:
    """Entry size: max of attribute file_size and chunk extent
    (filer/filechunks.go FileSize)."""
    fsize = total_size(entry.chunks)
    if entry.attributes.file_size > fsize:
        fsize = entry.attributes.file_size
    return fsize


def etag_of_chunks(chunks) -> str:
    """Aggregate ETag: md5-of-md5s for multi-chunk files
    (filechunks.go ETagChunks)."""
    if len(chunks) == 1:
        return chunks[0].e_tag
    h = hashlib.md5()
    for c in chunks:
        h.update(bytes.fromhex(c.e_tag) if _is_hex(c.e_tag) else c.e_tag.encode())
    return f"{h.hexdigest()}-{len(chunks)}"


def _is_hex(s: str) -> bool:
    try:
        bytes.fromhex(s)
        return len(s) % 2 == 0 and len(s) > 0
    except ValueError:
        return False


def read_resolved_chunks(
    chunks, start_offset: int = 0, stop_offset: int = MAX_INT64
) -> list[VisibleInterval]:
    """Resolve overlapping chunks into disjoint visible intervals.

    Chunks are applied in modified_ts_ns order (ties: list order, later
    wins, matching the reference's stable point sort); each application
    clips any previously-visible span it overlaps.
    """
    order = sorted(range(len(chunks)), key=lambda i: (chunks[i].modified_ts_ns, i))
    visibles: list[VisibleInterval] = []  # disjoint, sorted by start
    starts: list[int] = []
    for i in order:
        c = chunks[i]
        start = max(c.offset, start_offset)
        stop = min(c.offset + int(c.size), stop_offset)
        if start >= stop:
            continue
        new = VisibleInterval(
            start=start,
            stop=stop,
            modified_ts_ns=c.modified_ts_ns,
            file_id=c.file_id,
            offset_in_chunk=start - c.offset,
            chunk_size=int(c.size),
            cipher_key=bytes(c.cipher_key),
            is_gzipped=c.is_compressed,
        )
        # find the window of existing intervals overlapping [start, stop)
        lo = bisect_right(starts, start) - 1
        if lo >= 0 and visibles[lo].stop <= start:
            lo += 1
        lo = max(lo, 0)
        hi = bisect_left(starts, stop)
        replacement: list[VisibleInterval] = []
        for v in visibles[lo:hi]:
            if v.start < start:  # left remnant survives
                left = replace(v, stop=start)
                replacement.append(left)
            if v.stop > stop:  # right remnant survives
                right = replace(
                    v,
                    start=stop,
                    offset_in_chunk=v.offset_in_chunk + (stop - v.start),
                )
                replacement.append(right)
        insert_at = lo
        for r in replacement:
            if r.start >= start:
                break
            insert_at += 1
        replacement.insert(insert_at - lo, new)
        visibles[lo:hi] = replacement
        starts[lo:hi] = [v.start for v in replacement]
    return visibles


def view_from_visibles(
    visibles: list[VisibleInterval], offset: int, size: int
) -> list[ChunkView]:
    stop = MAX_INT64 if size == MAX_INT64 else offset + size
    if stop < offset:
        stop = MAX_INT64
    views: list[ChunkView] = []
    for v in visibles:
        start = max(offset, v.start)
        end = min(stop, v.stop)
        if start < end:
            views.append(
                ChunkView(
                    file_id=v.file_id,
                    offset_in_chunk=start - v.start + v.offset_in_chunk,
                    view_size=end - start,
                    view_offset=start,
                    chunk_size=v.chunk_size,
                    cipher_key=v.cipher_key,
                    is_gzipped=v.is_gzipped,
                    modified_ts_ns=v.modified_ts_ns,
                )
            )
    return views


def view_from_chunks(
    chunks, offset: int, size: int, lookup_fn=None
) -> list[ChunkView]:
    """Read plan for [offset, offset+size): resolve manifests (if a
    lookup_fn is given), then clip visible intervals to the range."""
    if lookup_fn is not None:
        from .manifest import resolve_chunk_manifest

        chunks, _ = resolve_chunk_manifest(lookup_fn, chunks, offset, offset + size)
    visibles = read_resolved_chunks(chunks)
    return view_from_visibles(visibles, offset, size)


def compact_file_chunks(chunks):
    """Split chunks into (still-visible, garbage) — garbage chunks are fully
    shadowed by newer writes (filechunks.go CompactFileChunks)."""
    visibles = read_resolved_chunks(chunks)
    used = {v.file_id for v in visibles}
    compacted = [c for c in chunks if c.file_id in used]
    garbage = [c for c in chunks if c.file_id not in used]
    return compacted, garbage


def find_unused_file_chunks(old_chunks, new_chunks):
    """Chunks present in old but not in new — to be deleted after an
    entry update (filechunks.go MinusChunks shape)."""
    new_ids = {c.file_id for c in new_chunks}
    return [c for c in old_chunks if c.file_id not in new_ids]


def make_chunk(
    file_id: str, offset: int, size: int, modified_ts_ns: int = 0, e_tag: str = ""
) -> filer_pb2.FileChunk:
    return filer_pb2.FileChunk(
        file_id=file_id,
        offset=offset,
        size=size,
        modified_ts_ns=modified_ts_ns,
        e_tag=e_tag,
    )
