"""Filer: the namespace/metadata tier (reference weed/filer/, 16.1k LoC).

A copy of seaweedfs_tpu/filer/__init__.py; it imports nothing of that
package.
"""
from .entry import Attr, Entry, MODE_DIR, dir_and_name, new_dir_entry, new_full_path
from .filechunks import (
    ChunkView,
    VisibleInterval,
    compact_file_chunks,
    etag_of_chunks,
    find_unused_file_chunks,
    make_chunk,
    read_resolved_chunks,
    total_size,
    view_from_chunks,
    view_from_visibles,
)
from .filer import Filer, FilerError, NotEmptyError
from .filerstore import (
    AbstractSqlStore,
    FilerStore,
    MemoryStore,
    NotFoundError,
    OnConflictSqliteDialect,
    SqlDialect,
    SqliteDialect,
    SqliteStore,
)
from .manifest import maybe_manifestize, resolve_chunk_manifest
from .meta_log import MetaLog

__all__ = [
    "Attr",
    "ChunkView",
    "Entry",
    "Filer",
    "FilerError",
    "AbstractSqlStore",
    "FilerStore",
    "MODE_DIR",
    "MemoryStore",
    "MetaLog",
    "NotEmptyError",
    "NotFoundError",
    "SqlDialect",
    "SqliteDialect",
    "OnConflictSqliteDialect",
    "SqliteStore",
    "VisibleInterval",
    "compact_file_chunks",
    "dir_and_name",
    "etag_of_chunks",
    "find_unused_file_chunks",
    "make_chunk",
    "maybe_manifestize",
    "new_dir_entry",
    "new_full_path",
    "read_resolved_chunks",
    "resolve_chunk_manifest",
    "total_size",
    "view_from_chunks",
    "view_from_visibles",
]
