"""Filer core: namespace operations over a pluggable FilerStore.

Reference: weed/filer/filer.go (CreateEntry :175, ensureParentDirectoryEntry
:226, UpdateEntry :284, FindEntry :312), filer_delete_entry.go
(DeleteEntryMetaAndData + recursive child walk), filer_grpc_server_rename.go
(transactional move).  Every mutation is appended to the MetaLog for
SubscribeMetadata / filer.sync consumers.

A copy of seaweedfs_tpu/filer/filer.py; it imports nothing of that
package.
"""
from __future__ import annotations

import logging
import threading
import time

from .entry import Attr, Entry, MODE_DIR, dir_and_name, new_full_path
from .filechunks import find_unused_file_chunks
from .filerstore import FilerStore, NotFoundError
from .meta_log import MetaLog

log = logging.getLogger("filer")

ROOT = "/"


class FilerError(Exception):
    pass


class NotEmptyError(FilerError):
    pass


class Filer:
    def __init__(
        self,
        store: FilerStore,
        delete_file_ids_fn=None,  # async (list[str]) -> None; wired by the server
        meta_log_path: str | None = None,
        notifier=None,  # replication.notification.Notifier
        fetch_manifest_fn=None,  # async (FileChunk) -> decoded manifest bytes
    ):
        self.store = store
        self.meta_log = MetaLog(meta_log_path, notifier=notifier)
        self._delete_file_ids_fn = delete_file_ids_fn
        self._fetch_manifest_fn = fetch_manifest_fn
        self._dir_cache: dict[str, float] = {}  # known-directory memo
        # hard links: shared content + name refcount live in the store KV
        # under the hard_link_id; all counter math happens under this lock
        # (stores are sync and called from threads)
        self._hl_lock = threading.Lock()

    # ------------------------------------------------------------------ reads

    def find_entry(self, full_path: str) -> Entry:
        full_path = full_path.rstrip("/") or ROOT
        if full_path == ROOT:
            return Entry(full_path=ROOT, attr=Attr(mode=0o755 | MODE_DIR))
        entry = self.store.find_entry(full_path)
        if _is_expired(entry):
            raise NotFoundError(full_path)
        return self._hl_overlay(entry)

    # ---------------------------------------------------------- hard links
    #
    # POSIX hard links share one inode: chunks/attributes/xattrs written
    # through ANY name must be visible through every other name, and data
    # is released only when the LAST name goes (reference weedfs_link.go +
    # filer hard-link resolution).  The shared content lives in the store
    # KV at HL!<id>; named rows are pointers carrying the id, and HC!<id>
    # counts the names.

    def _hl_overlay(self, entry: Entry) -> Entry:
        if not entry.hard_link_id:
            return entry
        try:
            blob = self.store.kv_get(b"HL!" + entry.hard_link_id)
        except NotFoundError:
            return entry  # pre-link entry or missing content: serve the row
        shared = Entry.decode(entry.full_path, blob)
        shared.hard_link_id = entry.hard_link_id
        return shared

    def _hl_on_write(self, entry: Entry, new_name: bool) -> None:
        """Publish an updated hard-linked entry's content and maintain the
        name refcount.  Called after any named-row write."""
        if not entry.hard_link_id:
            return
        with self._hl_lock:
            self.store.kv_put(b"HL!" + entry.hard_link_id, entry.encode())
            ckey = b"HC!" + entry.hard_link_id
            try:
                refs = int(self.store.kv_get(ckey))
            except (NotFoundError, ValueError):
                refs = 0
            if new_name:
                refs += 1
            refs = max(refs, 1)  # first assignment: the existing name
            self.store.kv_put(ckey, str(refs).encode())

    def list_directory_entries(
        self,
        dir_path: str,
        start_file_name: str = "",
        include_start: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        """Up to `limit` live entries; TTL-expired rows are filtered and
        backfilled from the store so a short batch always means the
        directory is exhausted (pagination callers rely on that)."""
        out: list[Entry] = []
        start, inclusive = start_file_name, include_start
        while len(out) < limit:
            ask = limit - len(out)
            batch = self.store.list_directory_entries(
                dir_path, start, inclusive, ask, prefix
            )
            out.extend(e for e in batch if not _is_expired(e))
            if len(batch) < ask:
                break
            start, inclusive = batch[-1].name, False
        return out

    # ----------------------------------------------------------------- writes

    async def create_entry(
        self,
        entry: Entry,
        o_excl: bool = False,
        is_from_other_cluster: bool = False,
        signatures: list[int] | None = None,
        skip_create_parents: bool = False,
    ) -> None:
        old = None
        try:
            old = self.find_entry(entry.full_path)
        except NotFoundError:
            pass
        if old is not None:
            if o_excl:
                raise FilerError(f"{entry.full_path} already exists")
            if old.is_directory and not entry.is_directory:
                raise FilerError(f"{entry.full_path} is a directory")
        if not skip_create_parents:
            self._ensure_parents(entry.directory)
        self.store.insert_entry(entry)
        self._hl_on_write(entry, new_name=old is None)
        await self.meta_log.append(
            entry.directory, old, entry, signatures=signatures or []
        )

    def _ensure_parents(self, directory: str) -> None:
        """Materialize the directory chain (filer.go ensureParentDirectoryEntry)."""
        if directory in ("", ROOT) or self._dir_cache.get(directory):
            return
        parent, _ = dir_and_name(directory)
        self._ensure_parents(parent)
        try:
            existing = self.store.find_entry(directory)
            if not existing.is_directory:
                raise FilerError(f"{directory} is a file")
        except NotFoundError:
            now = int(time.time())
            self.store.insert_entry(
                Entry(
                    full_path=directory,
                    attr=Attr(mtime=now, crtime=now, mode=0o770 | MODE_DIR),
                )
            )
        self._dir_cache[directory] = time.time()
        if len(self._dir_cache) > 10240:
            self._dir_cache.clear()

    async def update_entry(
        self,
        old_entry: Entry | None,
        entry: Entry,
        signatures: list[int] | None = None,
    ) -> None:
        if old_entry is not None:
            if old_entry.is_directory and not entry.is_directory:
                raise FilerError(f"existing {entry.full_path} is a directory")
            if not old_entry.is_directory and entry.is_directory:
                raise FilerError(f"existing {entry.full_path} is a file")
        self.store.update_entry(entry)
        self._hl_on_write(entry, new_name=False)
        await self.meta_log.append(
            entry.directory, old_entry, entry, signatures=signatures or []
        )

    async def append_chunks(self, full_path: str, chunks: list) -> Entry:
        """AppendToEntry: add chunks at the current end of the file."""
        try:
            entry = self.find_entry(full_path)
            offset = entry.size()
        except NotFoundError:
            now = int(time.time())
            entry = Entry(full_path=full_path, attr=Attr(mtime=now, crtime=now))
            offset = 0
        for c in chunks:
            c.offset = offset
            offset += int(c.size)
        entry.chunks = list(entry.chunks) + list(chunks)
        entry.attr.mtime = int(time.time())
        entry.attr.file_size = offset
        self.store.insert_entry(entry)
        self._hl_on_write(entry, new_name=False)
        await self.meta_log.append(entry.directory, None, entry)
        return entry

    # --------------------------------------------------------------- deletion

    async def delete_entry_meta_and_data(
        self,
        full_path: str,
        is_recursive: bool = False,
        ignore_recursive_error: bool = False,
        is_delete_data: bool = True,
        signatures: list[int] | None = None,
    ) -> None:
        entry = self.find_entry(full_path)  # raises NotFoundError
        chunks: list = []
        if entry.is_directory:
            await self._delete_children(
                entry, is_recursive, ignore_recursive_error, chunks
            )
        if self._release_hard_link(entry):
            chunks.extend(entry.chunks)
        self.store.delete_entry(entry.full_path)
        self._dir_cache.pop(entry.full_path, None)
        await self.meta_log.append(
            entry.directory, entry, None, delete_chunks=is_delete_data,
            signatures=signatures or [],
        )
        if is_delete_data and chunks:
            await self._delete_chunks(chunks)

    async def _delete_children(
        self, dir_entry: Entry, is_recursive: bool, ignore_errors: bool, chunks: list
    ) -> None:
        while True:
            children = self.store.list_directory_entries(
                dir_entry.full_path, limit=1024
            )
            if not children:
                return
            if not is_recursive:
                raise NotEmptyError(f"{dir_entry.full_path} is not empty")
            for child in children:
                try:
                    if child.is_directory:
                        await self._delete_children(
                            child, is_recursive, ignore_errors, chunks
                        )
                    if self._release_hard_link(child):
                        chunks.extend(child.chunks)
                    self.store.delete_entry(child.full_path)
                    self._dir_cache.pop(child.full_path, None)
                    await self.meta_log.append(child.directory, child, None)
                except NotEmptyError:
                    if not ignore_errors:
                        raise
            if len(children) < 1024:
                return

    def _release_hard_link(self, entry: Entry) -> bool:
        """-> True when the entry's chunks may be GC'd: not hard-linked,
        or this was the LAST name referencing the shared chunk list
        (reference weedfs_link.go + filer hard-link counters)."""
        if not entry.hard_link_id:
            return True
        with self._hl_lock:
            ckey = b"HC!" + entry.hard_link_id
            try:
                refs = int(self.store.kv_get(ckey))
            except (NotFoundError, ValueError):
                # counter absent: sole owner (pre-link entry)
                self.store.kv_delete(b"HL!" + entry.hard_link_id)
                return True
            refs -= 1
            if refs <= 0:
                self.store.kv_delete(ckey)
                self.store.kv_delete(b"HL!" + entry.hard_link_id)
                return True
            self.store.kv_put(ckey, str(refs).encode())
            return False

    async def _delete_chunks(self, chunks: list, expand: bool = True) -> None:
        """expand=True resolves manifest chunks and deletes their children
        too (entry deletion).  delete_unused_chunks passes expand=False: its
        diff already decided exactly which fids are unreferenced — a dropped
        manifest whose children are still live inline must NOT cascade."""
        if self._delete_file_ids_fn is None:
            return
        chunks = list(chunks)
        if expand and any(
            c.is_chunk_manifest for c in chunks
        ) and self._fetch_manifest_fn:
            # expand BEFORE deleting anything: the children are reachable
            # only through the manifest blobs (entry delete would otherwise
            # orphan every data chunk inside them)
            from .manifest import expand_manifest_chunks

            try:
                data, meta = await expand_manifest_chunks(
                    self._fetch_manifest_fn, chunks
                )
                chunks = data + meta
            except Exception as e:  # noqa: BLE001 — delete what we can
                log.warning("manifest resolve for delete failed: %s", e)
        fids = sorted({c.file_id for c in chunks if c.file_id})
        if fids:
            try:
                await self._delete_file_ids_fn(fids)
            except Exception as e:  # noqa: BLE001 — deletion is best-effort
                log.warning("chunk deletion failed: %s", e)

    async def delete_unused_chunks(self, old_chunks, new_chunks) -> None:
        """GC chunks dropped by an entry update — MANIFEST-AWARE, like the
        reference's MinusChunks (filechunks.go): both sides resolve to
        (data, manifest) chunk sets and each set diffs independently, so
        folding data chunks into a manifest does not delete the live data
        and dropping a manifest deletes its children too."""
        if any(c.is_chunk_manifest for c in list(old_chunks) + list(new_chunks)):
            # append/flush keeps every old top-level fid: nothing can be
            # unused, skip the manifest fetches entirely
            if not find_unused_file_chunks(old_chunks, new_chunks):
                return
            if self._fetch_manifest_fn is None:
                return  # cannot resolve: leak rather than lose data
            from .manifest import expand_manifest_chunks

            try:
                old_d, old_m = await expand_manifest_chunks(
                    self._fetch_manifest_fn, old_chunks
                )
                new_d, new_m = await expand_manifest_chunks(
                    self._fetch_manifest_fn, new_chunks
                )
            except Exception as e:  # noqa: BLE001 — unresolvable manifest
                log.warning("manifest resolve for GC failed, skipping: %s", e)
                return
            unused = find_unused_file_chunks(
                old_d, new_d
            ) + find_unused_file_chunks(old_m, new_m)
        else:
            unused = find_unused_file_chunks(old_chunks, new_chunks)
        if unused:
            await self._delete_chunks(unused, expand=False)

    # ----------------------------------------------------------------- rename

    async def atomic_rename(
        self,
        old_dir: str,
        old_name: str,
        new_dir: str,
        new_name: str,
        signatures: list[int] | None = None,
    ) -> None:
        """Transactional move of an entry (and its whole subtree for
        directories) — filer_grpc_server_rename.go."""
        old_path = new_full_path(old_dir, old_name)
        new_path = new_full_path(new_dir, new_name)
        if old_path == new_path:
            return
        entry = self.find_entry(old_path)
        self._ensure_parents(new_dir)
        events: list[tuple] = []
        self.store.begin_transaction()
        try:
            self._move_subtree(entry, new_path, events)
            self.store.commit_transaction()
        except Exception:
            self.store.rollback_transaction()
            raise
        for directory, old_e, new_e, new_parent in events:
            await self.meta_log.append(
                directory, old_e, new_e, new_parent_path=new_parent,
                signatures=signatures or [],
            )

    def _move_subtree(self, entry: Entry, new_path: str, events: list) -> None:
        if entry.is_directory:
            for child in self.store.list_directory_entries(entry.full_path):
                self._move_subtree(
                    child, new_full_path(new_path, child.name), events
                )
        self._dir_cache.pop(entry.full_path, None)
        moved = Entry(
            full_path=new_path,
            attr=entry.attr,
            extended=entry.extended,
            chunks=entry.chunks,
            hard_link_id=entry.hard_link_id,
            hard_link_counter=entry.hard_link_counter,
            content=entry.content,
        )
        self.store.delete_entry(entry.full_path)
        self.store.insert_entry(moved)
        new_parent, _ = dir_and_name(new_path)
        events.append((entry.directory, entry, moved, new_parent))

    def shutdown(self) -> None:
        self.meta_log.close()
        self.store.shutdown()


def _is_expired(entry: Entry) -> bool:
    ttl = entry.attr.ttl_sec
    return ttl > 0 and entry.attr.crtime + ttl < time.time()
