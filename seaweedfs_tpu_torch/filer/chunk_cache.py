"""Tiered chunk cache for filer reads.

Reference: weed/util/chunk_cache/chunk_cache.go — a memory cache in
front of on-disk tiers, keyed by fileId, consulted before any volume
server fetch.  Here: a byte-budgeted LRU in memory plus an optional disk
tier directory; whole chunks only (sub-chunk views slice the cached
blob), which is also why the reference caches at chunk granularity.

A copy of seaweedfs_tpu/filer/chunk_cache.py; it imports nothing of that
package.
"""
from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict


class ChunkCache:
    """Thread-safe: servers call it from worker threads (asyncio.to_thread)
    when the disk tier is active, so every public method takes the lock."""

    def __init__(
        self,
        mem_limit_bytes: int = 64 * 1024 * 1024,
        disk_dir: str | None = None,
        disk_limit_bytes: int = 1024 * 1024 * 1024,
        max_entry_bytes: int = 8 * 1024 * 1024,
    ):
        self.mem_limit = mem_limit_bytes
        self.max_entry = max_entry_bytes
        self.disk_dir = disk_dir
        self.disk_limit = disk_limit_bytes
        self._lock = threading.Lock()
        self._mem: OrderedDict[str, bytes] = OrderedDict()
        self._mem_bytes = 0
        self._disk_bytes = 0
        self.hits = 0
        self.misses = 0
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
            for f in os.listdir(disk_dir):
                try:
                    self._disk_bytes += os.path.getsize(os.path.join(disk_dir, f))
                except OSError:
                    pass

    def _disk_path(self, file_id: str) -> str:
        h = hashlib.sha1(file_id.encode()).hexdigest()
        return os.path.join(self.disk_dir, h)

    def get(self, file_id: str) -> bytes | None:
        with self._lock:
            blob = self._mem.get(file_id)
            if blob is not None:
                self._mem.move_to_end(file_id)
                self.hits += 1
                return blob
        if self.disk_dir:
            try:
                with open(self._disk_path(file_id), "rb") as f:
                    blob = f.read()
                with self._lock:
                    self.hits += 1
                    self._put_mem(file_id, blob)  # promote
                return blob
            except FileNotFoundError:
                pass
        with self._lock:
            self.misses += 1
        return None

    def put(self, file_id: str, blob: bytes) -> None:
        if len(blob) > min(self.max_entry, self.mem_limit):
            return
        with self._lock:
            self._put_mem(file_id, blob)
            write_disk = (
                self.disk_dir is not None
                and self._disk_bytes + len(blob) <= self.disk_limit
            )
            if write_disk:
                self._disk_bytes += len(blob)
        if write_disk:
            tmp = self._disk_path(file_id) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._disk_path(file_id))

    def _put_mem(self, file_id: str, blob: bytes) -> None:
        old = self._mem.pop(file_id, None)
        if old is not None:
            self._mem_bytes -= len(old)
        self._mem[file_id] = blob
        self._mem_bytes += len(blob)
        while self._mem_bytes > self.mem_limit and self._mem:
            _, evicted = self._mem.popitem(last=False)
            self._mem_bytes -= len(evicted)

    def invalidate(self, file_id: str) -> None:
        with self._lock:
            old = self._mem.pop(file_id, None)
            if old is not None:
                self._mem_bytes -= len(old)
        if self.disk_dir:
            try:
                size = os.path.getsize(self._disk_path(file_id))
                os.unlink(self._disk_path(file_id))
                self._disk_bytes -= size
            except OSError:
                pass
