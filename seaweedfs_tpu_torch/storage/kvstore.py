"""ctypes binding for the embedded KV store (csrc/host/kvstore.cpp).

Port of seaweedfs_tpu/storage/kvstore.py: the counterpart of the
reference's leveldb dependency (weed/storage/needle_map_leveldb.go), a
bitcask-style append-only log + in-memory hash index.  The source is built
with g++ into the host library by ops/_build.host() at first use; a failed
build raises (no fallback to another map).  Used by
storage/needle_map_persistent.NativeNeedleMap (`-index native`).
"""
from __future__ import annotations

import ctypes
import threading

from ..ops import _build


class NativeKv:
    """One store file.  Thread-safe via a lock: the underlying FILE* seeks
    are stateful, and the engine's callers mix threads (asyncio.to_thread)."""

    def __init__(self, path: str):
        lib = _build.host()
        self._lib = lib
        self._h = lib.kv_open(path.encode())
        if not self._h:
            raise OSError(f"kv_open({path!r}) failed")
        self.path = path
        self._lock = threading.Lock()

    def _handle(self):
        """The live handle, or raise — a closed store must error in
        Python, not hand ctypes a NULL to segfault on."""
        if not self._h:
            raise ValueError(f"kv store {self.path!r} is closed")
        return self._h

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            rc = self._lib.kv_put(
                self._handle(), key, len(key), value, len(value)
            )
        if rc != 0:
            raise OSError(f"kv_put failed (rc={rc})")

    def get(self, key: bytes) -> bytes | None:
        cap = 4096
        with self._lock:
            while True:
                buf = ctypes.create_string_buffer(cap)
                n = self._lib.kv_get(self._handle(), key, len(key), buf, cap)
                if n == -1:
                    return None
                if n == -2:
                    cap *= 8
                    continue
                return buf.raw[:n]

    def delete(self, key: bytes) -> bool:
        with self._lock:
            return self._lib.kv_delete(self._handle(), key, len(key)) == 0

    def __len__(self) -> int:
        with self._lock:
            return self._lib.kv_count(self._handle())

    @property
    def dead_bytes(self) -> int:
        with self._lock:
            return self._lib.kv_dead_bytes(self._handle())

    def items(self) -> list[tuple[bytes, bytes]]:
        out: list[tuple[bytes, bytes]] = []

        @_build.KV_ITER_CB
        def cb(kp, kn, vp, vn, _ctx):
            out.append(
                (bytes(bytearray(kp[:kn])), bytes(bytearray(vp[:vn])))
            )
            return 0

        with self._lock:
            rc = self._lib.kv_iterate(self._handle(), cb, None)
        if rc != 0:
            raise OSError(f"kv_iterate failed (rc={rc})")
        return out

    def keys(self) -> list[bytes]:
        """Live keys only — no value copies across the ctypes boundary."""
        out: list[bytes] = []

        @_build.KV_ITER_CB
        def cb(kp, kn, _vp, _vn, _ctx):
            out.append(bytes(bytearray(kp[:kn])))
            return 0

        with self._lock:
            rc = self._lib.kv_iterate_keys(self._handle(), cb, None)
        if rc != 0:
            raise OSError(f"kv_iterate_keys failed (rc={rc})")
        return out

    def flush(self) -> None:
        with self._lock:
            self._lib.kv_flush(self._handle())

    def compact(self) -> int:
        with self._lock:
            reclaimed = self._lib.kv_compact(self._handle())
        if reclaimed < 0:
            raise OSError("kv_compact failed")
        return reclaimed

    def close(self) -> None:
        with self._lock:
            if self._h:
                self._lib.kv_close(self._h)
                self._h = None
