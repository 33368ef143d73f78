"""Filer metadata event log: every namespace mutation becomes an
EventNotification that subscribers can replay from a timestamp and then
tail live.

Reference: weed/filer/filer_notify.go (NotifyUpdateEvent → LogBuffer),
weed/util/log_buffer/log_buffer.go, filer_grpc_server_sub_meta.go.  The
reference persists the log as chunked files under /topics/.system/log
inside the filer itself; here the log is an in-memory deque with an
optional on-disk append file of length-prefixed SubscribeMetadataResponse
protos — enough for SubscribeMetadata replay+tail and filer.sync.

A copy of seaweedfs_tpu/filer/meta_log.py; it imports nothing of that
package. The on-disk file is byte-compatible with the reference's: a log
written by either package replays in the other.
"""
from __future__ import annotations

import asyncio
import os
import struct
import time
from collections import deque

from ..pb import filer_pb2

_MAX_MEMORY_EVENTS = 8192


class MetaLog:
    def __init__(self, persist_path: str | None = None, notifier=None):
        self.notifier = notifier  # replication.notification.Notifier
        self._events: deque[filer_pb2.SubscribeMetadataResponse] = deque(
            maxlen=_MAX_MEMORY_EVENTS
        )
        self._cond: asyncio.Condition = asyncio.Condition()
        self._last_ts_ns = 0
        self._persist_path = persist_path
        self._fh = None
        if persist_path:
            os.makedirs(os.path.dirname(persist_path) or ".", exist_ok=True)
            self._replay_disk()
            self._fh = open(persist_path, "ab")

    def _replay_disk(self) -> None:
        if not os.path.exists(self._persist_path):
            return
        with open(self._persist_path, "rb") as f:
            while True:
                hdr = f.read(4)
                if len(hdr) < 4:
                    break
                (n,) = struct.unpack("<I", hdr)
                blob = f.read(n)
                if len(blob) < n:
                    break  # truncated tail from a crash — ignore
                ev = filer_pb2.SubscribeMetadataResponse.FromString(blob)
                self._events.append(ev)
                self._last_ts_ns = max(self._last_ts_ns, ev.ts_ns)

    async def append(
        self,
        directory: str,
        old_entry,
        new_entry,
        delete_chunks: bool = False,
        new_parent_path: str = "",
        signatures: list[int] | None = None,
    ) -> int:
        """Record one mutation; returns its ts_ns."""
        ts_ns = max(time.time_ns(), self._last_ts_ns + 1)  # strictly monotonic
        self._last_ts_ns = ts_ns
        ev = filer_pb2.SubscribeMetadataResponse(
            directory=directory,
            ts_ns=ts_ns,
            event_notification=filer_pb2.EventNotification(
                old_entry=old_entry.to_pb() if old_entry else None,
                new_entry=new_entry.to_pb() if new_entry else None,
                delete_chunks=delete_chunks,
                new_parent_path=new_parent_path,
                signatures=signatures or [],
            ),
        )
        if self._fh is not None:
            blob = ev.SerializeToString()
            self._fh.write(struct.pack("<I", len(blob)) + blob)
            self._fh.flush()
        async with self._cond:
            self._events.append(ev)
            self._cond.notify_all()
        if self.notifier is not None:
            name = (new_entry or old_entry).name if (new_entry or old_entry) else ""
            try:
                await self.notifier.publish(
                    f"{directory.rstrip('/')}/{name}", ev.event_notification
                )
            except Exception:  # noqa: BLE001 — notification must not fail writes
                import logging

                logging.getLogger("notification").exception("publish failed")
        return ts_ns

    async def subscribe(self, since_ns: int = 0, path_prefix: str = ""):
        """Async iterator: replay events after since_ns, then tail forever
        (cancel the consuming task to stop)."""
        cursor = since_ns
        while True:
            batch = []
            async with self._cond:
                for ev in self._events:
                    if ev.ts_ns > cursor:
                        batch.append(ev)
                if not batch:
                    await self._cond.wait()
                    continue
            for ev in batch:
                cursor = ev.ts_ns
                if path_prefix and not (
                    ev.directory.startswith(path_prefix)
                    or path_prefix.startswith(ev.directory)
                ):
                    continue
                yield ev

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
