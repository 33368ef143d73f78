"""File-id sequencers (reference: weed/sequence/).

A copy of seaweedfs_tpu/topology/sequence.py (host code, no device work).

MemorySequencer: monotonically increasing counter, optionally persisted via
a tiny checkpoint file the way the master persists its sequence.
SnowflakeSequencer: 41b timestamp | 10b node | 12b counter ids, unique
across masters without coordination (snowflake_sequencer.go).
"""
from __future__ import annotations

import os
import threading
import time


class MemorySequencer:
    def __init__(self, start: int = 1, checkpoint_path: str | None = None):
        self._lock = threading.Lock()
        self.checkpoint_path = checkpoint_path
        self.counter = start
        if checkpoint_path and os.path.exists(checkpoint_path):
            with open(checkpoint_path) as f:
                self.counter = max(start, int(f.read().strip() or start))

    def next_ids(self, count: int = 1) -> int:
        """Reserve `count` ids; returns the first."""
        with self._lock:
            first = self.counter
            self.counter += count
            if self.checkpoint_path:
                tmp = self.checkpoint_path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(str(self.counter))
                os.replace(tmp, self.checkpoint_path)
            return first

    def peek(self) -> int:
        return self.counter

    def set_max(self, value: int) -> None:
        with self._lock:
            self.counter = max(self.counter, value)


class SnowflakeSequencer:
    EPOCH_MS = 1577836800000  # 2020-01-01

    def __init__(self, node_id: int):
        self.node_id = node_id & 0x3FF
        self._lock = threading.Lock()
        self._last_ms = 0
        self._seq = 0

    def next_ids(self, count: int = 1) -> int:
        with self._lock:
            ids = []
            for _ in range(count):
                now = int(time.time() * 1000) - self.EPOCH_MS
                if now == self._last_ms:
                    self._seq = (self._seq + 1) & 0xFFF
                    if self._seq == 0:
                        while now <= self._last_ms:
                            now = int(time.time() * 1000) - self.EPOCH_MS
                else:
                    self._seq = 0
                self._last_ms = now
                ids.append((now << 22) | (self.node_id << 12) | self._seq)
            return ids[0]

    def set_max(self, value: int) -> None:
        pass  # snowflake ids need no cross-master sync
