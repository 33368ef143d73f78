"""Whole-file reads and writes from event-loop code, off the loop (a copy
of seaweedfs_tpu/utils/aiofile.py).

A bare `open()` inside `async def` stalls every coroutine sharing the loop
(concurrent CLI uploads, a server's heartbeats); these run the file call
in a worker thread.
"""
from __future__ import annotations

import asyncio
import contextlib
from typing import IO, Any, AsyncIterator


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _read_text(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def _write_bytes(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _write_text(path: str, text: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


async def read_file_bytes(path: str) -> bytes:
    return await asyncio.to_thread(_read_bytes, path)


async def read_file_text(path: str) -> str:
    return await asyncio.to_thread(_read_text, path)


async def write_file_bytes(path: str, data: bytes) -> None:
    await asyncio.to_thread(_write_bytes, path, data)


async def write_file_text(path: str, text: str) -> None:
    await asyncio.to_thread(_write_text, path, text)


@contextlib.asynccontextmanager
async def open_in_thread(
    path: str, mode: str = "r", **kw: Any
) -> AsyncIterator[IO[Any]]:
    """`async with open_in_thread(p, "rb") as f:` — open and close run
    in to_thread; the caller dispatches each read/write the same way
    (`await asyncio.to_thread(f.read, n)`).  The shared form of the
    streaming pattern the whole-file helpers above don't cover."""
    f = await asyncio.to_thread(open, path, mode, **kw)
    try:
        yield f
    finally:
        await asyncio.to_thread(f.close)
