"""On-demand device profiling for a LIVE volume server.

Port of seaweedfs_tpu/obs/profile.py on `torch.profiler` instead of
`jax.profiler`:

  * `GET /debug/profile?seconds=N` starts `torch.profiler.profile` (CPU
    and, on the card, CUDA activity: CUPTI's kernel and copy records)
    around whatever the serving lanes launch for N seconds, exports the
    capture as a chrome trace (`trace.json`) into a fresh capture
    directory and returns the directory.  SWFS_DEBUG-gated by the volume
    server — a capture reveals internals and costs the card attention, so
    it is opt-in only.  One capture at a time; a concurrent request gets
    409.  A capture that fails answers 503, never an empty 200.
  * `GET /debug/device/hot` is the zero-cost half: rs_resident keeps a
    per-call-class dispatch counter + a dispatch->ready latency EWMA (see
    ops/rs_resident.hot_shapes), so "what is the card running right now"
    is one HTTP fetch.

CUPTI's first start in a process takes seconds: the window is timed from
the moment the profiler is live, so a capture of N seconds holds N
seconds of serving.  The profiler is started, stopped and exported on one
worker thread of the process's own (the same for every capture), off the
event loop, while the lanes keep serving.  utils/devtime.kernel_events
reads the kernel records back.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import math
import os
import threading
import time

from ..server.http import HTTPError, json_response

log = logging.getLogger("obs")

# hard cap on one capture's length: /debug/profile holds the card's
# attention and buffers trace events in memory for the duration
MAX_PROFILE_SECONDS = 30.0

# capture directories kept on disk, oldest deleted first, so repeated
# captures can't fill the disk
KEEP_PROFILE_DIRS = 8

# the chrome trace's name inside each capture directory
TRACE_FILE = "trace.json"

# single-flight: one profiler session per process
_PROFILE_BUSY = threading.Lock()
# the one thread every capture starts, stops and exports on (the
# profiler's client registers with the thread that first starts it)
_POOL: concurrent.futures.ThreadPoolExecutor | None = None


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="swfs-profile"
        )
    return _POOL


def _new_profile_dir() -> str:
    """Create this capture's directory and prune old siblings past
    KEEP_PROFILE_DIRS (runs on a worker thread).  All captures live
    under one stable parent so the cap can see them."""
    import shutil
    import tempfile

    parent = os.path.join(tempfile.gettempdir(), "swfs_device_profiles")
    os.makedirs(parent, exist_ok=True)
    d = tempfile.mkdtemp(prefix="capture_", dir=parent)
    siblings = sorted(
        (e for e in os.scandir(parent) if e.is_dir()),
        key=lambda e: e.stat().st_mtime,
    )
    for e in siblings[: max(0, len(siblings) - KEEP_PROFILE_DIRS)]:
        shutil.rmtree(e.path, ignore_errors=True)
    return d


def _profiler():
    """A torch.profiler session over the CPU, and the card when there is
    one (not started)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


async def profile_handler(request):
    """GET /debug/profile?seconds=N: capture a profile of the live
    serving process for N seconds (default 2, capped at 30) and return
    the capture directory + the hot-call snapshot taken at stop time.
    503 when the capture fails, 409 when one is already running."""
    try:
        seconds = float(request.query.get("seconds", 2.0))
    except ValueError:
        raise HTTPError(400, "seconds must be numeric")
    if not math.isfinite(seconds) or seconds <= 0:
        # nan sails past `<= 0` AND survives min() — it would reach
        # asyncio.sleep(nan) with the single-flight lock held
        raise HTTPError(400, "seconds must be finite > 0")
    seconds = min(seconds, MAX_PROFILE_SECONDS)
    if not _PROFILE_BUSY.acquire(blocking=False):
        raise HTTPError(409, "a profile capture is already running")
    loop = asyncio.get_running_loop()
    # start, stop and export on the same thread, off the event loop
    pool = _pool()
    try:
        trace_dir = await loop.run_in_executor(pool, _new_profile_dir)
        try:
            prof = await loop.run_in_executor(pool, _profiler)
            await loop.run_in_executor(pool, prof.start)
            # the window begins once the profiler is live
            t0 = time.time()
            try:
                await asyncio.sleep(seconds)
            finally:
                await loop.run_in_executor(pool, prof.stop)
            await loop.run_in_executor(
                pool, prof.export_chrome_trace,
                os.path.join(trace_dir, TRACE_FILE),
            )
        except Exception as e:  # noqa: BLE001 — no profiler / no CUPTI:
            # report, don't 500 and don't answer an empty 200
            log.warning("device profile capture failed: %s", e)
            raise HTTPError(503, f"device profiling unavailable: {e}")
        return json_response(
            {
                "trace_dir": trace_dir,
                "seconds": seconds,
                "started_unix_ms": int(t0 * 1e3),
                "hot_shapes": _hot_snapshot(),
            }
        )
    finally:
        _PROFILE_BUSY.release()


def _hot_snapshot(limit: int = 10) -> list[dict]:
    from ..ops import rs_resident

    return rs_resident.hot_shapes(limit)


async def device_hot_handler(request):
    """GET /debug/device/hot?limit=N: the per-call-class dispatch
    counters + latency EWMAs (ops/rs_resident), hottest first."""
    from ..ops import rs_resident

    try:
        limit = int(request.query.get("limit", 10))
    except ValueError:
        raise HTTPError(400, "limit must be an integer")
    if limit < 1:
        raise HTTPError(400, "limit must be >= 1")
    return json_response(
        {
            "generated_unix_ms": int(time.time() * 1e3),
            "shapes": rs_resident.hot_shapes(limit),
            "aot": rs_resident.aot_stats(),
        }
    )
