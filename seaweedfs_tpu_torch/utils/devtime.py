"""Device-side timing through torch.profiler.

Port of seaweedfs_tpu/utils/devtime.py.  The reference averages the TPU's
device-stream executable events of a `jax.profiler` capture; here the
counterpart is CUPTI's kernel records in a `torch.profiler` capture: N
calls of a thunk run under the profiler with CUDA activity, and the
kernels' durations are summed and divided by N.  That is the card's own
time for the calls, with no launch gap, host work or copy in it, so it
can only be at or below a CUDA-event bracket of the same calls.

Off the card (a CPU thunk) it is the wall clock, as the reference is off
the TPU.  Nothing on the serving path calls it; chip_smoke.py reads it
beside its CUDA-event medians.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time


def kernel_events(trace_path: str) -> list[tuple[str, float, float]]:
    """The CUDA kernel records of an exported torch.profiler chrome trace:
    [(kernel name, start µs, duration µs)] in start order."""
    with open(trace_path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    out = [
        (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "kernel"
    ]
    out.sort(key=lambda r: r[1])
    return out


def device_avg_ms(fn, n: int = 10, warmup: int = 1) -> float:
    """Average device time in ms of one call of `fn` (a no-arg thunk
    that launches its work on the current CUDA stream): the sum of the
    kernel durations a torch.profiler capture of `n` calls records,
    divided by `n`.  Without a CUDA device, the wall clock of the calls
    over `n`."""
    import torch

    for _ in range(warmup):
        fn()
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
    if not on_card:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    from torch.profiler import ProfilerActivity, profile

    d = tempfile.mkdtemp(prefix="swfs_devtime_")
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = kernel_events(path)
        if not events:
            raise RuntimeError("the capture holds no CUDA kernel events")
        return sum(dur for _, _, dur in events) / n / 1e3
    finally:
        shutil.rmtree(d, ignore_errors=True)
