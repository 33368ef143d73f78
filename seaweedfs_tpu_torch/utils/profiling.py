"""Profiling hooks (reference: weed/util/grace/pprof.go — every command
accepts -cpuprofile/-memprofile and servers expose /debug/pprof).

Port of seaweedfs_tpu/utils/profiling.py on the port's HTTP server
(server/http.py).  Python analogues: cProfile stats dumped at exit for
-cpuprofile, tracemalloc top allocations for -memprofile, and a
/debug/stacks handler that dumps every thread's live stack (the
goroutine-dump equivalent used to diagnose a hung server).
"""
from __future__ import annotations

import atexit
import cProfile
import io
import sys
import traceback

_profiler: cProfile.Profile | None = None


def start_cpu_profile(path: str) -> None:
    global _profiler
    _profiler = cProfile.Profile()
    _profiler.enable()

    def dump() -> None:
        _profiler.disable()
        _profiler.dump_stats(path)

    atexit.register(dump)


def start_mem_profile(path: str) -> None:
    import tracemalloc

    tracemalloc.start(10)

    def dump() -> None:
        snap = tracemalloc.take_snapshot()
        with open(path, "w") as f:
            for stat in snap.statistics("lineno")[:100]:
                f.write(f"{stat}\n")

    atexit.register(dump)


def maybe_start(args) -> None:
    """Honor -cpuprofile/-memprofile argparse flags when present."""
    cpu = getattr(args, "cpuprofile", "")
    mem = getattr(args, "memprofile", "")
    if not (cpu or mem):
        return
    if cpu:
        start_cpu_profile(cpu)
    if mem:
        start_mem_profile(mem)
    # server commands die by SIGTERM; atexit only runs on normal exit, so
    # route the signal through sys.exit (grace/pprof hooks signals too)
    import signal

    def _on_term(signum, frame):
        sys.exit(143)

    signal.signal(signal.SIGTERM, _on_term)


def thread_stacks() -> str:
    """Every thread's current stack — the goroutine dump analogue."""
    out = io.StringIO()
    frames = sys._current_frames()
    import threading

    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in frames.items():
        out.write(f"--- thread {names.get(ident, '?')} ({ident}) ---\n")
        traceback.print_stack(frame, file=out)
        out.write("\n")
    return out.getvalue()


async def debug_stacks_handler(request):
    """GET /debug/stacks (server/http.py handler)."""
    from ..server.http import Response

    return Response(body=thread_stacks().encode())
