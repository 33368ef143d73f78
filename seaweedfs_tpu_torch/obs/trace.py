"""Dapper-style request tracing for the serving path.

Port of seaweedfs_tpu/obs/trace.py, with the HTTP half rewritten for the
port's server (server/http.py) instead of aiohttp.  Aggregate metrics hide
the tail: nothing else attributes ONE slow read to its stage (coalescer
wait, batch pack, device execute, D2H, host reconstruct, disk shard read).
This module is the request-scoped view:

  * a trace id + parent span id travel on the `X-Seaweed-Trace-Id` HTTP
    header, in the reference's format, so a port node's entries join a
    reference node's by id; each server that sees the header records ITS
    OWN spans for the request under the shared trace id (the Dapper model
    — per-process rings, correlated by id).  Its metadata twin
    (`grpc_metadata`) rides every call of the port's RPC plane
    (pb/rpc.py), whose server side opens a `grpc <method>` entry;
  * inside a process the active trace rides a contextvar, so it crosses
    await points AND `asyncio.to_thread` hops (to_thread runs the worker
    in a copy of the caller's context) without threading a ctx argument
    through every storage call;
  * the serving dispatcher's queue hop breaks that chain on purpose (one
    drain task serves many requests' batches), so `ReadRequest` carries
    the admission-time context and the dispatcher replays batch-scoped
    stage timings onto every member trace via a STAGE SINK contextvar;
  * every span observation also lands in the per-stage Prometheus
    histogram (stats.REQUEST_STAGE_SECONDS), so dashboards get the
    distribution even when tracing is disabled;
  * completed traces go to a bounded in-memory ring served as JSON at
    /debug/traces on every server, newest-first, and requests slower
    than `-obs.slowMs` are logged with their per-span breakdown.

Separate processes each have their own ring, and the trace id is what
joins them.
"""
from __future__ import annotations

import contextvars
import logging
import math
import os
import threading
import time
from collections import deque

from ..server.http import HTTPError, json_response
from ..stats import metrics as _metrics
from .config import ObsConfig

log = logging.getLogger("obs")

TRACE_HEADER = "X-Seaweed-Trace-Id"
# the same id on the RPC plane's call metadata (pb/rpc.py)
GRPC_TRACE_KEY = "x-seaweed-trace-id"

CONFIG = ObsConfig()

# (Trace, parent_span_id) of the request being served in this context
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "obs_current", default=None
)
# stage-timing sink for code whose spans belong to MANY traces at once
# (the dispatcher's batched device call): span() accumulates
# {stage: [total_s, calls, annotations]} here instead
_STAGE_SINK: contextvars.ContextVar = contextvars.ContextVar(
    "obs_stage_sink", default=None
)


def _new_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


class Span:
    """One named, timed stage within a server-local trace."""

    __slots__ = ("name", "span_id", "parent_id", "start", "duration",
                 "annotations")

    def __init__(self, name, span_id, parent_id, start, duration=0.0,
                 annotations=None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start  # perf_counter, same clock as the trace anchor
        self.duration = duration
        self.annotations = annotations or {}

    def to_dict(self, t0: float) -> dict:
        d = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_span_id": self.parent_id,
            "offset_us": int((self.start - t0) * 1e6),
            "duration_us": int(self.duration * 1e6),
        }
        if self.annotations:
            d["annotations"] = self.annotations
        return d


class Trace:
    """This server's spans for one request, correlated across servers by
    `trace_id`.  Span appends are thread-safe: device/storage spans are
    recorded from to_thread workers."""

    __slots__ = ("trace_id", "role", "server", "name", "parent_span_id",
                 "wall_start", "t0", "end", "status", "root_id", "spans",
                 "_lock")

    def __init__(self, trace_id, role, name, server="", parent_span_id=""):
        self.trace_id = trace_id
        self.role = role
        self.server = server
        self.name = name
        self.parent_span_id = parent_span_id
        self.wall_start = time.time()
        self.t0 = time.perf_counter()
        self.end = self.t0
        self.status = ""
        self.root_id = _new_id(4)
        self.spans: list[Span] = []
        self._lock = threading.Lock()

    def add_span(self, name, start, duration, parent_id=None,
                 annotations=None) -> Span:
        sp = Span(
            name, _new_id(4), parent_id or self.root_id, start, duration,
            annotations,
        )
        with self._lock:
            self.spans.append(sp)
        return sp

    @property
    def duration_s(self) -> float:
        return self.end - self.t0

    def to_dict(self) -> dict:
        with self._lock:
            spans = list(self.spans)
        return {
            "trace_id": self.trace_id,
            "role": self.role,
            "server": self.server,
            "name": self.name,
            "parent_span_id": self.parent_span_id,
            "root_span_id": self.root_id,
            "start_unix_ms": int(self.wall_start * 1e3),
            "duration_us": int(self.duration_s * 1e6),
            "status": self.status,
            "spans": [sp.to_dict(self.t0) for sp in spans],
        }


class TraceRing:
    """Bounded ring of completed traces (newest win, oldest drop).

    Locking contract (the reference's): finished requests `add()` from
    any thread while /debug/traces and the tail store `snapshot()` and
    `configure()` may `resize()` the
    deque concurrently — EVERY deque touch (append, list-copy, the
    resize swap, clear) runs under `_lock`, so a snapshot can never
    observe the deque mid-resize (deque itself gives no such guarantee
    while `maxlen` is being swapped via rebuild).  Serialization runs
    OUTSIDE the ring lock on the copied Trace references: `to_dict`
    takes each trace's own `_lock` for its span list, and the ring lock
    is never held while a trace lock is taken (nor vice versa — Trace
    never touches the ring), so the two lock classes cannot form an
    order cycle.  A trace's scalar `end`/`status` may still be written
    by `finish_trace` while an already-snapshotted reference serializes
    — benign torn reads of floats/strs, never a torn container.
    tests/test_torch_obs.py races all four operations."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._dq: deque = deque(maxlen=capacity)

    def add(self, trace: Trace) -> None:
        with self._lock:
            self._dq.append(trace)

    def snapshot(
        self,
        limit: int | None = None,
        trace_id: str | None = None,
        since_unix: float | None = None,
    ) -> list[dict]:
        """Newest-first JSON-ready dicts; `trace_id` narrows to one
        trace's entries (a request can leave several per-role entries in
        a co-hosted ring) and `since_unix` keeps only traces still
        ACTIVE at/after that wall time (start + duration, not start:
        a request that stalled for a minute and finished during the
        burn is exactly the culprit an incident window exists to
        capture, and it STARTED before any short window) — both applied
        BEFORE the limit, so a fetch by id or window gets its slice
        instead of paging the whole ring."""
        with self._lock:
            items = list(self._dq)
        items.reverse()
        if trace_id is not None:
            items = [t for t in items if t.trace_id == trace_id]
        if since_unix is not None:
            items = [
                t for t in items
                if t.wall_start + t.duration_s >= since_unix
            ]
        if limit is not None:
            items = items[:limit]
        return [t.to_dict() for t in items]

    def resize(self, capacity: int) -> None:
        with self._lock:
            self._dq = deque(self._dq, maxlen=capacity)

    def clear(self) -> None:
        with self._lock:
            self._dq.clear()


RING = TraceRing(CONFIG.trace_ring)

# finished-trace taps (timeline.py's exemplar sampler).  Append-only
# registration; called after the ring add with the completed trace.
# Kept dumb on purpose: an observer that raises is dropped from the
# hot path's perspective (finish_trace must never fail a request).
FINISH_OBSERVERS: list = []


def configure(cfg: ObsConfig) -> None:
    """Apply the -obs.* flags; process-global like stats.REGISTRY."""
    global CONFIG
    CONFIG = cfg.validated()
    RING.resize(cfg.trace_ring)


def parse_trace_header(value: str) -> tuple[str | None, str]:
    """'<trace_id>-<parent_span_id>' (or bare trace id) -> parts."""
    if not value:
        return None, ""
    tid, _, psid = value.partition("-")
    return (tid or None), psid


# ------------------------------------------------------------- trace scope


def start_trace(name, role, server="", trace_id=None, parent_span_id=""):
    """Begin this server's trace for one inbound request.  Returns
    (trace, token); pass both to finish_trace.  (None, None) when
    tracing is disabled — every other call here no-ops on None."""
    if not CONFIG.enabled:
        return None, None
    t = Trace(trace_id or _new_id(), role, name, server, parent_span_id)
    token = _CURRENT.set((t, t.root_id))
    return t, token


def finish_trace(trace, token, status="") -> None:
    """Complete a trace: publish to the ring + slow log."""
    if trace is None:
        return
    try:
        _CURRENT.reset(token)
    except ValueError:
        pass  # finished from a different context (defensive)
    trace.end = time.perf_counter()
    trace.status = str(status)
    RING.add(trace)
    for obs_fn in FINISH_OBSERVERS:
        try:
            obs_fn(trace)
        except Exception:  # noqa: BLE001 — observers never fail a request
            log.exception("trace finish observer failed")
    dur_ms = trace.duration_s * 1e3
    if CONFIG.slow_ms > 0 and dur_ms >= CONFIG.slow_ms:
        stages = ", ".join(
            f"{sp.name}={sp.duration * 1e3:.2f}ms" for sp in trace.spans
        )
        log.warning(
            "slow request trace=%s role=%s %s: %.2fms (threshold %.1fms) "
            "status=%s stages: %s",
            trace.trace_id, trace.role, trace.name, dur_ms, CONFIG.slow_ms,
            trace.status, stages or "none recorded",
        )


def current():
    """(trace, parent_span_id) active in this context, or None."""
    return _CURRENT.get()


def outbound_headers() -> dict:
    """Headers to attach on outbound HTTP fan-out (empty when untraced)."""
    cur = _CURRENT.get()
    if cur is None:
        return {}
    t, sid = cur
    return {TRACE_HEADER: f"{t.trace_id}-{sid}"}


def grpc_metadata():
    """Metadata pairs for an outbound RPC, or None when untraced."""
    cur = _CURRENT.get()
    if cur is None:
        return None
    t, sid = cur
    return ((GRPC_TRACE_KEY, f"{t.trace_id}-{sid}"),)


# ------------------------------------------------------------------ spans


def record_span(ctx, name, start, duration, observe=True, annotations=None):
    """Record a completed stage onto a (trace, parent_span_id) context
    captured earlier — the dispatcher's queue hop, where the code that
    measured the stage is not running in the request's context.  With
    observe=True the per-stage histogram is fed too; pass False when the
    measurement was already observed once (sink replay)."""
    if observe:
        _metrics.REQUEST_STAGE_SECONDS.labels(stage=name).observe(duration)
    if ctx is None:
        return
    trace, parent = ctx
    trace.add_span(name, start, duration, parent_id=parent,
                   annotations=annotations)


class span:
    """Time a named stage of the current request.  Context-aware:

      * with an active trace (contextvar), records a child span and
        nests: spans opened inside this block become its children;
      * with a stage sink (the dispatcher's multi-trace batch scope),
        accumulates {stage: [total_s, calls, annotations]} for replay
        onto every member trace;
      * always feeds the per-stage Prometheus histogram.

    Works in handlers and in asyncio.to_thread workers alike (the
    context travels with the copied contextvars).  `annotate(**kw)` adds
    facts discovered mid-block (byte counts, compile misses)."""

    __slots__ = ("name", "annotations", "_t0", "_span", "_token")

    def __init__(self, name: str, **annotations):
        self.name = name
        self.annotations = annotations

    def annotate(self, **kw) -> None:
        self.annotations.update(kw)

    def __enter__(self) -> "span":
        self._t0 = time.perf_counter()
        self._span = None
        self._token = None
        cur = _CURRENT.get()
        if cur is not None:
            trace, parent = cur
            self._span = trace.add_span(
                self.name, self._t0, 0.0, parent_id=parent,
                annotations=self.annotations,
            )
            self._token = _CURRENT.set((trace, self._span.span_id))
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = time.perf_counter() - self._t0
        if self._token is not None:
            _CURRENT.reset(self._token)
        if self._span is not None:
            self._span.duration = dur
            self._span.annotations = self.annotations
        else:
            sink = _STAGE_SINK.get()
            if sink is not None:
                rec = sink.setdefault(self.name, [0.0, 0, {}])
                rec[0] += dur
                rec[1] += 1
                for k, v in self.annotations.items():
                    # numeric facts sum across calls (byte counts); the
                    # last value wins otherwise
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        rec[2][k] = rec[2].get(k, 0) + v
                    else:
                        rec[2][k] = v
        _metrics.REQUEST_STAGE_SECONDS.labels(stage=self.name).observe(dur)


class stage_sink:
    """Collect stage timings for a block that serves many traces at once
    (the dispatcher's batched device call).  Yields the dict to replay
    with record_span(observe=False) onto each member trace."""

    __slots__ = ("sink", "_token")

    def __enter__(self) -> dict:
        self.sink: dict = {}
        self._token = _STAGE_SINK.set(self.sink)
        return self.sink

    def __exit__(self, exc_type, exc, tb) -> None:
        _STAGE_SINK.reset(self._token)


class detached:
    """Null the active trace for the duration of the block.  Tasks
    created inside (asyncio copies the spawner's context into the new
    task) must NOT inherit the spawning request's trace: a long-lived
    worker like the dispatcher's drain lane would otherwise keep
    appending every later request's spans to the spawner's finished
    trace in the ring."""

    __slots__ = ("_token",)

    def __enter__(self) -> "detached":
        self._token = _CURRENT.set(None)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _CURRENT.reset(self._token)


def stamp_trace_header(response, trace) -> None:
    """Echo the trace id on a Response or HTTPError (server/http.py; both
    carry a `headers` dict) — one home for the echo rule.  No-op when
    untraced."""
    if trace is None:
        return
    response.headers[TRACE_HEADER] = f"{trace.trace_id}-{trace.root_id}"


# ------------------------------------------------------------------ HTTP


def parse_limit_since(request) -> tuple[int | None, float | None]:
    """Validated (?limit, ?since) -> (limit or None, since_unix cutoff
    or None) — ONE home for the debug endpoints' window parsing
    (/debug/traces, /debug/incident and /debug/tail share the
    semantics).  Raises 400 on negative or non-finite values: nan would
    sail past `< 0` and silently filter everything out."""
    try:
        limit = int(request.query.get("limit", 0))
        since_s = float(request.query.get("since", 0))
    except ValueError:
        raise HTTPError(400, "limit/since must be numeric")
    if limit < 0 or not math.isfinite(since_s) or since_s < 0:
        raise HTTPError(400, "limit/since must be finite >= 0")
    return limit or None, (time.time() - since_s) if since_s else None


async def traces_handler(request):
    """GET /debug/traces: recent complete traces, newest-first, with
    per-span durations.  ?limit=N bounds the payload; ?id=<trace_id>
    fetches one trace's entries instead of the whole ring; ?since=S
    keeps only traces still active in the last S seconds (a
    long-stalled request finishing inside the window counts) — filters
    apply before the limit.  An id that neither the ring nor a tail pin
    holds answers 404 with a JSON error."""
    limit, since_unix = parse_limit_since(request)
    trace_id = request.query.get("id") or None
    traces = RING.snapshot(limit, trace_id, since_unix)
    if trace_id is not None and not traces:
        # a pinned tail tree outlives the main ring's churn — serve it
        # through the same lane so one fetch path covers both rings
        from . import tailstore

        for pin in tailstore.pinned(trace_id):
            traces.extend(pin.get("entries", ()))
        if limit is not None:
            traces = traces[:limit]
    if trace_id is not None and not traces:
        # an id miss is a MISS, not an empty success: the critical-path
        # assembler keys off the status
        return json_response(
            {
                "error": f"trace {trace_id!r} not found (evicted or "
                "never traced)",
                "trace_id": trace_id,
            },
            status=404,
        )
    return json_response({"traces": traces})


# paths whose traffic is telemetry, not service: tracing them would wash
# every real request out of the bounded ring
_UNTRACED_PATHS = ("/metrics", "/status")


def middleware(role: str, server: str = ""):
    """Middleware around a server/http.py handler (`mw(request, handler)
    -> Response`): adopt/start a trace for every inbound data request,
    echo the trace id on the response, finish into the ring.  Also the
    deadline front door (utils/faultpolicy.py): the request's
    X-Seaweed-Deadline-Ms budget is adopted — or the configured default
    stamped — for the handler's duration; a spent budget surfaces as
    504, the honest verdict for work the client already gave up on.
    Any other exception is re-raised (the server answers 500), as the
    reference's middleware re-raises it."""
    from ..utils import faultpolicy

    async def trace_middleware(request, handler):
        path = request.path
        if path in _UNTRACED_PATHS or path.startswith("/debug/"):
            return await handler(request)
        tid, psid = parse_trace_header(request.headers.get(TRACE_HEADER, ""))
        t, token = start_trace(
            f"{request.method} {path}", role,
            server or request.headers.get("Host", ""),
            trace_id=tid, parent_span_id=psid,
        )
        status = ""
        try:
            with faultpolicy.request_scope(request.headers):
                resp = await handler(request)
            status = resp.status
            stamp_trace_header(resp, t)
            return resp
        except HTTPError as e:
            status = e.status
            stamp_trace_header(e, t)
            raise
        except faultpolicy.DeadlineExceeded as e:
            status = 504
            timeout = HTTPError(504, str(e))
            # deadline sheds are exactly the responses an operator
            # wants to correlate — echo the trace id like every other
            # exit path
            stamp_trace_header(timeout, t)
            raise timeout
        except Exception:
            status = 500
            raise
        finally:
            finish_trace(t, token, status)

    return trace_middleware
