"""Tail-based trace retention + per-route critical-path aggregation.

Port of seaweedfs_tpu/obs/tailstore.py (the store and its gate are the
reference's, copied; the handler is rewritten for server/http.py).

The bounded trace ring (obs/trace.py RING) evicts fastest-and-slowest
alike: under load the one trace an operator actually wants — the p99
straggler — is churned out by hundreds of fast requests within seconds.
This module adds the second retention class:

  * every finished trace updates its ROUTE's latency stats (a windowed
    p99 smoothed by an EWMA — `-obs.tail.alpha`); a root trace that
    lands ABOVE the live estimate (or at least `-obs.tail.floorMs`, or
    that tripped a QoS shed / breaker flip / hedge / deadline / stall
    incident mid-flight) gets its FULL span tree — every local ring
    entry for its trace id, child hops included — pinned into a
    separate bounded tail ring (`-obs.tail.ring`, newest pins win).
    Fast requests never pass the gate, so they can never evict a
    pinned slow tree; total memory stays bounded by construction;
  * every finished ROOT trace is also fed through obs/critpath.py's
    bucketing, so SeaweedFS_critpath_seconds{route,segment} and
    SeaweedFS_critpath_route_seconds{route} accumulate the per-route
    critical-path composition (segments sum to the route total by
    construction — chip_smoke.py checks it on the card);
  * `tail_handler` serves GET /debug/tail: per-route stats + pin
    summaries, `?id=` resolves one pinned tree (404 on a miss, same
    contract as /debug/traces).

Like the TimelineSampler, a TailStore hooks trace.FINISH_OBSERVERS via
`install()`; installed stores also register module-globally so
incident.record() can flag the ambient trace at the moment a QoS
decision sheds it — the flag pins the trace when it finishes, however
fast the route's quantile estimate thinks it was.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from ..server.http import json_response
from ..stats import metrics as _metrics
from . import critpath
from . import trace as obs_trace

# incident kinds that pin the ambient trace regardless of its latency:
# the request tripped a control-plane decision, which is exactly the
# evidence a post-hoc "why" needs even when the shed made it FAST
TAIL_TRIGGER_KINDS = frozenset((
    "qos_shed", "qos_breaker", "hedge", "deadline_exceeded",
    "dispatch_saturated", "stall_abort", "retry_budget",
))

# installed stores (append/remove under _INSTALLED_LOCK): each server
# installs one, flag_ambient/pinned fan over all of them
_INSTALLED_LOCK = threading.Lock()
INSTALLED: list["TailStore"] = []

# windowed-p99 estimator shape: the last `_SAMPLE_WINDOW` durations per
# route feed a p99 that the EWMA smooths; below `_MIN_SAMPLES` the
# estimate is not live yet and only the floor/flag gates pin
_SAMPLE_WINDOW = 128
_MIN_SAMPLES = 20


class _RouteStats:
    """One route's latency estimate + critical-path accumulation."""

    __slots__ = ("count", "total_s", "seg_s", "p99_ewma_ms", "pinned",
                 "window")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.seg_s = {s: 0.0 for s in critpath.SEGMENTS}
        self.p99_ewma_ms: float | None = None
        self.pinned = 0
        self.window: deque = deque(maxlen=_SAMPLE_WINDOW)

    def observe(self, dur_ms: float, alpha: float) -> None:
        self.window.append(dur_ms)
        n = len(self.window)
        if n < _MIN_SAMPLES:
            return
        ordered = sorted(self.window)
        p99 = ordered[min(n - 1, int(0.99 * n))]
        if self.p99_ewma_ms is None:
            self.p99_ewma_ms = p99
        else:
            self.p99_ewma_ms += alpha * (p99 - self.p99_ewma_ms)

    def to_dict(self) -> dict:
        total_us = self.total_s * 1e6
        return {
            "count": self.count,
            "total_s": round(self.total_s, 6),
            "p99_ewma_ms": (
                round(self.p99_ewma_ms, 3)
                if self.p99_ewma_ms is not None else None
            ),
            "pinned": self.pinned,
            "segments_s": {k: round(v, 6) for k, v in self.seg_s.items()},
            "segments_pct": {
                k: round(v * 1e6 * 100.0 / total_us, 2) if total_us > 0
                else 0.0
                for k, v in self.seg_s.items()
            },
        }


class TailStore:
    """One process's tail ring + route stats (install like a
    TimelineSampler; uninstall on server stop)."""

    def __init__(self, node: str = "", capacity: int | None = None,
                 alpha: float | None = None,
                 floor_ms: float | None = None):
        cfg = obs_trace.CONFIG
        self.node = node
        self._lock = threading.Lock()
        self._ring: deque = deque(
            maxlen=int(capacity if capacity is not None else cfg.tail_ring)
        )
        self._alpha = float(alpha if alpha is not None else cfg.tail_alpha)
        self._floor_ms = float(
            floor_ms if floor_ms is not None else cfg.tail_floor_ms
        )
        self._routes: dict[str, _RouteStats] = {}
        # trace ids flagged mid-flight by an incident trigger, consumed
        # at finish; bounded so an untraced-flag flood can't grow it
        self._flags: dict[str, str] = {}
        self._flag_order: deque = deque(maxlen=1024)
        self._installed = False

    # ------------------------------------------------------------ install

    def install(self) -> "TailStore":
        if not self._installed:
            obs_trace.FINISH_OBSERVERS.append(self._on_trace)
            with _INSTALLED_LOCK:
                INSTALLED.append(self)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            try:
                obs_trace.FINISH_OBSERVERS.remove(self._on_trace)
            except ValueError:
                pass
            with _INSTALLED_LOCK:
                try:
                    INSTALLED.remove(self)
                except ValueError:
                    pass
            self._installed = False

    # ------------------------------------------------------------ tuning

    def set_floor_ms(self, floor_ms: float) -> None:
        """Retune the absolute pin floor at runtime (a benchmark anchors
        it to a calm p99 it can only measure after the store installs)."""
        if floor_ms < 0:
            raise ValueError("floor_ms must be >= 0")
        self._floor_ms = float(floor_ms)

    # ------------------------------------------------------------- flags

    def flag(self, trace_id: str, reason: str) -> None:
        """Mark a still-running trace for pinning at finish (a QoS
        shed/breaker/hedge decision just shaped it)."""
        if not trace_id:
            return
        with self._lock:
            if trace_id not in self._flags:
                if len(self._flag_order) == self._flag_order.maxlen:
                    oldest = self._flag_order[0]
                    self._flags.pop(oldest, None)
                self._flag_order.append(trace_id)
            self._flags[trace_id] = reason

    # ------------------------------------------------------- finish tap

    def _on_trace(self, t) -> None:
        dur_ms = t.duration_s * 1e3
        is_root = not t.parent_span_id
        route = critpath.route_of(t.name)
        with self._lock:
            st = self._routes.get(route)
            if st is None:
                st = self._routes[route] = _RouteStats()
            threshold = st.p99_ewma_ms  # the estimate BEFORE this sample
            if is_root:
                st.observe(dur_ms, self._alpha)
            flag_reason = self._flags.pop(t.trace_id, None)
            if flag_reason is not None:
                try:
                    self._flag_order.remove(t.trace_id)
                except ValueError:
                    pass
        reason = None
        if flag_reason is not None:
            reason = f"incident:{flag_reason}"
        elif is_root and threshold is not None and dur_ms >= threshold:
            reason = "p99"
        elif is_root and self._floor_ms > 0 and dur_ms >= self._floor_ms:
            reason = "floor"
        if reason is not None:
            # the FULL local span tree: every ring entry for the id
            # (children finished — and ring-published — before the
            # root), frozen now so later churn can't thin it
            entries = obs_trace.RING.snapshot(trace_id=t.trace_id)
            pin = {
                "pinned_unix_ms": int(time.time() * 1e3),
                "trace_id": t.trace_id,
                "route": route,
                "name": t.name,
                "reason": reason,
                "total_ms": round(dur_ms, 3),
                "entries": entries,
            }
            with self._lock:
                self._ring.append(pin)
                self._routes[route].pinned += 1
        if is_root:
            # aggregate critical path: same bucketing the /debug/critpath
            # answer uses, fed from the local view
            doc = critpath.assemble(
                obs_trace.RING.snapshot(trace_id=t.trace_id)
            )
            if doc is None:
                return
            total_s = doc["total_us"] / 1e6
            _metrics.CRITPATH_ROUTE_SECONDS.labels(route=route).inc(total_s)
            covered = 0.0
            with self._lock:
                st = self._routes[route]
                st.count += 1
                st.total_s += total_s
                for seg in critpath.SEGMENTS:
                    if seg == "untraced":
                        continue
                    sec = doc["segments_us"].get(seg, 0) / 1e6
                    covered += sec
                    st.seg_s[seg] += sec
                    if sec > 0:
                        _metrics.CRITPATH_SECONDS.labels(
                            route=route, segment=seg
                        ).inc(sec)
                # untraced as the exact remainder, so the six segments
                # sum to the route total to float precision
                rem = max(0.0, total_s - covered)
                st.seg_s["untraced"] += rem
                _metrics.CRITPATH_SECONDS.labels(
                    route=route, segment="untraced"
                ).inc(rem)

    # ------------------------------------------------------------ readers

    @property
    def capacity(self) -> int:
        return int(self._ring.maxlen or 0)

    def snapshot(
        self, limit: int | None = None, trace_id: str | None = None
    ) -> list[dict]:
        """Newest-first pins; `trace_id` narrows to one request's pin."""
        with self._lock:
            items = list(self._ring)
        items.reverse()
        if trace_id is not None:
            items = [p for p in items if p["trace_id"] == trace_id]
        if limit is not None:
            items = items[:limit]
        return items

    def routes(self) -> dict[str, dict]:
        with self._lock:
            return {r: st.to_dict() for r, st in self._routes.items()}

    def to_doc(self, limit: int | None = 16) -> dict:
        """The /debug/tail document: route stats + pin summaries (the
        full span trees stay behind ?id=)."""
        return {
            "node": self.node,
            "capacity": self.capacity,
            "routes": self.routes(),
            "pinned": [
                {k: v for k, v in p.items() if k != "entries"}
                for p in self.snapshot(limit)
            ],
        }


# ------------------------------------------------------- module fan-outs


def flag_ambient(kind: str, trace_id: str) -> None:
    """incident.record's tap: flag the ambient trace on every installed
    store when the event kind is a tail trigger."""
    if not trace_id or kind not in TAIL_TRIGGER_KINDS:
        return
    with _INSTALLED_LOCK:
        stores = list(INSTALLED)
    for s in stores:
        s.flag(trace_id, kind)


def pinned(trace_id: str) -> list[dict]:
    """Pinned tail entries for a trace id across installed stores."""
    with _INSTALLED_LOCK:
        stores = list(INSTALLED)
    out: list[dict] = []
    for s in stores:
        out.extend(s.snapshot(trace_id=trace_id))
    return out


def tail_handler(store: TailStore):
    """GET /debug/tail for one store: route stats + pins; ?id=<trace_id>
    resolves one pinned FULL span tree (404 + JSON error on a miss, the
    same not-found contract /debug/traces carries); ?limit=N bounds the
    pin summaries."""

    async def handler(request):
        limit, _since = obs_trace.parse_limit_since(request)
        trace_id = request.query.get("id") or None
        if trace_id is not None:
            pins = store.snapshot(trace_id=trace_id)
            if not pins:
                return json_response(
                    {
                        "error": f"trace {trace_id!r} has no pinned tail "
                        "entry (not slow enough, or pin evicted)",
                        "trace_id": trace_id,
                    },
                    status=404,
                )
            return json_response({"pinned": pins})
        return json_response(store.to_doc(limit or 16))

    return handler
