"""The flight recorder: the volume server's half of the incident plane.

Port of seaweedfs_tpu/obs/incident.py without the master-side
`IncidentBundler` (it fans out to every node and writes bundles on an SLO
fire; it waits for the master, ROADMAP A7c).  The telemetry plane measures
but captures nothing at the moment things go wrong; this is the
black-box recorder:

  * the process keeps a bounded in-memory ring of EVENTS — the
    *decisions* the serving plane makes (QoS sheds and breaker
    transitions, dispatcher saturation, spent deadline budgets) — each
    stamped with the ambient trace id, so one slow request's trace can
    be joined against the decisions that shaped it, and a decision that
    shaped a request flags its trace for tail pinning
    (obs/tailstore.py);
  * `GET /debug/incident?since=S&limit=N&kind=K` serves the ring plus
    the matching /debug/traces window.

Recording is a lock-guarded deque append (no IO, no serialization).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any

from ..server.http import json_response
from . import trace as obs_trace


@dataclass
class IncidentConfig:
    """Tunables for the flight recorder + bundler (the -obs.incident.*
    flags).  A copy of the reference's: the volume server takes the
    recorder knobs; the bundler knobs (dir, keep, min_interval_seconds,
    profile_seconds) are validated alike but used by nothing until the
    master is ported."""

    # record decision events into the in-memory ring at all
    # (-obs.incident.disable)
    enabled: bool = True
    # events kept in the per-process ring, newest win
    # (-obs.incident.events)
    events: int = 512
    # master-side: directory incident bundles are written under
    # (-obs.incident.dir); empty disables automatic bundling AND the
    # manual cluster.incident.dump
    dir: str = ""
    # bundles kept on disk, oldest deleted first (-obs.incident.keep)
    keep: int = 16
    # minimum seconds between bundles (-obs.incident.minIntervalSeconds):
    # a flapping SLO produces ONE bundle per interval, not one per pulse
    min_interval_seconds: float = 60.0
    # when the burning SLO is a LATENCY SLO, grab a device-profile
    # capture of this many seconds from the busiest fresh node via
    # /debug/profile (-obs.incident.profileSeconds; 0 disables — the
    # endpoint is SWFS_DEBUG-gated, so captures need that env too)
    profile_seconds: float = 0.0

    def validated(self) -> "IncidentConfig":
        if self.events < 1:
            raise ValueError("events ring must hold >= 1")
        if self.keep < 1:
            raise ValueError("keep must be >= 1")
        if self.min_interval_seconds < 0:
            raise ValueError("min_interval_seconds must be >= 0")
        if self.profile_seconds < 0:
            raise ValueError("profile_seconds must be >= 0")
        return self


CONFIG = IncidentConfig()


class EventRing:
    """Bounded ring of flight-recorder events.

    Locking mirrors TraceRing's discipline (obs/trace.py): every
    deque touch — append, copy, swap-on-resize — happens under `_lock`,
    and snapshots serialize OUTSIDE it from the copied list, so a
    recorder on a hot shed path never waits on a reader building JSON.
    Events are stored as plain dicts frozen at record time; nothing
    mutates them afterwards, so the copied references are safe to read
    unlocked."""

    def __init__(self, capacity: int = 512):
        self._lock = threading.Lock()
        self._dq: deque = deque(maxlen=capacity)

    def add(self, event: dict) -> None:
        with self._lock:
            self._dq.append(event)

    def resize(self, capacity: int) -> None:
        with self._lock:
            self._dq = deque(self._dq, maxlen=capacity)

    def clear(self) -> None:
        with self._lock:
            self._dq.clear()

    def snapshot(
        self,
        since_unix: float | None = None,
        limit: int | None = None,
        kind: str | None = None,
    ) -> list[dict]:
        """Newest-first events; `since_unix` keeps only events at/after
        that wall time and `kind` narrows to one event kind — both
        applied BEFORE the limit, like the trace ring's filters."""
        with self._lock:
            items = list(self._dq)
        items.reverse()
        if since_unix is not None:
            items = [e for e in items if e["unix_ms"] >= since_unix * 1e3]
        if kind is not None:
            items = [e for e in items if e["kind"] == kind]
        if limit is not None:
            items = items[:limit]
        return items


EVENTS = EventRing(CONFIG.events)


def configure(cfg: IncidentConfig) -> None:
    """Apply the -obs.incident.* flags; process-global like the trace
    ring."""
    global CONFIG
    CONFIG = cfg.validated()
    EVENTS.resize(cfg.events)


def record(kind: str, **details: Any) -> None:
    """Record one decision event, stamped with the ambient trace id
    (empty when the decision ran outside any request context — a
    background loop's move).  Hot-path cheap: one dict build + one
    locked append; no IO, nothing retained beyond the ring."""
    if not CONFIG.enabled:
        return
    cur = obs_trace.current()
    trace_id = cur[0].trace_id if cur is not None else ""
    EVENTS.add(
        {
            "unix_ms": int(time.time() * 1e3),
            "kind": kind,
            "trace_id": trace_id,
            "details": details,
        }
    )
    if trace_id:
        # a shed/breaker/hedge/stall decision marks the ambient trace
        # for tail-ring pinning at finish (obs/tailstore.py filters to
        # its trigger kinds; no installed store = no-op)
        from . import tailstore

        tailstore.flag_ambient(kind, trace_id)


# ------------------------------------------------------------------ HTTP


async def incident_handler(request):
    """GET /debug/incident: this process's flight-recorder ring plus the
    matching /debug/traces window (what the reference's master fans out
    to fetch from every node).  ?since=S keeps only the last S seconds
    (events AND traces), ?limit=N bounds each list, ?kind= narrows
    events."""
    limit, since_unix = obs_trace.parse_limit_since(request)
    return json_response(
        {
            "generated_unix_ms": int(time.time() * 1e3),
            "events": EVENTS.snapshot(
                since_unix, limit, request.query.get("kind") or None
            ),
            "traces": obs_trace.RING.snapshot(
                limit, since_unix=since_unix
            ),
        }
    )
