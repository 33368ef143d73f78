"""Cluster-wide flight recorder + incident bundler.

Port of seaweedfs_tpu/obs/incident.py.  The telemetry plane measures
(traces, stage digests, QoS series, the repair plane's histograms) but
captures nothing at the moment things go wrong.  This module is the
black-box recorder half of the incident plane (obs/slo.py is the judge):

  * every role keeps a bounded in-memory ring of EVENTS — the
    *decisions* the serving and repair planes make (QoS sheds and
    breaker transitions, dispatcher saturation, spent deadline budgets,
    stall aborts, SLO violations) — each stamped with the ambient trace
    id, so one slow request's trace can be joined against the decisions
    that shaped it, and a decision that shaped a request flags its trace
    for tail pinning (obs/tailstore.py);
  * `GET /debug/incident?since=S&limit=N&kind=K` serves the ring plus
    the matching /debug/traces window on every role, the fan-out target
    of the master's bundler;
  * when the master's SLO engine fires (or an operator runs
    `cluster.incident.dump`), `IncidentBundler` snapshots ALL fresh
    nodes' events+traces over the port's HTTP client (server/http.py),
    correlates trace ids across nodes, optionally grabs a short
    torch.profiler capture of the busiest node (latency SLOs; on the
    card its CUPTI kernel records), and writes ONE JSON bundle under
    -obs.incident.dir — rate-limited (-obs.incident.minIntervalSeconds)
    and ring-capped (-obs.incident.keep) so a flapping SLO can't fill
    the disk.

Recording is a lock-guarded deque append (no IO, no serialization).
"""
from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any

from ..server.http import get_json, json_response
from . import trace as obs_trace

log = logging.getLogger("obs")


@dataclass
class IncidentConfig:
    """Tunables for the flight recorder + bundler (the -obs.incident.*
    flags; every role shares the recorder knobs, the bundler knobs are
    master-only)."""

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
    matching /debug/traces window — the master's incident fan-out fetches
    exactly this from every fresh node.  ?since=S keeps only the last S seconds
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


# ------------------------------------------------------------- bundler


class IncidentBundler:
    """Master-side: one correlated incident bundle per SLO fire (or
    manual dump), written under CONFIG.dir.

    The bundle joins what every plane saw over the burn window: the SLO
    verdict that tripped, the full /cluster/health.json document (slo +
    repair blocks included), every fresh node's flight-recorder events
    for the window plus this process's own ring (the master records
    repair/SLO events), the cross-node trace-id correlation, the
    ASSEMBLED critical paths of the window's worst offenders (raw
    per-node trace rings collapse to counts — obs/critpath.py turns
    them into the structured "why" before the write), and — for latency
    SLOs with profiling enabled — a device-profile capture from the
    busiest node."""

    def __init__(
        self, node_urls_fn, health_fn, clock=time.monotonic,
        timeline_fn=None, skew_ms_fn=None,
    ):
        # node_urls_fn() -> fresh volume-server HTTP urls;
        # health_fn() -> the /cluster/health.json dict (slo block incl.);
        # timeline_fn(window_s) -> the assembled cluster flight timeline
        # (stats/cluster.py) — the "what happened BEFORE the burn" view;
        # skew_ms_fn(server) -> heartbeat clock-skew estimate in ms, fed
        # to the critical-path assembly of the worst offenders
        self._node_urls = node_urls_fn
        self._health = health_fn
        self._timeline = timeline_fn
        self._skew_ms = skew_ms_fn
        self._clock = clock
        self._last_bundle_at: float | None = None
        self._lock = asyncio.Lock()  # one capture at a time
        self.bundles_written = 0
        self.last_bundle_path: str | None = None

    def _rate_limited(self) -> bool:
        return (
            self._last_bundle_at is not None
            and self._clock() - self._last_bundle_at
            < CONFIG.min_interval_seconds
        )

    async def capture(
        self,
        reason: dict,
        window_s: float,
        trigger: str = "slo",
        force: bool = False,
    ) -> dict | None:
        """Build + write one bundle; returns a summary dict (path,
        correlation) or None when bundling is disabled or rate-limited
        (`force=True` — the operator's manual dump — skips only the
        rate limit, never the disabled state)."""
        if not CONFIG.dir:
            return None
        async with self._lock:
            if not force and self._rate_limited():
                log.info(
                    "incident bundle suppressed (rate limit %ss): %s",
                    CONFIG.min_interval_seconds, reason,
                )
                return None
            now_ms = int(time.time() * 1e3)
            since_unix = time.time() - window_s
            nodes: dict[str, dict] = {
                # this process's own ring FIRST, before the fan-out:
                # the triggering slo_violation event must not age out
                # of the window while slow peers are being fetched
                "<master>": {
                    "events": EVENTS.snapshot(since_unix),
                    "traces": obs_trace.RING.snapshot(
                        since_unix=since_unix
                    ),
                }
            }
            urls = sorted(self._node_urls())
            results = await asyncio.gather(
                *(
                    get_json(u, f"/debug/incident?since={window_s}",
                             timeout=5.0)
                    for u in urls
                ),
                return_exceptions=True,
            )
            for u, res in zip(urls, results):
                if isinstance(res, BaseException):
                    # a node that died IS the incident; record the
                    # failure instead of losing the whole bundle
                    nodes[u] = {"error": str(res) or type(res).__name__}
                else:
                    nodes[u] = {
                        "events": res.get("events", []),
                        "traces": res.get("traces", []),
                    }
            profile = None
            if (
                trigger == "slo"
                and reason.get("latency")
                and CONFIG.profile_seconds > 0
            ):
                profile = await self._capture_profile(urls)
            timeline = None
            if self._timeline is not None:
                try:
                    # the trailing flight-timeline window: per-class
                    # device attribution + QoS/ingest pressure leading
                    # INTO the burn, clock-aligned across nodes
                    timeline = self._timeline(window_s)
                except Exception:  # noqa: BLE001 — a timeline failure
                    # must not lose the bundle
                    log.exception("incident timeline assembly failed")
            # correlation reads the raw per-node trace payloads; the
            # bundle itself then carries the ASSEMBLED critical paths of
            # the worst offenders instead of every node's raw ring — the
            # structured "why" an operator opens the bundle for, at a
            # fraction of the bytes
            correlation = self._correlate(nodes)
            critpaths = self._worst_critpaths(nodes)
            for doc in nodes.values():
                traces = doc.pop("traces", None)
                if traces is not None:
                    doc["trace_count"] = len(traces)
            bundle = {
                "written_unix_ms": now_ms,
                "trigger": trigger,
                "window_seconds": window_s,
                "reason": reason,
                "health": self._health(),
                "timeline": timeline,
                "nodes": nodes,
                "correlation": correlation,
                "critpaths": critpaths,
                "profile": profile,
            }
            path = os.path.join(
                CONFIG.dir,
                f"incident-{now_ms}-{reason.get('slo', trigger)}.json",
            )
            await asyncio.to_thread(self._write_capped, path, bundle)
            # the rate-limit clock starts only at a SUCCESSFULLY written
            # SLO-fired bundle: a manual force-dump or a failed fan-out/
            # write must not consume the interval — violations fire on
            # rising edges only and never retry, so a consumed interval
            # with no bundle would lose the real incident's black box
            if not force:
                self._last_bundle_at = self._clock()
            self.bundles_written += 1
            self.last_bundle_path = path
            log.warning(
                "incident bundle written: %s (%d nodes, %d correlated "
                "trace ids)", path, len(nodes),
                len(bundle["correlation"]["trace_ids_multi_node"]),
            )
            return {
                "path": path,
                "nodes": sorted(nodes),
                "correlation": bundle["correlation"],
                "profile": profile,
            }

    async def _capture_profile(self, urls: list[str]) -> dict:
        """Short torch.profiler capture (obs/profile.py: CUPTI's kernel
        records on the card), busiest fresh node first (by dispatcher
        queue depth in the health doc), falling through the candidates —
        the burn's likely CAUSE may be a node that just died but hasn't
        aged stale yet.  Errors are recorded, never raised — the bundle
        must land even when profiling is unavailable (SWFS_DEBUG off, no
        profiler)."""
        if not urls:
            return {"error": "no fresh nodes"}
        health_nodes = self._health().get("nodes", {})

        def depth(u: str) -> int:
            return int(
                (health_nodes.get(u, {}).get("dispatcher") or {}).get(
                    "queue_depth", 0
                )
            )

        last: dict = {}
        for target in sorted(urls, key=depth, reverse=True):
            try:
                res = await get_json(
                    target,
                    f"/debug/profile?seconds={CONFIG.profile_seconds}",
                    # generous: a process's FIRST capture pays CUPTI's
                    # start (seconds) on top of the window
                    timeout=CONFIG.profile_seconds + 30.0,
                )
                return {"node": target, **res}
            except Exception as e:  # noqa: BLE001 — best-effort; try
                # the next candidate
                last = {
                    "node": target,
                    "error": str(e) or type(e).__name__,
                }
        return last

    def _worst_critpaths(self, nodes: dict[str, dict], top: int = 5) -> list:
        """Assembled critical paths of the window's worst offenders:
        pool every node's fetched trace entries by id, rank the root
        entries by client-visible duration, and assemble the top few
        cross-node (obs/critpath.py, heartbeat skew applied).  Pinned
        tail trees in this process's stores are pooled too — a straggler
        that aged out of every live ring is exactly the one the bundle
        is for.  Best-effort: an assembly failure drops that entry, not
        the bundle."""
        from . import critpath, tailstore

        by_id: dict[str, list[dict]] = {}
        for doc in nodes.values():
            for t in doc.get("traces", ()):
                tid = t.get("trace_id", "")
                if tid:
                    by_id.setdefault(tid, []).append(t)
        with tailstore._INSTALLED_LOCK:
            stores = list(tailstore.INSTALLED)
        for s in stores:
            for pin in s.snapshot():
                for t in pin.get("entries", ()):
                    tid = t.get("trace_id", "")
                    if tid:
                        by_id.setdefault(tid, []).append(t)

        def root_duration(entries: list[dict]) -> float:
            return max(
                (
                    float(t.get("duration_us", 0))
                    for t in entries if not t.get("parent_span_id")
                ),
                default=0.0,
            )

        worst = sorted(
            by_id.items(), key=lambda kv: root_duration(kv[1]), reverse=True
        )[: max(0, top)]
        out = []
        for tid, entries in worst:
            if root_duration(entries) <= 0:
                continue
            try:
                doc = critpath.assemble(entries, self._skew_ms)
            except Exception:  # noqa: BLE001 — best-effort embedding
                log.exception("critpath assembly failed for %s", tid)
                continue
            if doc is not None:
                out.append(doc)
        return out

    @staticmethod
    def _correlate(nodes: dict[str, dict]) -> dict:
        """The 'one request, many servers' joins the operator reads the
        bundle for.  Two views: `trace_ids_multi_node` (ids fetched
        from 2+ node endpoints — meaningful in a multi-process
        deployment, trivially shared in a co-hosted/in-process one,
        since co-hosted roles share one ring) and
        `trace_ids_cross_server` (ids whose ENTRIES were recorded at
        2+ distinct capture points — e.g. a front door's HTTP entry
        plus the peer's `grpc VolumeEcShardRead` entry — which proves
        the request genuinely crossed servers either way)."""
        seen: dict[str, set[str]] = {}
        entries: dict[str, set[tuple]] = {}
        for url, doc in nodes.items():
            ids = {t["trace_id"] for t in doc.get("traces", [])}
            ids |= {
                e["trace_id"] for e in doc.get("events", [])
                if e.get("trace_id")
            }
            for tid in ids:
                seen.setdefault(tid, set()).add(url)
            for t in doc.get("traces", []):
                entries.setdefault(t["trace_id"], set()).add(
                    (t.get("role", ""), t.get("server", ""),
                     t.get("name", ""))
                )
        multi = sorted(
            tid for tid, where in seen.items() if len(where) >= 2
        )
        cross = sorted(
            tid for tid, pts in entries.items() if len(pts) >= 2
        )
        return {
            "trace_ids_multi_node": multi,
            "trace_ids_cross_server": cross,
            "nodes_with_data": sum(
                1 for d in nodes.values()
                if d.get("events") or d.get("traces")
            ),
        }

    @staticmethod
    def _write_capped(path: str, bundle: dict) -> None:
        """Atomic write + keep-cap enforcement (oldest bundles deleted
        past CONFIG.keep; stale .tmp leftovers from crashed/cancelled
        writes pruned too, or they would accumulate outside the cap
        forever) — runs on a worker thread."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(bundle, f, indent=1, default=str)
        os.replace(tmp, path)
        d = os.path.dirname(path)
        bundles = sorted(
            fn for fn in os.listdir(d)
            if fn.startswith("incident-") and fn.endswith(".json")
        )
        stale_tmp = [
            fn for fn in os.listdir(d)
            if fn.startswith("incident-") and ".json.tmp." in fn
        ]
        for fn in bundles[: max(0, len(bundles) - CONFIG.keep)] + stale_tmp:
            try:
                os.remove(os.path.join(d, fn))
            except OSError:  # raced another cleanup; the cap held anyway
                pass
