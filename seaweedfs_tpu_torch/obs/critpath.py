"""Cross-node trace assembly + critical-path attribution.

Port of seaweedfs_tpu/obs/critpath.py: the assembly and the attribution
are the reference's arithmetic, copied (tests/test_torch_critpath.py holds
them equal on seeded inputs); the master's fan-out over every node's
/debug/traces (`fetch_entries`) rides the port's HTTP client
(server/http.py).

Dapper-style tracing (obs/trace.py) is only half the system: each server
keeps ITS OWN span entries for a request, correlated by the propagated
trace id, and until now a human had to join the per-node rings by hand.
This module is the other half — the per-request complement of the
devledger's per-class answer to "who used the device":

  * `assemble()` stitches every participant's trace entries for one
    trace id into a single request DAG.  Cross-node edges come from the
    propagated header: a child entry's `parent_span_id` is the span id
    that was active on the parent when it fanned out, so the child hangs
    off that exact span.  Each node's wall clock is reconciled against
    the master's heartbeat skew estimate (stats/cluster.py reads the
    `wall_clock_unix_ms` telemetry field), and the child is additionally
    clamped into its parent-side call span's window — millisecond wall
    clocks plus residual skew error must never make a child appear to
    run outside the RPC that invoked it;
  * `attribute()` walks the assembled spans and buckets the root's
    client-visible wall time into the six critical-path segments
    (stats.metrics.CRITPATH_SEGMENTS): queue_wait, device_execute,
    host_reconstruct, disk, network_gap, untraced.  Overlapping spans
    resolve by specificity — a child node's device_execute wins over the
    parent's covering network-call span — so the network_gap segment is
    exactly the remote-call time the remote's own spans do NOT explain,
    and `untraced` is whatever no span anywhere covers;
  * `critpath_handler()` serves GET /debug/critpath?id= on every role:
    the master assembles cluster-wide (fan-out over the existing
    /debug/traces?id= lane, 404 = that node holds no entries), a volume
    server assembles from its local ring + tail pins.

The same bucketing feeds SeaweedFS_critpath_seconds{route,segment} for
every finished root trace (obs/tailstore.py), so the aggregate per-route
composition and the per-request /debug/critpath answer can never use
different arithmetic.
"""
from __future__ import annotations

import asyncio
import json

from ..server.http import HTTPError, fetch, json_response
from ..stats import metrics as _metrics
from . import trace as obs_trace

SEGMENTS = _metrics.CRITPATH_SEGMENTS

# trace stage -> critical-path segment.  Everything the device pipeline
# touches is device_execute (the batched stages replay flat onto member
# traces, so they overlap by construction and must share a bucket);
# remote_shard_read/chunk_fetch are the parent-side network-call windows
# whose unexplained remainder IS the network gap.
STAGE_SEGMENT = {
    "queue_wait": "queue_wait",
    "batch_dispatch": "device_execute",
    "batch_pack": "device_execute",
    "h2d_copy": "device_execute",
    "device_execute": "device_execute",
    "d2h_copy": "device_execute",
    "bulk_device": "device_execute",
    "host_reconstruct": "host_reconstruct",
    "shard_read": "disk",
    "bulk_read": "disk",
    "bulk_write": "disk",
    "remote_shard_read": "network_gap",
    "chunk_fetch": "network_gap",
}

# overlap resolution: the most specific work wins the time slice.  A
# parent's network-call span covers the child's whole execution; the
# child's own device/disk spans must claim their share, leaving only the
# genuinely unexplained wire+handoff time to network_gap.  queue_wait
# ranks last among spans: a request sitting in the coalescer while its
# batch executes is making progress, not waiting.
_PRIORITY = {
    "device_execute": 5,
    "host_reconstruct": 4,
    "disk": 3,
    "network_gap": 2,
    "queue_wait": 1,
}


def route_of(name: str) -> str:
    """Normalize a trace name ('GET /3,0101f3…') to its route class so
    per-route aggregation doesn't explode on file ids: any leading path
    segment that starts with a digit (fid, volume id) collapses to
    '<fid>', everything else keeps its first segment."""
    method, _, path = name.partition(" ")
    if not path:
        return name or "?"
    seg = path.split("?", 1)[0]
    parts = [p for p in seg.split("/") if p]
    if not parts:
        return f"{method} /"
    head = parts[0]
    if head[:1].isdigit():
        return f"{method} /<fid>"
    return f"{method} /{head}"


def attribute(
    intervals: list[tuple[float, float, str]], total_us: float
) -> dict[str, int]:
    """Bucket `total_us` of client-visible wall time into the six
    segments from (start_us, end_us, segment) intervals on the root's
    timeline.  Boundary sweep: each elementary slice goes to the
    highest-priority segment covering it, the uncovered remainder is
    `untraced` — segments sum to total_us by construction."""
    total_us = max(0.0, float(total_us))
    out: dict[str, float] = {s: 0.0 for s in SEGMENTS}
    clipped = []
    for s, e, seg in intervals:
        if seg not in _PRIORITY:
            continue
        s = min(max(0.0, float(s)), total_us)
        e = min(max(0.0, float(e)), total_us)
        if e > s:
            clipped.append((s, e, seg))
    points = sorted(
        {0.0, total_us}
        | {s for s, _, _ in clipped}
        | {e for _, e, _ in clipped}
    )
    covered = 0.0
    for a, b in zip(points, points[1:]):
        if b <= a:
            continue
        best = None
        for s, e, seg in clipped:
            if s <= a and e >= b and (
                best is None or _PRIORITY[seg] > _PRIORITY[best]
            ):
                best = seg
        if best is not None:
            out[best] += b - a
            covered += b - a
    out["untraced"] = max(0.0, total_us - covered)
    return {k: int(round(v)) for k, v in out.items()}


def _dedupe(entries: list[dict]) -> list[dict]:
    """A trace entry can arrive twice — the live ring AND a tail pin,
    or a co-hosted ring fetched through two node urls.  `root_span_id`
    is minted per entry, so it is the identity."""
    seen: dict[tuple, dict] = {}
    for e in entries:
        key = (e.get("server", ""), e.get("role", ""),
               e.get("root_span_id", "") or id(e))
        if key not in seen:
            seen[key] = e
    return list(seen.values())


def assemble(
    entries: list[dict], skew_ms=None, client_total_us: float | None = None
) -> dict | None:
    """Stitch one trace id's per-node entries (Trace.to_dict dicts) into
    the request DAG and attribute the root's wall time.  `skew_ms` maps
    a server name to its estimated clock skew in ms (callable or dict;
    positive = that node's clock runs ahead) — the heartbeat estimate on
    the master, empty elsewhere.  `client_total_us` anchors the timeline
    on the CLIENT's measured wall time when the caller has one: the
    delta above the root handler span is the request/response wire +
    handoff legs no server span can see, so it lands in network_gap —
    not untraced — and the six segments then sum to the client-visible
    total.  Returns None on no entries."""
    ents = _dedupe(entries)
    if not ents:
        return None
    if callable(skew_ms):
        skew = skew_ms
    else:
        table = dict(skew_ms or {})

        def skew(server: str) -> float:
            return float(table.get(server, 0.0))

    # every span id -> owning entry (+ its in-entry window) so a child
    # entry's parent_span_id resolves to the exact parent-side call span
    span_owner: dict[str, int] = {}
    span_at: dict[str, tuple[int, float, float]] = {}
    for i, e in enumerate(ents):
        rid = e.get("root_span_id", "")
        if rid:
            span_owner.setdefault(rid, i)
        for sp in e.get("spans", ()):  # noqa: B007
            sid = sp.get("span_id", "")
            if sid:
                span_owner.setdefault(sid, i)
                span_at[sid] = (
                    i,
                    float(sp.get("offset_us", 0)),
                    float(sp.get("duration_us", 0)),
                )

    parent_of: dict[int, tuple[int, str]] = {}
    for i, e in enumerate(ents):
        psid = e.get("parent_span_id", "")
        j = span_owner.get(psid)
        if psid and j is not None and j != i:
            parent_of[i] = (j, psid)

    # client-facing root: no resolvable parent, preferring an entry with
    # no parent AT ALL (a front door), longest first as the tie-break
    roots = [i for i in range(len(ents)) if i not in parent_of]

    def _root_key(i: int) -> tuple:
        e = ents[i]
        return (
            1 if e.get("parent_span_id") else 0,
            -float(e.get("duration_us", 0)),
        )

    root = min(roots, key=_root_key) if roots else 0
    server_total_us = max(0.0, float(ents[root].get("duration_us", 0)))
    total_us = server_total_us
    if client_total_us is not None:
        total_us = max(total_us, float(client_total_us))

    children: dict[int, list[int]] = {}
    for i, (j, _psid) in parent_of.items():
        children.setdefault(j, []).append(i)

    # place every entry on the root's timeline: skew-adjusted wall start
    # first, then clamp into the parent-side call span (or the parent's
    # whole body when the fan-out happened under the root span)
    adj_ms = [
        float(e.get("start_unix_ms", 0)) - skew(e.get("server", ""))
        for e in ents
    ]
    base_us: list[float | None] = [None] * len(ents)
    base_us[root] = 0.0
    order: list[int] = [root]
    seen_idx = {root}
    qi = 0
    while qi < len(order):
        cur = order[qi]
        qi += 1
        for c in sorted(children.get(cur, ())):
            if c in seen_idx:
                continue  # defensive: corrupt links can't loop us
            seen_idx.add(c)
            order.append(c)
    for i in order[1:]:
        j, psid = parent_of[i]
        pb = base_us[j]
        if pb is None:
            continue
        est = (adj_ms[i] - adj_ms[root]) * 1e3
        dur_i = float(ents[i].get("duration_us", 0))
        if psid in span_at:
            _pj, p_off, p_dur = span_at[psid]
            lo = pb + p_off
            hi = lo + max(0.0, p_dur - dur_i)
        else:
            lo = pb
            hi = pb + max(0.0, float(ents[j].get("duration_us", 0)) - dur_i)
        base_us[i] = min(max(est, lo), max(lo, hi))

    linked = [i for i in order if base_us[i] is not None]
    intervals: list[tuple[float, float, str]] = []
    for i in linked:
        b = base_us[i] or 0.0
        for sp in ents[i].get("spans", ()):
            seg = STAGE_SEGMENT.get(sp.get("name", ""))
            if seg is None:
                continue
            s = b + float(sp.get("offset_us", 0))
            intervals.append((s, s + float(sp.get("duration_us", 0)), seg))
    if total_us > server_total_us:
        # client-anchored: the slice of client wall time outside the
        # root handler span is the uninstrumented wire+handoff legs
        intervals.append((server_total_us, total_us, "network_gap"))
    segments_us = attribute(intervals, total_us)
    segments_pct = {
        k: round(v * 100.0 / total_us, 2) if total_us > 0 else 0.0
        for k, v in segments_us.items()
    }

    def _node_doc(i: int) -> dict:
        e = ents[i]
        b = base_us[i] or 0.0
        return {
            "server": e.get("server", ""),
            "role": e.get("role", ""),
            "name": e.get("name", ""),
            "status": e.get("status", ""),
            "skew_ms": skew(e.get("server", "")),
            "offset_us": int(round(b)),
            "duration_us": int(e.get("duration_us", 0)),
            "spans": [
                {
                    "name": sp.get("name", ""),
                    "offset_us": int(round(b + float(sp.get("offset_us", 0)))),
                    "duration_us": int(sp.get("duration_us", 0)),
                    **(
                        {"annotations": sp["annotations"]}
                        if sp.get("annotations") else {}
                    ),
                }
                for sp in e.get("spans", ())
            ],
            "children": [_node_doc(c) for c in sorted(children.get(i, ()))],
        }

    root_e = ents[root]
    return {
        "trace_id": root_e.get("trace_id", ""),
        "name": root_e.get("name", ""),
        "route": route_of(root_e.get("name", "")),
        "status": root_e.get("status", ""),
        "start_unix_ms": int(root_e.get("start_unix_ms", 0)),
        "total_us": int(total_us),
        "server_total_us": int(server_total_us),
        "segments_us": segments_us,
        "segments_pct": segments_pct,
        "coverage_pct": round(100.0 - segments_pct.get("untraced", 0.0), 2),
        "participants": [
            {
                "server": ents[i].get("server", ""),
                "role": ents[i].get("role", ""),
                "name": ents[i].get("name", ""),
                "offset_us": int(round(base_us[i] or 0.0)),
                "duration_us": int(ents[i].get("duration_us", 0)),
                "spans": len(ents[i].get("spans", ())),
            }
            for i in linked
        ],
        "unlinked": [
            {
                "server": ents[i].get("server", ""),
                "role": ents[i].get("role", ""),
                "name": ents[i].get("name", ""),
            }
            for i in range(len(ents)) if i not in seen_idx
        ],
        "tree": _node_doc(root),
    }


def local_entries(trace_id: str) -> list[dict]:
    """This process's entries for a trace id: the live ring plus any
    pinned tail tree (a tail request may have aged out of the main ring
    — being findable after churn is the tail ring's whole point)."""
    entries = obs_trace.RING.snapshot(trace_id=trace_id)
    from . import tailstore

    for pin in tailstore.pinned(trace_id):
        entries.extend(pin.get("entries", ()))
    return entries


async def fetch_entries(
    trace_id: str, node_urls, timeout_s: float = 2.5
) -> tuple[list[dict], dict[str, str]]:
    """Fan the /debug/traces?id= lane out to `node_urls`; a 404 means
    that node holds no entries for the id (normal for non-participants),
    any other failure is recorded per node instead of failing the
    assembly."""
    urls = sorted(set(node_urls))
    entries: list[dict] = []
    errors: dict[str, str] = {}
    if not urls:
        return entries, errors

    async def one(u: str) -> list[dict]:
        status, _, body = await fetch(
            u, "GET", f"/debug/traces?id={trace_id}", timeout=timeout_s)
        if status == 404:
            return []
        if status != 200:
            raise ValueError(f"HTTP {status}")
        return list(json.loads(body).get("traces", ()))

    results = await asyncio.gather(
        *(one(u) for u in urls), return_exceptions=True
    )
    for u, res in zip(urls, results):
        if isinstance(res, BaseException):
            errors[u] = str(res) or type(res).__name__
        else:
            entries.extend(res)
    return entries, errors


def critpath_handler(node_urls_fn=None, skew_ms_fn=None):
    """GET /debug/critpath?id=<trace_id>: the assembled request DAG +
    critical-path attribution.  With `node_urls_fn` (the master) the
    assembly fans out to every fresh node's /debug/traces?id= and
    reconciles clocks via `skew_ms_fn(server) -> ms`; without it (a
    volume server) the local ring + tail pins are the universe.
    ?client_total_us= anchors the timeline on the client's measured wall
    time.  404 + JSON error when no entry holds the id."""

    async def handler(request):
        trace_id = request.query.get("id") or None
        if not trace_id:
            raise HTTPError(400, "?id=<trace_id> required")
        client_total_us = None
        raw = request.query.get("client_total_us")
        if raw:
            try:
                client_total_us = max(0.0, float(raw))
            except ValueError:
                raise HTTPError(
                    400, "client_total_us must be a number (microseconds)"
                )
        entries = local_entries(trace_id)
        errors: dict[str, str] = {}
        if node_urls_fn is not None:
            remote, errors = await fetch_entries(trace_id, node_urls_fn())
            entries.extend(remote)
        doc = assemble(entries, skew_ms_fn, client_total_us=client_total_us)
        if doc is None:
            return json_response(
                {
                    "error": f"trace {trace_id!r} not found "
                    "(evicted or never traced)",
                    "trace_id": trace_id,
                },
                status=404,
            )
        if errors:
            doc["fetch_errors"] = errors
        return json_response(doc)

    return handler
