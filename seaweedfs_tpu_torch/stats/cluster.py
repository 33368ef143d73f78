"""Master-side cluster telemetry plane (the Monarch/Borgmon-style view).

Every volume server ships a compact `VolumeServerTelemetry` payload on
each heartbeat pulse (server/volume.py _build_telemetry): device shard
cache occupancy, serving-dispatcher state, and a fixed-bucket DELTA
digest of its `SeaweedFS_request_stage_seconds` histogram.  This module
is the receiving half:

  * `ClusterTelemetry.observe()` keeps the latest per-node snapshot and
    folds each node's stage digests into cluster-wide merged histograms
    (same bucket edges on both sides — stats.STAGE_SECONDS_BUCKETS — so
    merging is vector addition, no raw samples ever cross the wire);
  * nodes that miss heartbeats are flagged STALE after
    `stale_after_pulses` intervals; their last snapshot is kept (an
    operator wants to see what the dead node last looked like), their
    scalars drop out of the fresh-cluster aggregates;
  * `refresh_gauges()` re-exports the aggregate view as master-side
    `SeaweedFS_cluster_*` series at scrape time;
  * `health()` builds the `/cluster/health.json` document: per-node
    freshness + HBM headroom + dispatcher state, the cluster residency
    map, and per-stage p50/p99 estimates interpolated from the merged
    buckets ("The Tail at Scale"'s prerequisite for hedged routing).

A copy of seaweedfs_tpu/stats/cluster.py on the port's own metric types
(stats/metrics.py); the port's volume servers ship the stage digests and
timeline samples it merges (server/volume.py, ACK-gated).
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import Any

from .metrics import REGISTRY, STAGE_SECONDS_BUCKETS, Counter, Gauge

# ONE retention window for everything the telemetry plane keeps past a
# node's last heartbeat: a disconnected node's final snapshot AND its
# shipped flight-timeline samples age out together (two magic numbers
# here previously meant the post-mortem views could expire at different
# times — useless for correlating them)
RETENTION_SECONDS = 3600.0

CLUSTER_NODES = Gauge(
    "SeaweedFS_cluster_volume_nodes",
    "Volume servers known to the master's telemetry plane, by heartbeat "
    "freshness (stale = missed >= 2 pulse intervals).",
    ["state"],
    registry=REGISTRY,
)
for _s in ("fresh", "stale"):
    CLUSTER_NODES.labels(state=_s)
CLUSTER_DEVICE_BUDGET = Gauge(
    "SeaweedFS_cluster_device_budget_bytes",
    "Per-node device shard-cache budget (HBM bytes reserved for EC "
    "shards), re-exported from heartbeat telemetry.",
    ["node"],
    registry=REGISTRY,
)
CLUSTER_DEVICE_USED = Gauge(
    "SeaweedFS_cluster_device_used_bytes",
    "Per-node device shard-cache bytes in use (padded device bytes).",
    ["node"],
    registry=REGISTRY,
)
CLUSTER_DEVICE_RESIDENT = Gauge(
    "SeaweedFS_cluster_device_resident_shards",
    "Per-node EC shards resident in device HBM.",
    ["node"],
    registry=REGISTRY,
)
CLUSTER_DEVICE_EVICTIONS = Gauge(
    "SeaweedFS_cluster_device_evictions",
    "Per-node cumulative budget-pressure shard evictions (the 'HBM too "
    "small for the working set' signal), re-exported from heartbeats.",
    ["node"],
    registry=REGISTRY,
)
CLUSTER_DISPATCHER_QUEUE = Gauge(
    "SeaweedFS_cluster_dispatcher_queue_depth",
    "Per-node EC serving dispatcher queue depth at last heartbeat.",
    ["node"],
    registry=REGISTRY,
)
CLUSTER_DISPATCHER_INFLIGHT = Gauge(
    "SeaweedFS_cluster_dispatcher_inflight",
    "Per-node EC serving dispatcher batches in flight at last heartbeat.",
    ["node"],
    registry=REGISTRY,
)
CLUSTER_DISPATCHER_SHED = Gauge(
    "SeaweedFS_cluster_dispatcher_shed",
    "Per-node cumulative EC reads shed to the native path (dispatcher "
    "backpressure), re-exported from heartbeats.",
    ["node"],
    registry=REGISTRY,
)
CLUSTER_OVERLAP_FRACTION = Gauge(
    "SeaweedFS_cluster_ec_overlap_fraction",
    "Per-node device-busy/wall ratio of the last double-buffered EC "
    "batch window (>1 = staging slots overlapped), re-exported from "
    "heartbeat telemetry.",
    ["node"],
    registry=REGISTRY,
)
CLUSTER_TIER_VOLUMES = Gauge(
    "SeaweedFS_cluster_tier_volumes",
    "Per-node EC volume census by residency tier (hbm/host/disk) at the "
    "node's last tier rebalance, re-exported from heartbeat telemetry.",
    ["node", "tier"],
    registry=REGISTRY,
)
CLUSTER_TIER_PROMOTIONS = Gauge(
    "SeaweedFS_cluster_tier_promotions",
    "Per-node cumulative residency-ladder promotions (hbm + host), "
    "re-exported from heartbeat telemetry.",
    ["node"],
    registry=REGISTRY,
)
CLUSTER_TIER_DEMOTIONS = Gauge(
    "SeaweedFS_cluster_tier_demotions",
    "Per-node cumulative residency-ladder demotions (hbm + host) — "
    "rising fast relative to promotions means that node's ladder is "
    "thrashing.",
    ["node"],
    registry=REGISTRY,
)
# SLO engine (obs/slo.py): declared objectives evaluated every
# telemetry pulse with multi-window burn-rate alerting.  Burn rate =
# (observed bad fraction over the window) / (budgeted bad fraction);
# >= the threshold on BOTH windows = a violation, which also fires the
# incident bundler.  Budget remaining is 1 - slow-window burn, clamped.
CLUSTER_SLO_BURN_RATE = Gauge(
    "SeaweedFS_cluster_slo_burn_rate",
    "Error-budget burn rate per declared SLO and alert window (fast = "
    "-obs.slo.fastWindowSeconds, slow = -obs.slo.slowWindowSeconds); "
    "1.0 = burning exactly the budgeted rate, >= the threshold on both "
    "windows fires a violation.",
    ["slo", "window"],
    registry=REGISTRY,
)
CLUSTER_SLO_BUDGET = Gauge(
    "SeaweedFS_cluster_slo_budget_remaining",
    "Fraction of the error budget left over the slow alert window per "
    "declared SLO (1.0 = untouched, 0.0 = fully burned); refills on "
    "its own as bad pulses age out of the window.",
    ["slo"],
    registry=REGISTRY,
)
CLUSTER_SLO_VIOLATIONS = Counter(
    "SeaweedFS_cluster_slo_violations",
    "SLO violations fired (rising edges only: fast AND slow burn "
    "crossed the threshold together) — each one also triggers an "
    "incident bundle when -obs.incident.dir is set.",
    ["slo"],
    registry=REGISTRY,
)
for _slo in ("read_p99", "error_rate", "time_to_healthy", "breaker_open"):
    CLUSTER_SLO_BUDGET.labels(slo=_slo)
    CLUSTER_SLO_VIOLATIONS.labels(slo=_slo)
    for _w in ("fast", "slow"):
        CLUSTER_SLO_BURN_RATE.labels(slo=_slo, window=_w)
CLUSTER_STAGE_P50 = Gauge(
    "SeaweedFS_cluster_stage_p50_seconds",
    "Cluster-wide p50 estimate per serving stage, interpolated from the "
    "merged heartbeat stage digests.",
    ["stage"],
    registry=REGISTRY,
)
CLUSTER_STAGE_P99 = Gauge(
    "SeaweedFS_cluster_stage_p99_seconds",
    "Cluster-wide p99 estimate per serving stage, interpolated from the "
    "merged heartbeat stage digests.",
    ["stage"],
    registry=REGISTRY,
)


def quantile_from_buckets(
    counts: Sequence[float],
    q: float,
    edges: Sequence[float] = STAGE_SECONDS_BUCKETS,
) -> float | None:
    """Linear-interpolation quantile estimate from per-bucket counts
    (len(edges) + 1, last bucket = +Inf overflow).  The overflow bucket
    has no upper edge, so a quantile landing there reports the last
    finite edge — a deliberate UNDER-estimate, flagged by the caller via
    the overflow count rather than invented here.  None when empty."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    acc = 0.0
    lo = 0.0
    for i, c in enumerate(counts):
        hi = edges[i] if i < len(edges) else math.inf
        if acc + c >= target and c > 0:
            if math.isinf(hi):
                return float(edges[-1])
            return lo + (hi - lo) * (target - acc) / c
        acc += c
        lo = hi
    return float(edges[-1])


@dataclass
class NodeTelemetry:
    """Latest heartbeat-carried snapshot for one volume server."""

    last_seen: float = 0.0
    connected: bool = True
    has_payload: bool = False  # False: pre-telemetry server, identity only
    device_budget_bytes: int = 0
    device_used_bytes: int = 0
    device_resident_shards: int = 0
    device_evictions: int = 0
    device_pin_claims: int = 0
    compile_hits: int = 0
    compile_misses: int = 0
    compile_cache_enabled: bool = False
    dispatcher_queue_depth: int = 0
    dispatcher_inflight: int = 0
    dispatcher_shed: int = 0
    qos_breaker_open: bool = False
    # cumulative EC reads admitted / shed on this node — the master's
    # error-rate SLO numerator & denominator (obs/slo.py)
    ec_reads_total: int = 0
    ec_reads_shed_total: int = 0
    overlap_fraction: float = 0.0
    ec_h2d_bytes: int = 0
    ec_d2h_bytes: int = 0
    tier_hbm_volumes: int = 0
    tier_host_volumes: int = 0
    tier_promotions: int = 0
    tier_demotions: int = 0
    tier_host_bytes: int = 0
    # per-device residency breakdown (r19 mesh layout), index-ordered:
    # one entry per serving-mesh device; [] = no cache / pre-r19 server
    device_bytes_per_device: list[int] = field(default_factory=list)
    resident_by_volume: dict[int, int] = field(default_factory=dict)
    # streaming ingest plane (r20): write bytes accepted, stripe rows
    # encoded online split by codec locus, door sheds, group-commit
    # fsyncs, live pipelines, seals that skipped the offline encode
    ingest_bytes_total: int = 0
    ingest_rows_device: int = 0
    ingest_rows_host: int = 0
    ingest_shed_total: int = 0
    ingest_fsyncs_total: int = 0
    ingest_active_pipelines: int = 0
    ingest_streamed_seals: int = 0
    # flight-timeline samples shipped over heartbeats (obs/timeline.py),
    # keyed by the sample's whole-second `t` — the key IS the dedupe for
    # ACK-protocol reships — trimmed to RETENTION_SECONDS
    timeline: dict[int, dict] = field(default_factory=dict)
    # node wall clock minus master wall clock (ms) at the last pulse,
    # from pb wall_clock_unix_ms — the tail-forensics assembler's span
    # reconciliation input; None until a clock-stamped pulse arrives
    clock_skew_ms: float | None = None
    # multi-controller pod membership (r20): the pod id shared by every
    # member of one jax.distributed job ("" = single-process server)
    # and this member's rank/count — the per-host pod rows of health()
    mesh_pod: str = ""
    mesh_process_id: int = 0
    mesh_process_count: int = 1

    def to_dict(self, now: float, stale_after: float) -> dict[str, Any]:
        age = now - self.last_seen
        d: dict[str, Any] = {
            "age_seconds": round(age, 3),
            "stale": bool(age > stale_after),
            "connected": self.connected,
            "telemetry": self.has_payload,
        }
        if self.mesh_pod:
            # per-host pod row: which host (process) of which pod this
            # node is — health()'s pods table aggregates across nodes
            d["mesh"] = {
                "pod": self.mesh_pod,
                "process_id": self.mesh_process_id,
                "process_count": self.mesh_process_count,
            }
        if self.has_payload:
            if self.clock_skew_ms is not None:
                d["clock_skew_ms"] = round(self.clock_skew_ms, 3)
            d["device"] = {
                "budget_bytes": self.device_budget_bytes,
                "used_bytes": self.device_used_bytes,
                "headroom_bytes": max(
                    0, self.device_budget_bytes - self.device_used_bytes
                ),
                "resident_shards": self.device_resident_shards,
                "evictions": self.device_evictions,
                "pin_claims": self.device_pin_claims,
                "compile_hits": self.compile_hits,
                "compile_misses": self.compile_misses,
                "compile_cache_enabled": self.compile_cache_enabled,
                "resident_shards_by_volume": {
                    str(v): n for v, n in sorted(self.resident_by_volume.items())
                },
            }
            if self.device_bytes_per_device:
                # the device-axis breakdown: per-device used/budget so a
                # lopsided mesh (one chip full, others idle) reads off
                # cluster.health instead of hiding in the aggregate
                per = self.device_budget_bytes // max(
                    1, len(self.device_bytes_per_device)
                )
                d["device"]["per_device"] = [
                    {
                        "device": i,
                        "used_bytes": used,
                        "budget_bytes": per,
                        "headroom_bytes": max(0, per - used),
                    }
                    for i, used in enumerate(self.device_bytes_per_device)
                ]
            d["dispatcher"] = {
                "queue_depth": self.dispatcher_queue_depth,
                "inflight": self.dispatcher_inflight,
                "shed_total": self.dispatcher_shed,
                # true while the node's INTERACTIVE admission breaker is
                # open — the repair scheduler's yield signal
                "qos_breaker_open": self.qos_breaker_open,
                "overlap_fraction": round(self.overlap_fraction, 3),
                "h2d_bytes_total": self.ec_h2d_bytes,
                "d2h_bytes_total": self.ec_d2h_bytes,
                "ec_reads_total": self.ec_reads_total,
                "ec_reads_shed_total": self.ec_reads_shed_total,
            }
            d["tiering"] = {
                "hbm_volumes": self.tier_hbm_volumes,
                "host_volumes": self.tier_host_volumes,
                "promotions_total": self.tier_promotions,
                "demotions_total": self.tier_demotions,
                "host_bytes": self.tier_host_bytes,
            }
            d["ingest"] = {
                "bytes_total": self.ingest_bytes_total,
                "rows_device": self.ingest_rows_device,
                "rows_host": self.ingest_rows_host,
                "shed_total": self.ingest_shed_total,
                "fsyncs_total": self.ingest_fsyncs_total,
                "active_pipelines": self.ingest_active_pipelines,
                "streamed_seals": self.ingest_streamed_seals,
            }
        return d


@dataclass
class _StageAgg:
    """Cluster-merged digest for one stage: per-bucket counts (fixed
    ladder + trailing +Inf overflow), total count, total seconds."""

    buckets: list[int]
    count: int
    sum_seconds: float


class ClusterTelemetry:
    """Aggregates heartbeat telemetry into the master's health plane.

    Thread-safe (gRPC heartbeat streams and HTTP scrapes interleave);
    per-stage merged buckets are cluster-cumulative since master start,
    exactly like a Prometheus histogram would be."""

    def __init__(
        self,
        pulse_seconds: float,
        stale_after_pulses: float = 2.0,
        retention_seconds: float = RETENTION_SECONDS,
    ) -> None:
        self.pulse_seconds = pulse_seconds
        self.stale_after = stale_after_pulses * pulse_seconds
        # a DISCONNECTED node's last snapshot is kept this long past its
        # final heartbeat (the operator's post-mortem view), then
        # dropped — otherwise rolling restarts on dynamic ports would
        # grow the node set and its gauge label space without bound.
        # Timeline samples share the SAME window (see RETENTION_SECONDS).
        self.retention_seconds = max(retention_seconds, self.stale_after)
        self._lock = threading.Lock()
        self._nodes: dict[str, NodeTelemetry] = {}
        self._stages: dict[str, _StageAgg] = {}

    # -------------------------------------------------------------- intake

    def observe(
        self,
        node_url: str,
        tel: Any | None = None,
        now: float | None = None,
        mesh_pod: str = "",
    ) -> None:
        """Record one heartbeat from `node_url`; `tel` is the pb
        VolumeServerTelemetry (None for pre-telemetry servers — the
        pulse still refreshes freshness).  `mesh_pod` rides the
        Heartbeat envelope, not the telemetry payload, so it updates
        even on identity-only pulses."""
        now = time.time() if now is None else now
        with self._lock:
            nt = self._nodes.setdefault(node_url, NodeTelemetry())
            nt.last_seen = now
            nt.connected = True
            nt.mesh_pod = mesh_pod
            if tel is None:
                return
            nt.has_payload = True
            # getattr-guarded: pre-r20 servers lack the pod-rank fields
            nt.mesh_process_id = int(getattr(tel, "mesh_process_id", 0))
            nt.mesh_process_count = max(
                1, int(getattr(tel, "mesh_process_count", 1))
            )
            nt.device_budget_bytes = tel.device_budget_bytes
            nt.device_used_bytes = tel.device_used_bytes
            nt.device_resident_shards = tel.device_resident_shards
            nt.device_evictions = tel.device_evictions
            nt.device_pin_claims = tel.device_pin_claims
            nt.compile_hits = tel.compile_hits
            nt.compile_misses = tel.compile_misses
            # getattr-guarded: pre-r11 servers lack the field
            nt.compile_cache_enabled = bool(
                getattr(tel, "compile_cache_enabled", False)
            )
            nt.dispatcher_queue_depth = tel.dispatcher_queue_depth
            nt.dispatcher_inflight = tel.dispatcher_inflight
            nt.dispatcher_shed = tel.dispatcher_shed
            # getattr-guarded: pre-r16 servers lack the breaker field
            nt.qos_breaker_open = bool(
                getattr(tel, "qos_breaker_open", False)
            )
            # getattr-guarded: pre-r17 servers lack the read counters
            nt.ec_reads_total = int(getattr(tel, "ec_reads_total", 0))
            nt.ec_reads_shed_total = int(
                getattr(tel, "ec_reads_shed_total", 0)
            )
            # getattr-guarded: a pre-r09 volume server's telemetry pb
            # simply lacks the pipeline fields
            nt.overlap_fraction = float(
                getattr(tel, "overlap_fraction", 0.0)
            )
            nt.ec_h2d_bytes = int(getattr(tel, "ec_h2d_bytes", 0))
            nt.ec_d2h_bytes = int(getattr(tel, "ec_d2h_bytes", 0))
            # getattr-guarded: pre-r15 servers lack the tiering fields
            nt.tier_hbm_volumes = int(getattr(tel, "tier_hbm_volumes", 0))
            nt.tier_host_volumes = int(
                getattr(tel, "tier_host_volumes", 0)
            )
            nt.tier_promotions = int(getattr(tel, "tier_promotions", 0))
            nt.tier_demotions = int(getattr(tel, "tier_demotions", 0))
            nt.tier_host_bytes = int(getattr(tel, "tier_host_bytes", 0))
            # getattr-guarded: pre-r19 servers lack the per-device axis
            nt.device_bytes_per_device = [
                int(b) for b in getattr(tel, "device_bytes_per_device", ())
            ]
            # getattr-guarded: pre-r20 servers lack the ingest plane
            nt.ingest_bytes_total = int(
                getattr(tel, "ingest_bytes_total", 0)
            )
            nt.ingest_rows_device = int(
                getattr(tel, "ingest_rows_device", 0)
            )
            nt.ingest_rows_host = int(getattr(tel, "ingest_rows_host", 0))
            nt.ingest_shed_total = int(
                getattr(tel, "ingest_shed_total", 0)
            )
            nt.ingest_fsyncs_total = int(
                getattr(tel, "ingest_fsyncs_total", 0)
            )
            nt.ingest_active_pipelines = int(
                getattr(tel, "ingest_active_pipelines", 0)
            )
            nt.ingest_streamed_seals = int(
                getattr(tel, "ingest_streamed_seals", 0)
            )
            nt.resident_by_volume = dict(tel.resident_shards_by_volume)
            # getattr-guarded: pre-r22 servers ship no clock stamp.
            # Stored raw (no EWMA): heartbeat transit inflates the
            # estimate by at most one one-way delay, and the critpath
            # assembler clamps child spans into the parent's call
            # window anyway — determinism beats smoothing here
            wall_ms = int(getattr(tel, "wall_clock_unix_ms", 0))
            if wall_ms > 0:
                nt.clock_skew_ms = wall_ms - now * 1e3
            # getattr-guarded: pre-r21 servers ship no timeline; parsed
            # leniently (the sample schema is JSON on purpose — see
            # master.proto field 35) and deduped by `t`, which makes the
            # volume server's ACK-protocol reships idempotent
            for raw in getattr(tel, "timeline_samples_json", ()):
                try:
                    s = json.loads(raw)
                    t_key = int(s["t"])
                except (ValueError, KeyError, TypeError):
                    continue
                nt.timeline[t_key] = s
            if nt.timeline:
                cutoff = now - self.retention_seconds
                for t_key in [t for t in nt.timeline if t < cutoff]:
                    del nt.timeline[t_key]
            n_buckets = len(STAGE_SECONDS_BUCKETS) + 1
            for d in tel.stage_digests:
                merged = self._stages.setdefault(
                    d.stage, _StageAgg([0] * n_buckets, 0, 0.0)
                )
                # tolerate a ladder drift between versions, preserving
                # the +Inf overflow semantics in BOTH directions: the
                # sender's LAST bucket is always its overflow, so a
                # shorter ladder's tail lands in our +Inf (never in a
                # finite mid-ladder bucket, which would fake fast
                # observations), and a longer ladder's extras fold into
                # +Inf too — counts never silently vanish or speed up
                counts = list(d.bucket_counts)
                if counts:
                    if len(counts) >= n_buckets:
                        counts = counts[: n_buckets - 1] + [
                            sum(counts[n_buckets - 1:])
                        ]
                    else:
                        counts = (
                            counts[:-1]
                            + [0] * (n_buckets - len(counts))
                            + [counts[-1]]
                        )
                for i, c in enumerate(counts):
                    merged.buckets[i] += c
                merged.count += d.count
                merged.sum_seconds += d.sum_seconds

    def disconnect(self, node_url: str) -> None:
        """Heartbeat stream broke: keep the last snapshot (the operator
        wants the dead node's final state) but mark it disconnected —
        age will take it stale within the staleness window."""
        with self._lock:
            nt = self._nodes.get(node_url)
            if nt is not None:
                nt.connected = False

    def _prune(self, now: float) -> None:
        """Drop disconnected nodes past the retention window (caller
        holds the lock).  Connected nodes are never pruned — a live
        stream that stopped pulsing is exactly what staleness flags."""
        for url in [
            u for u, nt in self._nodes.items()
            if not nt.connected
            and (now - nt.last_seen) > self.retention_seconds
        ]:
            del self._nodes[url]

    # ------------------------------------------------------------- exports

    def _stale(self, nt: NodeTelemetry, now: float) -> bool:
        return (now - nt.last_seen) > self.stale_after

    def refresh_gauges(self, now: float | None = None) -> None:
        """Re-export the aggregate view as SeaweedFS_cluster_* series
        (called at master /metrics scrape time).  Per-node gauges are
        cleared first so departed nodes drop to absent, not stale-stuck
        — the same pattern as the volume gauge refresh."""
        now = time.time() if now is None else now
        with self._lock:
            self._prune(now)
            nodes = dict(self._nodes)
            stages = {
                s: (list(v.buckets), v.count, v.sum_seconds)
                for s, v in self._stages.items()
            }
        for g in (
            CLUSTER_DEVICE_BUDGET, CLUSTER_DEVICE_USED,
            CLUSTER_DEVICE_RESIDENT, CLUSTER_DEVICE_EVICTIONS,
            CLUSTER_DISPATCHER_QUEUE, CLUSTER_DISPATCHER_INFLIGHT,
            CLUSTER_DISPATCHER_SHED, CLUSTER_OVERLAP_FRACTION,
            CLUSTER_TIER_VOLUMES, CLUSTER_TIER_PROMOTIONS,
            CLUSTER_TIER_DEMOTIONS,
        ):
            g.clear()
        fresh = stale = 0
        for url, nt in nodes.items():
            if self._stale(nt, now):
                stale += 1
            else:
                fresh += 1
            if not nt.has_payload:
                continue
            CLUSTER_DEVICE_BUDGET.labels(node=url).set(nt.device_budget_bytes)
            CLUSTER_DEVICE_USED.labels(node=url).set(nt.device_used_bytes)
            CLUSTER_DEVICE_RESIDENT.labels(node=url).set(
                nt.device_resident_shards
            )
            CLUSTER_DEVICE_EVICTIONS.labels(node=url).set(nt.device_evictions)
            CLUSTER_DISPATCHER_QUEUE.labels(node=url).set(
                nt.dispatcher_queue_depth
            )
            CLUSTER_DISPATCHER_INFLIGHT.labels(node=url).set(
                nt.dispatcher_inflight
            )
            CLUSTER_DISPATCHER_SHED.labels(node=url).set(nt.dispatcher_shed)
            CLUSTER_OVERLAP_FRACTION.labels(node=url).set(
                nt.overlap_fraction
            )
            CLUSTER_TIER_VOLUMES.labels(node=url, tier="hbm").set(
                nt.tier_hbm_volumes
            )
            CLUSTER_TIER_VOLUMES.labels(node=url, tier="host").set(
                nt.tier_host_volumes
            )
            CLUSTER_TIER_PROMOTIONS.labels(node=url).set(nt.tier_promotions)
            CLUSTER_TIER_DEMOTIONS.labels(node=url).set(nt.tier_demotions)
        CLUSTER_NODES.labels(state="fresh").set(fresh)
        CLUSTER_NODES.labels(state="stale").set(stale)
        for stage, (buckets, _count, _sum) in stages.items():
            p50 = quantile_from_buckets(buckets, 0.50)
            p99 = quantile_from_buckets(buckets, 0.99)
            if p50 is not None:
                CLUSTER_STAGE_P50.labels(stage=stage).set(p50)
            if p99 is not None:
                CLUSTER_STAGE_P99.labels(stage=stage).set(p99)

    def stale_node_urls(self, now: float | None = None) -> set[str]:
        """Nodes past the staleness window (missed heartbeats): the
        repair scheduler treats shards held ONLY by these as suspect."""
        now = time.time() if now is None else now
        with self._lock:
            return {
                url for url, nt in self._nodes.items()
                if self._stale(nt, now)
            }

    def breakers_open(self, now: float | None = None) -> int:
        """Fresh nodes whose last pulse reported an open INTERACTIVE
        QoS breaker — nonzero means the front door is overloaded and
        repair traffic must yield."""
        now = time.time() if now is None else now
        with self._lock:
            return sum(
                1 for nt in self._nodes.values()
                if nt.has_payload
                and nt.qos_breaker_open
                and not self._stale(nt, now)
            )

    def fresh_node_urls(self, now: float | None = None) -> list[str]:
        """Nodes inside the staleness window — the incident bundler's
        fan-out targets (a stale node's HTTP endpoint is likely gone;
        its last state is in the health doc the bundle embeds)."""
        now = time.time() if now is None else now
        with self._lock:
            return sorted(
                url for url, nt in self._nodes.items()
                if not self._stale(nt, now)
            )

    def clock_skew_ms(self, node_url: str) -> float:
        """Latest wall-clock skew estimate for one node (node clock
        minus master clock, in ms; 0.0 when unknown) — passed into
        obs/critpath.py's assembler to place a skewed node's span
        timestamps on the master's clock line."""
        with self._lock:
            nt = self._nodes.get(node_url)
            if nt is None or nt.clock_skew_ms is None:
                return 0.0
            return float(nt.clock_skew_ms)

    def read_shed_totals(self) -> tuple[int, int]:
        """(cumulative EC reads, cumulative sheds) summed over every
        node with telemetry — the error-rate SLO's raw counters.  The
        SLO engine diffs consecutive calls and clamps negative deltas
        (a node restart resets its counters; a pruned node drops out of
        the sum)."""
        with self._lock:
            return (
                sum(
                    nt.ec_reads_total for nt in self._nodes.values()
                    if nt.has_payload
                ),
                sum(
                    nt.ec_reads_shed_total for nt in self._nodes.values()
                    if nt.has_payload
                ),
            )

    def stage_buckets(self, stage: str) -> list[int] | None:
        """Cumulative merged per-bucket counts for one stage (fixed
        ladder + trailing +Inf overflow), or None before the first
        digest — the latency SLO's raw histogram; the engine diffs
        consecutive snapshots into per-pulse deltas."""
        with self._lock:
            rec = self._stages.get(stage)
            return list(rec.buckets) if rec is not None else None

    def stage_quantile(self, stage: str, q: float) -> float | None:
        """Interpolated quantile estimate for one stage's merged digest
        (tests cross-check this against the per-server histograms)."""
        with self._lock:
            rec = self._stages.get(stage)
            buckets = list(rec.buckets) if rec is not None else None
        return quantile_from_buckets(buckets, q) if buckets else None

    def timeline(
        self,
        window_s: float | None = None,
        now: float | None = None,
    ) -> dict[str, Any]:
        """The assembled cluster flight timeline: every node's shipped
        samples joined CLOCK-ALIGNED on their whole-second `t`, so one
        row answers "what was every node doing at t" (ledger busy
        deltas, QoS pressure, ingest ramp, exemplar traces).  `window_s`
        trims to the trailing window; the incident bundler embeds
        exactly this with the burn window."""
        now = time.time() if now is None else now
        with self._lock:
            per_node = {
                url: dict(nt.timeline)
                for url, nt in self._nodes.items()
                if nt.timeline
            }
        ticks: set[int] = set()
        for samples in per_node.values():
            ticks.update(samples)
        if window_s is not None and ticks:
            cutoff = max(ticks) - window_s
            ticks = {t_ for t_ in ticks if t_ >= cutoff}
        rows = [
            {
                "t": t_,
                "nodes": {
                    url: samples[t_]
                    for url, samples in sorted(per_node.items())
                    if t_ in samples
                },
            }
            for t_ in sorted(ticks)
        ]
        return {
            "generated_unix_ms": int(now * 1e3),
            "window_seconds": window_s,
            "nodes": sorted(per_node),
            "samples": rows,
        }

    def health(self, now: float | None = None) -> dict[str, Any]:
        """The /cluster/health.json document."""
        now = time.time() if now is None else now
        with self._lock:
            self._prune(now)
            nodes = {url: nt for url, nt in self._nodes.items()}
            stages = {
                s: (list(v.buckets), v.count, v.sum_seconds)
                for s, v in self._stages.items()
            }
        node_docs = {
            url: nt.to_dict(now, self.stale_after)
            for url, nt in sorted(nodes.items())
        }
        fresh = [
            nt for nt in nodes.values()
            if nt.has_payload and not self._stale(nt, now)
        ]
        residency: dict[str, dict[str, int]] = {}
        for url, nt in sorted(nodes.items()):
            for vid, n in nt.resident_by_volume.items():
                residency.setdefault(str(vid), {})[url] = n
        # r20 pod table: multi-controller pods as first-class rows.  A
        # pod is "degraded" when fewer live members than its declared
        # process_count — one member down stalls the whole SPMD mesh,
        # so this is the signal the repair plane (and the kill bench
        # phase) keys on.
        pods: dict[str, dict[str, Any]] = {}
        for url, nt in sorted(nodes.items()):
            if not nt.mesh_pod:
                continue
            pod = pods.setdefault(
                nt.mesh_pod,
                {"members": [], "process_count": 0, "live_members": 0},
            )
            stale = self._stale(nt, now)
            pod["members"].append(
                {
                    "url": url,
                    "process_id": nt.mesh_process_id,
                    "stale": stale,
                }
            )
            pod["process_count"] = max(
                pod["process_count"], nt.mesh_process_count
            )
            if not stale:
                pod["live_members"] += 1
        for pod in pods.values():
            pod["degraded"] = pod["live_members"] < pod["process_count"]
        stage_docs: dict[str, dict[str, Any]] = {}
        for stage, (buckets, count, sum_s) in sorted(stages.items()):
            p50 = quantile_from_buckets(buckets, 0.50)
            p99 = quantile_from_buckets(buckets, 0.99)
            stage_docs[stage] = {
                "count": count,
                "sum_seconds": round(sum_s, 6),
                "p50_seconds": round(p50, 9) if p50 is not None else None,
                "p99_seconds": round(p99, 9) if p99 is not None else None,
                # observations past the last finite edge: when nonzero
                # the p99 estimate is a floor, not an interpolation
                "overflow": buckets[-1],
            }
        return {
            "generated_unix_ms": int(now * 1e3),
            "pulse_seconds": self.pulse_seconds,
            "stale_after_seconds": self.stale_after,
            "bucket_edges_seconds": list(STAGE_SECONDS_BUCKETS),
            "nodes": node_docs,
            # r20: pod id -> member rows; absent key meaning "no
            # multi-controller pods in this cluster" keeps single
            # process health docs byte-identical to r19
            **({"pods": pods} if pods else {}),
            "cluster": {
                "nodes_total": len(nodes),
                "nodes_stale": sum(
                    1 for nt in nodes.values() if self._stale(nt, now)
                ),
                "device_budget_bytes": sum(
                    nt.device_budget_bytes for nt in fresh
                ),
                "device_used_bytes": sum(
                    nt.device_used_bytes for nt in fresh
                ),
                "device_headroom_bytes": sum(
                    max(0, nt.device_budget_bytes - nt.device_used_bytes)
                    for nt in fresh
                ),
                "dispatcher_queue_depth": sum(
                    nt.dispatcher_queue_depth for nt in fresh
                ),
                "dispatcher_inflight": sum(
                    nt.dispatcher_inflight for nt in fresh
                ),
                "dispatcher_shed_total": sum(
                    nt.dispatcher_shed for nt in fresh
                ),
                "qos_breakers_open": sum(
                    1 for nt in fresh if nt.qos_breaker_open
                ),
                "tier_volumes": {
                    "hbm": sum(nt.tier_hbm_volumes for nt in fresh),
                    "host": sum(nt.tier_host_volumes for nt in fresh),
                },
                "tier_promotions_total": sum(
                    nt.tier_promotions for nt in fresh
                ),
                "tier_demotions_total": sum(
                    nt.tier_demotions for nt in fresh
                ),
                "tier_host_bytes": sum(
                    nt.tier_host_bytes for nt in fresh
                ),
                "ingest": {
                    "bytes_total": sum(
                        nt.ingest_bytes_total for nt in fresh
                    ),
                    "rows_device": sum(
                        nt.ingest_rows_device for nt in fresh
                    ),
                    "rows_host": sum(
                        nt.ingest_rows_host for nt in fresh
                    ),
                    "shed_total": sum(
                        nt.ingest_shed_total for nt in fresh
                    ),
                    "fsyncs_total": sum(
                        nt.ingest_fsyncs_total for nt in fresh
                    ),
                    "active_pipelines": sum(
                        nt.ingest_active_pipelines for nt in fresh
                    ),
                    "streamed_seals": sum(
                        nt.ingest_streamed_seals for nt in fresh
                    ),
                },
                "ec_volume_residency": residency,
                "stages": stage_docs,
            },
        }
