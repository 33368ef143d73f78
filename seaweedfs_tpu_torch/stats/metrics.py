"""A small standard-library metrics registry with the reference's series.

Port of the volume-server serving subset of seaweedfs_tpu/stats/metrics.py,
without prometheus_client (absent where the card runs): counters, gauges
and histograms with labels, rendered in the Prometheus text format by
`generate_latest` for `GET /metrics`.  As in prometheus_client, a counter
is exposed with a `_total` suffix (added when its name lacks one) and a
histogram as `_bucket{le=...}`, `_sum` and `_count`.

Only the series the serving stack touches are here: request counters and
latency, the volume and residency gauges, the dispatcher's batch, queue,
in-flight, fallback and route series, QoS admission, the response copy
and stall series, deadline refusals, the pipeline's H2D/D2H bytes, the
port's kernel launches, the parity scrub's corrupt-volume gauge and
dispatch counter, the residency ladder's tier series
(serving/tiering.py), the streaming ingest plane's series (ingest/), the
device-time ledger's four series
(obs/devledger.py), the per-stage request-tracing histogram
(obs/trace.py) with the heartbeat digest helpers, the critical-path
counters (obs/critpath.py, obs/tailstore.py) and the master's
heartbeat and repair-plane series (repair/scheduler.py).

One process-wide registry, like the reference's default registry.
"""
from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v: float) -> str:
    """A sample value as prometheus_client writes it (Go's float format:
    an exponent once the integer part passes six digits)."""
    v = float(v)
    if v == math.inf:
        return "+Inf"
    s = repr(v)
    dot = s.find(".")
    if v > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _label_str(names, values, extra: str = "") -> str:
    parts = [f'{n}="{v}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Registry:
    def __init__(self):
        self._metrics: list[_Metric] = []

    def register(self, m: "_Metric") -> None:
        self._metrics.append(m)

    def collect(self):
        return list(self._metrics)

    def get_sample_value(self, name: str, labels: dict | None = None):
        """The value of one exposed sample (prometheus_client's lookup):
        `name` as rendered (a counter's `_total`, a histogram's `_sum` /
        `_count`), `labels` its label set; None when absent."""
        want = dict(labels or {})
        for m in self.collect():
            for values, child in m._series():
                if dict(zip(m.labelnames, values)) != want:
                    continue
                for suffix, value in child._values():
                    if m.name.removesuffix("_total") + suffix == name:
                        return value
        return None


class _Metric:
    kind = ""

    def __init__(self, name, documentation, labelnames=(), registry=None):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, _Metric] = {}
        self._labelvalues: tuple = ()
        self._init_value()
        if registry is not None:
            registry.register(self)

    def _init_value(self) -> None:
        raise NotImplementedError

    def labels(self, **kw) -> "_Metric":
        values = tuple(str(kw[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._child()
                child._labelvalues = values
                self._children[values] = child
            return child

    def _child(self) -> "_Metric":
        c = object.__new__(type(self))
        c.__dict__.update(self.__dict__)
        c._lock = threading.Lock()
        c._children = {}
        c._init_value()
        return c

    def clear(self) -> None:
        with self._lock:
            self._children.clear()

    def _series(self):
        """[(labelvalues, metric)] this metric exposes."""
        if self.labelnames:
            with self._lock:
                return sorted(self._children.items())
        return [((), self)]

    def render(self) -> list[str]:
        base = self.name.removesuffix("_total")
        lines = [f"# HELP {base} {self.documentation}",
                 f"# TYPE {base} {self.kind}"]
        for values, m in self._series():
            lines += m._samples(values)
        return lines


class Counter(_Metric):
    kind = "counter"

    def _init_value(self) -> None:
        self._value = 0.0

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _values(self) -> list[tuple[str, float]]:
        return [("_total", self._value)]

    def _samples(self, values) -> list[str]:
        return [f"{self.name.removesuffix('_total')}_total"
                f"{_label_str(self.labelnames, values)} {_fmt(self._value)}"]


class Gauge(_Metric):
    kind = "gauge"

    def _init_value(self) -> None:
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def _values(self) -> list[tuple[str, float]]:
        return [("", self._value)]

    def _samples(self, values) -> list[str]:
        return [f"{self.name}{_label_str(self.labelnames, values)} "
                f"{_fmt(self._value)}"]


class Histogram(_Metric):
    kind = "histogram"
    DEFAULT_BUCKETS = (.005, .01, .025, .05, .075, .1, .25, .5, .75, 1.0,
                       2.5, 5.0, 7.5, 10.0)

    def __init__(self, name, documentation, labelnames=(), registry=None,
                 buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        if self.buckets[-1] != math.inf:
            self.buckets += (math.inf,)
        super().__init__(name, documentation, labelnames, registry)

    def _init_value(self) -> None:
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            for i, edge in enumerate(self.buckets):
                if v <= edge:
                    self._counts[i] += 1
                    break

    @property
    def count(self) -> int:
        return sum(self._counts)

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> list[tuple[float, int]]:
        """[(upper edge, observations <= edge)]."""
        out, acc = [], 0
        for edge, c in zip(self.buckets, self._counts):
            acc += c
            out.append((edge, acc))
        return out

    def _values(self) -> list[tuple[str, float]]:
        return [("_sum", self._sum), ("_count", float(self.count))]

    def _samples(self, values) -> list[str]:
        lines = [
            f"{self.name}_bucket"
            f"{_label_str(self.labelnames, values, f'le=\"{_fmt(edge)}\"')}"
            f" {_fmt(acc)}"
            for edge, acc in self.cumulative()
        ]
        ls = _label_str(self.labelnames, values)
        lines.append(f"{self.name}_sum{ls} {_fmt(self._sum)}")
        lines.append(f"{self.name}_count{ls} {_fmt(self.count)}")
        return lines


def generate_latest(registry: Registry) -> bytes:
    """The registry in the Prometheus text exposition format."""
    lines: list[str] = []
    for m in registry.collect():
        lines += m.render()
    return ("\n".join(lines) + "\n").encode()


REGISTRY = Registry()

VOLUME_SERVER_REQUEST_COUNTER = Counter(
    "SeaweedFS_volumeServer_request_total",
    "Counter of volume server requests.",
    ["type"],
    registry=REGISTRY,
)
VOLUME_SERVER_REQUEST_HISTOGRAM = Histogram(
    "SeaweedFS_volumeServer_request_seconds",
    "Bucketed histogram of volume server request processing time.",
    ["type"],
    registry=REGISTRY,
    buckets=(0.000005, 0.00001, 0.000025, 0.00005, 0.0001, 0.001, 0.01,
             0.1, 1.0, 10.0),
)
VOLUME_SERVER_VOLUME_GAUGE = Gauge(
    "SeaweedFS_volumeServer_volumes",
    "Number of volumes or EC shards.",
    ["collection", "type"],
    registry=REGISTRY,
)
VOLUME_SERVER_RESIDENT_SHARD_GAUGE = Gauge(
    "SeaweedFS_volumeServer_ec_resident_shards",
    "EC shards pinned in device memory (the degraded-read fast path).",
    registry=REGISTRY,
)
VOLUME_SERVER_RESIDENT_BYTES_GAUGE = Gauge(
    "SeaweedFS_volumeServer_ec_resident_bytes",
    "Device memory held by the EC shard cache (padded bytes).",
    registry=REGISTRY,
)
# one series a serving-mesh lane (device = the lane's index), so a
# lopsided mesh shows beside the aggregate
VOLUME_SERVER_EC_DEVICE_CACHE_BYTES = Gauge(
    "SeaweedFS_volumeServer_ec_device_cache_bytes",
    "Padded EC shard-cache bytes resident per serving-mesh device "
    "(device = mesh index; the sum over devices is device_used_bytes).",
    ["device"],
    registry=REGISTRY,
)

# the continuous-batching EC serving dispatcher (serving/dispatcher.py)
VOLUME_SERVER_EC_BATCH_SIZE = Histogram(
    "SeaweedFS_volumeServer_ec_batch_size",
    "Coalesced EC read batch width (needles per device call).",
    registry=REGISTRY,
    # one bucket per width: the CUDA kernels take any width, so the
    # reference's COUNT_BUCKETS edges (its compiled shapes) mean nothing
    # here, and exact edges give the width quantiles and maximum
    buckets=tuple(range(1, 257)),
)
VOLUME_SERVER_EC_BATCH_QUEUE_WAIT = Histogram(
    "SeaweedFS_volumeServer_ec_batch_queue_wait_seconds",
    "Time an EC read waited in the coalescer before its batch dispatched.",
    registry=REGISTRY,
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.05,
             0.25, 1.0),
)
VOLUME_SERVER_EC_BATCH_INFLIGHT = Gauge(
    "SeaweedFS_volumeServer_ec_batch_inflight",
    "EC read batches currently in flight on the device (occupancy; "
    "bounded by -ec.serving.maxInflight).",
    registry=REGISTRY,
)
VOLUME_SERVER_EC_QUEUE_DEPTH = Gauge(
    "SeaweedFS_volumeServer_ec_queue_depth",
    "EC reads waiting in the serving coalescer right now (bounded by "
    "-ec.serving.maxQueue; zeroed on clean dispatcher shutdown).",
    registry=REGISTRY,
)
VOLUME_SERVER_EC_BATCH_FALLBACK = Counter(
    "SeaweedFS_volumeServer_ec_batch_fallback_total",
    "EC reads shed to the native per-read path because the dispatch "
    "queue was saturated.",
    registry=REGISTRY,
)
VOLUME_SERVER_EC_READ_ROUTE = Counter(
    "SeaweedFS_volumeServer_ec_read_route_total",
    "EC reads by serving route (batched = resident continuous-batching "
    "path, native = per-read host path; s3_batched/s3_native count reads "
    "the S3 gateway sent, in addition to the admitting route).",
    ["route"],
    registry=REGISTRY,
)
for _route in ("batched", "native", "s3_batched", "s3_native"):
    VOLUME_SERVER_EC_READ_ROUTE.labels(route=_route)
VOLUME_SERVER_RESPONSE_COPY_BYTES = Counter(
    "SeaweedFS_volumeServer_response_copy_bytes_total",
    "Bytes COPIED while assembling volume-server HTTP read responses "
    "(needle-buffer materialization, range slices of bytes bodies, "
    "decompress output); 0 for reads on the zero-copy path.",
    registry=REGISTRY,
)
VOLUME_SERVER_RESPONSE_STALL_ABORTS = Counter(
    "SeaweedFS_volumeServer_response_stall_aborts_total",
    "HTTP read responses aborted because the client drained the body "
    "slower than the per-response stall budget.",
    registry=REGISTRY,
)

# QoS admission control (serving/qos.py)
VOLUME_SERVER_EC_QOS_ADMITTED = Counter(
    "SeaweedFS_volumeServer_ec_qos_admitted_total",
    "EC reads admitted to the serving queue by QoS tier.",
    ["tier"],
    registry=REGISTRY,
)
VOLUME_SERVER_EC_QOS_SHED = Counter(
    "SeaweedFS_volumeServer_ec_qos_shed_total",
    "EC reads the QoS admission controller re-routed to the host path "
    "before they could queue, by tier and reason (queue_budget, "
    "deadline, breaker_open).",
    ["tier", "reason"],
    registry=REGISTRY,
)
VOLUME_SERVER_EC_QOS_QUEUE_DEPTH = Gauge(
    "SeaweedFS_volumeServer_ec_qos_queue_depth",
    "EC reads currently queued in the serving coalescer, by QoS tier.",
    ["tier"],
    registry=REGISTRY,
)
VOLUME_SERVER_EC_QOS_BREAKER_STATE = Gauge(
    "SeaweedFS_volumeServer_ec_qos_breaker_state",
    "QoS admission breaker state by tier: 0 closed, 1 half-open, 2 open.",
    ["tier"],
    registry=REGISTRY,
)
for _tier in ("interactive", "bulk"):
    VOLUME_SERVER_EC_QOS_ADMITTED.labels(tier=_tier)
    VOLUME_SERVER_EC_QOS_QUEUE_DEPTH.labels(tier=_tier)
    VOLUME_SERVER_EC_QOS_BREAKER_STATE.labels(tier=_tier)
    for _reason in ("queue_budget", "deadline", "breaker_open"):
        VOLUME_SERVER_EC_QOS_SHED.labels(tier=_tier, reason=_reason)

VOLUME_SERVER_EC_DEADLINE_EXCEEDED = Counter(
    "SeaweedFS_volumeServer_ec_deadline_exceeded",
    "Work refused or abandoned because the request's propagated deadline "
    "budget (X-Seaweed-Deadline-Ms) was already spent — admission sheds, "
    "doomed RPCs, and survivor gathers that ran out of budget.",
    registry=REGISTRY,
)

# the fault policy's peer decisions (utils/faultpolicy.py), with the
# reference's names: hedges armed, won and abandoned by the degraded-read
# survivor gather, and retries refused by a drained per-peer budget
VOLUME_SERVER_EC_HEDGE_SENT = Counter(
    "SeaweedFS_volumeServer_ec_hedge_sent",
    "Hedge fetches armed by the degraded-read survivor gather: a pending "
    "shard fetch exceeded its peer's latency-EWMA quantile "
    "(-ec.rpc.hedgeQuantile) and a spare holder was asked for a different "
    "shard (bounded by -ec.rpc.hedgeBudgetPct).",
    registry=REGISTRY,
)
VOLUME_SERVER_EC_HEDGE_WINS = Counter(
    "SeaweedFS_volumeServer_ec_hedge_wins",
    "Hedge fetches whose bytes completed a reconstruct before the "
    "tail-slow primary they covered.",
    registry=REGISTRY,
)
VOLUME_SERVER_EC_HEDGE_CANCELLED = Counter(
    "SeaweedFS_volumeServer_ec_hedge_cancelled",
    "Hedge fetches abandoned because the gather was satisfied first.",
    registry=REGISTRY,
)
VOLUME_SERVER_EC_RETRY_BUDGET_EXHAUSTED = Counter(
    "SeaweedFS_volumeServer_ec_retry_budget_exhausted",
    "RPC retries refused because the peer's token-bucket retry budget "
    "(-ec.rpc.retryBudgetPct) was drained.",
    registry=REGISTRY,
)
# the remote shard reader (server/volume.py _remote_shard_reader): each
# VolumeEcShardRead stream this server opened to a peer, and its bytes
VOLUME_SERVER_EC_REMOTE_SHARD_READS = Counter(
    "SeaweedFS_volumeServer_ec_remote_shard_reads",
    "Shard intervals fetched from a peer over VolumeEcShardRead, by "
    "outcome (ok, deleted, miss: no holder answered).",
    ["result"],
    registry=REGISTRY,
)
for _r in ("ok", "deleted", "miss"):
    VOLUME_SERVER_EC_REMOTE_SHARD_READS.labels(result=_r)
VOLUME_SERVER_EC_REMOTE_SHARD_BYTES = Counter(
    "SeaweedFS_volumeServer_ec_remote_shard_bytes",
    "Shard bytes fetched from peers over VolumeEcShardRead.",
    registry=REGISTRY,
)

# the master (server/master.py)
MASTER_RECEIVED_HEARTBEATS = Counter(
    "SeaweedFS_master_received_heartbeats",
    "Counter of master received heartbeats.",
    ["type"],
    registry=REGISTRY,
)

# the master's repair plane (repair/scheduler.py): lifecycle counters a
# repair job (one EC volume's gather -> rebuild -> remount), the live job
# gauge, deferrals by reason, and the recovery time itself
MASTER_REPAIR_QUEUED = Counter(
    "SeaweedFS_master_repair_queued_total",
    "Repair jobs admitted to the scheduler's queue (one per EC volume "
    "per detection; re-queues after backoff count again).",
    registry=REGISTRY,
)
MASTER_REPAIR_INFLIGHT = Gauge(
    "SeaweedFS_master_repair_inflight",
    "Repair jobs currently executing their gather/rebuild fan-out.",
    registry=REGISTRY,
)
MASTER_REPAIR_COMPLETED = Counter(
    "SeaweedFS_master_repair_completed_total",
    "Repair jobs that restored their volume's shards.",
    registry=REGISTRY,
)
MASTER_REPAIR_FAILED = Counter(
    "SeaweedFS_master_repair_failed_total",
    "Repair jobs parked after exhausting -ec.repair.maxAttempts.",
    registry=REGISTRY,
)
MASTER_REPAIR_BACKOFF = Counter(
    "SeaweedFS_master_repair_backoff_total",
    "Repair deferrals, by reason: 'retry' = a failed job entering "
    "exponential backoff; 'breaker_open' = a whole scheduling cycle "
    "deferred because a fresh node reported an open interactive QoS "
    "breaker (repair yields to the front door).",
    ["reason"],
    registry=REGISTRY,
)
for _r in ("retry", "breaker_open"):
    MASTER_REPAIR_BACKOFF.labels(reason=_r)
MASTER_REPAIR_TIME_TO_HEALTHY = Histogram(
    "SeaweedFS_master_repair_time_to_healthy_seconds",
    "Wall seconds from first observing missing/corrupt EC shards to "
    "the cluster reaching full redundancy again (the recovery SLO).",
    registry=REGISTRY,
    buckets=(0.5, 1, 2, 5, 10, 30, 60, 120, 300, 600, 1800),
)

# the resident pipeline's transfers (ops/rs_resident.DevicePipeline's
# h2d_bytes / d2h_bytes, mirrored at scrape time)
VOLUME_SERVER_EC_H2D_BYTES = Counter(
    "SeaweedFS_volumeServer_ec_h2d_bytes",
    "Host->device bytes of the resident EC reconstruct calls (the work "
    "list and bit masks in the launch parameters; survivor bytes stay "
    "resident).",
    registry=REGISTRY,
)
VOLUME_SERVER_EC_D2H_BYTES = Counter(
    "SeaweedFS_volumeServer_ec_d2h_bytes",
    "Device->host bytes of the resident EC reconstruct calls (the "
    "reconstructed intervals at their fetch lengths).",
    registry=REGISTRY,
)
VOLUME_SERVER_EC_OVERLAP_FRACTION = Gauge(
    "SeaweedFS_volumeServer_ec_overlap_fraction",
    "Device-busy time / wall time over the double-buffered EC "
    "pipeline's current batch window, refreshed at every batch "
    "completion (1.0 = the device section was busy the whole window; "
    ">1 = staging slots overlapped, up to the slot count).",
    registry=REGISTRY,
)
VOLUME_SERVER_SCRUB_CORRUPT_GAUGE = Gauge(
    "SeaweedFS_volumeServer_ec_scrub_corrupt_volumes",
    "EC volumes whose last parity scrub found mismatching bytes.",
    registry=REGISTRY,
)
VOLUME_SERVER_EC_SCRUB_DISPATCH = Counter(
    "SeaweedFS_volumeServer_ec_scrub_device_dispatch_total",
    "Device dispatches spent scrubbing resident EC volumes, by mode: "
    "per_volume = one call per volume (scrub_volume), megakernel = one "
    "launch covering a stack of up to 32 pinned volumes of one span "
    "(scrub_all_resident).",
    ["mode"],
    registry=REGISTRY,
)
for _mode in ("per_volume", "megakernel"):
    VOLUME_SERVER_EC_SCRUB_DISPATCH.labels(mode=_mode)

# heat-tiered residency (serving/tiering.py): the ladder's census, its
# promotion/demotion counters (the thrash signal), the warm tier's bytes
# and the reads it served from RAM
VOLUME_SERVER_EC_TIER_VOLUMES = Gauge(
    "SeaweedFS_volumeServer_ec_tier_volumes",
    "EC volumes by residency tier after the last tier rebalance (hbm = "
    "device-resident serving, host = shard bytes pinned in host RAM, "
    "disk = served from shard files).",
    ["tier"],
    registry=REGISTRY,
)
VOLUME_SERVER_EC_TIER_PROMOTIONS = Counter(
    "SeaweedFS_volumeServer_ec_tier_promotions",
    "Tier-ladder promotions by destination tier (hbm = pinned into the "
    "device cache, host = shard bytes staged into the host-RAM "
    "reconstruct cache).",
    ["tier"],
    registry=REGISTRY,
)
VOLUME_SERVER_EC_TIER_DEMOTIONS = Counter(
    "SeaweedFS_volumeServer_ec_tier_demotions",
    "Tier-ladder demotions by source tier (hbm = heat-chosen device "
    "eviction under budget pressure or a hotter candidate's swap, host "
    "= host-RAM bytes dropped for a warmer volume).  A high rate means "
    "the ladder is thrashing — widen -ec.tier.promoteRatio or "
    "-ec.tier.minResidencySeconds.",
    ["tier"],
    registry=REGISTRY,
)
VOLUME_SERVER_EC_TIER_HOST_BYTES = Gauge(
    "SeaweedFS_volumeServer_ec_tier_host_bytes",
    "Host RAM held by the warm-tier shard cache (-ec.tier.hostCacheMB "
    "budget).",
    registry=REGISTRY,
)
VOLUME_SERVER_EC_TIER_HOST_READS = Counter(
    "SeaweedFS_volumeServer_ec_tier_host_reads",
    "Shard interval reads served from the host-RAM tier (zero-copy "
    "memoryview slices of the staged shard bytes, no disk pread).",
    registry=REGISTRY,
)
for _tier in ("hbm", "host", "disk"):
    VOLUME_SERVER_EC_TIER_VOLUMES.labels(tier=_tier)
for _tier in ("hbm", "host"):
    VOLUME_SERVER_EC_TIER_PROMOTIONS.labels(tier=_tier)
    VOLUME_SERVER_EC_TIER_DEMOTIONS.labels(tier=_tier)

# streaming ingest plane (ingest/): bytes and rows through the per-volume
# pipelines, the arena's backpressure, the door's sheds by reason, the
# group commit's batching factor and the seals by provenance
VOLUME_SERVER_INGEST_BYTES = Counter(
    "SeaweedFS_volumeServer_ingest_bytes",
    "Payload bytes accepted into per-volume streaming ingest pipelines "
    "(staged toward stripe rows; every byte here is EC-encoded online "
    "or swept into the offline fallback at seal).",
    registry=REGISTRY,
)
VOLUME_SERVER_INGEST_ROWS = Counter(
    "SeaweedFS_volumeServer_ingest_rows",
    "Completed stripe rows encoded by the streaming ingest plane, by "
    "where the parity was computed (device = K1's route: the gf2_matmul "
    "kernel, or its plain version on a torch backend; host = the CPU "
    "codec of a numpy or native backend).",
    ["path"],
    registry=REGISTRY,
)
VOLUME_SERVER_INGEST_BACKPRESSURE = Counter(
    "SeaweedFS_volumeServer_ingest_backpressure",
    "Ingest arena stage() calls that had to BLOCK for a free staging "
    "row — each one is a writer stalled because the encode leg hasn't "
    "drained; a steady rate means the arena (-ec.ingest.arenaSlots) or "
    "the device is undersized for the write load.",
    registry=REGISTRY,
)
VOLUME_SERVER_INGEST_SHED = Counter(
    "SeaweedFS_volumeServer_ingest_shed",
    "Writes refused at the door by the ingest plane, by reason "
    "(qos = write-tier admission shed, deadline = the deadline budget "
    "says the upload cannot finish in time, arena = no staging row "
    "freed within the backpressure budget).",
    ["reason"],
    registry=REGISTRY,
)
for _reason in ("qos", "deadline", "arena"):
    VOLUME_SERVER_INGEST_SHED.labels(reason=_reason)
VOLUME_SERVER_INGEST_FSYNCS = Counter(
    "SeaweedFS_volumeServer_ingest_fsyncs",
    "Group-commit fsync batches issued by ingest pipelines — many "
    "writes acknowledged per fsync is the point; compare against "
    "SeaweedFS_volumeServer_ingest_fsync_writes for the batching "
    "factor.",
    registry=REGISTRY,
)
VOLUME_SERVER_INGEST_FSYNC_WRITES = Counter(
    "SeaweedFS_volumeServer_ingest_fsync_writes",
    "Writes whose durability was covered by a group-commit fsync batch "
    "(fsync_writes / fsyncs = achieved group-commit factor).",
    registry=REGISTRY,
)
VOLUME_SERVER_INGEST_PIPELINES = Gauge(
    "SeaweedFS_volumeServer_ingest_pipelines",
    "Per-volume streaming ingest pipelines currently live (streaming "
    "state valid: rows encoded so far remain byte-identical to an "
    "offline re-encode of the final .dat).",
    registry=REGISTRY,
)
VOLUME_SERVER_INGEST_STREAMED_SEALS = Counter(
    "SeaweedFS_volumeServer_ingest_seals",
    "Volume EC seals by provenance (streamed = parity rows were "
    "already encoded online and only the zero-padded tail row remained "
    "at ec.encode time; offline = the pipeline had been invalidated — "
    "large-row boundary, encode error, starved arena, restart — and the "
    "bulk executor re-encoded from scratch).",
    ["path"],
    registry=REGISTRY,
)
for _path in ("streamed", "offline"):
    VOLUME_SERVER_INGEST_STREAMED_SEALS.labels(path=_path)
for _path in ("device", "host"):
    VOLUME_SERVER_INGEST_ROWS.labels(path=_path)

# device-time attribution ledger (obs/devledger.py): every device section
# is tagged with a workload class and lands here per class per device;
# the class busy sums reconcile against the DevicePipeline and bulk Codec
# wall clocks (tests pin the conservation)
DEVICE_WORKLOADS = (
    "serving_interactive", "serving_bulk", "ingest", "scrub", "repair",
    "warmup", "bulk", "untagged",
)
VOLUME_SERVER_DEVICE_BUSY_SECONDS = Counter(
    "SeaweedFS_volumeServer_device_busy_seconds",
    "Device busy seconds (the wall of each device section) attributed per "
    "workload class and device (default for the card, host for CPU "
    "codec legs; untagged = a dispatch that escaped the workload tagging "
    "— should stay 0).",
    ["workload", "device"],
    registry=REGISTRY,
)
VOLUME_SERVER_DEVICE_DISPATCHES = Counter(
    "SeaweedFS_volumeServer_device_dispatches",
    "Device dispatches (kernel calls / codec legs) per workload class and "
    "device.",
    ["workload", "device"],
    registry=REGISTRY,
)
VOLUME_SERVER_DEVICE_DISPATCH_BYTES = Counter(
    "SeaweedFS_volumeServer_device_dispatch_bytes",
    "Bytes moved across the device boundary (H2D + D2H) per workload "
    "class and device.",
    ["workload", "device"],
    registry=REGISTRY,
)
VOLUME_SERVER_DEVICE_QUEUE_WAIT_SECONDS = Counter(
    "SeaweedFS_volumeServer_device_queue_wait_seconds",
    "Seconds workloads spent queued for a device pipeline slot per "
    "workload class and device.",
    ["workload", "device"],
    registry=REGISTRY,
)

# the port's own series: launches of each hand-written kernel, mirrored
# at scrape time from the wrappers' counts
VOLUME_SERVER_EC_KERNEL_LAUNCHES = Counter(
    "SeaweedFS_volumeServer_ec_kernel_launches",
    "Launches of each CUDA kernel of the EC paths in this process "
    "(fused_reconstruct, fused_reconstruct_blockdiag, gf2_matmul, "
    "gf2_matmul_small, scrub).",
    ["kernel"],
    registry=REGISTRY,
)
for _kernel in ("fused_reconstruct", "fused_reconstruct_blockdiag",
                "gf2_matmul", "gf2_matmul_small", "scrub"):
    VOLUME_SERVER_EC_KERNEL_LAUNCHES.labels(kernel=_kernel)


# request tracing stages (obs/trace.py spans): one histogram family,
# labeled by stage, µs-resolution buckets — the per-stage view that lets
# a tail regression name its stage instead of hiding in the aggregate
# request histogram.  Stages are pre-registered so /metrics always
# exposes every stage series, even before the first request exercises a
# path (h2d_copy stays at 0 here: the resident call copies nothing up,
# its work list rides in the launch's parameters).
TRACE_STAGES = (
    "queue_wait",        # coalescer admission -> batch take (dispatcher)
    "batch_dispatch",    # one coalesced batch through the store call
    "batch_pack",        # host-side planning + vector staging of a batch
    "h2d_copy",          # shipping the packed vectors host -> device
    "device_execute",    # rs_resident reconstruct (launch -> kernel done)
    "d2h_copy",          # fetching reconstructed bytes device -> host
    "host_reconstruct",  # host GF(256) reconstruct (K1 or the plain version)
    "shard_read",        # .ecx index lookups + local shard preads
    "remote_shard_read", # peer shard interval fetch (VolumeEcShardRead)
    "chunk_fetch",       # filer -> volume server chunk read
    "bulk_read",         # bulk EC pipeline reader leg (stripe preads)
    "bulk_device",       # bulk EC pipeline codec leg (stage+H2D+kernel+D2H)
    "bulk_write",        # bulk EC pipeline writer leg (shard writes/compare)
)
# the reference's fixed bucket ladder (its heartbeat stage digests ride
# on exactly these edges, +Inf appended)
STAGE_SECONDS_BUCKETS = (0.000005, 0.00001, 0.000025, 0.00005, 0.0001,
                         0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                         0.05, 0.25, 1.0)
REQUEST_STAGE_SECONDS = Histogram(
    "SeaweedFS_request_stage_seconds",
    "Per-stage serving time from the request-tracing spans "
    "(obs/trace.py); stage names cover the EC read path end to end.",
    ["stage"],
    registry=REGISTRY,
    buckets=STAGE_SECONDS_BUCKETS,
)
for _stage in TRACE_STAGES:
    REQUEST_STAGE_SECONDS.labels(stage=_stage)


def stage_histogram_snapshot() -> dict:
    """{stage: (cumulative per-le counts incl +Inf, sum_seconds)} from the
    stage histogram: the raw material of the heartbeat stage digests.
    stage_digest_deltas() turns two snapshots into per-bucket increments."""
    return {
        values[0]: ([int(acc) for _, acc in child.cumulative()],
                    float(child.sum))
        for values, child in REQUEST_STAGE_SECONDS._series()
    }


def stage_digest_deltas(before: dict, after: dict) -> list:
    """[(stage, per-bucket increments, count, sum_seconds_delta)] accrued
    between two stage_histogram_snapshot() calls; stages with no new
    observations are dropped so an idle pulse ships an empty digest."""
    out = []
    for stage, (cum_b, sum_b) in after.items():
        cum_a, sum_a = before.get(stage, ([0] * len(cum_b), 0.0))
        dcum = [b - a for a, b in zip(cum_a, cum_b)]
        count = dcum[-1] if dcum else 0
        if count <= 0:
            continue
        buckets = [dcum[0]] + [
            dcum[i] - dcum[i - 1] for i in range(1, len(dcum))
        ]
        out.append((stage, buckets, count, max(0.0, sum_b - sum_a)))
    return out

# critical-path attribution (obs/critpath.py): every finished ROOT trace
# has its client-visible wall time bucketed into exactly these six
# segments (trace stages map onto the first five; whatever no span
# covers is `untraced`), so the per-route composition is a counter
# ratio.  The segment label universe is fixed here; routes register
# lazily.
CRITPATH_SEGMENTS = ("queue_wait", "device_execute", "host_reconstruct",
                     "disk", "network_gap", "untraced")
CRITPATH_SECONDS = Counter(
    "SeaweedFS_critpath_seconds",
    "Client-visible request seconds attributed to each critical-path "
    "segment per route (obs/tailstore.py feeds every finished root "
    "trace through obs/critpath.py's bucketing); the six segments of "
    "one route sum to that route's SeaweedFS_critpath_route_seconds.",
    ["route", "segment"],
    registry=REGISTRY,
)
CRITPATH_ROUTE_SECONDS = Counter(
    "SeaweedFS_critpath_route_seconds",
    "Total client-visible request seconds per route — the denominator "
    "the per-segment SeaweedFS_critpath_seconds composition is read "
    "against (segments sum to this by construction).",
    ["route"],
    registry=REGISTRY,
)


@contextmanager
def time_request(counter: Counter, histogram: Histogram, kind: str):
    """Count + time one request under the given label."""
    counter.labels(type=kind).inc()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        histogram.labels(type=kind).observe(time.perf_counter() - t0)


def start_push_loop(
    job: str,
    instance: str,
    address: str,
    interval_seconds: int,
    collect=None,
):
    """Background task PUSHING the registry to a Prometheus pushgateway
    (reference metrics.go:263-283 LoopPushingMetric): PUT the text
    exposition to /metrics/job/<job>/instance/<instance> every
    `interval_seconds`, over the port's HTTP client (server/http.py).
    Returns the asyncio.Task (cancel on server stop), or None when no
    address/interval is configured — serving /metrics locally is
    unaffected either way."""
    import asyncio

    # interval 0 = pushing disabled even with an address, matching the
    # reference's early return (metrics.go:264-266)
    if not address or interval_seconds == 0:
        return None
    if interval_seconds < 0:
        # misconfigured negative interval would busy-loop; the reference
        # clamps to its 15s default the same way (metrics.go:277-279)
        interval_seconds = 15
    return asyncio.create_task(
        _push_loop(job, instance, address, interval_seconds, collect)
    )


async def _push_loop(job, instance, address, interval_seconds, collect):
    import asyncio
    import logging
    import urllib.parse

    from ..server.http import fetch

    log = logging.getLogger("stats")
    parts = urllib.parse.urlsplit(
        address if "://" in address else f"http://{address}")
    hostport = f"{parts.hostname}:{parts.port or 80}"
    path = (
        f"{parts.path.rstrip('/')}/metrics/job/"
        f"{urllib.parse.quote(job, safe='')}"
        f"/instance/{urllib.parse.quote(instance, safe='')}"
    )
    url = f"http://{hostport}{path}"
    log.info("pushing metrics to %s every %ds", url, interval_seconds)

    async def push_once():
        if collect is not None:
            collect()
        status, _, _ = await fetch(
            hostport, "PUT", path,
            headers={"Content-Type": CONTENT_TYPE_LATEST},
            body=generate_latest(REGISTRY), timeout=30.0,
        )
        if status >= 300:
            log.warning("pushgateway %s returned HTTP %d", url, status)

    try:
        while True:
            try:
                await push_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — the gateway being
                # down must not kill the server's push loop
                log.warning("could not push metrics to %s: %s", url, e)
            await asyncio.sleep(interval_seconds)
    except asyncio.CancelledError:
        # final best-effort push so a short-lived run (benchmark, CI
        # job) doesn't silently drop the last interval's samples —
        # bounded, so a dead gateway can't stall server shutdown
        try:
            await asyncio.wait_for(push_once(), timeout=2.0)
        except Exception:  # noqa: BLE001
            log.debug("final metrics push to %s failed", url)
        raise
