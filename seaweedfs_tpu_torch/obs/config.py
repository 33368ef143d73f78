"""Knobs for the request-tracing layer (the -obs.* flags).

Copy of seaweedfs_tpu/obs/config.py: the same fields, defaults and
validation (tests/test_torch_obs.py holds the two equal).

Mirrors serving/config.py's shape: one dataclass is the single source of
the defaults, the CLI flags exist so an operator can tune without a
rebuild, and `validated()` is the one validation layer.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ObsConfig:
    """Tunables for `seaweedfs_tpu_torch.obs` (CLI: the -obs.* flags)."""

    # record per-request traces into the /debug/traces ring and forward
    # the trace header on fan-out; False keeps only the per-stage
    # Prometheus histograms (spans become pure timers) (-obs.disable)
    enabled: bool = True
    # any request whose end-to-end trace exceeds this many milliseconds
    # is logged with its per-span breakdown; 0 disables the slow log
    # (-obs.slowMs)
    slow_ms: float = 0.0
    # completed traces kept in memory for /debug/traces (newest win)
    # (-obs.traceRing)
    trace_ring: int = 256
    # record per-workload device-time attribution into the devledger
    # and its SeaweedFS_volumeServer_device_* series
    # (-obs.ledger.disable)
    ledger_enabled: bool = True
    # sample the flight timeline (ledger deltas, QoS depths, ingest
    # backpressure, cache residency, breaker states + slow-span
    # exemplars) into the per-node ring, shipped over heartbeats to the
    # master's cluster timeline (-obs.timeline.disable)
    timeline_enabled: bool = True
    # seconds between timeline samples (-obs.timeline.intervalSeconds)
    timeline_interval_seconds: float = 1.0
    # samples kept in the per-node ring — window = interval * this
    # (-obs.timeline.window)
    timeline_window: int = 120
    # pin the FULL span tree of tail requests (slower than the live
    # per-route p99 EWMA, or flagged by a QoS shed/breaker/stall
    # incident) into a second retention ring the fast-path churn can
    # never evict (-obs.tail.disable)
    tail_enabled: bool = True
    # pinned tail traces kept per process, newest win (-obs.tail.ring)
    tail_ring: int = 64
    # EWMA smoothing applied to the per-route windowed p99 estimate;
    # higher chases spikes faster, lower rides through them
    # (-obs.tail.alpha)
    tail_alpha: float = 0.2
    # absolute pin floor in milliseconds: any request at least this slow
    # is pinned even while the route's p99 estimate is still warming up;
    # 0 keeps the pin purely quantile-driven (-obs.tail.floorMs)
    tail_floor_ms: float = 0.0

    def validated(self) -> "ObsConfig":
        if self.slow_ms < 0:
            raise ValueError("slow_ms must be >= 0")
        if self.trace_ring < 1:
            raise ValueError("trace_ring must be >= 1")
        if self.timeline_interval_seconds <= 0:
            raise ValueError("timeline_interval_seconds must be > 0")
        if self.timeline_window < 2:
            # a single-sample ring can never show a ramp — the
            # timeline's whole job — so reject it at flag-parse time
            raise ValueError("timeline_window must be >= 2")
        if self.tail_ring < 1:
            raise ValueError("tail_ring must be >= 1")
        if not 0.0 < self.tail_alpha <= 1.0:
            raise ValueError("tail_alpha must be in (0, 1]")
        if self.tail_floor_ms < 0:
            raise ValueError("tail_floor_ms must be >= 0")
        return self
