"""Flight timeline: a bounded per-node ring of ~1s samples of the
signals that explain a latency spike after the fact.

Port of seaweedfs_tpu/obs/timeline.py (the sampler is the reference's;
its counters are read from the port's registry, stats/metrics.py).  The
incident recorder captures decisions AT a moment; a latency spike needs
the 30 seconds LEADING INTO it.  Each sample is one JSON-able dict holding
counter DELTAS since the previous sample (devledger busy/dispatches per
workload class, QoS sheds, ingest bytes/backpressure) plus point-in-time
gauges (QoS queue depths, breaker states, resident cache bytes) and an
EXEMPLAR: the slowest trace that finished inside the window, with its
slowest span — so a spike in the timeline links to a concrete trace in
/debug/traces instead of a shrug.

Every sample's `t` is a whole unix second, so samples of several nodes
align by `t`.  The volume server ships them to the master over its
heartbeats, ACK-gated (`take_new` is the shipper's cursor), and the
master assembles the cluster timeline (stats/cluster.py).

Bounded memory by construction: the ring holds `-obs.timeline.window`
samples (default 120 ≈ two minutes at the default 1s
`-obs.timeline.intervalSeconds`), the exemplar is one tuple, and the
delta baseline is one flat dict of floats.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from ..stats.metrics import REGISTRY
from . import devledger
from . import trace as obs_trace

# QoS label universes sampled via the metrics registry (reading the
# exported series keeps the sampler decoupled from serving/* objects)
_TIERS = ("interactive", "bulk")
_QOS_SHED_REASONS = ("queue_budget", "deadline", "breaker_open")
_INGEST_SHED_REASONS = ("qos", "deadline", "arena")


def _value(name: str, labels: dict | None = None) -> float:
    v = REGISTRY.get_sample_value(name, labels or {})
    return 0.0 if v is None else float(v)


class TimelineSampler:
    """One node's flight-timeline ring + exemplar tap.

    `install()` hooks the finished-trace stream; `sample()` is called by
    the node's ~1s loop (and by tests, with an explicit `now`); the ring
    serves /debug/timeline locally and `take_new()` hands a heartbeat
    shipper its not-yet-folded suffix."""

    def __init__(self, node: str = "", window: int | None = None):
        cfg = obs_trace.CONFIG
        self.node = node
        self._lock = threading.Lock()
        self._ring: deque = deque(
            maxlen=int(window if window is not None else cfg.timeline_window)
        )
        self._seq = 0  # samples ever taken; take_new's cursor space
        self._taken = 0  # seq already handed to the heartbeat shipper
        self._last: dict[str, float] = {}  # counter baseline for deltas
        self._installed = False
        # slowest finished trace since the last sample:
        # (duration_s, trace_id, name, slowest_span_name)
        self._slowest: tuple | None = None

    @property
    def capacity(self) -> int:
        return int(self._ring.maxlen or 0)

    # ------------------------------------------------------------ exemplars

    def install(self) -> "TimelineSampler":
        if not self._installed:
            obs_trace.FINISH_OBSERVERS.append(self._on_trace)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            try:
                obs_trace.FINISH_OBSERVERS.remove(self._on_trace)
            except ValueError:
                pass
            self._installed = False

    def _on_trace(self, t) -> None:
        dur = t.duration_s
        with self._lock:
            if self._slowest is not None and dur <= self._slowest[0]:
                return
            spans = list(t.spans)
            slow_span = max(
                spans, key=lambda sp: sp.duration, default=None
            )
            self._slowest = (
                dur, t.trace_id, t.name,
                slow_span.name if slow_span is not None else "",
            )

    # ------------------------------------------------------------- sampling

    def _counters(self) -> dict[str, float]:
        """The flat counter vector the deltas are computed over."""
        out: dict[str, float] = {}
        for wl, busy in devledger.LEDGER.busy_by_workload().items():
            out[f"busy:{wl}"] = busy
        for wl, n in devledger.LEDGER.dispatches_by_workload().items():
            out[f"disp:{wl}"] = float(n)
        for tier in _TIERS:
            for reason in _QOS_SHED_REASONS:
                out[f"qshed:{tier}"] = out.get(f"qshed:{tier}", 0.0) + _value(
                    "SeaweedFS_volumeServer_ec_qos_shed_total",
                    {"tier": tier, "reason": reason},
                )
        out["ingest_bytes"] = _value("SeaweedFS_volumeServer_ingest_bytes_total")
        out["ingest_bp"] = _value(
            "SeaweedFS_volumeServer_ingest_backpressure_total"
        )
        for reason in _INGEST_SHED_REASONS:
            out["ingest_shed"] = out.get("ingest_shed", 0.0) + _value(
                "SeaweedFS_volumeServer_ingest_shed_total", {"reason": reason}
            )
        return out

    def sample(self, now: float | None = None) -> dict:
        """Take one clock-aligned sample; appends to the ring and
        returns it.  `now` (unix seconds) is a test seam."""
        t = int(now if now is not None else time.time())
        cur = self._counters()
        with self._lock:
            prev, self._last = self._last, cur
            slowest, self._slowest = self._slowest, None
            # drop the not-yet-shipped cursor's overflow: if the shipper
            # stalls past a full ring the oldest unshipped samples are
            # gone anyway (bounded memory beats complete shipping)
            busy_ms = {}
            disp = {}
            for key, v in cur.items():
                d = v - prev.get(key, 0.0)
                if d <= 0:
                    continue
                kind, _, wl = key.partition(":")
                if kind == "busy":
                    busy_ms[wl] = round(d * 1e3, 3)
                elif kind == "disp":
                    disp[wl] = int(d)
            sample = {
                "t": t,
                "node": self.node,
                "busy_ms": busy_ms,
                "disp": disp,
                "qos": {
                    "depth": {
                        tier: int(_value(
                            "SeaweedFS_volumeServer_ec_qos_queue_depth",
                            {"tier": tier},
                        ))
                        for tier in _TIERS
                    },
                    "shed": {
                        tier: int(
                            cur.get(f"qshed:{tier}", 0.0)
                            - prev.get(f"qshed:{tier}", 0.0)
                        )
                        for tier in _TIERS
                    },
                    "breaker": {
                        tier: int(_value(
                            "SeaweedFS_volumeServer_ec_qos_breaker_state",
                            {"tier": tier},
                        ))
                        for tier in _TIERS
                    },
                },
                "ingest": {
                    "bytes": int(
                        cur["ingest_bytes"] - prev.get("ingest_bytes", 0.0)
                    ),
                    "backpressure": int(
                        cur["ingest_bp"] - prev.get("ingest_bp", 0.0)
                    ),
                    "shed": int(
                        cur.get("ingest_shed", 0.0)
                        - prev.get("ingest_shed", 0.0)
                    ),
                },
                "resident_bytes": int(
                    _value("SeaweedFS_volumeServer_ec_resident_bytes")
                ),
            }
            if slowest is not None:
                sample["exemplar"] = {
                    "trace_id": slowest[1],
                    "name": slowest[2],
                    "ms": round(slowest[0] * 1e3, 3),
                    "span": slowest[3],
                }
            self._ring.append(sample)
            self._seq += 1
        return sample

    # ------------------------------------------------------------- readers

    def snapshot(self, window_s: float | None = None) -> list[dict]:
        """Oldest-first samples, optionally only the trailing window."""
        with self._lock:
            items = list(self._ring)
        if window_s is not None and items:
            cutoff = items[-1]["t"] - window_s
            items = [s for s in items if s["t"] >= cutoff]
        return items

    def take_new(self) -> list[dict]:
        """Samples appended since the last take — the heartbeat
        shipper's fold source.  A stalled shipper gets at most a ring's
        worth (older unshipped samples have already been evicted)."""
        with self._lock:
            missed = self._seq - self._taken
            self._taken = self._seq
            if missed <= 0:
                return []
            return list(self._ring)[-min(missed, len(self._ring)):]
