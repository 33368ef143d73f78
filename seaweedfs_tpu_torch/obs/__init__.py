"""Observability of the port (seaweedfs_tpu/obs/ less its master half):
request tracing (trace ids, spans, /debug/traces), the flight recorder
(incident.py), on-demand device profiling on torch.profiler (profile.py),
the per-workload device-time ledger (devledger.py), the flight timeline
(timeline.py), and critical-path attribution (critpath.py) over
tail-pinned full span trees (tailstore.py).

What waits for the master (ROADMAP A7c): the SLO burn-rate engine
(slo.py), the incident bundler, the timeline's heartbeat shipping, the
master's cross-node /debug/critpath fan-out and the gRPC trace metadata.
"""
from . import critpath, devledger, incident, profile, tailstore, timeline
from .config import ObsConfig
from .critpath import critpath_handler
from .devledger import DeviceLedger, LEDGER
from .incident import IncidentConfig
from .profile import device_hot_handler, profile_handler
from .tailstore import TailStore, tail_handler
from .timeline import TimelineSampler
from .trace import (
    RING,
    TRACE_HEADER,
    Trace,
    configure,
    current,
    detached,
    finish_trace,
    middleware,
    outbound_headers,
    parse_trace_header,
    record_span,
    span,
    stage_sink,
    stamp_trace_header,
    start_trace,
    traces_handler,
)

__all__ = [
    "DeviceLedger",
    "IncidentConfig",
    "LEDGER",
    "ObsConfig",
    "RING",
    "TailStore",
    "TimelineSampler",
    "critpath",
    "critpath_handler",
    "device_hot_handler",
    "devledger",
    "incident",
    "profile",
    "profile_handler",
    "tail_handler",
    "tailstore",
    "timeline",
    "TRACE_HEADER",
    "Trace",
    "configure",
    "current",
    "detached",
    "finish_trace",
    "middleware",
    "outbound_headers",
    "parse_trace_header",
    "record_span",
    "span",
    "stage_sink",
    "stamp_trace_header",
    "start_trace",
    "traces_handler",
]
