"""Observability of the port (seaweedfs_tpu/obs/): request tracing (trace
ids, spans, /debug/traces; the ids ride HTTP headers and RPC metadata),
the incident plane's flight recorder + bundler (incident.py), the
master-side SLO burn-rate engine (slo.py), on-demand device profiling on
torch.profiler (profile.py), the per-workload device-time ledger
(devledger.py), the flight timeline (timeline.py), and the tail-latency
forensics plane — cross-node trace assembly + critical-path attribution
(critpath.py) over tail-pinned full span trees (tailstore.py)."""
from . import critpath, devledger, incident, profile, slo, tailstore, timeline
from .config import ObsConfig
from .critpath import critpath_handler
from .devledger import DeviceLedger, LEDGER
from .incident import IncidentBundler, IncidentConfig
from .profile import device_hot_handler, profile_handler
from .slo import SloConfig, SloEngine
from .tailstore import TailStore, tail_handler
from .timeline import TimelineSampler
from .trace import (
    GRPC_TRACE_KEY,
    RING,
    TRACE_HEADER,
    Trace,
    configure,
    current,
    detached,
    finish_trace,
    grpc_metadata,
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
    "GRPC_TRACE_KEY",
    "IncidentBundler",
    "IncidentConfig",
    "LEDGER",
    "ObsConfig",
    "RING",
    "SloConfig",
    "SloEngine",
    "TailStore",
    "TimelineSampler",
    "critpath",
    "critpath_handler",
    "device_hot_handler",
    "devledger",
    "incident",
    "profile",
    "profile_handler",
    "slo",
    "tail_handler",
    "tailstore",
    "timeline",
    "TRACE_HEADER",
    "Trace",
    "configure",
    "current",
    "detached",
    "finish_trace",
    "grpc_metadata",
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
