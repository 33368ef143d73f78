"""Flags shared by the server commands (reference: the global
-metrics.address / -metrics.intervalSeconds pair every `weed` server
command forwards to stats.LoopPushingMetric, weed/stats/metrics.go:263).

Port of seaweedfs_tpu/command/common_args.py: the master and the volume
server take the -metrics.* and -obs.* flags, the master the -obs.slo.*
and the bundler's -obs.incident.* flags, all with the reference's
spellings and defaults.
"""
from __future__ import annotations


def add_metrics_args(p) -> None:
    p.add_argument(
        "-metrics.address", dest="metrics_address", default="",
        help="Prometheus pushgateway host:port to push metrics to "
        "(empty = serve /metrics only)",
    )
    p.add_argument(
        "-metrics.intervalSeconds", dest="metrics_interval_seconds",
        type=int, default=15, help="how often to push metrics",
    )


def metrics_kwargs(args) -> dict:
    return dict(
        metrics_address=args.metrics_address,
        metrics_interval_seconds=args.metrics_interval_seconds,
    )


def add_obs_args(p) -> None:
    """The -obs.* request-tracing, flight-recorder, timeline, tail and
    ledger flags every server role shares (ObsConfig and IncidentConfig
    are the single sources of the defaults)."""
    from ..obs import IncidentConfig, ObsConfig

    d = ObsConfig()
    di = IncidentConfig()
    p.add_argument(
        "-obs.disable", dest="obs_disable", action="store_true",
        help="disable request tracing (/debug/traces stays empty; the "
        "per-stage histograms keep recording)",
    )
    p.add_argument(
        "-obs.slowMs", dest="obs_slow_ms", type=float, default=d.slow_ms,
        help="log any request whose end-to-end trace exceeds this many "
        "milliseconds, with its per-stage breakdown (0 = off)",
    )
    p.add_argument(
        "-obs.traceRing", dest="obs_trace_ring", type=int,
        default=d.trace_ring,
        help="completed traces kept in memory for /debug/traces",
    )
    p.add_argument(
        "-obs.incident.disable", dest="obs_incident_disable",
        action="store_true",
        help="disable the flight recorder (decision events — QoS sheds, "
        "breaker flips, dispatcher saturation, spent deadlines, stall "
        "aborts — stop landing in /debug/incident)",
    )
    p.add_argument(
        "-obs.incident.events", dest="obs_incident_events", type=int,
        default=di.events,
        help="flight-recorder events kept in memory per process "
        "(newest win), served at /debug/incident",
    )
    p.add_argument(
        "-obs.ledger.disable", dest="obs_ledger_disable",
        action="store_true",
        help="disable the per-workload device-time ledger (the "
        "SeaweedFS_volumeServer_device_* attribution series stop moving; "
        "workload tagging context still propagates)",
    )
    p.add_argument(
        "-obs.timeline.disable", dest="obs_timeline_disable",
        action="store_true",
        help="disable the flight-timeline sampler (/debug/timeline "
        "stays empty and heartbeats stop carrying samples)",
    )
    p.add_argument(
        "-obs.timeline.intervalSeconds",
        dest="obs_timeline_interval_seconds", type=float,
        default=d.timeline_interval_seconds,
        help="seconds between flight-timeline samples",
    )
    p.add_argument(
        "-obs.timeline.window", dest="obs_timeline_window", type=int,
        default=d.timeline_window,
        help="flight-timeline samples kept (the ring bound; default 120 "
        "≈ two minutes at the 1s interval)",
    )
    p.add_argument(
        "-obs.tail.disable", dest="obs_tail_disable", action="store_true",
        help="disable tail-based trace retention (/debug/tail answers "
        "404; slow traces churn out of the ring like fast ones and "
        "SeaweedFS_critpath_seconds stops accumulating)",
    )
    p.add_argument(
        "-obs.tail.ring", dest="obs_tail_ring", type=int,
        default=d.tail_ring,
        help="pinned slow/incident span trees kept per process "
        "(newest pins win; fast requests never evict a pin)",
    )
    p.add_argument(
        "-obs.tail.alpha", dest="obs_tail_alpha", type=float,
        default=d.tail_alpha,
        help="EWMA smoothing factor for the per-route p99 estimate "
        "that gates tail pinning (0 < alpha <= 1)",
    )
    p.add_argument(
        "-obs.tail.floorMs", dest="obs_tail_floor_ms", type=float,
        default=d.tail_floor_ms,
        help="also pin any request at least this slow, regardless of "
        "its route's p99 estimate (0 = off)",
    )


def apply_obs_args(args) -> None:
    """Process-global, like the metrics registry: call once at entry."""
    from ..obs import IncidentConfig, ObsConfig, configure, devledger, incident

    configure(
        ObsConfig(
            enabled=not args.obs_disable,
            slow_ms=args.obs_slow_ms,
            trace_ring=args.obs_trace_ring,
            ledger_enabled=not args.obs_ledger_disable,
            timeline_enabled=not args.obs_timeline_disable,
            timeline_interval_seconds=args.obs_timeline_interval_seconds,
            timeline_window=args.obs_timeline_window,
            tail_enabled=not args.obs_tail_disable,
            tail_ring=args.obs_tail_ring,
            tail_alpha=args.obs_tail_alpha,
            tail_floor_ms=args.obs_tail_floor_ms,
        )
    )
    devledger.configure(enabled=not args.obs_ledger_disable)
    incident.configure(
        IncidentConfig(
            enabled=not args.obs_incident_disable,
            events=args.obs_incident_events,
        )
    )


def add_slo_incident_args(p) -> None:
    """Master-only incident-plane flags: the declared SLOs
    (obs/slo.py SloConfig) and the bundler's disk/rate knobs
    (obs/incident.py IncidentConfig)."""
    from ..obs import IncidentConfig, SloConfig

    d = SloConfig()
    di = IncidentConfig()
    p.add_argument(
        "-obs.slo.disable", dest="obs_slo_disable", action="store_true",
        help="disable SLO evaluation entirely (individual objectives "
        "are also off while their target flag is 0)",
    )
    p.add_argument(
        "-obs.slo.readP99Ms", dest="obs_slo_read_p99_ms", type=float,
        default=d.read_p99_ms,
        help="read-latency SLO: at most 1%% of -obs.slo.readStage "
        "observations may exceed this many ms (0 = objective off)",
    )
    p.add_argument(
        "-obs.slo.readStage", dest="obs_slo_read_stage",
        default=d.read_stage,
        help="stage digest the read-latency SLO judges (a "
        "SeaweedFS_request_stage_seconds stage name)",
    )
    p.add_argument(
        "-obs.slo.errorRatePct", dest="obs_slo_error_rate_pct",
        type=float, default=d.error_rate_pct,
        help="error-rate SLO: allowed percent of EC reads shed/failed "
        "per window (0 = objective off)",
    )
    p.add_argument(
        "-obs.slo.timeToHealthySeconds",
        dest="obs_slo_time_to_healthy_seconds", type=float,
        default=d.time_to_healthy_seconds,
        help="recovery SLO: the repair plane must restore full "
        "redundancy within this many seconds (0 = objective off)",
    )
    p.add_argument(
        "-obs.slo.breakerOpenPct", dest="obs_slo_breaker_open_pct",
        type=float, default=d.breaker_open_pct,
        help="front-door SLO: allowed percent of telemetry pulses with "
        "any open interactive QoS breaker (0 = objective off)",
    )
    p.add_argument(
        "-obs.slo.fastWindowSeconds", dest="obs_slo_fast_window_seconds",
        type=float, default=d.fast_window_seconds,
        help="fast burn-rate alert window (trips quickly)",
    )
    p.add_argument(
        "-obs.slo.slowWindowSeconds", dest="obs_slo_slow_window_seconds",
        type=float, default=d.slow_window_seconds,
        help="slow burn-rate alert window (confirms the fast trip; "
        "also the error-budget horizon)",
    )
    p.add_argument(
        "-obs.slo.burnThreshold", dest="obs_slo_burn_threshold",
        type=float, default=d.burn_threshold,
        help="burn rate BOTH windows must reach to fire a violation "
        "(1.0 = burning exactly the budgeted rate)",
    )
    p.add_argument(
        "-obs.incident.dir", dest="obs_incident_dir", default=di.dir,
        help="directory incident bundles are written under; empty "
        "disables bundling (SLO-fired and cluster.incident.dump alike)",
    )
    p.add_argument(
        "-obs.incident.keep", dest="obs_incident_keep", type=int,
        default=di.keep,
        help="incident bundles kept on disk, oldest deleted first",
    )
    p.add_argument(
        "-obs.incident.minIntervalSeconds",
        dest="obs_incident_min_interval_seconds", type=float,
        default=di.min_interval_seconds,
        help="minimum seconds between SLO-fired bundles (a flapping "
        "SLO writes one bundle per interval, not one per pulse)",
    )
    p.add_argument(
        "-obs.incident.profileSeconds",
        dest="obs_incident_profile_seconds", type=float,
        default=di.profile_seconds,
        help="when a LATENCY SLO burns, grab a device-profile capture "
        "of this many seconds from the busiest fresh node's "
        "/debug/profile (0 = off; the endpoint needs SWFS_DEBUG=1)",
    )


def slo_incident_kwargs(args) -> dict:
    """MasterServer kwargs from the -obs.slo.* / master-side
    -obs.incident.* flags (validated at server construction)."""
    from ..obs import IncidentConfig, SloConfig

    return dict(
        obs_slo=SloConfig(
            enabled=not args.obs_slo_disable,
            read_p99_ms=args.obs_slo_read_p99_ms,
            read_stage=args.obs_slo_read_stage,
            error_rate_pct=args.obs_slo_error_rate_pct,
            time_to_healthy_seconds=args.obs_slo_time_to_healthy_seconds,
            breaker_open_pct=args.obs_slo_breaker_open_pct,
            fast_window_seconds=args.obs_slo_fast_window_seconds,
            slow_window_seconds=args.obs_slo_slow_window_seconds,
            burn_threshold=args.obs_slo_burn_threshold,
        ),
        obs_incident=IncidentConfig(
            enabled=not args.obs_incident_disable,
            events=args.obs_incident_events,
            dir=args.obs_incident_dir,
            keep=args.obs_incident_keep,
            min_interval_seconds=args.obs_incident_min_interval_seconds,
            profile_seconds=args.obs_incident_profile_seconds,
        ),
    )
