"""`master` — run a master server (reference: weed/command/master.go).

Port of seaweedfs_tpu/command/master.py for the flags one master without
raft serves, with the reference's spellings:

    python3 -m seaweedfs_tpu_torch master -ip 127.0.0.1 -port 9333 \\
        -volumeSizeLimitMB 30720 -defaultReplication 000

The -ec.repair.* flags configure the repair plane (repair/config.py
RepairConfig), which is on by default:

    python3 -m seaweedfs_tpu_torch master -port 9333 \
        -ec.repair.intervalSeconds 1 -ec.repair.scrubIntervalSeconds 60

The -obs.slo.* flags declare the SLOs the master judges every pulse
(obs/slo.py) and the -obs.incident.* flags where and how often the
incident bundler writes (obs/incident.py); -metrics.* and -obs.* are the
flags every server role shares (command/common_args.py):

    python3 -m seaweedfs_tpu_torch master -port 9333 \
        -obs.slo.readP99Ms 50 -obs.slo.readStage batch_dispatch \
        -obs.incident.dir /var/lib/swfs/incidents \
        -obs.incident.profileSeconds 2

The master itself does no device work; its repair jobs run K1 on the
volume servers' cards, and a latency SLO's bundle holds a torch.profiler
capture of the busiest volume server's card.  `-peers`, `-mdir` and
vacuum wait for ROADMAP A4c-3 and A4c-5.
"""
from __future__ import annotations

import asyncio
import logging

from . import common_args

NAME = "master"
HELP = "start a master server"


def add_args(p) -> None:
    p.add_argument("-ip", default="127.0.0.1", help="listen address")
    p.add_argument("-port", type=int, default=9333, help="http port")
    p.add_argument(
        "-port.grpc", dest="grpc_port", type=int, default=0,
        help="RPC port (default: port+10000)",
    )
    p.add_argument(
        "-volumeSizeLimitMB", dest="volume_size_limit_mb", type=int,
        default=30 * 1024, help="roll to a new volume past this size",
    )
    p.add_argument(
        "-defaultReplication", dest="default_replication", default="000",
        help="XYZ replica placement when an assign doesn't specify one",
    )
    p.add_argument("-pulseSeconds", dest="pulse_seconds", type=int, default=5)
    # the repair plane (repair/config.py RepairConfig): the master's
    # autonomous ec.rebuild loop over the telemetry plane
    p.add_argument(
        "-ec.repair.disable", dest="ec_repair_disable",
        action="store_true",
        help="disable the autonomous EC repair scheduler (detection "
        "status stays live; only manual ec.rebuild restores redundancy)",
    )
    p.add_argument(
        "-ec.repair.intervalSeconds", dest="ec_repair_interval_seconds",
        type=float, default=5.0,
        help="repair scan cadence: how often the master diffs the EC "
        "census against full redundancy and plans repairs",
    )
    p.add_argument(
        "-ec.repair.maxInflight", dest="ec_repair_max_inflight",
        type=int, default=2,
        help="concurrent repair jobs (one volume's gather/rebuild "
        "choreography each)",
    )
    p.add_argument(
        "-ec.repair.fanout", dest="ec_repair_fanout", type=int, default=4,
        help="per-job shard-copy fan-out width (the gather/spread "
        "concurrency bound)",
    )
    p.add_argument(
        "-ec.repair.backoffBaseSeconds",
        dest="ec_repair_backoff_base_seconds", type=float, default=1.0,
        help="first retry delay after a failed repair; doubles per "
        "attempt",
    )
    p.add_argument(
        "-ec.repair.backoffMaxSeconds",
        dest="ec_repair_backoff_max_seconds", type=float, default=60.0,
        help="exponential backoff ceiling for failed repairs",
    )
    p.add_argument(
        "-ec.repair.maxAttempts", dest="ec_repair_max_attempts",
        type=int, default=8,
        help="park a volume as failed after this many repair attempts",
    )
    p.add_argument(
        "-ec.repair.scrubIntervalSeconds",
        dest="ec_repair_scrub_interval_seconds", type=float, default=0.0,
        help="master-driven parity scrub sweep cadence feeding corrupt-"
        "shard verdicts into the repair queue (0 disables)",
    )
    p.add_argument(
        "-ec.repair.breakerPauseSeconds",
        dest="ec_repair_breaker_pause_seconds", type=float, default=2.0,
        help="defer repair scheduling this long whenever a fresh node "
        "reports an open interactive QoS breaker",
    )
    common_args.add_metrics_args(p)
    common_args.add_obs_args(p)
    # incident plane (obs/slo.py + obs/incident.py): declared SLOs +
    # bundle disk/rate knobs — master-side, it hosts the engine
    common_args.add_slo_incident_args(p)


def repair_config(args):
    """The RepairConfig the -ec.repair.* flags spell."""
    from ..repair import RepairConfig

    return RepairConfig(
        enabled=not args.ec_repair_disable,
        interval_seconds=args.ec_repair_interval_seconds,
        max_inflight=args.ec_repair_max_inflight,
        fanout_concurrency=args.ec_repair_fanout,
        backoff_base_seconds=args.ec_repair_backoff_base_seconds,
        backoff_max_seconds=args.ec_repair_backoff_max_seconds,
        max_attempts=args.ec_repair_max_attempts,
        scrub_interval_seconds=args.ec_repair_scrub_interval_seconds,
        breaker_pause_seconds=args.ec_repair_breaker_pause_seconds,
    ).validated()


def build_server(args):
    """A MasterServer from the parsed flags (not started)."""
    common_args.apply_obs_args(args)
    from ..server.master import MasterServer
    from ..storage import types as storage_types

    if args.volume_size_limit_mb * 1024 * 1024 > storage_types.MAX_POSSIBLE_VOLUME_SIZE:
        # volumes past the 4-byte 32GB address cap need 5-byte needle-map
        # offsets (reference 5BytesOffset build tag) — a deployment-wide
        # mode every node must share
        storage_types.set_offset_size(5)
    return MasterServer(
        ip=args.ip,
        port=args.port,
        grpc_port=args.grpc_port,
        volume_size_limit_mb=args.volume_size_limit_mb,
        default_replication=args.default_replication,
        pulse_seconds=args.pulse_seconds,
        ec_repair=repair_config(args),
        **common_args.metrics_kwargs(args),
        **common_args.slo_incident_kwargs(args),
    )


async def run(args) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    ms = build_server(args)
    await ms.start()
    try:
        await asyncio.Event().wait()  # serve until interrupted
    finally:
        await ms.stop()
