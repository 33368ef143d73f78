"""`master` — run a master server (reference: weed/command/master.go).

Port of seaweedfs_tpu/command/master.py, with the reference's spellings:

    python3 -m seaweedfs_tpu_torch master -ip 127.0.0.1 -port 9333 \\
        -volumeSizeLimitMB 30720 -defaultReplication 000

Three masters form a raft group (raft/node.py): each is given every
master's address with -peers (itself included; `host:port.grpcPort` where
the RPC port is not port+10000) and a directory of its own for the raft
state with -mdir, where a restart finds its term, vote, log and
snapshot.  Past -raft.snapshotThreshold log entries the log is compacted
into a snapshot:

    python3 -m seaweedfs_tpu_torch master -port 9333 -mdir /var/lib/m1 \
        -peers 10.0.0.1:9333,10.0.0.2:9333,10.0.0.3:9333

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
capture of the busiest volume server's card.  `-garbageThreshold` is the
garbage ratio past which a vacuum pass compacts a volume, and
`-autoVacuum` runs a pass every three pulses (off by default, as in the
reference):

    python3 -m seaweedfs_tpu_torch master -port 9333 \
        -garbageThreshold 0.3 -autoVacuum

security.toml (./, ~/.seaweedfs/, /etc/seaweedfs/) gives the write-JWT
key and lifetime (`[jwt.signing] key`, `expires_after_seconds`), the peer
white list (`[access] white_list`) and mutual TLS for the RPC plane
(`[tls] ca`, `cert`, `key`).
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
    p.add_argument(
        "-garbageThreshold", dest="garbage_threshold", type=float, default=0.3,
        help="vacuum when garbage ratio exceeds this",
    )
    p.add_argument(
        "-autoVacuum", dest="auto_vacuum", action="store_true",
        help="periodically drive the vacuum protocol",
    )
    p.add_argument(
        "-peers", default="",
        help="comma-separated masters in the raft group (including this "
        "one); empty = single-master",
    )
    p.add_argument(
        "-mdir", dest="meta_dir", default="",
        help="directory for durable raft state (term/vote/log/snapshot)",
    )
    p.add_argument(
        "-raft.snapshotThreshold", dest="raft_snapshot_threshold",
        type=int, default=1000,
        help="compact the raft log into a snapshot past this many entries",
    )
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
    from ..security import guard as guard_mod
    from ..server.master import MasterServer
    from ..storage import types as storage_types
    from ..utils import config as config_util

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
        garbage_threshold=args.garbage_threshold,
        auto_vacuum=args.auto_vacuum,
        ec_repair=repair_config(args),
        jwt_signing_key=config_util.jwt_signing_key(),
        jwt_expires_sec=config_util.jwt_expires_sec(),
        white_list=guard_mod.from_security_toml(),
        peers=[p.strip() for p in args.peers.split(",") if p.strip()],
        meta_dir=args.meta_dir or None,
        raft_snapshot_threshold=args.raft_snapshot_threshold,
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
