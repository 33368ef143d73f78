"""`server` — a master and a volume server in one process
(reference: weed/command/server.go; the port of
seaweedfs_tpu/command/server.py):

    python3 -m seaweedfs_tpu_torch server -dir /data -volume.max 64 \\
        -ec.backend cuda -ec.deviceCacheMB 16384

The volume server heartbeats to the co-hosted master.  `-ec.backend` is
the volume command's: `cuda` (the default: the card, failing at start
without one), `torch` (the plain PyTorch versions on the CPU) or `numpy`;
there is no `auto`.  `-ec.deviceCacheMB` pins mounted EC shards on the
card, as `volume`'s does; the kernels take runtime shapes, so there is no
compile cache to warm before the server starts.  A `-volumeSizeLimitMB`
past the 4-byte offsets' 32 GB switches the process to 5-byte offsets, as
`master` does.  `-master.port.grpc`, `-volume.port.grpc` and
`-pulseSeconds` are those of the master and volume commands (default: the
HTTP port + 10000, and 5 s).  `-filer` adds a filer (`-filer.port`,
`-filer.db`), built from the filer command's own parser as the reference
builds it, so every other filer flag keeps that command's default; it
never reaches the device.  `-s3` parses, and is refused at start: the S3
gateway waits for its ROADMAP A10 item.
"""
from __future__ import annotations

import asyncio
import logging

from . import common_args

NAME = "server"
HELP = "start master + volume server in one process"


def add_args(p) -> None:
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-master.port", dest="master_port", type=int, default=9333)
    p.add_argument(
        "-master.port.grpc", dest="master_grpc_port", type=int, default=0,
        help="the master's RPC port (default: master.port+10000)",
    )
    p.add_argument("-volume.port", dest="volume_port", type=int, default=8080)
    p.add_argument(
        "-volume.port.grpc", dest="volume_grpc_port", type=int, default=0,
        help="the volume server's RPC port (default: volume.port+10000)",
    )
    p.add_argument("-dir", default=".", help="volume data directories (comma-separated)")
    p.add_argument("-volume.max", dest="volume_max", default="8")
    p.add_argument(
        "-volumeSizeLimitMB", dest="volume_size_limit_mb", type=int, default=30 * 1024
    )
    p.add_argument("-defaultReplication", dest="default_replication", default="000")
    p.add_argument(
        "-pulseSeconds", dest="pulse_seconds", type=int, default=5,
        help="seconds between heartbeats",
    )
    p.add_argument(
        "-ec.backend", dest="ec_backend", default="cuda",
        choices=["cuda", "torch", "numpy"],
        help="erasure-coding kernel backend: cuda (the card; fails at "
        "start without one), torch (plain PyTorch versions on the CPU), "
        "numpy (the table oracle)",
    )
    p.add_argument(
        "-ec.deviceCacheMB", dest="ec_device_cache_mb", type=int, default=0,
        help="pin mounted EC shards in device memory up to this budget so "
        "degraded reads reconstruct on the card (0 = disabled)",
    )
    p.add_argument("-filer", action="store_true", help="also run a filer")
    p.add_argument("-filer.port", dest="filer_port", type=int, default=8888)
    p.add_argument("-filer.db", dest="filer_db", default="")
    p.add_argument("-s3", action="store_true", help="also run the S3 gateway")
    p.add_argument("-s3.port", dest="s3_port", type=int, default=8333)
    p.add_argument("-s3.config", dest="s3_config", default="")
    common_args.add_metrics_args(p)
    common_args.add_obs_args(p)
    # the co-hosted master carries the incident plane's engine/bundler
    common_args.add_slo_incident_args(p)


def build_servers(args):
    """-> (MasterServer, VolumeServer) from the parsed flags, neither
    started (the filer of -filer is built by `build_filer` once the
    master is bound).  Raises, with -ec.backend cuda, without a card;
    exits at once on -s3."""
    if args.s3:
        raise SystemExit(
            "server: -s3 is not served yet: the S3 gateway waits for "
            "ROADMAP A10")
    common_args.apply_obs_args(args)
    from ..security import guard as guard_mod
    from ..server.master import MasterServer
    from ..server.volume import VolumeServer
    from ..storage import types as storage_types
    from ..utils import config as config_util

    if args.volume_size_limit_mb * 1024 * 1024 > storage_types.MAX_POSSIBLE_VOLUME_SIZE:
        storage_types.set_offset_size(5)  # see command/master.py

    jwt_key = config_util.jwt_signing_key()
    white_list = guard_mod.from_security_toml()
    # every co-hosted role pushes the shared process registry under its
    # own job name, as the reference's combined `weed server` does with
    # its shared Gather — consumers aggregate with a job filter
    metrics_kw = common_args.metrics_kwargs(args)
    ms = MasterServer(
        ip=args.ip,
        port=args.master_port,
        grpc_port=args.master_grpc_port,
        volume_size_limit_mb=args.volume_size_limit_mb,
        default_replication=args.default_replication,
        pulse_seconds=args.pulse_seconds,
        jwt_signing_key=jwt_key,
        jwt_expires_sec=config_util.jwt_expires_sec(),
        white_list=white_list,
        **metrics_kw,
        **common_args.slo_incident_kwargs(args),
    )
    dirs = [d.strip() for d in args.dir.split(",") if d.strip()]
    counts = [int(c) for c in str(args.volume_max).split(",")]
    if len(counts) == 1:
        counts = counts * len(dirs)
    vs = VolumeServer(
        masters=[ms.advertise_url],
        directories=dirs,
        ip=args.ip,
        port=args.volume_port,
        grpc_port=args.volume_grpc_port,
        max_volume_counts=counts,
        pulse_seconds=args.pulse_seconds,
        ec_backend=args.ec_backend,
        ec_device_cache_mb=args.ec_device_cache_mb,
        jwt_signing_key=jwt_key,
        white_list=white_list,
        **metrics_kw,
    )
    return ms, vs


def build_filer(args, master_address: str):
    """-> the FilerServer of -filer, not started, subscribed to the
    co-hosted master at `master_address` (host:port[.grpc])."""
    import argparse

    from . import filer as filer_cmd

    # take every default from the filer command's own parser so new filer
    # flags can never drift out of sync with `server`
    fparser = argparse.ArgumentParser()
    filer_cmd.add_args(fparser)
    fargs = fparser.parse_args([])
    fargs.masters = master_address
    fargs.db_path = args.filer_db
    fargs.ip = args.ip
    fargs.port = args.filer_port
    fargs.metrics_address = args.metrics_address
    fargs.metrics_interval_seconds = args.metrics_interval_seconds
    return filer_cmd.build_filer_server(fargs)


async def run(args) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    ms, vs = build_servers(args)
    await ms.start()
    fs = None
    try:
        await vs.start()
        try:
            if args.filer:
                fs = build_filer(args, ms.advertise_url)
                await fs.start()
            await asyncio.Event().wait()
        finally:
            if fs is not None:
                await fs.stop()
            await vs.stop()
    finally:
        await ms.stop()
