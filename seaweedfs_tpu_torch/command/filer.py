"""`filer` — run a filer server (reference: weed/command/filer.go; the
port of seaweedfs_tpu/command/filer.py):

    python3 -m seaweedfs_tpu_torch filer -master 127.0.0.1:9333 \\
        -port 8888 -maxMB 4 -store native -db /data/filer.kv

Every flag keeps the reference's spelling.  `-store` takes memory, sqlite
or native (the embedded C++ KV, storage/kvstore.py; it needs `-db`); by
default sqlite when `-db` is set, else memory.  The filer never reaches
the device and starts without importing torch.  `-notifySpool` and
`-notifyMq` parse and exit at start: their notifiers are the replication
and message-queue layers, which wait for their ROADMAP A10 items.
`-encryptVolumeData` exits at start on a machine without the
`cryptography` package.
"""
from __future__ import annotations

import argparse
import asyncio
import logging

from . import common_args
from ..security import guard as guard_mod

NAME = "filer"
HELP = "start a filer server (namespace tier over the object store)"


def add_args(p) -> None:
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8888)
    p.add_argument(
        "-port.grpc", dest="grpc_port", type=int, default=0,
        help="RPC port (default: port+10000)",
    )
    p.add_argument(
        "-master", dest="masters", default="127.0.0.1:9333",
        help="comma-separated master servers",
    )
    p.add_argument("-collection", default="")
    p.add_argument("-defaultReplicaPlacement", dest="replication", default="")
    p.add_argument("-dataCenter", dest="data_center", default="")
    p.add_argument(
        "-maxMB", dest="max_mb", type=int, default=4,
        help="auto-chunk uploads into chunks of this size",
    )
    p.add_argument(
        "-db", dest="db_path", default="",
        help="metadata store path (default: in-memory)",
    )
    p.add_argument(
        "-store", dest="store_kind", default="",
        choices=["", "memory", "sqlite", "native"],
        help="metadata store kind; default: sqlite when -db is set, else "
        "memory.  'native' uses the embedded C++ KV (csrc/host/kvstore.cpp)",
    )
    p.add_argument(
        "-metaLog", dest="meta_log_path", default="",
        help="append-only metadata event log path",
    )
    p.add_argument(
        "-notifySpool", dest="notify_spool", default="",
        help="publish every metadata change to this spool file (refused "
        "at start: the notifiers wait for the replication layer)",
    )
    p.add_argument(
        "-notifyMq", dest="notify_mq", default="",
        help="publish every metadata change to this MQ broker (refused at "
        "start: the notifiers wait for the message-queue layer)",
    )
    p.add_argument(
        "-notifyMqTopic", dest="notify_mq_topic", default="filer_meta",
        help="MQ topic for -notifyMq events",
    )
    p.add_argument(
        "-metricsPort", dest="metrics_port", type=int, default=0,
        help="prometheus /metrics port (0 = auto-assign)",
    )
    p.add_argument(
        "-encryptVolumeData", dest="cipher", action="store_true",
        help="AES-GCM encrypt chunk data at rest (needs `cryptography`)",
    )
    p.add_argument(
        "-compressChunks", dest="compress_chunks",
        action=argparse.BooleanOptionalAction, default=True,
        help="compress compressible chunks (zstd, gzip without zstandard; "
        "default on; --no-compressChunks to disable)",
    )
    p.add_argument(
        "-cacheDir", dest="chunk_cache_dir", default="",
        help="directory for the on-disk chunk cache tier",
    )
    p.add_argument(
        "-cacheSizeMB", dest="chunk_cache_mb", type=int, default=64,
        help="memory chunk cache budget",
    )
    common_args.add_metrics_args(p)
    common_args.add_obs_args(p)


def build_filer_server(args):
    """-> a FilerServer from the parsed flags, not started.  Exits at once
    on -notifySpool / -notifyMq, on -store native without -db, and on
    -encryptVolumeData without `cryptography`."""
    if getattr(args, "notify_spool", "") or getattr(args, "notify_mq", ""):
        raise SystemExit(
            "filer: -notifySpool and -notifyMq are not served yet: the "
            "notifiers wait for replication/ and mq/ (ROADMAP A10)")
    if args.cipher:
        from ..utils.cipher import require

        try:
            require()
        except RuntimeError as e:
            raise SystemExit(f"filer: {e}")
    from ..filer.filerstore import MemoryStore, NativeKvStore, SqliteStore
    from ..server.filer import FilerServer

    kind = getattr(args, "store_kind", "") or (
        "sqlite" if args.db_path else "memory"
    )
    if kind == "native":
        if not args.db_path:
            raise SystemExit("-store native requires -db <path>")
        store = NativeKvStore(args.db_path)
    elif kind == "sqlite":
        store = SqliteStore(args.db_path or ":memory:")
    else:
        store = MemoryStore()
    return FilerServer(
        masters=[m.strip() for m in args.masters.split(",") if m.strip()],
        store=store,
        ip=args.ip,
        port=args.port,
        grpc_port=args.grpc_port,
        max_mb=args.max_mb,
        collection=args.collection,
        replication=args.replication,
        data_center=args.data_center,
        meta_log_path=args.meta_log_path or None,
        metrics_port=args.metrics_port,
        cipher=args.cipher,
        compress_chunks=args.compress_chunks,
        chunk_cache_dir=args.chunk_cache_dir or None,
        chunk_cache_mb=args.chunk_cache_mb,
        white_list=guard_mod.from_security_toml(),
        **common_args.metrics_kwargs(args),
    )


async def run(args) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    common_args.apply_obs_args(args)
    fs = build_filer_server(args)
    await fs.start()
    try:
        await asyncio.Event().wait()
    finally:
        await fs.stop()
