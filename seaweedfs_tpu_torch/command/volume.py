"""`volume` — run a volume server (reference: weed/command/volume.go).

Port of seaweedfs_tpu/command/volume.py with the reference's flag
spellings, for the flags this slice serves:

    python3 -m seaweedfs_tpu_torch volume -dir DIR -port 8080 \\
        -mserver 127.0.0.1:9333 -ec.backend cuda -ec.deviceCacheMB 16384 \\
        -ec.serving.layout flat -ec.scrub.intervalSeconds 60

`-ec.backend` is `cuda` (the default: the card, failing at start without
one), `torch` (the plain PyTorch versions on the CPU) or `numpy` (the
table oracle); there is no `auto`.  The -ec.tier.* flags drive the
residency ladder (serving/tiering.py) and the -ec.ingest.* flags the
streaming ingest plane (ingest/), with the reference's names and defaults;
`-ec.ingest.backend` takes the port's backend names (cuda, torch, numpy,
native) and defaults to `-ec.backend`.  `-mserver` names the masters the
server heartbeats to (the reference's default, 127.0.0.1:9333; an empty
value runs the server alone), `-port.grpc` its RPC listener (default:
port + 10000), and the -ec.rpc.* flags the fault policy of its peer
calls (utils/faultpolicy.py).  The -obs.* and -metrics.* flags are the
reference's, shared with the master (command/common_args.py): with
-metrics.address the server pushes its registry to a Prometheus
pushgateway every -metrics.intervalSeconds.

`-images.fix.orientation` turns uploaded JPEGs upright by their EXIF tag,
as the reference does.  `-ec.serving.aot.disable` is accepted and does
nothing: the kernels take runtime shapes, so there is no ahead-of-time
compile to turn off.  security.toml (./, ~/.seaweedfs/, /etc/seaweedfs/)
gives the write-JWT key (`[jwt.signing] key`), the peer white list
(`[access] white_list`) and mutual TLS for the RPC plane (`[tls]`).
"""
from __future__ import annotations

import argparse
import asyncio
import logging

from ..ingest import IngestConfig
from ..serving.config import ServingConfig
from .common_args import (
    add_metrics_args,
    add_obs_args,
    apply_obs_args,
    metrics_kwargs,
)

NAME = "volume"
HELP = "start a volume server"


def add_args(p) -> None:
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument(
        "-port.grpc", dest="grpc_port", type=int, default=0,
        help="RPC port (default: port+10000)",
    )
    p.add_argument(
        "-dir", default=".", help="comma-separated data directories"
    )
    p.add_argument(
        "-max", dest="max_volume_counts", default="8",
        help="max volumes per dir (comma-separated to match -dir)",
    )
    p.add_argument(
        "-mserver", dest="masters", default="127.0.0.1:9333",
        help="comma-separated master servers (empty: no master)",
    )
    p.add_argument("-publicUrl", dest="public_url", default="")
    p.add_argument("-dataCenter", dest="data_center", default="")
    p.add_argument("-rack", default="")
    p.add_argument("-pulseSeconds", dest="pulse_seconds", type=int, default=5)
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
    p.add_argument(
        "-ec.scrub.intervalSeconds", dest="ec_scrub_interval_seconds",
        type=int, default=0,
        help="periodically verify EC parity of locally-complete volumes "
        "(device-resident when pinned; 0 = disabled)",
    )
    p.add_argument(
        "-ec.scrub.megakernel.disable", dest="ec_scrub_megakernel_disable",
        action="store_true",
        help="scrub resident EC volumes one device call per volume instead "
        "of one pass over the whole cache per cycle",
    )
    add_metrics_args(p)
    add_obs_args(p)
    serving_defaults = ServingConfig()
    p.add_argument(
        "-ec.serving.disable", dest="ec_serving_disable",
        action="store_true",
        help="serve every EC read on the native per-read path instead of "
        "the resident continuous-batching dispatcher",
    )
    p.add_argument(
        "-ec.serving.maxBatch", dest="ec_serving_max_batch", type=int,
        default=serving_defaults.max_batch,
        help="widest coalesced EC read batch (needles per device call)",
    )
    p.add_argument(
        "-ec.serving.maxWaitUs", dest="ec_serving_max_wait_us", type=int,
        default=serving_defaults.max_wait_us,
        help="admission window (µs) a hot dispatch lane holds open for a "
        "partial batch to fill; 0 disables",
    )
    p.add_argument(
        "-ec.serving.maxInflight", dest="ec_serving_max_inflight", type=int,
        default=serving_defaults.max_inflight,
        help="pipelined EC read batches in flight",
    )
    p.add_argument(
        "-ec.serving.maxQueue", dest="ec_serving_max_queue", type=int,
        default=serving_defaults.max_queue,
        help="queued EC reads beyond this fall back to the native path "
        "(backpressure)",
    )
    p.add_argument(
        "-ec.serving.layout", dest="ec_serving_layout",
        default=serving_defaults.layout, choices=["flat", "blockdiag"],
        help="resident reconstruct system: flat, or the g=4 "
        "block-diagonal system (both run csrc/fused_reconstruct.cu)",
    )
    p.add_argument(
        "-ec.serving.overlap.disable", dest="ec_serving_overlap_disable",
        action="store_true",
        help="one device pipeline slot instead of two",
    )
    p.add_argument(
        "-ec.serving.aot.disable", dest="ec_serving_aot_disable",
        action="store_true",
        help="accepted for the reference's command lines and ignored: the "
        "CUDA kernels take their shapes at run time, so nothing is "
        "compiled ahead of time and there is no cold shape to shed",
    )
    p.add_argument(
        "-ec.serving.mesh.disable", dest="ec_serving_mesh_disable",
        action="store_true",
        help="pin resident EC volumes whole onto one card instead of "
        "lane-sharding them across the local cards",
    )
    p.add_argument(
        "-ec.serving.mesh.devices", dest="ec_serving_mesh_devices",
        type=int, default=0,
        help="cards the serving mesh may span (0 = every local card, "
        "n = the first n)",
    )
    p.add_argument(
        "-ec.serving.mesh.minShardMB", dest="ec_serving_mesh_min_shard_mb",
        type=int, default=8,
        help="volumes with shard files below this pin whole onto the "
        "least-loaded card instead of lane-sharding",
    )
    p.add_argument(
        "-ec.mesh.coordinator", dest="ec_mesh_coordinator", default="",
        help="host:port of the torch.distributed rendezvous this server "
        "joins as one process of a pod mesh (required when "
        "-ec.mesh.processCount > 1; ignored at 1)",
    )
    p.add_argument(
        "-ec.mesh.processId", dest="ec_mesh_process_id", type=int,
        default=0,
        help="this process's rank in the pod mesh (0 <= processId < "
        "processCount; one process per host)",
    )
    p.add_argument(
        "-ec.mesh.processCount", dest="ec_mesh_process_count", type=int,
        default=1,
        help="processes in the pod mesh; 1 (the default) shards over "
        "this host's cards only and contacts no coordinator",
    )
    p.add_argument(
        "-ec.serving.zerocopy.disable", dest="ec_serving_zerocopy_disable",
        action="store_true",
        help="materialize needle payloads as bytes on the HTTP read path "
        "instead of writing memoryview windows of the read buffers",
    )
    p.add_argument(
        "-ec.qos.disable", dest="ec_qos_disable", action="store_true",
        help="disable QoS admission control (tier budgets, deadline "
        "shedding, breaker)",
    )
    p.add_argument(
        "-ec.qos.interactiveQueue", dest="ec_qos_interactive_queue",
        type=int, default=serving_defaults.qos_interactive_queue,
        help="max interactive-tier reads queued at once",
    )
    p.add_argument(
        "-ec.qos.bulkQueue", dest="ec_qos_bulk_queue", type=int,
        default=serving_defaults.qos_bulk_queue,
        help="max bulk-tier reads queued at once (X-Seaweed-QoS: bulk)",
    )
    p.add_argument(
        "-ec.qos.interactiveDeadlineMs",
        dest="ec_qos_interactive_deadline_ms", type=int,
        default=serving_defaults.qos_interactive_deadline_ms,
        help="shed an interactive read to the host path at admission when "
        "its estimated queue wait already exceeds this (0 disables)",
    )
    p.add_argument(
        "-ec.qos.bulkDeadlineMs", dest="ec_qos_bulk_deadline_ms", type=int,
        default=serving_defaults.qos_bulk_deadline_ms,
        help="deadline budget for bulk-tier reads (0 disables)",
    )
    p.add_argument(
        "-ec.qos.tripAfter", dest="ec_qos_trip_after", type=int,
        default=serving_defaults.qos_trip_after,
        help="consecutive sheds that trip a tier's breaker",
    )
    p.add_argument(
        "-ec.qos.recoverSeconds", dest="ec_qos_recover_seconds", type=float,
        default=serving_defaults.qos_recover_seconds,
        help="breaker cooldown before a half-open probe may re-admit",
    )
    p.add_argument(
        "-ec.qos.stallBudgetSeconds", dest="ec_qos_stall_budget_seconds",
        type=float, default=serving_defaults.stall_budget_seconds,
        help="base seconds a read response may stall on a slow client "
        "before it is disconnected (plus bytes/minRate; 0 disables)",
    )
    p.add_argument(
        "-ec.qos.stallMinRateKBps", dest="ec_qos_stall_min_rate_kbps",
        type=int, default=serving_defaults.stall_min_rate_kbps,
        help="minimum drain rate a client must sustain for large read "
        "responses",
    )
    # heat-tiered residency ladder (serving/tiering.py): HBM -> host RAM
    # -> disk, driven by decayed per-volume read and write heat
    p.add_argument(
        "-ec.tier.disable", dest="ec_tier_disable", action="store_true",
        help="disable the automatic residency ladder (residency falls "
        "back to manual pin/unpin + blind LRU budget eviction)",
    )
    p.add_argument(
        "-ec.tier.intervalSeconds", dest="ec_tier_interval_seconds",
        type=float, default=serving_defaults.tier_interval_seconds,
        help="tier-loop rebalance cadence; 0 disables the loop",
    )
    p.add_argument(
        "-ec.tier.hostCacheMB", dest="ec_tier_host_cache_mb", type=int,
        default=serving_defaults.tier_host_cache_mb,
        help="pinned host-RAM warm-tier budget: demoted volumes' shard "
        "bytes stage here and serve reconstructs without disk reads "
        "(0 disables the host tier)",
    )
    p.add_argument(
        "-ec.tier.halfLifeSeconds", dest="ec_tier_half_life_seconds",
        type=float, default=serving_defaults.tier_half_life_seconds,
        help="decay half-life of the per-volume read-heat counters",
    )
    p.add_argument(
        "-ec.tier.promoteRatio", dest="ec_tier_promote_ratio", type=float,
        default=serving_defaults.tier_promote_ratio,
        help="hysteresis margin: a promotion swap needs the candidate "
        "to out-heat the coldest eligible resident by this factor",
    )
    p.add_argument(
        "-ec.tier.minResidencySeconds",
        dest="ec_tier_min_residency_seconds", type=float,
        default=serving_defaults.tier_min_residency_seconds,
        help="a promoted volume is not swap-eligible before this age "
        "(over-budget pressure demotions ignore it)",
    )
    p.add_argument(
        "-ec.tier.bulkWeight", dest="ec_tier_bulk_weight", type=float,
        default=serving_defaults.tier_bulk_weight,
        help="QoS weight of bulk-tier reads in the heat signal, so "
        "background scans cannot evict the interactive hot set",
    )
    add_ingest_args(p)
    p.add_argument(
        "-ec.rpc.deadlineMs", dest="ec_rpc_deadline_ms", type=int,
        default=30000,
        help="default deadline budget stamped on requests arriving "
        "without an X-Seaweed-Deadline-Ms header; every cross-node hop "
        "subtracts from it (0 = no default stamp)",
    )
    p.add_argument(
        "-ec.rpc.hedgeQuantile", dest="ec_rpc_hedge_quantile", type=float,
        default=0.95,
        help="per-peer latency EWMA quantile a survivor-shard fetch must "
        "exceed before a hedge is armed to a spare parity holder",
    )
    p.add_argument(
        "-ec.rpc.hedgeBudgetPct", dest="ec_rpc_hedge_budget_pct",
        type=float, default=10.0,
        help="hedge token budget as a percentage of primary fetches — "
        "hedging can add at most this much cluster load (0 disables "
        "hedging)",
    )
    p.add_argument(
        "-ec.rpc.retryBudgetPct", dest="ec_rpc_retry_budget_pct",
        type=float, default=10.0,
        help="per-peer retry token budget as a percentage of first "
        "attempts — a sick peer degrades into fast-fail instead of a "
        "retry storm (0 disables retries)",
    )
    # the staged bulk EC pipelines (storage/ec/bulk.py), which the
    # VolumeEcShardsGenerate and VolumeEcShardsRebuild rpcs run
    p.add_argument(
        "-ec.bulk.overlap.disable", dest="ec_bulk_overlap_disable",
        action="store_true",
        help="run the bulk EC pipelines (encode/rebuild/verify) serially "
        "on one thread instead of overlapping the read/device/write legs",
    )
    p.add_argument(
        "-ec.bulk.prefetch", dest="ec_bulk_prefetch", type=int, default=3,
        help="stripe batches the bulk pipelines' reader leg may run "
        "ahead of the codec (bounded queue depth)",
    )
    p.add_argument(
        "-ec.bulk.strideMB", dest="ec_bulk_stride_mb", type=int, default=0,
        help="per-shard bytes per bulk codec call (0 = built-in 4MB "
        "default)",
    )
    p.add_argument(
        "-readMode", dest="read_mode", default="proxy",
        choices=["local", "proxy", "redirect"],
        help="a GET of a volume held elsewhere: proxy to a holder, or "
        "redirect at it",
    )
    p.add_argument(
        "-images.fix.orientation", dest="fix_jpg_orientation",
        action="store_true",
        help="rotate JPEG pixels per EXIF orientation at upload",
    )
    p.add_argument(
        "-offset.bytes", dest="offset_bytes", type=int, default=4,
        choices=[4, 5],
        help="needle-map offset width: 5 raises the volume cap from 32GB "
        "to 8TB (the reference's 5BytesOffset build tag; must match the "
        "whole deployment: .idx/.ecx files are not readable across modes)",
    )
    p.add_argument(
        "-tier.dir", dest="tier_dir", default="",
        help="directory backing the 'local.default' tier storage backend",
    )
    p.add_argument(
        "-index", dest="index_kind", default="memory",
        choices=["memory", "sqlite", "native"],
        help="needle map kind: memory (CompactMap), sqlite (persistent, "
        "O(1) RAM per volume), or native (the embedded C++ KV, "
        "csrc/host/kvstore.cpp: the reference's leveldb index role)",
    )
    p.add_argument(
        "-fileSizeLimitMB", dest="client_max_size_mb", type=int, default=256,
        help="reject uploads larger than this",
    )
    p.add_argument(
        "-concurrentUploadLimitMB", dest="concurrent_upload_limit_mb",
        type=int, default=0, help="total in-flight upload bytes (0 = off)",
    )
    p.add_argument(
        "-concurrentDownloadLimitMB", dest="concurrent_download_limit_mb",
        type=int, default=0, help="total in-flight download bytes (0 = off)",
    )


def add_ingest_args(p) -> None:
    """The -ec.ingest.* flags of the streaming ingest plane (IngestConfig
    is the single source of the defaults)."""
    d = IngestConfig()
    p.add_argument(
        "-ec.ingest.disable", dest="ec_ingest_disable",
        action="store_true",
        help="disable the streaming write-path EC encode: every volume "
        "reverts to the after-the-fact bulk encode at ec.encode time",
    )
    p.add_argument(
        "-ec.ingest.backend", dest="ec_ingest_backend", default=d.backend,
        choices=["cuda", "torch", "numpy", "native"],
        help="codec backend for the streaming row encode: cuda (K1 on the "
        "card), torch (its plain version on the CPU), numpy or native "
        "(host codecs); default: -ec.backend",
    )
    p.add_argument(
        "-ec.ingest.arenaSlots", dest="ec_ingest_arena_slots", type=int,
        default=d.arena_slots,
        help="staged 10MB row buffers per actively-written volume; the "
        "pool is the ingest backpressure — a writer that cannot stage "
        "blocks until the encode leg drains",
    )
    p.add_argument(
        "-ec.ingest.backpressureMs", dest="ec_ingest_backpressure_ms",
        type=int, default=d.backpressure_ms,
        help="how long a writer may block on a free staging row before "
        "the volume falls back to the offline encode at seal",
    )
    p.add_argument(
        "-ec.ingest.fsync", dest="ec_ingest_fsync", action="store_true",
        help="group-commit durability: writers ack from a batched fsync "
        "instead of the page cache",
    )
    p.add_argument(
        "-ec.ingest.fsyncMaxBatch", dest="ec_ingest_fsync_max_batch",
        type=int, default=d.fsync_max_batch,
        help="writers per group-commit fsync batch before it fires",
    )
    p.add_argument(
        "-ec.ingest.fsyncMaxDelayMs", dest="ec_ingest_fsync_max_delay_ms",
        type=float, default=d.fsync_max_delay_ms,
        help="longest a group-commit writer lingers for batch-mates "
        "before the fsync fires anyway",
    )
    p.add_argument(
        "-ec.ingest.minRateKBps", dest="ec_ingest_min_rate_kbps",
        type=int, default=d.min_rate_kbps,
        help="deadline doom check: refuse an upload at the door when its "
        "size over this floor rate exceeds the request's remaining "
        "X-Seaweed-Deadline-Ms budget (0 disables)",
    )
    p.add_argument(
        "-ec.ingest.interactiveQueue", dest="ec_ingest_interactive_queue",
        type=int, default=d.interactive_queue,
        help="max interactive-tier writes queued at admission "
        "(X-Seaweed-QoS header absent or 'interactive')",
    )
    p.add_argument(
        "-ec.ingest.bulkQueue", dest="ec_ingest_bulk_queue", type=int,
        default=d.bulk_queue,
        help="max bulk-tier writes queued at admission (multipart parts, "
        "batch loaders) — a narrow slice so loader floods can't crowd "
        "out interactive PUTs",
    )
    p.add_argument(
        "-ec.ingest.deadlineMs", dest="ec_ingest_deadline_ms", type=int,
        default=d.deadline_ms,
        help="per-tier write admission deadline when the client sent no "
        "deadline header of its own (0 disables)",
    )


def ingest_config(args: argparse.Namespace) -> IngestConfig:
    """The -ec.ingest.* flags as a validated config."""
    return IngestConfig(
        enabled=not args.ec_ingest_disable,
        backend=args.ec_ingest_backend,
        arena_slots=args.ec_ingest_arena_slots,
        backpressure_ms=args.ec_ingest_backpressure_ms,
        fsync=args.ec_ingest_fsync,
        fsync_max_batch=args.ec_ingest_fsync_max_batch,
        fsync_max_delay_ms=args.ec_ingest_fsync_max_delay_ms,
        min_rate_kbps=args.ec_ingest_min_rate_kbps,
        interactive_queue=args.ec_ingest_interactive_queue,
        bulk_queue=args.ec_ingest_bulk_queue,
        deadline_ms=args.ec_ingest_deadline_ms,
    ).validated()


def serving_config(args: argparse.Namespace) -> ServingConfig:
    """The -ec.serving.*, -ec.qos.* and -ec.tier.* flags as a validated
    config."""
    return ServingConfig(
        enabled=not args.ec_serving_disable,
        max_batch=args.ec_serving_max_batch,
        max_wait_us=args.ec_serving_max_wait_us,
        max_inflight=args.ec_serving_max_inflight,
        max_queue=args.ec_serving_max_queue,
        layout=args.ec_serving_layout,
        overlap=not args.ec_serving_overlap_disable,
        mesh=not args.ec_serving_mesh_disable,
        mesh_devices=args.ec_serving_mesh_devices,
        mesh_min_shard_mb=args.ec_serving_mesh_min_shard_mb,
        mesh_coordinator=args.ec_mesh_coordinator,
        mesh_process_id=args.ec_mesh_process_id,
        mesh_process_count=args.ec_mesh_process_count,
        zero_copy=not args.ec_serving_zerocopy_disable,
        qos=not args.ec_qos_disable,
        qos_interactive_queue=args.ec_qos_interactive_queue,
        qos_bulk_queue=args.ec_qos_bulk_queue,
        qos_interactive_deadline_ms=args.ec_qos_interactive_deadline_ms,
        qos_bulk_deadline_ms=args.ec_qos_bulk_deadline_ms,
        qos_trip_after=args.ec_qos_trip_after,
        qos_recover_seconds=args.ec_qos_recover_seconds,
        stall_budget_seconds=args.ec_qos_stall_budget_seconds,
        stall_min_rate_kbps=args.ec_qos_stall_min_rate_kbps,
        tier=not args.ec_tier_disable,
        tier_interval_seconds=args.ec_tier_interval_seconds,
        tier_host_cache_mb=args.ec_tier_host_cache_mb,
        tier_half_life_seconds=args.ec_tier_half_life_seconds,
        tier_promote_ratio=args.ec_tier_promote_ratio,
        tier_min_residency_seconds=args.ec_tier_min_residency_seconds,
        tier_bulk_weight=args.ec_tier_bulk_weight,
    ).validated()


def build_server(args: argparse.Namespace):
    """A VolumeServer from the parsed flags (not started).  Raises, with
    -ec.backend cuda, without a card."""
    from ..parallel import mesh as mesh_mod
    from ..server.volume import VolumeServer
    from ..storage.ec import bulk as ec_bulk
    from ..security import guard as guard_mod
    from ..utils import config as config_util
    from ..utils import faultpolicy

    apply_obs_args(args)
    # the bulk pipelines are store-level maintenance verbs: their config
    # is process-global, like the obs flags
    ec_bulk.configure(
        ec_bulk.BulkConfig(
            overlap=not args.ec_bulk_overlap_disable,
            prefetch=args.ec_bulk_prefetch,
            stride=args.ec_bulk_stride_mb << 20,
        )
    )
    ec_serving = serving_config(args)  # a bad -ec.mesh.* config dies here
    if ec_serving.multiprocess:
        # join the pod's process group before the cache builds its mesh
        mesh_mod.initialize_distributed(
            ec_serving.mesh_coordinator,
            ec_serving.mesh_process_id,
            ec_serving.mesh_process_count,
            backend=mesh_mod.backend_for(args.ec_backend),
        )
    faultpolicy.configure(
        faultpolicy.FaultPolicyConfig(
            deadline_ms=args.ec_rpc_deadline_ms,
            hedge_quantile=args.ec_rpc_hedge_quantile,
            hedge_budget_pct=args.ec_rpc_hedge_budget_pct,
            retry_budget_pct=args.ec_rpc_retry_budget_pct,
        )
    )
    if args.offset_bytes != 4:
        # process-wide, like the reference's build tag: before any store
        # opens an .idx
        from ..storage import types as storage_types

        storage_types.set_offset_size(args.offset_bytes)
    dirs = [d.strip() for d in args.dir.split(",") if d.strip()]
    counts = [int(c) for c in str(args.max_volume_counts).split(",")]
    if len(counts) == 1:
        counts = counts * len(dirs)
    return VolumeServer(
        masters=[m.strip() for m in args.masters.split(",") if m.strip()],
        directories=dirs,
        ip=args.ip,
        port=args.port,
        grpc_port=args.grpc_port,
        public_url=args.public_url,
        max_volume_counts=counts,
        data_center=args.data_center,
        rack=args.rack,
        pulse_seconds=args.pulse_seconds,
        ec_backend=args.ec_backend,
        client_max_size_mb=args.client_max_size_mb,
        concurrent_upload_limit_mb=args.concurrent_upload_limit_mb,
        concurrent_download_limit_mb=args.concurrent_download_limit_mb,
        ec_device_cache_mb=args.ec_device_cache_mb,
        ec_serving=ec_serving,
        ec_scrub_interval_seconds=args.ec_scrub_interval_seconds,
        ec_scrub_megakernel=not args.ec_scrub_megakernel_disable,
        ec_ingest=ingest_config(args),
        read_mode=args.read_mode,
        jwt_signing_key=config_util.jwt_signing_key(),
        white_list=guard_mod.from_security_toml(),
        fix_jpg_orientation=args.fix_jpg_orientation,
        tier_backends={
            # master.toml [storage.backend.*] and the -tier.dir shorthand
            **config_util.storage_backends(),
            **({"local.default": {"type": "local", "dir": args.tier_dir}}
               if args.tier_dir else {}),
        } or None,
        index_kind=args.index_kind,
        **metrics_kwargs(args),
    )


async def run(args) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    vs = build_server(args)
    await vs.start()
    try:
        await asyncio.Event().wait()
    finally:
        await vs.stop()
