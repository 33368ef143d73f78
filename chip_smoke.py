#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seaweedfs_tpu_torch) once on an NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--volume-gib G]

Builds the port's kernels (csrc/gf2_matmul.cu, gf2_matmul_small.cu,
fused_reconstruct.cu and scrub.cu, one nvcc for each source, all started
together, linked into one library for sm_90a) and host library
(csrc/host/*.cpp, g++) from this checkout, holds each kernel byte-equal to
its plain PyTorch version on the card at the shapes the main path gives it,
then runs the EC main path through the port's entry points on a real
volume:

  1. device      `python3 -m seaweedfs_tpu_torch version`; CUDA device,
                 nvcc and driver versions, both builds; the
                 gf2_matmul kernels' registers and shared memory (nvcc
                 -Xptxas -v) and their tensor-core instructions (cuobjdump
                 -sass: BMMA); the fused_reconstruct kernels' registers;
                 the scrub kernels' registers and shared memory, the
                 tensor-core form's BMMA and its blocks an SM
  2. kernel      gf2_matmul and gf2_matmul_small (the CUDA-core K1,
                 which takes the small one-row calls) vs _apply_torch (+
                 numpy oracle sample), timed in turns (small, tensor-core,
                 tensor-core, small) at the main path's shapes: encode,
                 rebuild, the host degraded read's 4 KiB, 64 KiB, 256 KiB
                 and 1 MiB one-row reconstructs; utils/devtime's kernel
                 time of the flat encode beside its CUDA-event median
  2b. resident_kernel
                 fused_reconstruct and fused_reconstruct_blockdiag vs their
                 plain versions (+ numpy oracle sample) on 10 x 256 MiB
                 synthetic survivors, times against the bound: uniform
                 calls, and bursts of 64 needle reads served as one ragged
                 launch and as one uniform call per size bucket, in turns
  3. volume      write a volume of mixed 4 KB-1 MB needles from --seed
  4. encode      write_ec_files + write_sorted_file_from_idx under
                 torch.profiler (the card's busy share), verify_ec_files
  5. degraded    .ec00 and .ec11 down: EcVolume.read_needle of every needle
                 with bytes on shard 0, plus others (the host path)
  5b. resident_read
                 the same reads with the 12 survivors pinned in a
                 DeviceShardCache, in bursts (read_needles_batch) and
                 singly (read_needle), block-diagonal and flat; launches
                 and D2H bytes per burst; no read may fall back to the host
                 path
  5c. serve      the volume server started as an operator starts it
                 (python3 -m seaweedfs_tpu_torch volume -ec.backend cuda
                 -ec.deviceCacheMB ...) over the sidecars and 12 survivors,
                 a fresh server a turn (flat, block-diagonal): HTTP GETs of
                 a seeded 2,000 of every needle with bytes on shard 0
                 plus 400 others one at a time, then 64 concurrent
                 keep-alive clients (12,000 reads or 8 s; in the
                 profiled turn until its capture returns); every
                 body byte-verified, no native route once resident; batch
                 widths, launches and D2H bytes per batch from /metrics;
                 the trace plane: per-stage means and the critical-path
                 composition of the GET route from /metrics, the slowest
                 traced GET's /debug/critpath and /debug/tail, a 5 s
                 /debug/profile capture (SWFS_DEBUG=1) in the block-
                 diagonal turn (the card's kernel-busy share), and two
                 short flat turns, with -obs.disable (tracing's cost,
                 4,000 reads) and with -obs.tail.disable (the tail
                 store's share of it, 2,000 reads: the GET route's
                 critical path must not move)
  6. rebuild     shards 0, 5, 10, 13 removed: rebuild_ec_files +
                 rebuild_ecx_file, sha256 of every rebuilt shard
  6a. scrub      all 14 shards pinned through a port Store (15.75 GiB
                 padded): Store.scrub_ec in both layouts, clean ([0, 0, 0,
                 0], as verify_ec_files on the same files), corrupted on the
                 card ([1, 1, 5, 1], partials equal to the plain version's)
                 and restored; the scrub kernel's time against its bound,
                 in turns with its earlier CUDA-core form (tensor cores,
                 CUDA cores, CUDA cores, tensor cores), 16 D2H bytes a
                 256 MiB segment a call, the file scrub and the CPU codec on the same host;
                 a pass over the cache with in-memory volumes of two spans
                 beside it
  6b. scrub_serve
                 the volume server with -ec.scrub.intervalSeconds 2 over
                 vid 1 (14 shards), vid 2 (hard links minus shards 0 and
                 11, served) and a small corrupt vid 3 (29.5 GiB of HBM):
                 the corrupt gauge, one pass launch per span class a cycle,
                 64 clients reading vid 2 meanwhile, and the device ledger's
                 split from /debug/device/attribution
  7. decode      original .dat deleted: write_dat_file, sha256 of the .dat
  8. ingest      an in-process volume server (-ec.backend cuda, built
                 from the volume command's flags) takes 32 writers in 4
                 processes POSTing seeded 4 KB-1 MB needles until its .dat
                 holds 256 MiB, each completed 10 MiB stripe row encoded on
                 the card (K1) from a pinned arena slot as it fills; three
                 turns on the same needles: -ec.ingest.fsync, then
                 ec_generate seals from the stream (every row on the card,
                 one streamed seal, the 14 shards' sha256 equal to the
                 offline encodes of the same .dat on the card and on the
                 native CPU codec, hashed in memory); the plane with the
                 server's defaults (no fsync); -ec.ingest.disable.  Write
                 rate, ack p50/p99, fsyncs, arena waits, the ledger's
                 ingest busy s; K1 at the row's shape against its bound
  8b. tiering    the residency ladder: an in-process server whose cache
                 holds one volume's survivors and not two, vids 2 and 3
                 (links of vid 1's survivors) mounted in turn; 64 clients
                 read vid 2 until the ladder swaps it into HBM, then vid 3
                 until it swaps back; rounds of reads/s, p50/p99, routes,
                 K2-K5 launches and the tier series; the moves' latency and
                 the pins' GB/s; 0 native routes on a promoted volume
  9. cluster     the cluster as users run it: `python3 -m
                 seaweedfs_tpu_torch master`, volume servers started with
                 `volume -mserver ... -ec.backend cuda`, and the shell as
                 `python3 -m seaweedfs_tpu_torch shell -c ...`; every wait
                 is on the state the master reports (VolumeList,
                 LookupEcVolume, /cluster/health.json) or a server's
                 /status.  The master's repair plane runs every second.
                 9a, the main 11 GiB volume at full width by hard links (no
                 byte written), with `volume.repair.pause` (its status
                 -json read back): server A (a cache for 14 shards) mounts
                 all 14 over the RPC plane and pins them; `cluster.health
                 -json` and `volume.device.status` show A's device block
                 (the used bytes of A's /metrics, 14 resident shards of vid
                 1, the breaker closed); `ec.scrub` runs B5
                 there (0 mismatches); shard 0 moves to server B (no
                 cache); GETs on A of 600 of the needles with bytes on
                 shard 0 and 400 others (K2-K5 on the card, 0 remote
                 fetches); GETs on B of as many needles wholly on shards
                 1-9 (deep in the large-block row, in the small-block rows,
                 across block boundaries), over VolumeEcShardRead from A,
                 in sequence and with 64 clients; shard 5 unmounted on A,
                 GETs on B of 400 needles with bytes on shard 5 (shard 0
                 local and 9
                 remote survivors through the hedged gather, K1's host
                 degraded read); p50/p99, reads/s, remote fetches and
                 bytes a read, hedge and retry counters; the master's
                 /debug/critpath of the ten slowest gathers (B's GET
                 joined with A's VolumeEcShardRead legs) and their
                 segment shares.  The incident plane: the master runs
                 with a read_p99 SLO on the batch_dispatch digests (its
                 target the highest digest edge that 5c's first flat
                 turn's one-client pass stayed under (0.5%) and at
                 least 2% of its 64-client pass passed; steps 4-6 must
                 leave it quiet), 2 s and 4 s burn windows,
                 -obs.incident.dir with a 2 s profile, and
                 -metrics.address at a pushgateway sink of this script
                 (A and B push too, every process runs with
                 SWFS_DEBUG=1); then 64 clients on A (K2+K3) and 64 on B
                 (K1) at once until the SLO fires, its one bundle lands
                 (the health and slo blocks, A's and B's timeline
                 samples, both nodes without error, critical paths, and a
                 CUPTI capture naming a port kernel with device time) and
                 `cluster.slo -json; cluster.incident.dump -json` has run
                 (budget below 1; a second, forced bundle); the merged
                 batch_dispatch and queue_wait p50/p99 within a bucket of
                 the servers' /metrics; the pushes; /debug/stacks.  A killed, the
                 plane resumed until it flags vid 1 (shard 0 left on B)
                 unrecoverable with nothing queued, paused, B killed.
                 9b, the verbs that write, on a 192 MiB volume: three
                 servers; /vol/grow of collection ec9; 32 writers assign
                 and POST the 4 KB-1 MB mix (the holder's ingest plane
                 streams its stripe rows on the card); the vacuum: 35% of
                 the needles deleted over HTTP, `volume.vacuum
                 -garbageThreshold 0.3 -volumeId N` (the master's Check,
                 Compact, Commit on the holder): revision 1, the .dat
                 shrunk by exactly the deleted records, the pipeline
                 invalidated by the vacuum, live needles byte-equal,
                 deleted ones 404, and a pass under
                 `volume.vacuum.disable` a no-op; the compacted .dat
                 hard-linked as the oracle; `lock; ec.encode` (the offline
                 seal: K1 on the holder, spread), every shard sha256-equal
                 to the native codec's encode hashed in memory; GETs; the server with the fewest shards killed;
                 GETs (remote survivors, K1); `ec.rebuild -force`; then
                 `volume.repair.resume`, two shards unmounted and deleted
                 on one survivor, and the master's repair plane rebuilds
                 them with no shell verb (the wall from the loss to 14
                 shards, the master's time to healthy, the rebuilder's K1
                 launches, every shard equal to the native codec's),
                 `volume.repair.pause`; `ec.balance -force` (shards still
                 equal), `ec.decode` (the
                 .dat equal to the oracle); each verb's wall.  Before the
                 verbs, replicated writes: /vol/grow of a `001` volume
                 (collection ec9r, two copies), 32 writers assign and POST
                 64 MiB (each write fanned out to the other copy); every
                 fid read with a sha256 check on both holders, on the third
                 server (proxied) and on a fourth started with `-readMode
                 redirect` (each 301 followed).
                 9c, master HA: three `master -peers M1,M2,M3 -mdir ...`, a
                 `master.follower -masters M1,M2,M3` and three volume
                 servers (`-mserver M1,M2,M3 -ec.backend cuda`, no cache),
                 started together; the leader as `cluster.raft.ps` names
                 it; a 64 MiB volume of collection ec9c grown and written
                 through the leader's assign (a follower's /dir/assign
                 answers 307 to the leader), `ec.encode` (K1, shards equal
                 to the native codec's); the leader SIGKILLed: seconds to
                 one new leader, to the servers and 14 shards listed at
                 it, to the follower naming it; its repair totals then
                 (none queued); fid keys and vids past the kill; every
                 needle read back through the new leader's lookup (32
                 clients); two shards lost on a holder and healed by the
                 new leader's repair plane (K1 on the rebuilder, shards
                 equal to the native codec's); the killed master back on
                 its -mdir as a follower, caught up.
                 9d, the all-in-one server: `python3 -m
                 seaweedfs_tpu_torch server -ec.backend cuda
                 -ec.deviceCacheMB ...` as one process S (its master and
                 volume server); a 32 MiB volume of collection ec9d grown
                 and written by 32 writers through its assign; the
                 `benchmark` command as a process (-c 16 -n 2048 -size
                 4096, collection ec9dbench, 0 failures); G and H started
                 as `volume -mserver <S>`; `cluster.check` (3/3
                 reachable), `collection.list`, `volume.list`; `ec.encode`
                 (K1 on S, shards spread over S, G and H, S's pinned
                 bytes); `volume.server.evacuate -node S -force` (0
                 skipped; every shard and bench volume listed on G or H,
                 S's cache empty); every needle read back through the
                 master's lookup (32 clients), every shard equal to the
                 native codec's; `volume.server.leave` and S gone from
                 the topology
                 9e, the filer over an EC-encoded volume: a master, two
                 `volume ... -ec.deviceCacheMB 1024` servers and `filer
                 -collection ec9e -maxMB 4 -store native -db <dir>` as
                 processes; one volume of collection ec9e grown; about 37
                 MiB of files written through the filer by 16 clients
                 under eight directories (log-uniform 4 KB-1 MB, one 12
                 MiB file of three chunks, one text file stored
                 compressed); `fs.ls` / `fs.du` (counts and bytes) and
                 `volume.fsck` (0 orphans, 0 broken references) through
                 the shell; `ec.encode` (K1 on the holder, the shards
                 spread over both servers); `volume.repair.pause`, the two
                 data shards holding the most file bytes deleted on their
                 holders; the filer restarted on its -db (the same
                 listing); Range GETs across both chunk boundaries of the
                 12 MiB file, then every file through the filer (32
                 clients, sha256 equal), the servers' degraded reads and
                 kernel launches above 0 and the filer's chunk-cache hits
                 0; every remaining shard equal to the native codec's
  10. mesh       the mesh on one card (two lanes of cuda:0 built with
                 make_mesh(devices=...); no multi-GPU figure): vid 1's 12
                 survivors pinned lane-sharded beside the one-device cache;
                 every needle with bytes on shard 0 plus 400, shuffled,
                 in bursts of 64, both layouts, through each (bodies
                 equal; one ragged launch a lane a burst); one lane's
                 launch timed against its plain version and bound.
                 distributed_apply_matrix and distributed_encode_blockdiag
                 on [10, 100 MiB] of vid 1: two gloo ranks sharing the
                 card, then NCCL at world size 1 (processes of this
                 script), each rank's K1 and all_gather timed, equal to
                 the one-card K1 and the native codec.
                 distributed_degraded_read of 512 of those needles'
                 shard-0 intervals, equal to the one-device resident read
                 and the shard file

Every phase is fatal.  Prints one line per phase and one at each phase's
end (its wall, and this process's bytes written so far: /proc/self/io
wchar), a {"phase_walls": [...]} line (also on a failure, before the
failing phase's name), a {"kernels": [...]} line, the nvidia-smi
name/power-limit line, and as the last line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when no
CUDA device is present or the port is not beside this script.  The volume
lives in chip_smoke_work/ beside this script and is removed at the end.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import hashlib
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet; dense int8, HBM3) for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
# the size users run: the -volumeSizeLimitMB default (30 GiB)
FULL_VOLUME_GIB = 30
MIN_NEEDLE, MAX_NEEDLE = 4 * 1024, 1024 * 1024
# needles read in phase 5 besides every one with bytes on shard 0
EXTRA_READS = 1000
# (N requests, fetch bytes, wanted rows) of the resident kernels in phase
# 2b: one 4 KB read, bursts of 64 and 256 small reads, bursts of MB reads
RESIDENT_SHAPES = [(1, 6144, 1), (64, 6144, 2), (256, 2048, 2),
                   (16, 3 << 19, 2), (8, 2 << 20, 4)]
# the shape the kernels line reports for them: a burst of 64 small reads
RESIDENT_REPORT = [64, 6144, 2]
# each of phase 2b's 10 synthetic survivors, 2.5 GiB in all (L2: 50 MB)
SURVIVOR_BYTES = 256 << 20
# phase 5b: the 12 survivors of the 11 GiB volume pad to 13.5 GiB
RESIDENT_BUDGET = 16 << 30
BURST = 64
# further sampled bursts of other widths: (width, bursts)
BURST_SAMPLES = ((1, 64), (8, 32), (256, 8))
SINGLE_READS = 200
# phase 2b: bursts timed per layout, and the device spin (cycles) that
# hides a burst's host enqueue before its start event
BURST_TIMED = 12
BURST_SPIN = 4_000_000
NO_LIBRARY_CALL = "no single PyTorch call gathers, reconstructs and selects"
# bursts of BURST re-read under torch.profiler for the busy share
TRACED_BURSTS = 32

SMI = "unknown"
# the degraded read's needle sizes are log-uniform over 4 KB-1 MB: the
# median is 64 KiB
NEEDLE_MEDIAN = 1 << 16
MAX_TILE = 2 << 20  # a DeviceShardCache pads each survivor by this


START = time.monotonic()


def log(phase: str, **fields) -> None:
    """One line per phase, with the seconds since the script started;
    every time or rate carries the card's nvidia-smi name and power
    limit."""
    print(json.dumps({"phase": phase, "gpu": SMI,
                      "run_s": time.monotonic() - START, **fields}), flush=True)


def _wchar() -> int | None:
    """Bytes this process has written so far (/proc/self/io wchar; the
    servers and workers it starts count in their own), or None where the
    kernel does not say."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def sha256_file(path: str, chunk: int = 64 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


# --------------------------------------------------------------- phase 1


def phase_device(torch) -> dict:
    global SMI
    SMI = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from seaweedfs_tpu_torch.ops import _build

    # both builds at once: one compiler process per source set
    errors: list[BaseException] = []

    def build(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(fn,))
               for fn in (_build.kernels, _build.host)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    k1 = _k1_build_facts(_build)
    version = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "version"], cwd=HERE,
        capture_output=True, text=True, check=True, timeout=120,
    ).stdout.strip()
    if not version.startswith("seaweedfs-tpu-torch "):
        raise AssertionError(f"version printed {version!r}")
    info = {
        "version": version,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        # kernel parameters above 4 KB (the fused reconstruct's work list)
        # need CUDA 12.1 and a driver that supports it
        "nvcc": subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                               text=True, check=True).stdout.strip().splitlines()[-1],
        "driver": subprocess.run(
            ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
        "build_s": {k: round(v, 3) for k, v in _build.build_seconds.items()},
        "build_wall_s": round(time.perf_counter() - t0, 3),
    }
    log("device", **info, gf2_matmul_kernels=k1,
        fused_reconstruct_kernels=_fused_build_facts(_build),
        scrub_kernels=_scrub_build_facts(_build))
    return info


def _scrub_build_facts(_build) -> list:
    """Each scrub kernel instantiation from the build's -Xptxas -v log
    (registers, spills, static shared memory) and, for the tensor-core
    kernel (N-blocks of 4 parity rows: 1 or 2), its tensor-core
    instructions from cuobjdump -sass of the library and the blocks an SM
    holds at RS(10,4), flat and block-diagonal; the CUDA-core form (data
    and parity shards unrolled: 10 x 4, or 16 x 8 predicated) is timed
    beside it.  Fails if a tensor-core instantiation has no BMMA."""
    import re

    from seaweedfs_tpu_torch.ops import rs_resident as rr

    mma = re.compile(r"scrub_mma_kernelILi(\d)E")
    cores = re.compile(r"cuda_cores12scrub_kernelILi(\d+)ELi(\d+)E")

    def name(line):
        m = mma.search(line)
        if m:
            return f"tensor cores, {m.group(1)} N-block(s)"
        m = cores.search(line)
        return f"CUDA cores, {m.group(1)} x {m.group(2)}" if m else None

    facts: dict = {}
    cur = None
    for line in _build.build_logs.get("swfs_kernels", "").splitlines():
        if "Compiling entry function" in line:
            cur = name(line)
            if cur:
                facts[cur] = {}
        elif cur and "spill stores" in line:
            facts[cur]["spill_stores"] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif cur and "Used" in line and "registers" in line:
            facts[cur]["registers"] = int(line.split("Used")[1].split()[0])
            sm = re.search(r"(\d+) bytes smem", line)
            facts[cur]["static_smem"] = int(sm.group(1)) if sm else 0
            cur = None
    sass = subprocess.run(["cuobjdump", "-sass", _build.kernels()._name],
                          capture_output=True, text=True, check=True).stdout
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = name(line)
        elif cur and ("BMMA" in line or "IMMA" in line):
            op = line.split("*/")[1].split()[0] if "*/" in line else "MMA"
            ops = facts.setdefault(cur, {}).setdefault("tensor_ops", {})
            ops[op] = ops.get(op, 0) + 1
    tensor = {k: v for k, v in facts.items() if k.startswith("tensor")}
    if len(tensor) != 2 or any(not any(op.startswith("BMMA") for op in
                                       f.get("tensor_ops", {}))
                               for f in tensor.values()):
        raise AssertionError(f"a tensor-core scrub kernel has no BMMA in its "
                             f"SASS: {facts}")
    if not any(k.startswith("CUDA cores") for k in facts):
        raise AssertionError("the build log names no CUDA-core scrub kernel")
    lib = rr._scrub_lib()
    per_sm = {layout: lib.scrub_blocks_per_sm(10, 4, groups)
              for layout, groups in (("flat", 1), ("blockdiag", 4))}
    return [{"instance": k, **v} for k, v in sorted(facts.items())] + [
        {"blocks_per_sm_rs10_4": per_sm}]


def _fused_build_facts(_build) -> list:
    """Each fused_reconstruct_kernel instantiation (survivors unrolled: 10,
    or 16 predicated; work-list capacity) from the build's -Xptxas -v log:
    registers and spills."""
    import re

    facts, cur = [], None
    for line in _build.build_logs.get("swfs_kernels", "").splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"fused_reconstruct_kernelILi(\d+)ELi(\d+)E", line)
            cur = ({"k": int(m.group(1)), "capacity": int(m.group(2))}
                   if m else None)
        elif cur is not None and "spill stores" in line:
            cur["spill_stores"] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(line.split("Used")[1].split()[0])
            facts.append(cur)
            cur = None
    if not facts:
        raise AssertionError("the build log names no fused_reconstruct_kernel")
    return facts


def _k1_build_facts(_build) -> list:
    """Each gf2_matmul_kernel instantiation's registers, spills and shared
    memory from the build's -Xptxas -v log, and its tensor-core
    instructions from cuobjdump -sass of the library.  Fails if one has no
    BMMA or IMMA: the product must run on the tensor cores."""
    import re

    inst = re.compile(r"gf2_matmul_kernelILi(\d)ELb(\d)ELb(\d)E")

    def name(m):
        return (f"k_pad={16 * int(m.group(1))} "
                f"{'aligned' if m.group(2) == '1' else 'shifted'} "
                f"{'one-row' if m.group(3) == '1' else 'general'}")

    facts: dict = {}
    cur = None
    for line in _build.build_logs.get("swfs_kernels", "").splitlines():
        if "Compiling entry function" in line:
            m = inst.search(line)
            cur = name(m) if m else None
            if cur:
                facts[cur] = {}
        elif cur and "spill stores" in line:
            facts[cur]["spill_stores"] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif cur and "Used" in line and "registers" in line:
            facts[cur]["registers"] = int(line.split("Used")[1].split()[0])
            sm = re.search(r"(\d+) bytes smem", line)
            facts[cur]["static_smem"] = int(sm.group(1)) if sm else 0
            cur = None
    lib = _build.kernels()._name
    sass = subprocess.run(["cuobjdump", "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            m = inst.search(line)
            cur = name(m) if m else None
        elif cur and ("BMMA" in line or "IMMA" in line):
            op = line.split("*/")[1].split()[0] if "*/" in line else "MMA"
            facts.setdefault(cur, {}).setdefault("tensor_ops", {})
            facts[cur]["tensor_ops"][op] = facts[cur]["tensor_ops"].get(op, 0) + 1
    if not facts or any(not f.get("tensor_ops") for f in facts.values()):
        raise AssertionError(f"a gf2_matmul kernel has no tensor-core "
                             f"instruction in its SASS: {facts}")
    return [{"instance": k, **v} for k, v in sorted(facts.items())]


# --------------------------------------------------------------- phase 2


def _median_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """CUDA-event median of `fn`; a device-side spin before each start
    event keeps the host's launch time out of the window."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound(k: int, b: int, m_out: int, groups: int = 1) -> tuple[float, str]:
    """Least time for the function on these inputs: each input byte read
    once and each output byte written once over HBM, against the int8
    ops of the product the function needs, the m_out true output rows by
    the k true input columns in bits: 2*8m_out*8k*b.  Padding is not work,
    and neither are the zero blocks of a `groups`-block-diagonal system
    (each group's m_out/groups rows meet only its k/groups columns): of
    the prepared matrix only those 8m_out*8k/groups bytes count."""
    a_used = (8 * m_out) * (8 * k) // groups
    nbytes = k * b + m_out * b + a_used
    return _roofline(nbytes, 2 * a_used * b)


def _roofline(nbytes: int, ops: int) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes over the card's memory
    rate and the int8 operations over its peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel(torch, seed: int) -> dict:
    import numpy as np

    from seaweedfs_tpu_torch.ops import gf256, rs_cpu, rs_cuda
    from seaweedfs_tpu_torch.utils import devtime

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    parity = gf256.parity_matrix(10, 14)
    rebuild4, _ = gf256.reconstruction_matrix(
        10, 14, [i for i in range(14) if i not in (0, 5, 10, 13)], [0, 5, 10, 13]
    )
    recon1, _ = gf256.reconstruction_matrix(
        10, 14, [i for i in range(14) if i not in (0, 11)], [0]
    )
    mib = 1 << 20
    # (name, GF matrix, input rows, batch, rows the main path asks for,
    #  block-diagonal groups, time it?)
    shapes = [
        ("encode_flat", parity, 10, 4 * mib, 4, 1, True),
        ("encode_blockdiag_g4", rs_cuda.blockdiag_system(parity), 40, mib, 16,
         rs_cuda.BLOCKDIAG_GROUPS, True),
        ("reconstruct_1row", recon1, 10, mib, 1, 1, True),
        # the host degraded read: one lost shard, intervals of the 4 KB-1 MB
        # needle mix (its median, and an unaligned width), and 4 KiB
        ("reconstruct_1row_64k", recon1, 10, NEEDLE_MEDIAN, 1, 1, True),
        ("reconstruct_1row_64k_odd", recon1, 10, NEEDLE_MEDIAN + 13, 1, 1, True),
        ("reconstruct_1row_4k", recon1, 10, 4096, 1, 1, True),
        ("reconstruct_1row_256k", recon1, 10, 4 * NEEDLE_MEDIAN, 1, 1, True),
        ("rebuild_4row", rebuild4, 10, 4 * mib, 4, 1, True),
        ("encode_flat_ragged", parity, 10, 4 * mib + 37, 4, 1, True),
    ]
    for k in (1, 3, 7, 10, 13, 16, 40, 64):
        m = int(rng.integers(1, 15))
        mat = rng.integers(0, 256, (m, k), dtype=np.uint8)
        shapes.append((f"random_k{k}_m{m}", mat, k, 65536 + k, m, 1, k == 16))

    # timed inputs rotate through copies that together exceed the 50 MB
    # L2, so each launch finds its input cold, as the main path does
    l2_cold = 128 << 20
    results = {}
    # the least time this method reads for one launch: a kernel that
    # spins for 0 cycles
    floor_ms = _median_ms(torch, lambda: torch.cuda._sleep(0), 20)
    log("kernel", launch_floor_ms=floor_ms)
    for name, mat, k, b, m_out, groups, timed in shapes:
        a = rs_cuda.prepare_matrix(mat, dev)
        if m_out > a.shape[0] // 8:
            raise AssertionError(f"{name}: m_out {m_out} > m_pad")
        x = torch.randint(0, 256, (k, b), dtype=torch.uint8, device=dev,
                          generator=gen)
        paths0 = dict(rs_cuda.gf2_matmul.launches_by_path)
        got = rs_cuda.gf2_matmul(a, x, m_out)
        ref = rs_cuda._apply_torch(a, x, m_out)
        torch.cuda.synchronize()
        diff = got.to(torch.int16) - ref.to(torch.int16)
        mismatched = int((diff != 0).sum().item())
        max_err = int(diff.abs().max().item()) if diff.numel() else 0
        # a sample against the numpy table oracle (padded rows are zero)
        sample = min(b, 65536)
        full = np.zeros((a.shape[0] // 8, mat.shape[1]), dtype=np.uint8)
        full[: mat.shape[0]] = mat
        oracle = rs_cpu.apply_matrix_numpy(
            full[:m_out], x[:, :sample].cpu().numpy()
        )
        oracle_bad = int((got[:, :sample].cpu().numpy() != oracle).sum())
        row = {
            "a": list(a.shape), "k": k, "b": b, "m_out": m_out,
            "load_path": next(p for p, n in rs_cuda.gf2_matmul.launches_by_path.items()
                              if n != paths0[p]),
            "mismatched_bytes": mismatched, "max_abs_err": max_err,
            "oracle_sample_mismatched": oracle_bad,
        }
        # the main path sends the small one-row calls to gf2_matmul_small;
        # it takes every shape, and is held and timed on all of them
        row["routed_to"] = rs_cuda._kernel_for(x, m_out).__name__
        n0 = rs_cuda.gf2_matmul_small.launches
        sdiff = rs_cuda.gf2_matmul_small(a, x, m_out).to(torch.int16) - ref.to(torch.int16)
        row["small_mismatched_bytes"] = int((sdiff != 0).sum().item())
        row["small_max_abs_err"] = int(sdiff.abs().max().item()) if sdiff.numel() else 0
        if rs_cuda.gf2_matmul_small.launches != n0 + 1:
            raise AssertionError("gf2_matmul_small did not count its launch")
        if mismatched or oracle_bad or row["small_mismatched_bytes"]:
            log("kernel", shape=name, **row)
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        if timed:
            bound_ms, bound_by = _bound(k, b, m_out, groups)
            xs = itertools.cycle([x] + [
                torch.randint(0, 256, (k, b), dtype=torch.uint8, device=dev,
                              generator=gen)
                for _ in range(-(-l2_cold // x.numel()) - 1)])
            tc = lambda: rs_cuda.gf2_matmul(a, next(xs), m_out)  # noqa: E731
            sm = lambda: rs_cuda.gf2_matmul_small(a, next(xs), m_out)  # noqa: E731
            turns = [_median_ms(torch, f, 20) for f in (sm, tc, tc, sm)]
            row["ms_turns"] = turns[1:3]
            row["small_ms_turns"] = [turns[0], turns[3]]
            row["ms"] = statistics.mean(row["ms_turns"])
            if name == "encode_flat":
                # the kernels' own time from a torch.profiler capture of
                # the same calls: at most the event bracket, plus noise
                row["devtime_ms"] = devtime.device_avg_ms(tc, n=20, warmup=2)
                if not 0 < row["devtime_ms"] <= 1.25 * row["ms"]:
                    raise AssertionError(
                        f"{name}: devtime {row['devtime_ms']} ms against the "
                        f"CUDA-event median {row['ms']} ms")
            row["small_ms"] = statistics.mean(row["small_ms_turns"])
            row["plain_ms"] = _median_ms(
                torch, lambda: rs_cuda._apply_torch(a, next(xs), m_out), 5,
                warmup=1,
            )
            del xs
            row["bound_ms"] = bound_ms
            row["bound_by"] = bound_by
            row["library_ms"] = _int_mm_ms(torch, a, x)
            row["input_GBps"] = k * b / (row["ms"] * 1e-3) / 1e9
            row["share_of_bound"] = bound_ms / row["ms"]
        results[name] = row
        log("kernel", shape=name, **row)
        del x, got, ref, diff, sdiff

    # the wrapper refuses what the kernel does not take, before any launch
    before = rs_cuda.gf2_matmul.launches
    a = rs_cuda.prepare_matrix(parity, dev)
    for bad in (torch.zeros((10, 8), dtype=torch.int32, device=dev),
                torch.zeros((11, 8), dtype=torch.uint8, device=dev)[:10, ::2]):
        try:
            rs_cuda.gf2_matmul(a, bad, 4)
        except (TypeError, ValueError):
            continue
        raise AssertionError("gf2_matmul took an argument it must refuse")
    if rs_cuda.gf2_matmul.launches != before:
        raise AssertionError("a refused gf2_matmul call counted a launch")

    # CPU yardstick: the native GF(256) codec on the same encode batch
    xs = rng.integers(0, 256, (10, 4 * mib), dtype=np.uint8)
    rs_cpu.apply_matrix_native(parity, xs)
    t0 = time.perf_counter()
    for _ in range(3):
        rs_cpu.apply_matrix_native(parity, xs)
    native_s = (time.perf_counter() - t0) / 3
    log("kernel", shape="encode_flat", cpu_native_ms=native_s * 1e3,
        cpu_native_input_GBps=xs.nbytes / native_s / 1e9,
        host_cpus=os.cpu_count())
    return {"shapes": results, "launch_floor_ms": floor_ms}


def _fused_bound(k: int, fetches, rows: int,
                 groups: int = 1) -> tuple[float, str]:
    """Least time for one fused reconstruct call: each request's k survivor
    windows (its own fetch) and its meta word read once, the packed output
    written once, and of the prepared matrix only what the function needs,
    8 output bits by 8k input bits for each of the `rows` wanted rows in
    each of the `groups` diagonal blocks (pad rows and zero blocks are not
    read); against the int8 ops of the one wanted row per byte."""
    total = int(sum(fetches))
    nbytes = (k + 1) * total + 4 * len(fetches) + groups * rows * 8 * (8 * k)
    return _roofline(nbytes, 2 * 8 * (8 * k) * total)


def _event_ms(torch, fn, spin: int = 1_000_000) -> float:
    """CUDA events around `fn`'s device work; a device-side spin of `spin`
    cycles (about half a millisecond by default) before the start event
    keeps the host's enqueue time, the work list's checks included, out of
    the window."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _launch_ms(torch, launch, metas) -> float:
    """CUDA-event median of one kernel launch for each meta vector after
    the first two (warm-up).  Each vector asks for fresh random windows, so
    the survivors' bytes are cold in L2 as a serving call finds them."""
    times = [_event_ms(torch, lambda: launch(meta)) for meta in metas]
    return statistics.median(times[2:])


def phase_resident_kernels(torch, seed: int) -> dict:
    """Both fused reconstruct kernels against their plain versions (and a
    numpy-oracle sample) on synthetic resident survivors, at the shapes a
    degraded-read burst gives them, flat and block-diagonal: uniform calls
    (RESIDENT_SHAPES), and bursts of needle reads served both as one
    uniform call per size bucket and as one ragged call."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import gf256, rs_cpu, rs_cuda
    from seaweedfs_tpu_torch.ops import rs_resident as rr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 7)
    rng = np.random.default_rng(seed + 7)
    surv = tuple(
        torch.randint(0, 256, (SURVIVOR_BYTES,), dtype=torch.uint8,
                      device=dev, generator=gen)
        for _ in range(10)
    )
    g = rs_cuda.BLOCKDIAG_GROUPS
    results: dict = {"flat": [], "blockdiag": []}
    for layout in ("flat", "blockdiag"):
        for n, fetch, w in RESIDENT_SHAPES:
            wanted = [0, 11, 5, 13][:w]
            mat, _ = gf256.reconstruction_matrix(
                10, 14, [i for i in range(14) if i not in wanted], wanted
            )
            if layout == "flat":
                tile = rr._fused_tile_for(fetch)
                a = rs_cuda.prepare_matrix(mat, dev)
                fn, plain = rr.fused_reconstruct, rr._fused_reconstruct_torch
                kw = dict(tile=tile, fetch=fetch, k_true=10)
                fkw, pkw = dict(w_true=w), {}
                launch_g, launch_tile = 1, fetch
            else:
                fetch_b, tile = rr._blockdiag_fetch_tile(fetch, g)
                # the serving path's prepared system, proved block-diagonal
                a = rr._prepared_blockdiag(mat.tobytes(), *mat.shape, g, "cuda")
                fn, plain = (rr.fused_reconstruct_blockdiag,
                             rr._fused_reconstruct_blockdiag_torch)
                kw = dict(tile=tile, fetch=fetch_b, k_true=10)
                fkw = pkw = dict(w_true=w, groups=g)
                launch_g, launch_tile = g, tile
            f = kw["fetch"]
            last = (SURVIVOR_BYTES - f) // rr.FUSED_ALIGN

            def words_of():
                units = rng.integers(0, last + 1, n)
                units[-1] = last  # the last legal window
                rows = rng.integers(0, w, n)
                return (units << rr.META_ROW_BITS) | rows

            words = words_of()
            meta = torch.from_numpy(words.astype(np.int32)).to(dev)
            got = fn(a, surv, meta, **kw, **fkw)
            want = plain(a, surv, meta, **kw, **pkw)
            torch.cuda.synchronize()
            diff = got.to(torch.int16) - want.to(torch.int16)
            mismatched = int((diff != 0).sum().item())
            max_err = int(diff.abs().max().item())
            # the first and the last (last legal window) request against the
            # numpy table oracle: the same bytes in either layout
            oracle_bad = 0
            sample = min(f, 65536)
            for j in (0, n - 1):
                oracle_bad += int((got[j, :sample].cpu().numpy() != _oracle(
                    rr, rs_cpu, mat, surv, int(words[j]), sample)).sum())
            row = {"layout": layout, "shape": [n, fetch, w], "fetch": f,
                   "tile": tile, "a": list(a.shape),
                   "mismatched_bytes": mismatched, "max_abs_err": max_err,
                   "oracle_sample_mismatched": oracle_bad}
            if mismatched or oracle_bad:
                log("resident_kernel", **row)
                raise AssertionError(f"{layout} {n}x{f}: kernel disagrees "
                                     "with its plain version")
            # the kernel alone: the host builds each list under the spin
            metas = [words_of() for _ in range(22)]
            row["ms"] = _launch_ms(
                torch,
                lambda m: rr._launch(fn, a, surv, m, [f] * n, w, launch_g,
                                     launch_tile),
                metas,
            )
            # the median of the timed calls' bounds, each with the rows its
            # requests want
            row_mask = (1 << rr.META_ROW_BITS) - 1
            bounds = [_fused_bound(10, [f] * n, len(np.unique(m & row_mask)),
                                   launch_g) for m in metas[2:]]
            row["bound_ms"] = statistics.median(b for b, _ in bounds)
            row["bound_by"] = bounds[0][1]
            row["plain_ms"] = _median_ms(
                torch, lambda: plain(a, surv, meta, **kw, **pkw), 3, warmup=1
            )
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["output_GBps"] = n * f / (row["ms"] * 1e-3) / 1e9
            row["library_ms"] = None
            row["library_note"] = NO_LIBRARY_CALL
            results[layout].append(row)
            log("resident_kernel", **row)
            del got, want, diff
        results[layout + "_burst"] = _burst_row(torch, np, rr, rs_cpu, gf256,
                                                surv, layout, g, seed)
    del surv
    torch.cuda.empty_cache()
    return results


def _oracle(rr, rs_cpu, mat, surv, word: int, nbytes: int):
    """The numpy table oracle's `nbytes` from meta word `word`."""
    import numpy as np

    start = (word >> rr.META_ROW_BITS) * rr.FUSED_ALIGN
    r = word & ((1 << rr.META_ROW_BITS) - 1)
    x = np.stack([s[start : start + nbytes].cpu().numpy() for s in surv])
    return rs_cpu.apply_matrix_numpy(mat[r : r + 1], x)[0]


def _burst_requests(np, rng):
    """BURST needle reads of lost shard 0 and lost parity shard 11 (w = 2):
    sizes log-uniform over MIN_NEEDLE-MAX_NEEDLE as phase 3's volume,
    offsets anywhere in the survivors short of a cache's MAX_TILE pad."""
    sizes = np.exp(rng.uniform(np.log(MIN_NEEDLE), np.log(MAX_NEEDLE),
                               BURST)).astype(np.int64)
    offs = rng.integers(0, SURVIVOR_BYTES - MAX_NEEDLE - MAX_TILE, BURST)
    sids = rng.choice([0, 11], BURST)
    return [(int(a), int(b), int(c)) for a, b, c in zip(sids, offs, sizes)]


def _bucket_calls(rr, subs, reqs, row_of, groups):
    """The per-bucket call structure for one burst: one uniform call per
    size bucket present (more where _max_count caps one), every request
    of a call fetched at the cover of the call's largest.  -> [(part,
    words, fetch, tile, deltas)]"""
    calls = []
    for bucket in rr.SIZE_BUCKETS:
        group = [(i, s) for i, s in enumerate(subs) if s[4] == bucket]
        if not group:
            continue
        step = rr._bucket(rr.COUNT_BUCKETS,
                          min(len(group), rr._max_count(bucket)))
        for lo in range(0, len(group), step):
            part = group[lo : lo + step]
            words, deltas, fetch = rr._fused_vectors(part, reqs, row_of)
            if groups > 1:
                fetch, tile = rr._blockdiag_fetch_tile(fetch, groups)
            else:
                tile = fetch
            calls.append((part, words, fetch, tile, deltas))
    return calls


def _burst_row(torch, np, rr, rs_cpu, gf256, surv, layout, g, seed) -> dict:
    """BURST_TIMED bursts of BURST needle reads, each served two ways on the
    same kernel, timed in turns (A, B, B, A) with CUDA events from the
    first enqueued operation to the last D2H's completion (a device spin
    long enough to hide the host's enqueue before the start event):
    (A) the per-bucket structure, one uniform call per size bucket, each a
    launch and a D2H; (B) one ragged launch and one D2H.  (B)'s output is held
    byte-equal to the ragged plain version, (A)'s trimmed bytes equal (B)'s,
    and the first and last requests equal the numpy oracle."""
    rng = np.random.default_rng(seed + 11)
    wanted = [0, 11]
    mat, _ = gf256.reconstruction_matrix(
        10, 14, [i for i in range(14) if i not in wanted], wanted)
    groups = g if layout == "blockdiag" else 1
    if groups > 1:
        a = rr._prepared_blockdiag(mat.tobytes(), *mat.shape, g, "cuda")
        fn = rr.fused_reconstruct_blockdiag
    else:
        a = rr.rs_cuda._prepared(mat.tobytes(), *mat.shape, "cuda")
        fn = rr.fused_reconstruct
    tile = groups * rr.FUSED_ALIGN
    row_of = {0: 0, 11: 1}
    host = torch.empty(0, dtype=torch.uint8, pin_memory=True)
    spin_ms = _event_ms(torch, lambda: torch.cuda._sleep(BURST_SPIN), spin=0)
    per = []
    mismatched = oracle_bad = 0
    for i in range(BURST_TIMED):
        reqs = _burst_requests(np, rng)
        subs = rr._plan(reqs)
        # one ragged call, or more where the burst passes one launch's
        # work list (RAGGED_MAX_BLOCKS entries) or _MAX_CALL_OUT
        calls_b = rr._ragged_calls(subs, reqs, row_of, groups)
        calls_a = _bucket_calls(rr, subs, reqs, row_of, groups)
        fetches_b = [f for c in calls_b for f in c[2]]
        d2h_a = sum(len(w) * f for _, w, f, _, _ in calls_a)
        if host.numel() < max(d2h_a, sum(fetches_b)):
            host = torch.empty(max(d2h_a, sum(fetches_b)), dtype=torch.uint8,
                               pin_memory=True)

        def enqueue_a():
            off = 0
            for _, words, fetch, t, _ in calls_a:
                out = rr._launch(fn, a, surv, words, [fetch] * len(words), 2,
                                 groups, t)[0]
                host[off : off + out.numel()].copy_(out, non_blocking=True)
                off += out.numel()

        def enqueue_b() -> int:
            off = sent = 0
            for _, words, fetches, _ in calls_b:
                out, _, pb = rr._launch(fn, a, surv, words, fetches, 2,
                                        groups, tile)
                host[off : off + out.numel()].copy_(out, non_blocking=True)
                off += out.numel()
                sent += pb
            return sent

        # the bytes: (B) against the ragged plain version and the oracle,
        # (A)'s trimmed pieces against (B)'s
        l0 = fn.launches
        param_bytes = enqueue_b()
        torch.cuda.synchronize()
        launches_b = fn.launches - l0
        pieces_b: dict = {}
        off = 0
        max_err = 0
        for part, words, fetches, deltas in calls_b:
            got_b = host[off : off + sum(fetches)].clone()
            off += sum(fetches)
            want = rr._fused_reconstruct_ragged_torch(
                a, surv, words, fetches, k_true=10, w_true=2, groups=groups,
                tile=tile).cpu()
            diff = got_b.to(torch.int16) - want.to(torch.int16)
            mismatched += int((diff != 0).sum())
            max_err = max(max_err, int(diff.abs().max()))
            rr._trim(got_b.numpy(), part, deltas, rr._offsets(fetches),
                     pieces_b)
        for j in (0, len(reqs) - 1):
            sid, off, size = reqs[j]
            data = b"".join(pieces_b[k] for k, s in enumerate(subs)
                            if s[0] == j)
            unit = off - off % rr.FUSED_ALIGN
            word = (unit // rr.FUSED_ALIGN) << rr.META_ROW_BITS | row_of[sid]
            ref = _oracle(rr, rs_cpu, mat, surv, word,
                          off % rr.FUSED_ALIGN + size)[off % rr.FUSED_ALIGN :]
            oracle_bad += int((np.frombuffer(data, np.uint8) != ref).sum())
        l0 = fn.launches
        enqueue_a()
        torch.cuda.synchronize()
        launches_a = fn.launches - l0
        pieces_a: dict = {}
        off = 0
        for part, words, fetch, _, deltas in calls_a:
            nbytes = len(words) * fetch
            rr._trim(host[off : off + nbytes].numpy(), part, deltas,
                     [fetch * j for j in range(len(words))], pieces_a)
            off += nbytes
        mismatched += sum(pieces_a[k] != pieces_b[k] for k in pieces_b)

        turns = {"A": [], "B": []}
        enq = {"A": [], "B": []}
        for name in ("A", "B", "B", "A"):
            fn_ = enqueue_a if name == "A" else enqueue_b
            t = [0.0]

            def timed():
                t0 = time.perf_counter()
                fn_()
                t[0] = (time.perf_counter() - t0) * 1e3

            turns[name].append(_event_ms(torch, timed, spin=BURST_SPIN))
            enq[name].append(t[0])
        kernel = statistics.median(
            _event_ms(torch, lambda: [
                rr._launch(fn, a, surv, words, fetches, 2, groups, tile)
                for _, words, fetches, _ in calls_b])
            for _ in range(3))
        bound, bound_by = _fused_bound(10, fetches_b, 2, groups)
        per.append({
            "sub_requests": len(subs), "calls_A": len(calls_a),
            "calls_B": len(calls_b),
            "launches_A": launches_a, "launches_B": launches_b,
            "d2h_A": d2h_a, "d2h_B": int(sum(fetches_b)),
            "window_A_ms": statistics.mean(turns["A"]),
            "window_B_ms": statistics.mean(turns["B"]),
            "enqueue_A_ms": max(enq["A"]), "enqueue_B_ms": max(enq["B"]),
            "kernel_ms": kernel, "bound_ms": bound, "bound_by": bound_by,
            "param_bytes": param_bytes,
            "max_abs_err": max_err,
        })
    row = {"layout": layout, "shape": "burst", "bursts": len(per),
           "requests": BURST, "w_true": 2,
           "mismatched_bytes": mismatched, "oracle_mismatched": oracle_bad,
           "max_abs_err": max(p["max_abs_err"] for p in per),
           "spin_ms": spin_ms, "bound_by": per[0]["bound_by"]}
    for key in ("sub_requests", "calls_A", "calls_B", "launches_A",
                "launches_B", "d2h_A",
                "d2h_B", "window_A_ms", "window_B_ms", "enqueue_A_ms",
                "enqueue_B_ms", "kernel_ms", "bound_ms", "param_bytes"):
        row[key] = statistics.median(p[key] for p in per)
    row["share_of_bound"] = statistics.median(
        p["bound_ms"] / p["kernel_ms"] for p in per)
    row["host_enqueue_under_spin"] = max(
        max(p["enqueue_A_ms"], p["enqueue_B_ms"]) for p in per) < spin_ms
    row["launches_B_max"] = max(p["launches_B"] for p in per)
    row["calls_B_max"] = max(p["calls_B"] for p in per)
    row["plain_ms"] = _median_ms(torch, lambda: [
        rr._fused_reconstruct_ragged_torch(
            a, surv, words, fetches, k_true=10, w_true=2, groups=groups,
            tile=tile) for _, words, fetches, _ in calls_b], 3, warmup=1)
    row["library_ms"] = None
    row["library_note"] = NO_LIBRARY_CALL
    log("resident_kernel", **row)
    if mismatched or oracle_bad:
        raise AssertionError(f"{layout} burst: the ragged kernel disagrees "
                             "with its plain version or the oracle")
    return row


def _int_mm_ms(torch, a, x):
    """torch._int_mm (cuBLASLt int8 GEMM) of A by the unpacked bit planes:
    the library yardstick for the product alone (no unpack, no pack).  The
    port never calls it.  None when cuBLASLt refuses the shape."""
    k_pad = a.shape[1] // 8
    k, b = x.shape
    b8 = -(-b // 8) * 8  # _int_mm takes widths that are multiples of 8
    bits = torch.zeros((8, k_pad, b8), dtype=torch.int8, device=x.device)
    for i in range(8):
        bits[i, :k, :b] = ((x & (1 << i)) != 0).to(torch.int8)
    bits = bits.reshape(8 * k_pad, b8)
    try:
        return _median_ms(torch, lambda: torch._int_mm(a, bits), 10)
    except RuntimeError as e:
        print(f"torch._int_mm refused {tuple(a.shape)}x{tuple(bits.shape)}: {e}",
              file=sys.stderr)
        return None


# --------------------------------------------------------------- phase 3


def phase_volume(workdir: str, seed: int, volume_bytes: int) -> dict:
    import numpy as np

    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume

    rng = np.random.default_rng(seed)
    # bodies are slices of one seeded random pool at seeded offsets
    pool = rng.bytes(64 << 20)
    pool_view = memoryview(pool)
    v = Volume(workdir, 1)
    needles = {}  # id -> (offset, size on disk, data sha256, cookie)
    t0 = time.perf_counter()
    nid = 0
    lo, hi = np.log(MIN_NEEDLE), np.log(MAX_NEEDLE)
    while v.content_size < volume_bytes:
        nid += 1
        size = int(np.exp(rng.uniform(lo, hi)))
        start = int(rng.integers(0, len(pool) - size))
        data = bytes(pool_view[start : start + size])
        n = Needle(
            id=nid, cookie=int(rng.integers(0, 1 << 32)), data=data,
            name=b"n%d" % nid, last_modified=1_700_000_000,
            append_at_ns=1_700_000_000_000_000_000 + nid,
        )
        off, body = v.append_needle(n)
        needles[nid] = (off, body, hashlib.sha256(data).digest(), n.cookie)
    v.sync()
    dat_size = v.content_size
    v.close()
    write_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    dat_sha = sha256_file(os.path.join(workdir, "1.dat"))
    log(
        "volume", needles=len(needles), dat_bytes=dat_size,
        write_s=write_s, hash_s=time.perf_counter() - t1,
        needle_bytes=[MIN_NEEDLE, MAX_NEEDLE],
        reduced={"volume_gib": [FULL_VOLUME_GIB, volume_bytes / (1 << 30)],
                 "why": "one H100 machine's disk (a call may write 45 GiB, "
                        "deleted files counted; the main path writes 3.8x "
                        "the volume) and the run's time limit; 11 GiB is "
                        "the smallest volume with a 1 GiB large-block row "
                        "and 1 MiB small-block rows"},
    )
    return {"needles": needles, "dat_size": dat_size, "dat_sha": dat_sha}


# --------------------------------------------------------------- phase 4


def _device_time(prof, path: str, wall: float, kernels: tuple[str, ...]) -> dict:
    """Device busy time from a torch.profiler run, read from its chrome
    trace (written to `path`, then removed): the union of every
    kernel/memcpy/memset interval on the card, its share of `wall`, each
    named kernel's own sum and the copies' sum.  Empty when the trace holds
    no device event."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    spans, copy_us = [], 0.0
    kernel_us = dict.fromkeys(kernels, 0.0)
    for e in events:
        cat = e.get("cat", "")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset") or "dur" not in e:
            continue
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        if cat == "gpu_memcpy":
            copy_us += float(e["dur"])
        for name in kernels:
            if cat == "kernel" and name in e.get("name", ""):
                kernel_us[name] += float(e["dur"])
    if not spans:
        return {}
    spans.sort()
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    busy_s = busy_us * 1e-6
    return {"device_events": len(spans), "busy_s": busy_s,
            "busy_share": busy_s / wall, "idle_share": 1.0 - busy_s / wall,
            **{f"{k}_s": v * 1e-6 for k, v in kernel_us.items()},
            "memcpy_s": copy_us * 1e-6}


def _reset(*kernels) -> None:
    """Set wrappers' launch counts to 0 (gf2_matmul's by load path too)."""
    for kernel in kernels:
        kernel.launches = 0
        for p in getattr(kernel, "launches_by_path", {}):
            kernel.launches_by_path[p] = 0


def _k1_counts(kernel, small) -> dict:
    """The two K1 wrappers' launches since their _reset."""
    return {"gf2_matmul": kernel.launches, **kernel.launches_by_path,
            "gf2_matmul_small": small.launches}


def phase_encode(torch, workdir: str, dat_size: int, k1: tuple, seed: int) -> dict:
    import numpy as np

    from seaweedfs_tpu_torch.ops import gf256, rs_cpu
    from seaweedfs_tpu_torch.storage import ec

    base = os.path.join(workdir, "1")
    stats: dict = {}
    _reset(*k1)
    # traced, to read the card's busy and idle share of the encode
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ec.write_ec_files(base, backend="cuda", stats=stats)
        ec.write_sorted_file_from_idx(base)
        wall = time.perf_counter() - t0
    enc_paths = _k1_counts(*k1)
    enc_launches = enc_paths["gf2_matmul"] + enc_paths["gf2_matmul_small"]
    if enc_launches == 0:
        raise AssertionError("encode launched no gf2_matmul kernel")
    dev = _device_time(prof, os.path.join(workdir, "encode_trace.json"), wall,
                       ("gf2_matmul",))
    if not dev:
        print("chip_smoke: the profiler recorded no device event in the "
              "encode; device busy share not measured", file=sys.stderr)
    shard_size = os.path.getsize(base + ec.to_ext(0))
    log("encode", GBps=dat_size / wall / 1e9, wall_s=wall, shard_bytes=shard_size,
        launches=enc_launches, load_paths=enc_paths, stats=stats,
        overlapped=stats["read_s"] + stats["write_s"] + stats["device_busy_s"]
        > stats["wall_s"] - stats["fsync_s"],
        device_trace=dev or "not measured")

    _reset(*k1)
    vstats: dict = {}
    t0 = time.perf_counter()
    mism, verified = ec.verify_ec_files(base, backend="cuda", stats=vstats)
    vwall = time.perf_counter() - t0
    ver_paths = _k1_counts(*k1)
    ver_launches = ver_paths["gf2_matmul"] + ver_paths["gf2_matmul_small"]
    if any(mism) or ver_launches == 0:
        raise AssertionError(f"verify: mismatches {mism}, launches {ver_launches}")
    # re-derive the parity of a sample of stripes with the numpy oracle
    rng = np.random.default_rng(seed + 1)
    pm = gf256.parity_matrix(10, 14)
    span = 65536
    checked = 0
    handles = [open(base + ec.to_ext(i), "rb") for i in range(14)]
    try:
        for off in rng.integers(0, shard_size - span, 8).tolist() + [0, shard_size - span]:
            rows = np.stack([
                np.frombuffer(os.pread(h.fileno(), span, off), dtype=np.uint8)
                for h in handles
            ])
            if not np.array_equal(rs_cpu.apply_matrix_numpy(pm, rows[:10]), rows[10:]):
                raise AssertionError(f"parity at shard offset {off} disagrees with the oracle")
            checked += 1
    finally:
        for h in handles:
            h.close()
    log("verify", GBps=verified * 14 / vwall / 1e9, wall_s=vwall,
        mismatches=mism, launches=ver_launches, load_paths=ver_paths,
        oracle_stripes=checked,
        stats=vstats)
    return {"wall_s": wall, "shard_size": shard_size,
            "launches": {"encode": enc_launches, "verify": ver_launches},
            "load_paths": {"encode": enc_paths, "verify": ver_paths}}


# --------------------------------------------------------------- phase 5


def phase_degraded(workdir: str, vol: dict, shard_size: int, k1: tuple, seed: int) -> dict:
    import numpy as np

    from seaweedfs_tpu_torch.storage import ec, needle as needle_mod
    from seaweedfs_tpu_torch.storage.ec import layout

    base = os.path.join(workdir, "1")
    for sid in (0, 11):
        os.rename(base + ec.to_ext(sid), base + ec.to_ext(sid) + ".down")
    dat_size = layout.DATA_SHARDS * shard_size
    on_shard0 = []
    others = []
    for nid, (off, body, _, _) in vol["needles"].items():
        total = needle_mod.actual_size(body, needle_mod.CURRENT_VERSION)
        ivs = layout.locate_data(dat_size, off, total)
        (on_shard0 if any(iv.to_shard_and_offset()[0] == 0 for iv in ivs)
         else others).append(nid)
    rng = np.random.default_rng(seed + 2)
    picks = on_shard0 + rng.choice(
        others, size=min(EXTRA_READS, len(others)), replace=False
    ).tolist()
    ev = ec.EcVolume(workdir, 1)
    for sid in range(14):
        if sid not in (0, 11):
            ev.add_shard(sid)
    _reset(*k1)
    lat_deg, lat_local = [], []
    shard0 = set(on_shard0)
    for nid in picks:
        _, _, digest, cookie = vol["needles"][nid]
        t0 = time.perf_counter()
        n = ev.read_needle(nid, cookie=cookie, backend="cuda")  # checks CRC
        dt = time.perf_counter() - t0
        if hashlib.sha256(n.data).digest() != digest:
            raise AssertionError(f"needle {nid}: bytes differ after degraded read")
        (lat_deg if nid in shard0 else lat_local).append(dt)
    paths = _k1_counts(*k1)
    launches = paths["gf2_matmul"] + paths["gf2_matmul_small"]
    if launches < len(on_shard0):
        raise AssertionError(f"{len(on_shard0)} degraded needles, {launches} launches")
    # journal three deletes (never the last needle, so the decoded .dat
    # keeps its size) for rebuild_ecx_file to replay after the rebuild
    deleted = sorted(vol["needles"])[1:4]
    for nid in deleted:
        ev.delete_needle(nid)
        try:
            ev.read_needle(nid, backend="cuda")
        except ec.NeedleNotFound:
            continue
        raise AssertionError(f"deleted needle {nid} still reads")
    ev.close()
    both = lat_deg + lat_local
    host = {"p50_ms": _pct(both, 50), "p99_ms": _pct(both, 99),
            "degraded_p50_ms": _pct(lat_deg, 50),
            "degraded_p99_ms": _pct(lat_deg, 99)}
    log("degraded_read", shards_down=[0, 11], reads=len(picks),
        degraded_reads=len(lat_deg), launches=launches, load_paths=paths, **host,
        local_p50_ms=_pct(lat_local, 50), local_p99_ms=_pct(lat_local, 99))
    return {"launches": launches, "load_paths": paths, "deleted": deleted,
            "picks": picks, "on_shard0": on_shard0, "host": host}


def _bucket_structure(rr, ev, burst, groups: int) -> tuple[int, int]:
    """What the per-bucket call structure (one uniform call per size
    bucket, every request at the cover of its call's largest) would launch
    and copy down for one read_needles_batch burst: -> (calls, D2H bytes),
    counted from the burst's own degraded intervals and plan."""
    reqs = []
    for nid in burst:
        _, _, ivs = ev.locate_needle(nid)
        for iv in ivs:
            sid, off = iv.to_shard_and_offset()
            if sid not in ev.shards:
                reqs.append((sid, off, iv.size))
    if not reqs:
        return 0, 0
    row_of = {sid: i for i, sid in enumerate(sorted({r[0] for r in reqs}))}
    calls = _bucket_calls(rr, rr._plan(reqs), reqs, row_of, groups)
    return len(calls), sum(len(w) * f for _, w, f, _, _ in calls)


def _pct(seconds: list, q: float):
    """q-th percentile of a list of seconds, in ms (None when empty)."""
    import numpy as np

    return float(np.percentile(np.asarray(seconds) * 1e3, q)) if seconds else None


# -------------------------------------------------------------- phase 5b


def phase_resident(torch, workdir: str, vol: dict, deg: dict, seed: int) -> dict:
    """Shards 0 and 11 still down: pin the 12 survivors in HBM and serve the
    degraded reads from there (EcVolume.read_needles_batch and read_needle
    through reconstruct_intervals), in both layouts."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops import rs_resident as rr
    from seaweedfs_tpu_torch.storage import ec

    kernels = {"blockdiag": rr.fused_reconstruct_blockdiag,
               "flat": rr.fused_reconstruct}
    ev = ec.EcVolume(workdir, 1)
    for sid in range(14):
        if sid not in (0, 11):
            ev.add_shard(sid)
    cache = rr.DeviceShardCache(device="cuda", budget_bytes=RESIDENT_BUDGET)
    deleted = set(deg["deleted"])
    ids = [n for n in deg["picks"] if n not in deleted]
    shard0 = [n for n in deg["on_shard0"] if n not in deleted]
    rng = np.random.default_rng(seed + 3)

    def check(burst, got) -> None:
        for nid, n in zip(burst, got):
            if isinstance(n, Exception):
                raise AssertionError(f"needle {nid}: {n!r}")
            _, _, digest, cookie = vol["needles"][nid]
            if n.cookie != cookie or hashlib.sha256(n.data).digest() != digest:
                raise AssertionError(f"needle {nid}: bytes differ after a "
                                     "resident read")

    def bursts(width, seq, keep=None) -> list[tuple[float, int]]:
        """Read `seq` in bursts of `width`: (seconds, needles) per burst.
        The sha256 check runs outside the timing, or later for `keep`."""
        lat = []
        for i in range(0, len(seq), width):
            burst = seq[i : i + width]
            t0 = time.perf_counter()
            got = ev.read_needles_batch(burst, backend="cuda")
            lat.append((time.perf_counter() - t0, len(burst)))
            if keep is None:
                check(burst, got)
            else:
                keep.append((burst, got))
        return lat

    try:
        for kern in (*kernels.values(), rs_cuda.gf2_matmul,
                     rs_cuda.gf2_matmul_small):
            kern.launches = 0
        t0 = time.perf_counter()
        pinned = ev.load_shards_to_device(cache)
        torch.cuda.synchronize()
        pin_s = time.perf_counter() - t0
        true_bytes = sum(cache.shard_size(1, s) for s in cache.shard_ids(1))
        if pinned != 12 or not ev.is_device_resident():
            raise AssertionError(f"pinned {pinned} shards, "
                                 f"resident {cache.shard_ids(1)}")
        log("resident_pin", shards=cache.shard_ids(1), shard_bytes=true_bytes,
            padded_bytes=cache.bytes_used, budget_bytes=RESIDENT_BUDGET,
            pin_s=pin_s, GBps=true_bytes / pin_s / 1e9)

        per_burst: dict = {}
        for layout, kern in kernels.items():
            cache.layout = layout
            k0, d2h0, h2d0 = (kern.launches, cache.pipeline.d2h_bytes,
                              cache.pipeline.h2d_bytes)
            # the first burst grows the slot's pinned result buffer
            t0 = time.perf_counter()
            check(ids[:BURST], ev.read_needles_batch(ids[:BURST], backend="cuda"))
            first_ms = (time.perf_counter() - t0) * 1e3
            m0, md0 = kern.launches, cache.pipeline.d2h_bytes
            main = bursts(BURST, ids)
            main_launches = kern.launches - m0
            main_d2h = cache.pipeline.d2h_bytes - md0
            # the same bursts' plans under the per-bucket structure, counted
            per_bucket = [_bucket_structure(rr, ev, ids[i : i + BURST],
                              cache.groups if layout == "blockdiag" else 1)
                   for i in range(0, len(ids), BURST)]
            widths = {}
            for width, count in BURST_SAMPLES:
                seq = rng.choice(shard0, size=min(width * count, len(shard0)),
                                 replace=False).tolist()
                lat = bursts(width, seq)
                widths[width] = {"bursts": len(lat),
                                 "p50_ms": _pct([s for s, _ in lat], 50),
                                 "p99_ms": _pct([s for s, _ in lat], 99)}
            singles = []
            single_ids = rng.choice(shard0, size=min(SINGLE_READS, len(shard0)),
                                    replace=False).tolist()
            for nid in single_ids:
                _, _, digest, cookie = vol["needles"][nid]
                t0 = time.perf_counter()
                n = ev.read_needle(nid, cookie=cookie, backend="cuda")
                singles.append(time.perf_counter() - t0)
                if hashlib.sha256(n.data).digest() != digest:
                    raise AssertionError(f"needle {nid}: bytes differ after a "
                                         "resident read_needle")
            # the same reads split: the .ecx lookup, then one
            # reconstruct_intervals call for each missing-shard interval
            split: dict = {"locate": [], "reconstruct_intervals": []}
            for nid in single_ids:
                t0 = time.perf_counter()
                _, _, ivs = ev.locate_needle(nid)
                t1 = time.perf_counter()
                for iv in ivs:
                    sid, off = iv.to_shard_and_offset()
                    if sid not in ev.shards:
                        rr.reconstruct_intervals(cache, 1, [(sid, off, iv.size)])
                split["locate"].append(t1 - t0)
                split["reconstruct_intervals"].append(time.perf_counter() - t1)
            split = {k: {"p50_ms": _pct(v, 50), "p99_ms": _pct(v, 99)}
                     for k, v in split.items()}
            trace = None
            if layout == "blockdiag":  # the JAX serving default, traced
                kept: list = []
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                t_launches = kern.launches
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    bursts(BURST, ids[: TRACED_BURSTS * BURST], keep=kept)
                    wall = time.perf_counter() - t0
                t_launches = kern.launches - t_launches
                for burst, got in kept:
                    check(burst, got)
                trace = _device_time(
                    prof, os.path.join(workdir, "resident_trace.json"), wall,
                    ("fused_reconstruct", "gf2_matmul"),
                )
                if trace:
                    trace["wall_s"] = wall
                    trace["bursts"] = len(kept)
                    trace["fused_reconstruct_launches"] = t_launches
                else:
                    trace = "not measured"
            launches = kern.launches - k0
            per_burst[kern.__name__] = main_launches / len(main)
            if launches == 0:
                raise AssertionError(f"{layout}: no {kern.__name__} launch")
            log("resident_read", layout=layout, needles=len(ids),
                degraded_needles=len(shard0), bursts=len(main),
                burst_width=BURST, first_burst_ms=first_ms,
                burst_p50_ms=_pct([s for s, _ in main], 50),
                burst_p99_ms=_pct([s for s, _ in main], 99),
                needle_amortized_p50_ms=_pct([s / w for s, w in main], 50),
                needle_amortized_p99_ms=_pct([s / w for s, w in main], 99),
                widths=widths, read_needle=len(singles),
                read_needle_p50_ms=_pct(singles, 50),
                read_needle_p99_ms=_pct(singles, 99), read_needle_split=split,
                launches={kern.__name__: launches},
                main_burst_launches=main_launches,
                launches_per_main_burst=main_launches / len(main),
                d2h_bytes_per_main_burst=main_d2h / len(main),
                bucket_structure_per_main_burst={
                    "launches": sum(c for c, _ in per_bucket) / len(main),
                    "d2h_bytes": sum(d for _, d in per_bucket) / len(main)},
                d2h_bytes=cache.pipeline.d2h_bytes - d2h0,
                h2d_bytes=cache.pipeline.h2d_bytes - h2d0,
                host_route=deg["host"], device_trace=trace)
        # a journaled delete still fails in its own slot of a burst
        got = ev.read_needles_batch([min(deleted), ids[0]], backend="cuda")
        if not isinstance(got[0], ec.NeedleNotFound):
            raise AssertionError(f"deleted needle read as {got[0]!r}")
        check(ids[:1], got[1:])
        host_k1 = rs_cuda.gf2_matmul.launches + rs_cuda.gf2_matmul_small.launches
        if ev.device_misses or host_k1:
            raise AssertionError(
                f"{ev.device_misses} intervals fell back to the host path "
                f"({host_k1} gf2_matmul launches)")
        out = {kern.__name__: kern.launches for kern in kernels.values()}
        out["per_main_burst"] = per_burst
    finally:
        ev.close()
        cache.clear()
        torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------- phase 5c

# phase 5c: needles read besides every one with bytes on the lost shard
SERVE_EXTRA = 400
SERVE_CLIENTS = 64
# the clients run in this many processes, so that one client process's
# event loop (HTTP parsing, sha256 of every body) does not bound the pass
SERVE_CLIENT_PROCS = 4
SERVE_READS = 12_000
SERVE_SECONDS = 8.0
# the one-client pass of each layout's turn: a seeded sample of the reads
SERVE_SEQ_READS = 2000
SERVE_PIN_TIMEOUT = 180.0
# one turn a layout (flat, block-diagonal twice, flat before: cut for the
# run's time limit)
SERVE_TURNS = ("flat", "blockdiag")
SERVE_CACHE_MB = RESIDENT_BUDGET >> 20
# the trace plane: every needle GET is traced under this route; the
# block-diagonal turn runs its server with SWFS_DEBUG=1 and takes a
# /debug/profile capture this long, this long after its clients start
# (not the flat turn: 9a's SLO target comes from its concurrent pass)
GET_ROUTE = "GET /<fid>"
PROFILE_TURNS = (1,)
PROFILE_SECONDS = 5.0
PROFILE_DELAY_S = 3.0
# the profiled turn's concurrent pass runs until its capture has returned
# (CUPTI's first start in the server takes seconds, more on a slow host),
# and this long at most (the others SERVE_SECONDS or SERVE_READS)
PROFILE_PASS_S = 120.0
# the added turns, flat and concurrent only, each with its reads:
# -obs.disable (tracing's cost), then -obs.tail.disable (the tail store's
# share of it; short: it checks that the GET route's critical path stays
# still with the tail store off)
COST_TURNS = ((("-obs.disable",), 4_000), (("-obs.tail.disable",), 2_000))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scrape(port: int) -> dict:
    """/metrics of the server on `port`, parsed: {series line key: value}
    (the key is the name with its labels, as printed)."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def _serve_counts(m: dict) -> dict:
    """The serving series phase 5c reads, from one _scrape."""
    from seaweedfs_tpu_torch.stats.metrics import CRITPATH_SEGMENTS, TRACE_STAGES

    stage = 'SeaweedFS_request_stage_seconds_%s{stage="%s"}'
    crit = ('SeaweedFS_critpath_seconds_total{route="%s",segment="%s"}'
            % (GET_ROUTE, "%s"))
    widths = {}
    prev = 0.0
    for w in range(1, 257):
        acc = m[f'SeaweedFS_volumeServer_ec_batch_size_bucket{{le="{w}.0"}}']
        widths[w] = acc - prev
        prev = acc
    kern = "SeaweedFS_volumeServer_ec_kernel_launches_total{kernel=\"%s\"}"
    route = "SeaweedFS_volumeServer_ec_read_route_total{route=\"%s\"}"
    return {
        "widths": widths,
        "batches": m["SeaweedFS_volumeServer_ec_batch_size_count"],
        "launches": {k: m.get(kern % k, 0.0) for k in (
            "fused_reconstruct", "fused_reconstruct_blockdiag", "gf2_matmul",
            "gf2_matmul_small")},
        "routes": {r: m[route % r] for r in ("batched", "native")},
        "fallback": m["SeaweedFS_volumeServer_ec_batch_fallback_total"],
        "d2h": m["SeaweedFS_volumeServer_ec_d2h_bytes_total"],
        "h2d": m["SeaweedFS_volumeServer_ec_h2d_bytes_total"],
        # the GET handler's time on the server (parse to response built,
        # the socket write excluded) and the coalescer's queue wait
        "get_s": m.get('SeaweedFS_volumeServer_request_seconds_sum{type="get"}', 0.0),
        "gets": m.get('SeaweedFS_volumeServer_request_seconds_count{type="get"}', 0.0),
        "wait_s": m["SeaweedFS_volumeServer_ec_batch_queue_wait_seconds_sum"],
        "waits": m["SeaweedFS_volumeServer_ec_batch_queue_wait_seconds_count"],
        # the trace plane: per-stage histograms, the GET route's
        # critical-path counters, and the ledger's device calls
        "stages": {st: (m[stage % ("count", st)], m[stage % ("sum", st)])
                   for st in TRACE_STAGES},
        "crit": {seg: m.get(crit % seg, 0.0) for seg in CRITPATH_SEGMENTS},
        "crit_route_s": m.get('SeaweedFS_critpath_route_seconds_total'
                              f'{{route="{GET_ROUTE}"}}', 0.0),
        "ledger_calls": m.get(
            'SeaweedFS_volumeServer_device_dispatches_total'
            '{workload="serving_interactive",device="default"}', 0.0),
        "slo_stage": _stage_buckets(m, SLO_STAGE),
    }


def _stage_buckets(m: dict, stage: str) -> list:
    """Per-bucket counts (the digest ladder, +Inf last) of one stage of
    SeaweedFS_request_stage_seconds, from one _scrape: the shape of a
    heartbeat stage digest."""
    from seaweedfs_tpu_torch.stats.metrics import STAGE_SECONDS_BUCKETS, _fmt

    key = 'SeaweedFS_request_stage_seconds_bucket{stage="%s",le="%s"}'
    cum = [m.get(key % (stage, _fmt(e)), 0.0)
           for e in STAGE_SECONDS_BUCKETS + (float("inf"),)]
    return [cum[0]] + [cum[i] - cum[i - 1] for i in range(1, len(cum))]


def _serve_delta(before: dict, after: dict) -> dict:
    """What one pass added to the serving series."""
    widths = {w: after["widths"][w] - before["widths"][w] for w in range(1, 257)}
    batches = after["batches"] - before["batches"]
    seen = [w for w, c in widths.items() if c > 0]
    half, acc, p50 = batches / 2, 0.0, None
    for w in range(1, 257):
        acc += widths[w]
        if p50 is None and acc >= half and batches:
            p50 = w
    launches = {k: after["launches"][k] - before["launches"][k]
                for k in after["launches"]}
    return {
        "batches": batches,
        "batch_width_p50": p50,
        "batch_width_max": max(seen) if seen else None,
        "launches": launches,
        "routes": {r: after["routes"][r] - before["routes"][r]
                   for r in after["routes"]},
        "fallback": after["fallback"] - before["fallback"],
        "d2h_bytes": after["d2h"] - before["d2h"],
        "h2d_bytes": after["h2d"] - before["h2d"],
        "server_get_mean_ms": (after["get_s"] - before["get_s"]) * 1e3
                              / max(1.0, after["gets"] - before["gets"]),
        "queue_wait_mean_ms": (after["wait_s"] - before["wait_s"]) * 1e3
                              / max(1.0, after["waits"] - before["waits"]),
        "stages": {
            st: {"count": after["stages"][st][0] - before["stages"][st][0],
                 "sum_s": after["stages"][st][1] - before["stages"][st][1]}
            for st in after["stages"]},
        "crit_s": {seg: after["crit"][seg] - before["crit"][seg]
                   for seg in after["crit"]},
        "crit_route_s": after["crit_route_s"] - before["crit_route_s"],
        "ledger_calls": after["ledger_calls"] - before["ledger_calls"],
        "slo_stage": [b - a for a, b in zip(before["slo_stage"],
                                            after["slo_stage"])],
    }


def _trace_checks(name: str, d: dict, traces: int, kern: str,
                  tail: bool = True) -> dict:
    """The trace plane's accounting over one pass of `traces` traced GETs
    (`d` from _serve_delta): fatal where it does not add up.  -> the
    per-stage means and the critical-path composition of the GET route
    (fed by the tail store: with `tail` False it must not move)."""
    st = d["stages"]
    crit_sum = sum(d["crit_s"].values())
    if abs(crit_sum - d["crit_route_s"]) > 1e-6 * max(1, traces):
        raise AssertionError(f"{name}: critical-path segments sum to "
                             f"{crit_sum} s, the route to {d['crit_route_s']} s")
    if (d["crit_route_s"] > 0) != tail:
        raise AssertionError(f"{name}: the GET route's critical path moved "
                             f"{d['crit_route_s']} s with the tail store "
                             f"{'on' if tail else 'off'}")
    batched = d["routes"]["batched"]
    calls = d["launches"][kern]
    checks = {
        # every batch runs under one batch_dispatch span
        "batch_dispatch == batches": st["batch_dispatch"]["count"] == d["batches"],
        # every batch with a degraded read packs and executes once; a batch
        # whose needles all lie on local shards has no device call
        "device_execute == batch_pack": (st["device_execute"]["count"]
                                         == st["batch_pack"]["count"]),
        "device_execute <= batches": st["device_execute"]["count"] <= d["batches"],
        # one D2H span a device call, one launch a call, one ledger
        # dispatch a call
        "d2h_copy == launches": st["d2h_copy"]["count"] == calls,
        "d2h_copy == ledger calls": st["d2h_copy"]["count"] == d["ledger_calls"],
        # nothing is copied up: the work list rides in the parameters
        "h2d_copy == 0": st["h2d_copy"]["count"] == 0,
        # the drain loop observes one queue_wait a batched read
        "queue_wait == batched reads": st["queue_wait"]["count"] == batched,
    }
    if not all(checks.values()):
        raise AssertionError(f"{name}: trace accounting {checks}: "
                             f"stages {st}, batches {d['batches']}, "
                             f"launches {calls}, reads {batched}")
    return {
        "stage_mean_ms": {k: v["sum_s"] * 1e3 / v["count"]
                          for k, v in st.items() if v["count"]},
        "stage_count": {k: v["count"] for k, v in st.items() if v["count"]},
        "batches_without_device_call": d["batches"]
                                       - st["device_execute"]["count"],
        "critpath_route_s": d["crit_route_s"],
        "critpath_share": {seg: v / d["crit_route_s"]
                           for seg, v in d["crit_s"].items()}
                          if d["crit_route_s"] else {},
    }


def _trace_docs(port: int) -> dict:
    """/debug/traces?limit=16, then /debug/critpath of the slowest of
    them, and /debug/tail's GET route."""
    traces = _get_json(port, "/debug/traces?limit=16")["traces"]
    gets = [t for t in traces if t["name"].startswith("GET /")]
    if not gets:
        raise AssertionError(f"no traced GET in /debug/traces: {traces[:2]}")
    slow = max(gets, key=lambda t: t["duration_us"])
    crit = _get_json(port, f"/debug/critpath?id={slow['trace_id']}")
    if abs(sum(crit["segments_us"].values()) - crit["total_us"]) > 6:
        raise AssertionError(f"critpath segments {crit['segments_us']} do not "
                             f"sum to {crit['total_us']} us")
    tail = _get_json(port, "/debug/tail")
    return {
        "slowest_of_16": {
            "duration_ms": slow["duration_us"] / 1e3,
            "spans": [(sp["name"], sp["duration_us"] / 1e3)
                      for sp in slow["spans"]],
            "segments_us": crit["segments_us"],
            "coverage_pct": crit["coverage_pct"],
        },
        "tail": {"route": tail["routes"].get(GET_ROUTE),
                 "pinned": len(tail["pinned"])},
    }


def _profile_window(port: int, delay_s: float, out: dict,
                    stop_path: str) -> None:
    """In a thread: after `delay_s`, a PROFILE_SECONDS /debug/profile
    capture of the server on `port` (its status and document into
    `out`); then the file `stop_path` tells the readers to stop."""
    import urllib.error
    import urllib.request

    time.sleep(delay_s)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/profile?seconds="
                f"{PROFILE_SECONDS}", timeout=300) as r:
            out["status"], out["doc"] = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        out["status"], out["doc"] = e.code, e.read().decode(errors="replace")
    except OSError as e:
        out["status"], out["doc"] = None, repr(e)
    finally:
        with open(stop_path, "w"):
            pass


def _profile_summary(doc: dict) -> dict:
    """Kernel events of a /debug/profile capture by name (count, total
    ms) and the card's kernel-busy share of its window."""
    from seaweedfs_tpu_torch.utils import devtime

    path = os.path.join(doc["trace_dir"], "trace.json")
    events = devtime.kernel_events(path)
    by_name: dict = {}
    for name, _, dur in events:
        row = by_name.setdefault(name, {"count": 0, "ms": 0.0})
        row["count"] += 1
        row["ms"] += dur / 1e3
    busy_us, end = 0.0, float("-inf")
    for _, ts, dur in events:
        if ts + dur > end:
            busy_us += ts + dur - max(ts, end)
            end = ts + dur
    return {"window_s": doc["seconds"], "trace_bytes": os.path.getsize(path),
            "kernels": by_name, "kernel_busy_ms": busy_us / 1e3,
            "kernel_busy_share": busy_us / 1e6 / doc["seconds"]}


async def _serve_sequential(port: int, seq: list, vol: dict) -> list:
    """GET every needle of `seq` in turn on one keep-alive connection:
    -> seconds per read.  Every body is byte-verified."""
    from seaweedfs_tpu_torch.server.http import Client
    from seaweedfs_tpu_torch.storage import types as t

    client = Client("127.0.0.1", port)
    lat = []
    try:
        for nid in seq:
            _, _, digest, cookie = vol["needles"][nid]
            t0 = time.perf_counter()
            status, headers, body = await client.request(
                "GET", "/" + t.format_fid(1, nid, cookie))
            lat.append(time.perf_counter() - t0)
            if status != 200 or hashlib.sha256(body).digest() != digest:
                raise AssertionError(f"needle {nid}: HTTP {status}, "
                                     f"{len(body)} bytes differ from the "
                                     "written needle")
            if "X-Seaweed-Trace-Id" not in headers:
                raise AssertionError(f"needle {nid}: no trace header")
    finally:
        await client.close()
    return lat


async def _serve_clients(port: int, seq: list, n_clients: int, reads: int,
                         seconds: float, seed: int, vid: int = 1,
                         traced: bool = True, stop_path: str = ""):
    """`n_clients` closed-loop keep-alive clients GET needles of `seq`
    ((nid, cookie, sha256) triples, seeded picks) of volume `vid` until
    `reads` reads, `seconds`, or the file `stop_path` exists: -> (seconds
    per read, body bytes).  Every body is byte-verified, and carries the
    trace header iff `traced`."""
    import numpy as np

    from seaweedfs_tpu_torch.server.http import Client
    from seaweedfs_tpu_torch.storage import types as t

    lat: list = []
    nbytes = [0]
    t_end = time.monotonic() + seconds

    async def client(i: int) -> None:
        rng = np.random.default_rng(seed * 1000 + i)
        c = Client("127.0.0.1", port)
        try:
            while len(lat) < reads and time.monotonic() < t_end and not (
                    stop_path and os.path.exists(stop_path)):
                nid, cookie, digest = seq[int(rng.integers(0, len(seq)))]
                t0 = time.perf_counter()
                status, headers, body = await c.request(
                    "GET", "/" + t.format_fid(vid, nid, cookie))
                lat.append(time.perf_counter() - t0)
                if status != 200 or hashlib.sha256(body).digest() != digest:
                    raise AssertionError(f"needle {nid}: HTTP {status}, "
                                         f"{len(body)} bytes differ from the "
                                         "written needle")
                if ("X-Seaweed-Trace-Id" in headers) != traced:
                    raise AssertionError(f"needle {nid}: trace header "
                                         f"{'missing' if traced else 'sent'}")
                nbytes[0] += len(body)
        finally:
            await c.close()

    await asyncio.gather(*(client(i) for i in range(n_clients)))
    return lat, nbytes[0]


def _client_proc(port: int, seq: list, n_clients: int, reads: int,
                 seconds: float, seed: int, vid: int = 1,
                 traced: bool = True, stop_path: str = "") -> dict:
    """One client process of the concurrent pass (run under spawn)."""
    sys.path.insert(0, HERE)
    cpu0, t0 = time.process_time(), time.monotonic()
    lat, nbytes = asyncio.run(_serve_clients(
        port, seq, n_clients, reads, seconds, seed, vid, traced, stop_path))
    return {"lat": lat, "bytes": nbytes, "start": t0, "end": time.monotonic(),
            "cpu_s": time.process_time() - cpu0}


def _serve_concurrent(port: int, seq: list, seed: int, vid: int = 1,
                      reads: int = SERVE_READS, traced: bool = True,
                      procs: int = SERVE_CLIENT_PROCS,
                      seconds: float = SERVE_SECONDS,
                      stop_path: str = "") -> dict:
    """SERVE_CLIENTS clients in `procs` processes reading volume `vid`,
    `reads` reads in all (or for `seconds`, or until `stop_path` exists):
    -> latencies, body bytes, wall (first start to last end) and the
    clients' CPU s."""
    import concurrent.futures
    import multiprocessing

    per = SERVE_CLIENTS // procs
    with concurrent.futures.ProcessPoolExecutor(
            procs, mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = [pool.submit(_client_proc, port, seq, per, reads // procs,
                            seconds, seed * 10 + i, vid, traced, stop_path)
                for i in range(procs)]
        parts = [f.result() for f in futs]
    return {"lat": [x for p in parts for x in p["lat"]],
            "bytes": sum(p["bytes"] for p in parts),
            "wall": max(p["end"] for p in parts) - min(p["start"] for p in parts),
            "client_cpu_s": sum(p["cpu_s"] for p in parts)}


def _proc_cpu_s(pid: int) -> float:
    """User + system CPU seconds of process `pid` (its threads included)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


@contextlib.contextmanager
def _volume_server(args: list, log_path: str, env: dict | None = None,
                   command: str = "volume"):
    """`python3 -m seaweedfs_tpu_torch volume ARGS` (or another `command`)
    as an operator starts it (with `env` added to its environment), its
    output in `log_path`: yields the process; on an error in the block the
    server is killed and its log's tail printed; it is stopped on the way
    out either way."""
    cmd = [sys.executable, "-m", "seaweedfs_tpu_torch", command, *args]
    with open(log_path, "wb") as logf:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=logf,
                                stderr=subprocess.STDOUT,
                                env={**os.environ, **(env or {})})
    try:
        yield proc
    except BaseException:
        proc.kill()
        proc.wait(30)
        with open(log_path, "rb") as f:
            sys.stderr.write(f.read()[-20000:].decode(errors="replace"))
        raise
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)


def _serve_layout(workdir: str, serve_dir: str, layout: str, seq: list,
                  vol: dict, deleted: list, seed: int, turn: int,
                  sequential: list, profile: bool = False,
                  flags: tuple = (), reads: int = SERVE_READS) -> dict:
    """One fresh server in `layout` (with the -obs `flags`): pin, then the
    one-client pass over the needles `sequential` names (none when empty)
    and the concurrent pass of `reads` reads, with its trace accounting
    (unless -obs.disable) and the trace documents (unless
    -obs.tail.disable too), and, when `profile`, a
    /debug/profile capture in its middle (the server runs with
    SWFS_DEBUG=1)."""
    import urllib.request

    traced = "-obs.disable" not in flags
    tail = traced and "-obs.tail.disable" not in flags
    port = _free_port()
    log_path = os.path.join(workdir, f"serve_{turn}_{layout}.log")
    args = ["-dir", serve_dir, "-port", str(port), "-mserver", "",
            "-ec.backend", "cuda", "-ec.deviceCacheMB", str(SERVE_CACHE_MB),
            "-ec.serving.layout", layout, *flags]
    # the server's captures land under the work directory
    env = {"TMPDIR": os.path.join(workdir, "tmp")}
    os.makedirs(env["TMPDIR"], exist_ok=True)
    if profile:
        env["SWFS_DEBUG"] = "1"
    with _volume_server(args, log_path, env) as proc:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"volume server exited ({proc.returncode})")
            if time.perf_counter() - t0 > SERVE_PIN_TIMEOUT:
                raise AssertionError("volume not resident within "
                                     f"{SERVE_PIN_TIMEOUT} s")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/status", timeout=10) as r:
                    status = json.loads(r.read())
            except OSError:
                status = None
            ecv = status and status["EcVolumes"]
            if ecv and ecv[0]["serving"] and len(ecv[0]["resident"]) == 12:
                break
            time.sleep(0.2)
        pin_s = time.perf_counter() - t0
        start = _serve_counts(_scrape(port))
        if any(start["launches"].values()) or start["batches"] \
                or any(start["routes"].values()):
            raise AssertionError(f"counts not 0 before the reads: {start}")
        passes = []
        if sequential:
            seq_lat = asyncio.run(_serve_sequential(port, sequential, vol))
            passes.append(("sequential", seq_lat, _serve_delta(
                start, _serve_counts(_scrape(port)))))
            # a journaled delete answers 404 through the whole stack
            from seaweedfs_tpu_torch.server.http import Client
            from seaweedfs_tpu_torch.storage import types as t

            async def gone():
                c = Client("127.0.0.1", port)
                try:
                    return (await c.request("GET", "/" + t.format_fid(
                        1, deleted[0], vol["needles"][deleted[0]][3])))[0]
                finally:
                    await c.close()
            if asyncio.run(gone()) != 404:
                raise AssertionError("a deleted needle did not answer 404")
        mid = _serve_counts(_scrape(port))
        prof: dict = {}
        stop_path = ""
        if profile:
            stop_path = os.path.join(workdir, f"serve_{turn}.stop")
            window = threading.Thread(
                target=_profile_window,
                args=(port, PROFILE_DELAY_S, prof, stop_path), daemon=True)
            window.start()
        cpu0 = _proc_cpu_s(proc.pid)
        con = _serve_concurrent(port, [
            (nid, vol["needles"][nid][3], vol["needles"][nid][2])
            for nid in seq], seed, reads=sys.maxsize if profile else reads,
            traced=traced,
            seconds=PROFILE_PASS_S if profile else SERVE_SECONDS,
            stop_path=stop_path)
        server_cpu_s = _proc_cpu_s(proc.pid) - cpu0
        passes.append(("concurrent", con["lat"], _serve_delta(
            mid, _serve_counts(_scrape(port)))))
        kern = ("fused_reconstruct_blockdiag" if layout == "blockdiag"
                else "fused_reconstruct")
        trace = {}
        if traced:
            trace = _trace_checks(f"{layout} turn {turn}", passes[-1][2],
                                  len(con["lat"]), kern, tail)
        if tail:
            trace.update(_trace_docs(port))
        if profile:
            window.join()
            if prof.get("status") != 200:
                raise AssertionError(f"/debug/profile answered "
                                     f"{prof.get('status')}: {prof.get('doc')}")
            trace["profile"] = _profile_summary(prof["doc"])
            if not any("fused_reconstruct" in k
                       for k in trace["profile"]["kernels"]):
                raise AssertionError("no fused_reconstruct kernel event in "
                                     f"the capture: {trace['profile']}")
        # the residency ladder runs (tiering is on with a cache) and must
        # move nothing: the one volume is resident and under budget
        tiers = _tier_series(_scrape(port))
        if any(tiers["promotions"].values()) or any(tiers["demotions"].values()):
            raise AssertionError(f"{layout} turn {turn}: the ladder moved "
                                 f"volumes: {tiers}")
    out = {"pin_s": pin_s}
    for name, lat, d in passes:
        if d["routes"]["native"] or d["fallback"]:
            raise AssertionError(f"{layout} {name}: {d['routes']['native']} "
                                 "reads took the native route once resident")
        if d["launches"]["gf2_matmul"] or d["launches"]["gf2_matmul_small"]:
            raise AssertionError(f"{layout} {name}: host K1 launches "
                                 f"{d['launches']}")
        if not d["launches"][kern]:
            raise AssertionError(f"{layout} {name}: no {kern} launch")
        row = {"reads": len(lat), "p50_ms": _pct(lat, 50),
               "p99_ms": _pct(lat, 99), "p99.9_ms": _pct(lat, 99.9),
               "batches": d["batches"], "batch_width_p50": d["batch_width_p50"],
               "batch_width_max": d["batch_width_max"],
               "launches": d["launches"][kern],
               "launches_per_batch": d["launches"][kern] / d["batches"],
               "d2h_MB_per_batch": d["d2h_bytes"] / d["batches"] / 1e6,
               "h2d_bytes": d["h2d_bytes"], "routes": d["routes"],
               "server_get_mean_ms": d["server_get_mean_ms"],
               "queue_wait_mean_ms": d["queue_wait_mean_ms"],
               # 9a's latency SLO takes its target from these (flat turn 0)
               f"{SLO_STAGE}_buckets": d["slo_stage"]}
        if name == "concurrent":
            wall = con["wall"]
            row.update(clients=SERVE_CLIENTS, client_procs=SERVE_CLIENT_PROCS,
                       wall_s=wall, reads_per_s=len(lat) / wall,
                       MBps=con["bytes"] / wall / 1e6,
                       server_cpu_s=server_cpu_s,
                       server_cores=server_cpu_s / wall,
                       client_cpu_s=con["client_cpu_s"],
                       client_cores=con["client_cpu_s"] / wall,
                       obs_flags=list(flags), profiled=profile)
        out[name] = row
    out["launches"] = sum(row["launches"] for name, row in out.items()
                          if name != "pin_s")
    out["trace"] = trace
    log("serve", layout=layout, turn=turn, kernel=kern, pin_s=pin_s,
        needles=len(seq), tier_moves=0,
        **{name: out[name] for name, _, _ in passes})
    if trace:
        log("serve_trace", layout=layout, turn=turn, **trace)
    return out


def phase_serve(torch, workdir: str, vol: dict, deg: dict, seed: int) -> dict:
    """The volume server as an operator starts it, over the volume's
    sidecars and 12 surviving shards (.ec00 and .ec11 still down), a fresh
    server a turn, in turns flat, block-diagonal, block-diagonal, flat: a
    sequential pass of HTTP reads in each layout's first turn, and a
    concurrent pass in every turn.  -> per layout: the launches of all its
    turns, its sequential pass and its concurrent passes."""
    import numpy as np

    from seaweedfs_tpu_torch.storage import ec

    torch.cuda.empty_cache()
    serve_dir = os.path.join(workdir, "serve")
    os.makedirs(serve_dir)
    base = os.path.join(workdir, "1")
    names = [ec.to_ext(s) for s in range(14) if s not in (0, 11)]
    for ext in names + [".ecx", ".ecj", ".vif"]:
        if os.path.exists(base + ext):  # links: no byte is written
            os.link(base + ext, os.path.join(serve_dir, "1" + ext))
    deleted = set(deg["deleted"])
    shard0 = [n for n in deg["on_shard0"] if n not in deleted]
    others = [n for n in deg["picks"] if n not in deleted and n not in set(shard0)]
    rng = np.random.default_rng(seed + 5)
    seq = shard0 + rng.choice(others, size=min(SERVE_EXTRA, len(others)),
                              replace=False).tolist()
    seq_one = rng.choice(seq, size=min(SERVE_SEQ_READS, len(seq)),
                         replace=False).tolist()
    out: dict = {}
    try:
        for turn, layout in enumerate(SERVE_TURNS):
            first = layout not in out
            run = _serve_layout(workdir, serve_dir, layout, seq, vol,
                                sorted(deleted), seed, turn,
                                seq_one if first else [],
                                profile=turn in PROFILE_TURNS)
            row = out.setdefault(layout, {"launches": 0, "concurrent": [],
                                          "trace": []})
            row["launches"] += run["launches"]
            row["concurrent"].append(run["concurrent"])
            row["trace"].append(run["trace"])
            if first:
                row["sequential"] = run["sequential"]
        # tracing's cost: flat turns with -obs.disable and with
        # -obs.tail.disable, concurrent only
        out["flat"]["cost_turns"] = {}
        for i, (flags, reads) in enumerate(COST_TURNS):
            run = _serve_layout(workdir, serve_dir, "flat", seq, vol,
                                sorted(deleted), seed, len(SERVE_TURNS) + i,
                                [], flags=flags, reads=reads)
            out["flat"]["launches"] += run["launches"]
            out["flat"]["cost_turns"][flags[0]] = run["concurrent"]
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    for layout, row in out.items():
        row["launches_per_batch"] = (
            sum(c["launches"] for c in row["concurrent"])
            / sum(c["batches"] for c in row["concurrent"]))
        summary = {
            "stage_mean_ms": [t["stage_mean_ms"] for t in row["trace"]],
            "critpath_share": [t["critpath_share"] for t in row["trace"]],
            "kernel_busy_share": [t["profile"]["kernel_busy_share"]
                                  for t in row["trace"] if "profile" in t],
            "reads_per_s": [c["reads_per_s"] for c in row["concurrent"]],
            "p50_ms": [c["p50_ms"] for c in row["concurrent"]],
        }
        for flag, c in row.get("cost_turns", {}).items():
            summary[flag] = {"reads_per_s": c["reads_per_s"],
                             "p50_ms": c["p50_ms"]}
        log("serve_trace_summary", layout=layout, **summary)
    return out


# --------------------------------------------------------------- phase 6


def phase_rebuild(workdir: str, shard_size: int, k1: tuple) -> dict:
    from seaweedfs_tpu_torch.storage import ec

    base = os.path.join(workdir, "1")
    lost = (0, 5, 10, 13)
    before = {}
    for sid in lost:
        path = base + ec.to_ext(sid)
        if sid == 0:
            path += ".down"
        before[sid] = sha256_file(path)
        os.remove(path)
    os.rename(base + ec.to_ext(11) + ".down", base + ec.to_ext(11))
    stats: dict = {}
    _reset(*k1)
    t0 = time.perf_counter()
    rebuilt = ec.rebuild_ec_files(base, backend="cuda", stats=stats)
    ec.rebuild_ecx_file(base)
    wall = time.perf_counter() - t0
    paths = _k1_counts(*k1)
    launches = paths["gf2_matmul"] + paths["gf2_matmul_small"]
    if sorted(rebuilt) != list(lost) or launches == 0:
        raise AssertionError(f"rebuilt {rebuilt} with {launches} launches")
    for sid in lost:
        if sha256_file(base + ec.to_ext(sid)) != before[sid]:
            raise AssertionError(f"rebuilt shard {sid} differs from the original")
    if os.path.exists(base + ".ecj"):
        raise AssertionError("rebuild_ecx_file left the .ecj journal")
    log("rebuild", shards=list(lost), GBps=10 * shard_size / wall / 1e9,
        wall_s=wall, launches=launches, load_paths=paths, stats=stats)
    return {"wall_s": wall, "launches": launches, "load_paths": paths}


# -------------------------------------------------------------- phase 6a

# the scrub's cache: volume 1's 14 shards (15.75 GiB padded) and the
# in-memory volumes beside them
SCRUB_BUDGET = 24 << 30
SCRUB_TIMED = 10
# the CPU native codec's span in the comparison: this much of each data
# shard file, read into memory first
NATIVE_SPAN = 64 << 20
# in-memory volumes of phase 6a: (vid, shard bytes), two span classes
MEM_VOLUMES = [(101, 32 << 20), (102, 32 << 20), (103, 32 << 20),
               (104, 32 << 20), (105, (8 << 20) + 17), (106, (8 << 20) + 17)]
NO_SCRUB_LIBRARY_CALL = ("no single PyTorch call recomputes the parity, "
                         "compares it and counts per segment")


def _scrub_bound(rr, n_lanes: int, vols: int = 1) -> tuple[float, str]:
    """Least time for one scrub call: the 14 shards' first n_lanes bytes
    read once and the int32 [V, 4, n_seg] partials written once, against
    the int8 ops of the parity product the function needs (4 rows by 10
    shards in bits, 2*32*80 a column)."""
    n_seg = rr._scrub_segments(n_lanes, rr._SCRUB_SEG.bit_length() - 1)
    nbytes = vols * (14 * n_lanes + 4 * 4 * n_seg)
    return _roofline(nbytes, vols * 2 * (8 * 4) * (8 * 10) * n_lanes)


def _flip(torch, buf, positions) -> None:
    """XOR 0x5A into the resident buffer at `positions`, in place."""
    idx = torch.tensor(positions, dtype=torch.long, device=buf.device)
    buf[idx] ^= 0x5A
    torch.cuda.synchronize()


def phase_scrub(torch, workdir: str, seed: int) -> dict:
    """All 14 shards of volume 1 pinned through a port Store: the resident
    scrub in both layouts, clean, corrupted on the card ([1, 1, 5, 1]) and
    restored, held to verify_ec_files on the same files and to the plain
    version's partials; then a pass over the cache with in-memory volumes
    of two spans beside it.  -> the scrub kernel's numbers."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import gf256, rs_cpu
    from seaweedfs_tpu_torch.ops import rs_resident as rr
    from seaweedfs_tpu_torch.storage import ec
    from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
    from seaweedfs_tpu_torch.storage.store import Store

    torch.cuda.empty_cache()
    scrub_dir = os.path.join(workdir, "scrub")
    os.makedirs(scrub_dir)
    base = os.path.join(workdir, "1")
    for ext in [ec.to_ext(s) for s in range(14)] + [".ecx", ".ecj", ".vif"]:
        if os.path.exists(base + ext):  # links: no byte is written
            os.link(base + ext, os.path.join(scrub_dir, "1" + ext))
    cache = rr.DeviceShardCache(device="cuda", budget_bytes=SCRUB_BUDGET)
    t0 = time.perf_counter()
    store = Store([DiskLocation(scrub_dir)], ec_backend="cuda",
                  ec_device_cache=cache)
    launches = 0

    def window(fn):
        """Run `fn` on the main path with the scrub count set to 0 just
        before it and read just after: -> (its result, launches)."""
        rr.scrub.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, rr.scrub.launches

    try:
        ev = store.find_ec_volume(1)
        while cache.resident_count(1) < 14:
            if time.perf_counter() - t0 > SERVE_PIN_TIMEOUT:
                raise AssertionError(f"pinned {cache.shard_ids(1)}")
            time.sleep(0.1)
        torch.cuda.synchronize()
        pin_s = time.perf_counter() - t0
        true_size = cache.shard_size(1, 0)
        if not ev.is_device_resident():
            raise AssertionError("volume 1 is not resident")

        def scrub_both():
            got = {}
            for layout in ("flat", "blockdiag"):
                cache.layout = layout
                t1 = time.perf_counter()
                got[layout] = store.scrub_ec(ev)
                got[layout]["wall_s"] = time.perf_counter() - t1
            return got

        d2h0 = rr.scrub.d2h_bytes
        clean, n = window(scrub_both)
        launches += n
        d2h_per_call = (rr.scrub.d2h_bytes - d2h0) / n
        for layout, r in clean.items():
            if (r["backend"], r["parity_mismatch_bytes"]) != (
                    "device_resident", [0, 0, 0, 0]):
                raise AssertionError(f"clean {layout} scrub: {r}")
        # the int32 partials: 4 parity rows x the 256 MiB segments
        want_d2h = 4 * 4 * -(-true_size // rr._SCRUB_SEG)
        if n != 2 or d2h_per_call != want_d2h:
            raise AssertionError(f"{n} launches, {d2h_per_call} D2H bytes a "
                                 f"call (want {want_d2h})")
        # the same files through the file-backed scrub, and the CPU codec
        t1 = time.perf_counter()
        file_mism, file_span = ec.verify_ec_files(base, backend="cuda")
        file_wall = time.perf_counter() - t1
        if file_mism != clean["flat"]["parity_mismatch_bytes"]:
            raise AssertionError(f"verify_ec_files found {file_mism}")
        data = np.stack([np.fromfile(base + ec.to_ext(s), dtype=np.uint8,
                                     count=NATIVE_SPAN) for s in range(10)])
        parity = gf256.build_matrix(10, 14)[10:]
        t1 = time.perf_counter()
        rs_cpu.apply_matrix_native(parity, data)
        native_s = time.perf_counter() - t1
        log("scrub", state="clean", shard_bytes=true_size, pin_s=pin_s,
            padded_bytes=cache.bytes_used,
            resident={k: {"mismatch": r["parity_mismatch_bytes"],
                          "bytes_verified": r["bytes_verified"],
                          "wall_s": r["wall_s"],
                          "GBps": 14 * r["bytes_verified"] / r["wall_s"] / 1e9}
                      for k, r in clean.items()},
            launches=n, d2h_bytes_per_call=d2h_per_call,
            verify_ec_files={"mismatch": file_mism, "bytes_verified": file_span,
                             "wall_s": file_wall,
                             "GBps": 14 * file_span / file_wall / 1e9},
            rs_cpu_native={"span_bytes_per_shard": NATIVE_SPAN,
                           "seconds": native_s,
                           "GBps": 14 * NATIVE_SPAN / native_s / 1e9,
                           "volume_s_at_that_rate": native_s * true_size
                           / NATIVE_SPAN})

        # corrupt on the card: parity shard 12 at both ends of the first
        # counting segment and at the true end, data shard 3 once
        seg = rr._SCRUB_SEG
        par_at = [0, seg - 1, seg, true_size - 1]
        data_at = [2 * seg + 12345]
        _flip(torch, cache.get(1, 12), par_at)
        _flip(torch, cache.get(1, 3), data_at)
        bad, n = window(scrub_both)
        launches += n
        for layout, r in bad.items():
            if r["parity_mismatch_bytes"] != [1, 1, 5, 1]:
                raise AssertionError(f"corrupt {layout} scrub: {r}")
        # the partials against the plain version, and the kernel's time
        vol = tuple(cache.get(1, s) for s in range(14))
        rows = {}
        for layout, groups in (("flat", 1), ("blockdiag", cache.groups)):
            n_lanes = bad[layout]["bytes_verified"]
            a = rr._scrub_matrix(10, 14, groups, "cuda")
            got = rr.scrub(a, [vol], n_lanes=n_lanes, groups=groups)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want = rr._scrub_torch(a, [vol], k=10, n_lanes=n_lanes,
                                   groups=groups,
                                   seg_log2=seg.bit_length() - 1)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t1) * 1e3
            diff = (got.long() - want.long()).abs()
            old = rr.scrub_cuda_cores(a, [vol], n_lanes=n_lanes, groups=groups)
            old_diff = (old.long() - want.long()).abs()
            # in turns: tensor cores, CUDA cores, CUDA cores, tensor cores
            turns = {"ms": [], "previous_ms": []}
            for key in ("ms", "previous_ms", "previous_ms", "ms"):
                fn = rr.scrub if key == "ms" else rr.scrub_cuda_cores
                turns[key].append(_median_ms(torch, lambda: fn(
                    a, [vol], n_lanes=n_lanes, groups=groups), SCRUB_TIMED))
            ms = statistics.mean(turns["ms"])
            prev_ms = statistics.mean(turns["previous_ms"])
            bound_ms, bound_by = _scrub_bound(rr, n_lanes)
            rows[layout] = {
                "n_lanes": n_lanes, "partials": got[0].tolist(),
                "max_abs_err": int(diff.max()),
                "mismatched_bytes": int((diff != 0).sum()),
                "ms": ms, "ms_turns": turns["ms"], "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / ms,
                "GBps": 14 * n_lanes / ms / 1e6,
                # the earlier CUDA-core kernel, timed in the same turns
                "previous_ms": prev_ms,
                "previous_ms_turns": turns["previous_ms"],
                "previous_share_of_bound": bound_ms / prev_ms,
                "previous_max_abs_err": int(old_diff.max())}
            if diff.any() or old_diff.any():
                raise AssertionError(
                    f"{layout} partials {got[0].tolist()} (CUDA cores "
                    f"{old[0].tolist()}) differ from the plain "
                    f"{want[0].tolist()}")
        _flip(torch, cache.get(1, 12), par_at)  # XOR again: restored
        _flip(torch, cache.get(1, 3), data_at)
        restored, n = window(scrub_both)
        launches += n
        if any(r["parity_mismatch_bytes"] != [0] * 4 for r in restored.values()):
            raise AssertionError(f"restored scrub: {restored}")
        log("scrub", state="corrupted then restored",
            parity_shard_12_bytes=par_at, data_shard_3_bytes=data_at,
            corrupt={k: r["parity_mismatch_bytes"] for k, r in bad.items()},
            restored={k: r["parity_mismatch_bytes"] for k, r in restored.items()},
            # Store.scrub_ec walls after the clean pass's first calls
            wall_s={k: [bad[k]["wall_s"], restored[k]["wall_s"]] for k in bad},
            kernel=rows, library_ms=None, library_note=NO_SCRUB_LIBRARY_CALL)

        # in-memory volumes beside volume 1, one of them corrupt
        rng = np.random.default_rng(seed + 7)
        want_mem = {}
        for vid, size in MEM_VOLUMES:
            d = rng.integers(0, 256, (10, size), dtype=np.uint8)
            shards = np.concatenate([d, rs_cpu.apply_matrix_native(parity, d)])
            want_mem[vid] = [0, 0, 0, 0]
            if vid == 103:
                shards[11, 12345] ^= 1
                shards[0, size - 1] ^= 1
                want_mem[vid] = [1, 2, 1, 1]
            for sid in range(14):
                cache.put(vid, sid, shards[sid])
        cache.layout = "flat"

        def pass_and_singles():
            return (rr.scrub_all_resident(cache),
                    {vid: rr.scrub_volume(cache, vid)
                     for vid in [1] + [v for v, _ in MEM_VOLUMES]})

        ((res, st), singles), n = window(pass_and_singles)
        launches += n
        if res != singles or st != {"device_calls": 3, "volumes": 7}:
            raise AssertionError(f"pass {res} {st} against {singles}")
        if any(res[v][0] != want_mem[v] for v in want_mem):
            raise AssertionError(f"in-memory verdicts {res}")
        log("scrub", state="pass over the cache", volumes=st["volumes"],
            device_calls=st["device_calls"], launches=n,
            spans=sorted({span for _, span in res.values()}),
            verdicts={v: r[0] for v, r in res.items()})
    finally:
        store.close()
        cache.clear()
        shutil.rmtree(scrub_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows,
            "d2h_bytes_per_call": d2h_per_call}


# -------------------------------------------------------------- phase 6b

SCRUB_SERVE_CACHE_MB = 32 << 10
SCRUB_INTERVAL_S = 2
# reads of phase 6b's concurrent pass: half of 5c's, so the phase keeps
# the script well inside its time limit; reads/s is what is compared
SCRUB_SERVE_READS = SERVE_READS // 2
SMALL_VOLUME_BYTES = 64 << 20


def _get_json(port: int, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def _small_volume(dirname: str, vid: int, seed: int) -> None:
    """A SMALL_VOLUME_BYTES volume written and EC-encoded by the port, its
    .dat and .idx removed and one parity byte (.ec10) flipped on disk."""
    import numpy as np

    from seaweedfs_tpu_torch.storage import ec
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume

    rng = np.random.default_rng(seed)
    v = Volume(dirname, vid)
    nid = 0
    while v.content_size < SMALL_VOLUME_BYTES:
        nid += 1
        v.append_needle(Needle(id=nid, cookie=int(rng.integers(0, 1 << 32)),
                               data=rng.bytes(int(rng.integers(4096, 1 << 20)))))
    v.sync()
    v.close()
    base = os.path.join(dirname, str(vid))
    ec.write_ec_files(base, backend="cuda")
    ec.write_sorted_file_from_idx(base)
    for ext in (".dat", ".idx"):
        os.remove(base + ext)
    with open(base + ec.to_ext(10), "r+b") as f:
        f.seek(1000)
        b = f.read(1)
        f.seek(1000)
        f.write(bytes([b[0] ^ 0xFF]))


def phase_scrub_serve(torch, workdir: str, vol: dict, deg: dict,
                      serve: dict, seed: int) -> dict:
    """The volume server with the scrub loop running (-ec.scrub.
    intervalSeconds) over three volumes: vid 1 (all 14 shards, full width),
    vid 2 (the same files minus shards 0 and 11, served) and vid 3 (a small
    volume with a corrupt parity byte on disk).  The loop's pass over the
    cache flags vid 3 and launches once per span class a cycle while 64
    clients read vid 2; the device ledger splits the card's time."""
    import numpy as np

    from seaweedfs_tpu_torch.storage import ec

    torch.cuda.empty_cache()
    serve_dir = os.path.join(workdir, "scrub_serve")
    os.makedirs(serve_dir)
    base = os.path.join(workdir, "1")
    with open(base + ".vif") as f:
        vif = json.load(f)
    if set(vif) - {"version"} or os.path.getsize(base + ".ecx") % 16:
        raise AssertionError(f"a sidecar holds more than needle entries: {vif}")
    for ext in [ec.to_ext(s) for s in range(14)] + [".ecx", ".ecj", ".vif"]:
        if os.path.exists(base + ext):  # links: no byte is written
            os.link(base + ext, os.path.join(serve_dir, "1" + ext))
            if ext not in (ec.to_ext(0), ec.to_ext(11)):
                os.link(base + ext, os.path.join(serve_dir, "2" + ext))
    _small_volume(serve_dir, 3, seed + 11)
    deleted = set(deg["deleted"])
    picks = [n for n in deg["picks"] if n not in deleted]
    rng = np.random.default_rng(seed + 13)
    seq = rng.choice(picks, size=min(len(picks), 4000), replace=False).tolist()

    port = _free_port()
    args = ["-dir", serve_dir, "-port", str(port), "-mserver", "",
            "-ec.backend", "cuda", "-ec.deviceCacheMB", str(SCRUB_SERVE_CACHE_MB),
            "-ec.scrub.intervalSeconds", str(SCRUB_INTERVAL_S)]
    try:
        with _volume_server(args, os.path.join(workdir, "scrub_serve.log")) \
                as proc:
            out = _scrub_serve_run(proc, port, vol, seq, serve, seed)
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    return out


def _scrub_serve_run(proc, port: int, vol: dict, seq: list, serve: dict,
                     seed: int) -> dict:
    """Phase 6b against the started server `proc` on `port`."""
    mk = 'SeaweedFS_volumeServer_ec_scrub_device_dispatch_total{mode="megakernel"}'
    pv = 'SeaweedFS_volumeServer_ec_scrub_device_dispatch_total{mode="per_volume"}'
    gauge = "SeaweedFS_volumeServer_ec_scrub_corrupt_volumes"
    kern = 'SeaweedFS_volumeServer_ec_kernel_launches_total{kernel="scrub"}'
    t0 = time.perf_counter()
    want = {1: 14, 2: 12, 3: 14}
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"volume server exited ({proc.returncode})")
        if time.perf_counter() - t0 > 2 * SERVE_PIN_TIMEOUT:
            raise AssertionError("volumes not resident in time")
        try:
            ecv = _get_json(port, "/status")["EcVolumes"]
        except OSError:
            ecv = []
        got = {v["id"]: len(v["resident"]) for v in ecv}
        if got == want:
            break
        time.sleep(0.2)
    pin_s = time.perf_counter() - t0
    # cycles that began while the volumes were pinning may have scrubbed
    # one by one; two whole passes (4 dispatches) after residency, the
    # loop is in its steady state and vid 3 is flagged
    t1 = time.perf_counter()
    mk_resident = _scrape(port)[mk]
    while True:
        m = _scrape(port)
        if m.get(gauge) == 1 and m[mk] >= mk_resident + 4:
            break
        if time.perf_counter() - t1 > 10 * SCRUB_INTERVAL_S + 60:
            raise AssertionError(f"corrupt gauge {m.get(gauge)}, "
                                 f"megakernel {m[mk]}")
        time.sleep(0.2)
    steady_s = time.perf_counter() - t1
    m0, w0 = _scrape(port), time.perf_counter()
    ledger0 = _get_json(port, "/debug/device/attribution")
    before = _serve_counts(m0)
    con = _serve_concurrent(port, [
        (nid, vol["needles"][nid][3], vol["needles"][nid][2])
        for nid in seq], seed + 17, vid=2, reads=SCRUB_SERVE_READS)
    m1, w1 = _scrape(port), time.perf_counter()
    ledger1 = _get_json(port, "/debug/device/attribution")
    d = _serve_delta(before, _serve_counts(m1))
    if d["routes"]["native"] or d["fallback"]:
        raise AssertionError(f"{d['routes']['native']} reads of vid 2 took "
                             "the native route once resident")
    if m1[pv] != m0[pv] or m1[gauge] != 1:
        raise AssertionError(f"per_volume {m0[pv]} -> {m1[pv]} during "
                             f"the pass, gauge {m1[gauge]}")
    tiers = _tier_series(m1)
    if any(tiers["promotions"].values()) or any(tiers["demotions"].values()):
        raise AssertionError(f"the ladder moved volumes during 6b: {tiers}")
    cycles_mk = m1[mk] - m0[mk]
    if cycles_mk < 2:
        raise AssertionError(f"{cycles_mk} megakernel dispatches during "
                             "the concurrent pass")
    wl = ledger1["workloads"]
    if wl.get("untagged", {}).get("busy_s", 0.0) != 0.0:
        raise AssertionError(f"untagged device time: {wl['untagged']}")

    def busy(doc, cls):
        return doc["workloads"].get(cls, {}).get("busy_s", 0.0)

    split = {cls: {"busy_s": busy(ledger1, cls),
                   "busy_s_during_pass": busy(ledger1, cls) - busy(ledger0, cls),
                   "dispatches": wl.get(cls, {}).get("dispatches", 0)}
             for cls in ("scrub", "serving_interactive", "serving_bulk")}
    wall = con["wall"]
    flat = serve["flat"]["concurrent"][0]
    out = {"launches": int(m1[kern]), "pin_s": pin_s,
           "reads_per_s": len(con["lat"]) / wall,
           "megakernel_per_s": cycles_mk / (w1 - w0)}
    log("scrub_serve", volumes=want, pin_s=pin_s,
        steady_after_s=steady_s, corrupt_volumes=m1[gauge],
        megakernel_dispatches=m1[mk],
        per_volume_dispatches_while_pinning=m0[pv],
        megakernel_during_pass=cycles_mk,
        per_volume_during_pass=m1[pv] - m0[pv],
        megakernel_per_cycle_expected=2,
        scrub_interval_s=SCRUB_INTERVAL_S, scrub_launches=m1[kern],
        reads=len(con["lat"]), wall_s=wall,
        reads_per_s=out["reads_per_s"],
        p50_ms=_pct(con["lat"], 50), p99_ms=_pct(con["lat"], 99),
        MBps=con["bytes"] / wall / 1e6,
        serve_flat_turn0_reads_per_s=flat["reads_per_s"],
        serve_flat_turn0_p50_ms=flat["p50_ms"],
        batches=d["batches"], routes=d["routes"],
        ledger=split, ledger_total_busy_s=ledger1["total_busy_seconds"],
        untagged_busy_s=0.0, tier_volumes=tiers["volumes"], tier_moves=0)
    return out


# --------------------------------------------------------------- phase 7


def phase_decode(workdir: str, vol: dict) -> None:
    from seaweedfs_tpu_torch.storage import ec

    base = os.path.join(workdir, "1")
    os.remove(base + ".dat")
    t0 = time.perf_counter()
    size = ec.write_dat_file(base)
    wall = time.perf_counter() - t0
    if size != vol["dat_size"] or sha256_file(base + ".dat") != vol["dat_sha"]:
        raise AssertionError("decoded .dat differs from the original")
    log("decode", dat_bytes=size, GBps=size / wall / 1e9, wall_s=wall,
        sha256_equal=True)


# --------------------------------------------------------------- phase 8

# the .dat each ingest turn streams (25 stripe rows).  8 GiB would be 819
# rows; a call may write 45 GiB to the H100 machine's disk, deleted files
# counted, and the main path writes 3.8x its 11 GiB volume (about 42
# GiB), phase 9 about 1.5 GiB.  This phase writes 4.8x its .dat: the
# fsync turn's .dat, parity scratch and data shards (2.4x), the default
# turn's .dat and scratch (1.4x), the turn without the plane's .dat; the
# offline encodes it is held against are hashed in memory
INGEST_DAT_BYTES = 256 << 20
INGEST_VID = 7
INGEST_WRITERS = 32
INGEST_WRITER_PROCS = 4
INGEST_POOL_BYTES = 64 << 20
# the streamed row: [10, 1 MiB] -> 4 parity rows, K1's ingest shape
INGEST_ROW = 1 << 20


class _InProcessServer:
    """A port VolumeServer built from volume-command flags (the user's
    entry point) and served by an event loop on its own thread of this
    process, so the phase can call its Store (ec_generate, mounts) and
    read its counters in place; clients reach it over HTTP."""

    def __init__(self, argv: list):
        from seaweedfs_tpu_torch import command

        args = command.parser().parse_args(["volume", *argv])
        self.vs = command.volume.build_server(args)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="volume-server", daemon=True)

    def __enter__(self):
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.vs.start(), self.loop).result(60)
        return self

    def __exit__(self, *exc):
        try:
            asyncio.run_coroutine_threadsafe(self.vs.stop(), self.loop).result(300)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(60)
            self.loop.close()

    @property
    def port(self) -> int:
        return self.vs.port


def _ingest_needles(seed: int, total: int) -> list:
    """(nid, cookie, pool offset, size) of the needles an ingest turn
    POSTs, sizes log-uniform over MIN_NEEDLE..MAX_NEEDLE as phase 3's,
    until `total` body bytes; bodies are slices of a seeded pool."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = np.log(MIN_NEEDLE), np.log(MAX_NEEDLE)
    out, acc = [], 0
    while acc < total:
        size = int(np.exp(rng.uniform(lo, hi)))
        out.append((len(out) + 1, int(rng.integers(0, 1 << 32)),
                    int(rng.integers(0, INGEST_POOL_BYTES - size)), size))
        acc += size
    return out


def _ingest_pool(seed: int) -> bytes:
    import numpy as np

    return np.random.default_rng(seed + 1).bytes(INGEST_POOL_BYTES)


async def _ingest_clients(port: int, vid: int, needles: list, n_clients: int,
                          pool: bytes):
    """`n_clients` keep-alive writers POST their share of `needles` in
    order: -> (ack seconds per write, body bytes)."""
    from seaweedfs_tpu_torch.server.http import Client
    from seaweedfs_tpu_torch.storage import types as t

    lat: list = []
    nbytes = [0]
    view = memoryview(pool)

    async def client(i: int) -> None:
        c = Client("127.0.0.1", port)
        try:
            for nid, cookie, off, size in needles[i::n_clients]:
                t0 = time.perf_counter()
                status, _, body = await c.request(
                    "POST", "/" + t.format_fid(vid, nid, cookie),
                    {"Content-Type": "application/octet-stream"},
                    bytes(view[off:off + size]))
                lat.append(time.perf_counter() - t0)
                if status != 200:
                    raise AssertionError(f"needle {nid}: HTTP {status} {body[:200]}")
                nbytes[0] += size
        finally:
            await c.close()

    await asyncio.gather(*(client(i) for i in range(n_clients)))
    return lat, nbytes[0]


def _ingest_writer_proc(port: int, vid: int, seed: int, needles: list,
                        n_clients: int) -> dict:
    """One writer process of an ingest turn (run under spawn)."""
    sys.path.insert(0, HERE)
    pool = _ingest_pool(seed)
    t0 = time.monotonic()
    lat, nbytes = asyncio.run(_ingest_clients(port, vid, needles, n_clients, pool))
    return {"lat": lat, "bytes": nbytes, "start": t0, "end": time.monotonic()}


def _ingest_write(port: int, seed: int, needles: list) -> dict:
    """INGEST_WRITERS writers in INGEST_WRITER_PROCS processes POST every
    needle of `needles` once: -> ack latencies, bytes, wall."""
    import concurrent.futures
    import multiprocessing

    per = INGEST_WRITERS // INGEST_WRITER_PROCS
    with concurrent.futures.ProcessPoolExecutor(
            INGEST_WRITER_PROCS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = [pool.submit(_ingest_writer_proc, port, INGEST_VID, seed,
                            needles[i::INGEST_WRITER_PROCS], per)
                for i in range(INGEST_WRITER_PROCS)]
        parts = [f.result() for f in futs]
    return {"lat": [x for p in parts for x in p["lat"]],
            "bytes": sum(p["bytes"] for p in parts),
            "wall": max(p["end"] for p in parts) - min(p["start"] for p in parts)}


def _ingest_series(m: dict) -> dict:
    """The ingest plane's series from one _scrape."""
    name = "SeaweedFS_volumeServer_ingest_%s"
    return {
        "bytes": m[name % "bytes_total"],
        "rows_device": m[name % 'rows_total{path="device"}'],
        "rows_host": m[name % 'rows_total{path="host"}'],
        "arena_waits": m[name % "backpressure_total"],
        "shed": {r: m[name % f'shed_total{{reason="{r}"}}']
                 for r in ("qos", "deadline", "arena")},
        "fsyncs": m[name % "fsyncs_total"],
        "fsync_writes": m[name % "fsync_writes_total"],
        "seals": {p: m[name % f'seals_total{{path="{p}"}}']
                  for p in ("streamed", "offline")},
    }


def _shard_hashes(base: str) -> list:
    from seaweedfs_tpu_torch.storage import ec

    return [sha256_file(base + ec.to_ext(i)) for i in range(14)]


def _card_shard_hashes(dat: str) -> tuple[list, float]:
    """The 14 shards' sha256 as the offline encode on the card makes them
    from `dat` (write_ec_files's stripe plan, bulk pipeline and card
    codec), hashed in memory instead of written: -> (hashes, wall s)."""
    from seaweedfs_tpu_torch.ops import gf256
    from seaweedfs_tpu_torch.storage.ec import bulk, encoder
    from seaweedfs_tpu_torch.storage.ec.layout import (
        LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)

    size = os.path.getsize(dat)
    stride = encoder._resolve_stride(None)
    plan = []
    for row_start, block in encoder._iter_rows(size, LARGE_BLOCK_SIZE,
                                               SMALL_BLOCK_SIZE):
        step = min(stride, block)
        if block % step:
            step = block
        plan.extend((row_start, block, off, step) for off in range(0, block, step))
    hashes = [hashlib.sha256() for _ in range(14)]
    codec = bulk.Codec(gf256.parity_matrix(10, 14), "cuda",
                       threaded=bulk.DEFAULT.overlap, workload="bulk")
    t0 = time.perf_counter()
    try:
        with open(dat, "rb") as f:
            def read_batch(desc):
                return bulk.read_stripe(f, size, *desc)

            def hash_batch(desc, data, parity):
                for i in range(10):
                    hashes[i].update(data[i])
                for i in range(4):
                    hashes[10 + i].update(parity[i])

            bulk.run("encode", plan, read_batch, codec, hash_batch,
                     overlap=bulk.DEFAULT.overlap)
    finally:
        codec.shutdown()
    return [h.hexdigest() for h in hashes], time.perf_counter() - t0


def _native_shard_hashes(dat: str) -> tuple[list, float]:
    """The 14 shards' sha256 as the native CPU codec encodes `dat`, stripe
    row by stripe row, hashed in memory (no shard is written): -> (hashes,
    wall s)."""
    from seaweedfs_tpu_torch.ops import gf256, rs_cpu
    from seaweedfs_tpu_torch.storage.ec import bulk
    from seaweedfs_tpu_torch.storage.ec.encoder import _iter_rows
    from seaweedfs_tpu_torch.storage.ec.layout import (
        LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)

    parity = gf256.parity_matrix(10, 14)
    hashes = [hashlib.sha256() for _ in range(14)]
    size = os.path.getsize(dat)
    t0 = time.perf_counter()
    with open(dat, "rb") as f:
        for row_start, block in _iter_rows(size, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE):
            stripe = bulk.read_stripe(f, size, row_start, block, 0, block)
            out = rs_cpu.apply_matrix_native(parity, stripe)
            for i in range(10):
                hashes[i].update(stripe[i])
            for i in range(4):
                hashes[10 + i].update(out[i])
    return [h.hexdigest() for h in hashes], time.perf_counter() - t0


def _ingest_kernel_row(torch, seed: int) -> dict:
    """K1 at the streamed row's shape, x[10, 1 MiB] -> 4 rows: held equal
    to its plain version and the numpy oracle's sample, then the CUDA-event
    medians of the kernel alone (inputs cold in L2), of the row's device
    window (H2D from a pinned slot, the kernel, D2H into pinned parity),
    of the plain version and of torch._int_mm on the same operands, and
    the encoder's own call (StreamEncoder.encode, host wall) against the
    plain version's bytes.  Launches here are outside the main path's
    count."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import gf256, rs_cpu, rs_cuda, rs_ingest

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 8)
    parity = gf256.parity_matrix(10, 14)
    a = rs_cuda.prepare_matrix(parity, dev)
    x = torch.randint(0, 256, (10, INGEST_ROW), dtype=torch.uint8, device=dev,
                      generator=gen)
    got = rs_cuda.gf2_matmul(a, x, 4)
    ref = rs_cuda._apply_torch(a, x, 4)
    torch.cuda.synchronize()
    diff = got.to(torch.int16) - ref.to(torch.int16)
    row = {"shape": [10, INGEST_ROW, 4],
           "mismatched_bytes": int((diff != 0).sum().item()),
           "max_abs_err": int(diff.abs().max().item())}
    host_x = x.cpu().numpy()
    oracle = rs_cpu.apply_matrix_numpy(parity, host_x[:, :65536])
    row["oracle_sample_mismatched"] = int(
        (got[:, :65536].cpu().numpy() != oracle).sum())
    enc = rs_ingest.StreamEncoder("cuda")
    slot = rs_ingest.IngestArena(10, INGEST_ROW, slots=1, pin=True)
    buf = slot.stage(1)
    buf[:] = host_x
    enc_out = enc.encode(buf)
    row["encoder_mismatched_bytes"] = int((enc_out != ref.cpu().numpy()).sum())
    if row["mismatched_bytes"] or row["oracle_sample_mismatched"] \
            or row["encoder_mismatched_bytes"]:
        log("ingest_kernel", **row)
        raise AssertionError("K1 at the ingest shape disagrees with its plain version")
    xs = itertools.cycle([x] + [
        torch.randint(0, 256, (10, INGEST_ROW), dtype=torch.uint8, device=dev,
                      generator=gen) for _ in range(12)])
    row["ms"] = _median_ms(torch, lambda: rs_cuda.gf2_matmul(a, next(xs), 4), 30)
    src = torch.from_numpy(buf)  # the pinned slot
    x_dev = torch.empty_like(x)
    par = torch.empty((4, INGEST_ROW), dtype=torch.uint8, pin_memory=True)

    def window():
        x_dev.copy_(src, non_blocking=True)
        par.copy_(rs_cuda.gf2_matmul(a, x_dev, 4), non_blocking=True)

    row["window_ms"] = _median_ms(torch, window, 30)
    row["plain_ms"] = _median_ms(
        torch, lambda: rs_cuda._apply_torch(a, next(xs), 4), 5, warmup=1)
    row["library_ms"] = _int_mm_ms(torch, a, x)
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        enc.encode(buf)
        walls.append(time.perf_counter() - t0)
    row["encode_call_ms"] = statistics.median(walls) * 1e3
    row["bound_ms"], row["bound_by"] = _bound(10, INGEST_ROW, 4)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["window_share_of_bound"] = row["bound_ms"] / row["window_ms"]
    slot.reclaim(buf)
    log("ingest_kernel", **row)
    del x, xs, got, ref, diff
    return row


# phase 8's turns: the server's flags and whether the turn ends in the
# streamed seal
INGEST_TURNS = {
    "fsync": (["-ec.ingest.fsync"], True),  # group-commit fsync, sealed
    "default": ([], False),  # the plane as a server starts by default
    "disable": (["-ec.ingest.disable"], False),  # no plane
}


def _ingest_turn(workdir: str, needles: list, seed: int, turn: str) -> dict:
    """One turn of INGEST_TURNS: an in-process server over an empty
    volume, the writers, and for the sealed turn the streamed seal
    (ec_generate).  -> the turn's figures and, with the plane on, the
    turn's K1 launches; the sealed turn's shard hashes."""
    from seaweedfs_tpu_torch.obs import devledger
    from seaweedfs_tpu_torch.ops import rs_cuda, rs_resident
    from seaweedfs_tpu_torch.storage.volume import Volume

    flags, seal = INGEST_TURNS[turn]
    ingest = turn != "disable"
    # what was written before (the main path's decode, the turn before)
    # is flushed first: this turn's fsyncs must not wait behind its
    # writeback
    os.sync()
    d = os.path.join(workdir, "ingest")
    os.makedirs(d)
    argv = ["-dir", d, "-port", "0", "-mserver", "", "-ec.backend", "cuda", *flags]
    with _InProcessServer(argv) as srv:
        vs = srv.vs
        vs.store.add_volume(INGEST_VID)
        if (vs.ingest is not None) != ingest:
            raise AssertionError("the ingest plane is not as the flags say")
        kernels = (rs_cuda.gf2_matmul, rs_cuda.gf2_matmul_small,
                   rs_resident.fused_reconstruct,
                   rs_resident.fused_reconstruct_blockdiag, rs_resident.scrub)
        _reset(*kernels)
        busy0 = devledger.LEDGER.busy_by_workload().get("ingest", 0.0)
        m0 = _ingest_series(_scrape(srv.port))
        w = _ingest_write(srv.port, seed, needles)
        m1 = _ingest_series(_scrape(srv.port))
        dat_size = vs.store.find_volume(INGEST_VID).content_size
        pipe = vs.ingest.pipelines.get(INGEST_VID) if ingest else None
        rows = dat_size // (10 * INGEST_ROW)
        if ingest:  # the last rows' encodes, before the ledger is read
            t0 = time.monotonic()
            while pipe.valid and pipe.encoded_rows < rows:
                if time.monotonic() - t0 > 60:
                    raise AssertionError(f"{turn}: rows still encoding")
                time.sleep(0.01)
        ingest_busy_s = devledger.LEDGER.busy_by_workload().get("ingest", 0.0) - busy0
        seal_s = None
        if seal:
            t0 = time.perf_counter()
            vs.store.ec_generate(INGEST_VID)
            seal_s = time.perf_counter() - t0
        m2 = _ingest_series(_scrape(srv.port))
        launches = _k1_counts(rs_cuda.gf2_matmul, rs_cuda.gf2_matmul_small)
        others = {k.__name__: k.launches for k in kernels[2:]}
        enc = vs.ingest.encoder if ingest else None
    base = Volume.base_name(d, INGEST_VID)
    lat = w["lat"]
    out = {
        "flags": flags, "needles": len(lat), "dat_bytes": dat_size,
        "wall_s": w["wall"], "writes_per_s": len(lat) / w["wall"],
        "MBps": w["bytes"] / w["wall"] / 1e6,
        "ack_p50_ms": _pct(lat, 50), "ack_p99_ms": _pct(lat, 99),
        "writers": INGEST_WRITERS, "writer_procs": INGEST_WRITER_PROCS,
        "fsyncs": m1["fsyncs"] - m0["fsyncs"],
        "fsync_writes": m1["fsync_writes"] - m0["fsync_writes"],
        "arena_waits": m1["arena_waits"] - m0["arena_waits"],
        "sheds": {r: m1["shed"][r] - m0["shed"][r] for r in m1["shed"]},
        "seal_s": seal_s,
        "seals": {p: m2["seals"][p] - m0["seals"][p] for p in m2["seals"]},
        "launches": launches, "other_kernel_launches": others,
    }
    out["writes_per_fsync"] = out["fsync_writes"] / max(1.0, out["fsyncs"])
    if not ingest:
        if any(launches.values()):
            # without the plane a write launches nothing
            raise AssertionError(f"the turn without the plane launched {launches}")
        return out
    tail = int(seal and dat_size % (10 * INGEST_ROW) > 0)
    out.update(
        rows_completed=rows, rows_encoded=pipe.encoded_rows,
        rows_device=pipe.rows_device, rows_host=pipe.rows_host,
        encoder_rows={"device": enc.device_rows, "host": enc.host_rows,
                      "failed": enc.failed_rows},
        rows_series={"device": m2["rows_device"] - m0["rows_device"],
                     "host": m2["rows_host"] - m0["rows_host"]},
        valid=pipe.valid, reason=pipe.invalid_reason or "",
        ingest_busy_s=ingest_busy_s,
        ingest_busy_share_of_write_wall=ingest_busy_s / w["wall"])
    if not (pipe.valid and pipe.encoded_rows == rows == pipe.rows_device
            and pipe.rows_host == 0 and enc.host_rows == 0):
        raise AssertionError(f"{turn}: streamed rows: {out}")
    if out["seals"] != {"streamed": int(seal), "offline": 0}:
        raise AssertionError(f"{turn}: seals {out['seals']}")
    if bool(out["fsyncs"]) != seal:
        raise AssertionError(f"{turn}: {out['fsyncs']} fsyncs")
    # one launch a streamed row (and the tail row's at the seal), all on
    # the aligned path; nothing else launched
    if launches["gf2_matmul"] != rows + tail or launches["aligned"] != rows + tail \
            or launches["gf2_matmul_small"] or any(others.values()):
        raise AssertionError(f"{turn}: launches {launches} {others} for {rows} rows")
    if seal:
        out["hashes"] = _shard_hashes(base)
    return out


def phase_ingest(torch, workdir: str, seed: int) -> dict:
    """The write path with the streaming ingest plane: 32 writers in 4
    processes POST seeded 4 KB-1 MB needles to an in-process server
    (-ec.backend cuda) until the .dat holds INGEST_DAT_BYTES, every
    completed stripe row encoded on the card (K1) as it fills, in three
    turns on the same needles: -ec.ingest.fsync, then the streamed seal,
    held byte-equal to the offline encodes of the same .dat on the card
    and on the native CPU codec (hashed in memory); the plane with the
    server's defaults (no group-commit fsync); -ec.ingest.disable.  The
    default turn against the fsync turn is the group commit's cost, the
    turn without the plane against the default turn the plane's own."""
    torch.cuda.empty_cache()
    k1 = _ingest_kernel_row(torch, seed)
    needles = _ingest_needles(seed + 80, INGEST_DAT_BYTES)
    turns = {}
    try:
        for turn in INGEST_TURNS:
            out = _ingest_turn(workdir, needles, seed + 80, turn)
            if "hashes" in out:
                dat = os.path.join(workdir, "ingest", f"{INGEST_VID}.dat")
                card, card_s = _card_shard_hashes(dat)
                native, native_s = _native_shard_hashes(dat)
                if not out.pop("hashes") == card == native:
                    raise AssertionError("the streamed seal's shards differ from "
                                         "the offline encodes of the same .dat")
                out.update(offline_card_encode_s=card_s, native_encode_s=native_s,
                           shards_equal={"offline_cuda": True, "native": True})
            shutil.rmtree(os.path.join(workdir, "ingest"))
            turns[turn] = out
            log("ingest", turn=turn, **out)
    finally:
        shutil.rmtree(os.path.join(workdir, "ingest"), ignore_errors=True)
    sealed = turns["fsync"]
    log("ingest_summary", dat_bytes=sealed["dat_bytes"],
        reduced={"dat_gib": [8, INGEST_DAT_BYTES / (1 << 30)],
                 "why": "a call may write 45 GiB to the H100 machine's disk, "
                        "and the main path's 11 GiB volume writes 42"},
        streamed_seal_s=sealed["seal_s"],
        offline_card_encode_in_memory_s=sealed["offline_card_encode_s"],
        **{key: {t: r[key] for t, r in turns.items()} for key in (
            "writes_per_s", "MBps", "ack_p50_ms", "ack_p99_ms", "fsyncs")},
        k1_row_ms=k1["ms"], k1_window_ms=k1["window_ms"],
        k1_bound_ms=k1["bound_ms"])
    launches = {k: turns["fsync"]["launches"][k] + turns["default"]["launches"][k]
                for k in turns["fsync"]["launches"]}
    return {"k1": k1, "turns": turns, "launches": launches}


# -------------------------------------------------------------- phase 8b

TIER_INTERVAL_S = 2
TIER_MIN_RESIDENCY_S = 5
# a short half-life, so the second swap's heat crosses the first's within
# seconds (the default is 60 s)
TIER_HALF_LIFE_S = 10
TIER_ROUND_S = 2.0
TIER_MOVE_TIMEOUT_S = 90.0


def _tier_series(m: dict) -> dict:
    name = "SeaweedFS_volumeServer_ec_tier_%s"
    return {
        "volumes": {t: m[name % f'volumes{{tier="{t}"}}'] for t in ("hbm", "host", "disk")},
        "promotions": {t: m[name % f'promotions_total{{tier="{t}"}}'] for t in ("hbm", "host")},
        "demotions": {t: m[name % f'demotions_total{{tier="{t}"}}'] for t in ("hbm", "host")},
        "host_bytes": m[name % "host_bytes"],
        "host_reads": m[name % "host_reads_total"],
    }


class _TierWatch(threading.Thread):
    """Polls the server's cache every 20 ms: when each volume's resident
    shard count changes (the demotion's evict, the promotion's pin)."""

    def __init__(self, cache, vids):
        super().__init__(daemon=True)
        self.cache, self.vids = cache, vids
        self.events: list = []  # (monotonic s, vid, resident shards)
        self.stop = threading.Event()

    def run(self):
        last = {}
        while not self.stop.is_set():
            for vid in self.vids:
                n = self.cache.resident_count(vid)
                if last.get(vid) != n:
                    self.events.append((time.monotonic(), vid, n))
                    last[vid] = n
            time.sleep(0.02)

    def first(self, vid, pred, after: float):
        return next((t for t, v, n in self.events if v == vid and t >= after and pred(n)),
                    None)


def _tier_round(pool, srv, seq, vid: int, seed: int, label: str, rnd: int) -> dict:
    """One TIER_ROUND_S pass of 64 clients reading `vid`: its reads, tail,
    routes, resident launches and tier series."""
    from seaweedfs_tpu_torch.ops import rs_resident

    per = SERVE_CLIENTS // SERVE_CLIENT_PROCS
    m0 = _scrape(srv.port)
    k0 = rs_resident.fused_reconstruct.launches
    futs = [pool.submit(_client_proc, srv.port, seq, per, 10 ** 9, TIER_ROUND_S,
                        seed * 100 + rnd * 10 + i, vid)
            for i in range(SERVE_CLIENT_PROCS)]
    parts = [f.result() for f in futs]
    m1 = _scrape(srv.port)
    lat = [x for p in parts for x in p["lat"]]
    wall = max(p["end"] for p in parts) - min(p["start"] for p in parts)
    d = _serve_delta(_serve_counts(m0), _serve_counts(m1))
    row = {"label": label, "round": rnd, "vid": vid, "reads": len(lat),
           "reads_per_s": len(lat) / wall, "p50_ms": _pct(lat, 50),
           "p99_ms": _pct(lat, 99), "routes": d["routes"],
           "k2_k5_launches": rs_resident.fused_reconstruct.launches - k0,
           "qos_sheds": {k: m1[k] - m0.get(k, 0.0) for k in m1
                         if k.startswith("SeaweedFS_volumeServer_ec_qos_shed_total{")
                         and m1[k] != m0.get(k, 0.0)},
           "tier_of": {v: srv.vs.store.ec_volume_tier(v) for v in (2, 3)},
           "tier_series": _tier_series(m1)}
    log("tiering_round", **row)
    return row


def phase_tiering(torch, workdir: str, vol: dict, deg: dict, seed: int) -> dict:
    """The residency ladder on the card: an in-process server
    (-ec.tier.intervalSeconds 2 -ec.tier.minResidencySeconds 5
    -ec.tier.hostCacheMB 0) whose cache holds one volume's 12 survivors
    and not two, over hard links of vid 1's sidecars and survivors as vids
    2 and 3, mounted in turn (vid 3's pin evicts most of vid 2).  64
    clients read vid 2 until the ladder swaps it in (vid 3 demoted), then
    vid 3 until it swaps back; every body is byte-checked, and reads of a
    promoted volume take the resident launch with 0 native routes."""
    import concurrent.futures
    import multiprocessing

    import numpy as np

    from seaweedfs_tpu_torch.ops import rs_resident
    from seaweedfs_tpu_torch.storage import ec

    torch.cuda.empty_cache()
    tier_dir = os.path.join(workdir, "tiering")
    os.makedirs(tier_dir)
    base = os.path.join(workdir, "1")
    survivors = [s for s in range(14) if s not in (0, 11)]
    shard = os.path.getsize(base + ec.to_ext(1))
    padded = -(-(shard + MAX_TILE) // rs_resident.SHARD_QUANTUM) * rs_resident.SHARD_QUANTUM
    one = len(survivors) * padded
    cache_mb = (one + one // 5) >> 20  # one volume fits, two do not
    deleted = set(deg["deleted"])
    picks = [n for n in deg["picks"] if n not in deleted]
    rng = np.random.default_rng(seed + 21)
    seq = [(nid, vol["needles"][nid][3], vol["needles"][nid][2])
           for nid in rng.choice(picks, size=min(len(picks), 4000), replace=False).tolist()]
    argv = ["-dir", tier_dir, "-port", "0",
            "-mserver", "", "-ec.backend", "cuda", "-ec.deviceCacheMB", str(cache_mb),
            "-ec.tier.intervalSeconds", str(TIER_INTERVAL_S),
            "-ec.tier.minResidencySeconds", str(TIER_MIN_RESIDENCY_S),
            "-ec.tier.halfLifeSeconds", str(TIER_HALF_LIFE_S),
            "-ec.tier.hostCacheMB", "0"]
    rounds, moves = [], []
    try:
        with _InProcessServer(argv) as srv:
            store = srv.vs.store
            cache = store.ec_device_cache
            t0 = time.perf_counter()
            # the served directory starts empty; each volume's files arrive
            # (links: no byte is written) and are mounted through the
            # Store's mount entry (VolumeEcShardsMount's), which pins its
            # survivors off the caller's thread.  vid 3's pin evicts vid 2's
            # oldest shards: vid 3 resident, vid 2 partial
            for vid in (2, 3):
                for ext in [ec.to_ext(s) for s in survivors] + [".ecx", ".ecj", ".vif"]:
                    if os.path.exists(base + ext):
                        os.link(base + ext, os.path.join(tier_dir, f"{vid}{ext}"))
                store.mount_ec_shards(vid, survivors)
                while cache.resident_count(vid) < len(survivors):
                    if time.perf_counter() - t0 > SERVE_PIN_TIMEOUT:
                        raise AssertionError(f"vid {vid} not pinned in time")
                    time.sleep(0.05)
            mount_s = time.perf_counter() - t0
            start = {v: cache.resident_count(v) for v in (2, 3)}
            if store.ec_volume_tier(2) != "disk" or store.ec_volume_tier(3) != "hbm":
                raise AssertionError(f"after the mounts: {start}")
            _reset(rs_resident.fused_reconstruct, rs_resident.fused_reconstruct_blockdiag)
            watch = _TierWatch(cache, (2, 3))
            watch.start()
            with concurrent.futures.ProcessPoolExecutor(
                    SERVE_CLIENT_PROCS,
                    mp_context=multiprocessing.get_context("spawn")) as pool:
                for hot, cold in ((2, 3), (3, 2)):
                    shift = time.monotonic()
                    rnd = 0
                    while store.ec_volume_tier(hot) != "hbm":
                        if time.monotonic() - shift > TIER_MOVE_TIMEOUT_S:
                            raise AssertionError(f"vid {hot} not promoted in time")
                        rounds.append(_tier_round(pool, srv, seq, hot, seed, "before", rnd))
                        rnd += 1
                    # the swap: the victim's evict, then the pin of the
                    # promoted volume's missing survivors (it serves from
                    # 10; the watch sees the last of the 12 land)
                    t_pin = time.monotonic()
                    while cache.resident_count(hot) < len(survivors):
                        if time.monotonic() - t_pin > SERVE_PIN_TIMEOUT:
                            raise AssertionError(f"vid {hot} pin incomplete")
                        time.sleep(0.02)
                    time.sleep(0.1)  # a watch poll after the last put
                    demoted = watch.first(cold, lambda n: n == 0, shift)
                    pinned = watch.first(hot, lambda n: n == len(survivors), shift)
                    pin_from = demoted
                    after = _tier_round(pool, srv, seq, hot, seed, "after", rnd)
                    rounds.append(after)
                    if after["routes"]["native"] or not after["k2_k5_launches"]:
                        raise AssertionError(f"vid {hot} after its promotion: {after}")
                    if store.ec_volume_tier(cold) == "hbm":
                        raise AssertionError(f"vid {cold} still in HBM")
                    put = len(survivors) - (start[hot] if hot == 2 else 0)
                    moves.append({
                        "promoted": hot, "demoted": cold,
                        "s_heat_shift_to_demote": demoted - shift if demoted else None,
                        "s_heat_shift_to_promoted": pinned - shift if pinned else None,
                        "pin_s": pinned - pin_from if pinned and pin_from else None,
                        "pin_GBps": (put * shard / (pinned - pin_from) / 1e9
                                     if pinned and pin_from and pinned > pin_from else None),
                        "shards_put": put})
            watch.stop.set()
            ladder = srv.vs.tiering.status()
            final = _tier_series(_scrape(srv.port))
    finally:
        shutil.rmtree(tier_dir, ignore_errors=True)
    if final["promotions"]["hbm"] < 2 or final["demotions"]["hbm"] < 2:
        raise AssertionError(f"ladder moves: {final}")
    launches = sum(r["k2_k5_launches"] for r in rounds)
    log("tiering", cache_mb=cache_mb, volume_padded_bytes=one, shard_bytes=shard,
        mount_s=mount_s, resident_after_mounts=start, moves=moves,
        ladder=ladder, tier_series=final, k2_k5_launches=launches,
        flags={"intervalSeconds": TIER_INTERVAL_S,
               "minResidencySeconds": TIER_MIN_RESIDENCY_S,
               "halfLifeSeconds": TIER_HALF_LIFE_S, "hostCacheMB": 0})
    return {"launches": launches, "moves": moves}


# --------------------------------------------------------------- phase 9

# 9a: server A's cache holds all 14 of vid 1's shards (15.75 GiB padded)
CLUSTER_CACHE_MB = SCRUB_BUDGET >> 20
# reads of step 5's concurrent pass (64 clients, SERVE_SECONDS at most)
CLUSTER_CONCURRENT_READS = 2000
# reads of 9a's one-client passes (steps 4 and 5) and of step 6's gather,
# each a seeded sample (the run's time limit: step 6 reads about 50-90 a
# second)
CLUSTER_SEQ_READS = 600
CLUSTER_GATHER_READS = 400
# 9a's memo step: at most this many needles wholly on shard 5 (outside step
# 6's sample), their intervals summing to at most half the memo's budget,
# read twice on B by one client; the degraded-read memo's series
MEMO_NEEDLES = 16
MEMO = 'SeaweedFS_volumeServer_ec_degraded_memo_total{result="%s"}'
# 9b: the volume the shell verbs vacuum, encode, spread, rebuild, balance
# and decode.  Its writes come on top of the main path's (a call may write
# 45 GiB, deleted files counted): about 6x this .dat (§4 of PERF.md)
CLUSTER_DAT_BYTES = 192 << 20
CLUSTER_COLLECTION = "ec9"
# 9b's replicated writes: a `001` volume (two copies) of this collection,
# written through assign before the verbs: 2x this .dat of writes
REPL_DAT_BYTES = 64 << 20
REPL_COLLECTION = "ec9r"
# 9b's vacuum: this seeded share of the volume's needles deleted through
# the front door, then the master's vacuum pass at this threshold
VACUUM_DELETE_SHARE = 0.35
VACUUM_THRESHOLD = 0.3
VACUUM_WALLS = 'SeaweedFS_volumeServer_vacuuming_seconds_%s{type="%s"}'
SEALS = 'SeaweedFS_volumeServer_ingest_seals_total{path="%s"}'
CLUSTER_WRITERS = 32
CLUSTER_READERS = 32
CLUSTER_WAIT_S = 180.0
# 9a's incident plane: the master judges a latency SLO on the servers'
# SLO_STAGE digests over these burn windows, and its bundle of a fire
# holds a SLO_PROFILE_S torch.profiler capture of the busiest node
SLO_STAGE = "batch_dispatch"
SLO_FAST_S, SLO_SLOW_S = 2.0, 4.0
SLO_PROFILE_S = 2.0
# a second SLO-fired bundle within the phase would break the rate limit
SLO_MIN_INTERVAL_S = 3600.0
# the target: the highest target that at most SLO_SEQ_MAX_BAD of 5c's
# sequential batch_dispatch observations exceeded while at least
# SLO_MIN_BAD of its 64-client pass did (the budget is 1%: one-client
# reads burn at most half of it, 64 clients at least twice, and 9a's
# one-client reads on A keep the most margin)
SLO_SEQ_MAX_BAD, SLO_MIN_BAD = 0.005, 0.02
# where no edge fits: candidate targets at these fractions of each bucket
SLO_TARGET_STEPS = 8
# the SLO window's readers stop once the bundle and the shell's reads are
# in, or after this long
SLO_LOAD_MAX_S = 120.0
SLO_LOAD_PROCS = 2
# the servers' trace rings hold all of step 6's gathers (9-10
# VolumeEcShardRead entries each on A) until the master's /debug/critpath
# has assembled the slowest of them
SLO_TRACE_RING = 32768
CRITPATH_SLOWEST = 10


class _Cluster:
    """The processes of phase 9, as users start them, and the calls the
    phase makes to them: the master's state over its RPC plane, a volume
    server's rpcs, its /status and /metrics over HTTP, and the shell."""

    def __init__(self, workdir: str, stack: contextlib.ExitStack,
                 master_flags: list = (), env: dict | None = None):
        from seaweedfs_tpu_torch.pb import (
            Stub, master_pb2, sync_channel_cached, volume_server_pb2)

        self.pb = master_pb2
        self.vpb = volume_server_pb2
        self._stub = Stub
        self._chan = sync_channel_cached
        self.dir = workdir
        self.stack = stack
        http, grpc = _free_port(), _free_port()
        self.master_http = http
        self.master = f"127.0.0.1:{http}.{grpc}"
        self.procs: dict = {}
        self.ports: dict = {}
        self.killed: set = set()
        # every process of the phase: its profile captures land under the
        # phase's directory, and /debug/profile and /debug/stacks answer
        self.env = {"TMPDIR": os.path.join(workdir, "tmp"), "SWFS_DEBUG": "1",
                    **(env or {})}
        os.makedirs(self.env["TMPDIR"], exist_ok=True)
        # the repair plane is on by default; 9a pauses it, 9b lets it heal
        self._start("master", "master", ["-port", str(http), "-port.grpc",
                                          str(grpc), "-pulseSeconds", "1",
                                          "-ec.repair.intervalSeconds", "1",
                                          *master_flags])
        self.mstub = Stub(sync_channel_cached(f"127.0.0.1:{grpc}"),
                          master_pb2, "Seaweed")
        self.wait("the master", lambda: self._try(self.nodes) is not None)

    def _start(self, name: str, command: str, args: list) -> None:
        log_path = os.path.join(self.dir, f"{name}.log")
        self.procs[name] = self.stack.enter_context(
            _volume_server(args, log_path, self.env, command=command))

    def start_servers(self, specs: dict) -> None:
        """{name: extra flags}: volume servers started together, then waited
        on until the master lists each."""
        for name, flags in specs.items():
            http, grpc = _free_port(), _free_port()
            self.ports[name] = (http, grpc)
            d = os.path.join(self.dir, name)
            os.makedirs(d)
            self._start(name, "volume", [
                "-dir", d, "-port", str(http), "-port.grpc", str(grpc),
                "-mserver", self.master, "-ec.backend", "cuda",
                "-pulseSeconds", "1", *flags])
        want = {self.url(n) for n in specs}
        self.wait(f"servers {sorted(specs)} registered",
                  lambda: want <= set(self._try(self.nodes) or ()))

    def url(self, name: str) -> str:
        return f"127.0.0.1:{self.ports[name][0]}"

    def vstub(self, name: str):
        return self._stub(self._chan(f"127.0.0.1:{self.ports[name][1]}"),
                          self.vpb, "VolumeServer")

    @staticmethod
    def _try(fn):
        from seaweedfs_tpu_torch.pb import RpcError

        try:
            return fn()
        except (RpcError, OSError):
            return None

    def wait(self, what: str, pred, timeout: float = CLUSTER_WAIT_S) -> float:
        """Poll `pred` until true: -> seconds waited.  A process that exits
        meanwhile is fatal."""
        t0 = time.perf_counter()
        while not pred():
            for name, proc in self.procs.items():
                if proc.poll() is not None and name not in self.killed:
                    raise AssertionError(f"{name} exited ({proc.returncode})")
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"timed out waiting for {what}")
            time.sleep(0.1)
        return time.perf_counter() - t0

    def nodes(self) -> list:
        """The volume servers the master lists (VolumeList)."""
        info = json.loads(self.mstub.VolumeList(
            self.pb.VolumeListRequest(), timeout=10).topology_info_json)
        return [n["id"] for dc in info["data_centers"]
                for r in dc["racks"] for n in r["nodes"]]

    def shards(self, vid: int) -> dict:
        """shard id -> server urls, as the master's LookupEcVolume says."""
        from seaweedfs_tpu_torch.pb import RpcError, StatusCode

        try:
            resp = self.mstub.LookupEcVolume(
                self.pb.LookupEcVolumeRequest(volume_id=vid), timeout=10)
        except RpcError as e:
            if e.code() == StatusCode.NOT_FOUND:
                return {}
            raise
        return {e.shard_id: sorted(l.url for l in e.locations)
                for e in resp.shard_id_locations}

    def shell(self, script: str) -> tuple[str, float]:
        """`python3 -m seaweedfs_tpu_torch shell -c SCRIPT`: -> (its output,
        wall s).  A failing command is fatal."""
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell", "-master",
             self.master, "-c", script],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"shell {script!r} failed: {proc.stdout}"
                                 f"{proc.stderr[-4000:]}")
        return proc.stdout, wall

    def health(self) -> dict:
        """The master's /cluster/health.json."""
        return _get_json(self.master_http, "/cluster/health.json")

    def repair(self, verb: str) -> dict:
        """`volume.repair.<verb>; volume.repair.status -json` in one shell:
        -> the repair block the status prints after the verb."""
        out, _ = self.shell(f"volume.repair.{verb}; volume.repair.status -json")
        return json.loads(out[out.index("{"):])

    def kill(self, name: str) -> None:
        self.killed.add(name)
        proc = self.procs[name]
        proc.kill()
        proc.wait(30)


def _k_counts(m: dict) -> dict:
    """A server's kernel launches, from one _scrape."""
    kern = 'SeaweedFS_volumeServer_ec_kernel_launches_total{kernel="%s"}'
    return {k: m.get(kern % k, 0.0) for k in (
        "gf2_matmul", "gf2_matmul_small", "fused_reconstruct",
        "fused_reconstruct_blockdiag", "scrub")}


def _peer_counts(m: dict) -> dict:
    """The remote shard reader's and the fault policy's series."""
    rr = 'SeaweedFS_volumeServer_ec_remote_shard_reads_total{result="%s"}'
    route = 'SeaweedFS_volumeServer_ec_read_route_total{route="%s"}'
    return {
        "remote_ok": m.get(rr % "ok", 0.0),
        "remote_miss": m.get(rr % "miss", 0.0),
        "remote_bytes": m.get(
            "SeaweedFS_volumeServer_ec_remote_shard_bytes_total", 0.0),
        "hedge_sent": m.get("SeaweedFS_volumeServer_ec_hedge_sent_total", 0.0),
        "hedge_wins": m.get("SeaweedFS_volumeServer_ec_hedge_wins_total", 0.0),
        "hedge_cancelled": m.get(
            "SeaweedFS_volumeServer_ec_hedge_cancelled_total", 0.0),
        "retry_budget_exhausted": m.get(
            "SeaweedFS_volumeServer_ec_retry_budget_exhausted_total", 0.0),
        "deadline_exceeded": m.get(
            "SeaweedFS_volumeServer_ec_deadline_exceeded_total", 0.0),
        "batched": m.get(route % "batched", 0.0),
        "native": m.get(route % "native", 0.0),
        "memo_hit": m.get(MEMO % "hit", 0.0),
        "memo_miss": m.get(MEMO % "miss", 0.0),
        **_k_counts(m),
    }


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


async def _get_each(port: int, items: list, n_clients: int,
                    traces: list | None = None) -> tuple[list, int]:
    """GET every (path, sha256 digest) of `items` once, over `n_clients`
    keep-alive clients: -> (seconds per read, body bytes).  Every body is
    byte-verified; `traces`, when given, gets (seconds, trace id) of each
    read."""
    from seaweedfs_tpu_torch.server.http import Client

    lat: list = []
    nbytes = [0]
    queue = list(reversed(items))

    async def client() -> None:
        c = Client("127.0.0.1", port)
        try:
            while queue:
                path, digest = queue.pop()
                t0 = time.perf_counter()
                status, headers, body = await c.request("GET", path)
                lat.append(time.perf_counter() - t0)
                if status != 200 or hashlib.sha256(body).digest() != digest:
                    raise AssertionError(f"{path}: HTTP {status}, {len(body)} "
                                         "bytes differ from the written needle")
                if traces is not None:
                    traces.append((lat[-1], headers.get(
                        "X-Seaweed-Trace-Id", "").split("-")[0]))
                nbytes[0] += len(body)
        finally:
            await c.close()

    await asyncio.gather(*(client() for _ in range(n_clients)))
    return lat, nbytes[0]


def _read_row(lat: list, wall: float, d: dict, nbytes: int) -> dict:
    n = len(lat)
    return {"reads": n, "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99),
            "reads_per_s": n / wall, "MBps": nbytes / wall / 1e6,
            "remote_fetches_per_read": d["remote_ok"] / n,
            "remote_bytes_per_read": d["remote_bytes"] / n,
            "remote_misses": d["remote_miss"],
            "hedges": {k: d[k] for k in ("hedge_sent", "hedge_wins",
                                         "hedge_cancelled")},
            "retry_budget_exhausted": d["retry_budget_exhausted"],
            "deadline_exceeded": d["deadline_exceeded"],
            "routes": {"batched": d["batched"], "native": d["native"]},
            "launches": {k: d[k] for k in _k_counts({})}}


def _timed_gets(port: int, items: list, n_clients: int, scrape_port: int,
                traces: list | None = None):
    """-> (row, counter delta) of one pass of GETs, counters read on the
    server that answered (`scrape_port`); `traces` as _get_each's."""
    before = _peer_counts(_scrape(scrape_port))
    t0 = time.perf_counter()
    lat, nbytes = asyncio.run(_get_each(port, items, n_clients, traces))
    wall = time.perf_counter() - t0
    d = _delta(before, _peer_counts(_scrape(scrape_port)))
    return _read_row(lat, wall, d, nbytes), d


def _cluster_telemetry(cl: _Cluster, a_port: int) -> dict:
    """9a, once A pinned its 14 shards: the master's telemetry plane on the
    card.  `cluster.health -json` and `volume.device.status` through the
    shell; A's device block must hold the used bytes A's own /metrics
    reports, 14 resident shards of vid 1 and a closed breaker.  Writes
    nothing."""
    a_url = cl.url("A")
    used = 'SeaweedFS_volumeServer_ec_resident_bytes'

    def agrees() -> bool:
        node = cl.health()["nodes"].get(a_url, {})
        dev = node.get("device", {})
        return (dev.get("resident_shards_by_volume") == {"1": 14}
                and dev.get("used_bytes") == _scrape(a_port).get(used))

    waited = cl.wait("A's telemetry on the master", agrees)
    out, wall = cl.shell("cluster.health -json; volume.device.status")
    doc, end = json.JSONDecoder().raw_decode(out)
    status = out[end:]
    node = doc["nodes"][a_url]
    dev, disp = node["device"], node["dispatcher"]
    metrics_used = _scrape(a_port)[used]
    if (dev["used_bytes"] != metrics_used
            or dev["resident_shards_by_volume"] != {"1": 14}
            or disp["qos_breaker_open"] is not False):
        raise AssertionError(f"A's telemetry: {node}, /metrics {metrics_used}")
    if f"{a_url} [fresh]" not in status or \
            "ec volume 1: 14 resident shards" not in status:
        raise AssertionError(f"volume.device.status: {status!r}")
    row = {"used_bytes": dev["used_bytes"],
           "metrics_used_bytes": metrics_used,
           "budget_bytes": dev["budget_bytes"],
           "resident_shards": dev["resident_shards"],
           "resident_shards_by_volume": dev["resident_shards_by_volume"],
           "evictions": dev["evictions"], "pin_claims": dev["pin_claims"],
           "qos_breaker_open": disp["qos_breaker_open"],
           "age_seconds": node["age_seconds"], "waited_s": waited,
           "shell_wall_s": wall,
           "device_status": status.strip().splitlines()}
    log("cluster_telemetry", server="A", **row)
    return row


class _PushSink:
    """A pushgateway stand-in for 9a: records each PUT
    /metrics/job/<job>/instance/<instance> (its series names); served by a
    thread of this process until close()."""

    def __init__(self):
        import http.server
        import urllib.parse

        self.pushes: list = []
        sink = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_PUT(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                parts = self.path.strip("/").split("/")
                if parts[:2] == ["metrics", "job"] and parts[3:4] == ["instance"]:
                    sink.pushes.append((parts[2], urllib.parse.unquote(
                        parts[4]), body.count(b"\nSeaweedFS_")))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.address = f"127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def _slo_target(serve: dict) -> dict:
    """9a's read_p99 target, from 5c's first flat turn (its server had
    the cache and layout A has): the highest target that at least
    SLO_MIN_BAD of the 64-client pass's batch_dispatch observations
    exceeded — so that 64 clients burn it — provided at most
    SLO_SEQ_MAX_BAD of the sequential pass's did, so that 9a's one-client
    reads on A (step 4) stay inside the 1% budget.  The highest such
    target, not the lowest: the SLO engine judges windows of a pulse or
    two, so a few slow one-client reads early in step 4 burn a target set
    at the one-client pass's tail (5 ms fired at the start of step 4 in
    one run).  The candidates are the digest ladder's edges, where a
    digest counts an observation bad exactly when it is slower; only when
    no edge fits (on a fast host both passes can fill one bucket), also
    SLO_TARGET_STEPS points inside each bucket, where the share is the
    master's own estimate (obs/slo.py `_bad_from_buckets`, linear inside
    the bucket that straddles the target)."""
    from seaweedfs_tpu_torch.obs.slo import _bad_from_buckets
    from seaweedfs_tpu_torch.stats.cluster import quantile_from_buckets
    from seaweedfs_tpu_torch.stats.metrics import STAGE_SECONDS_BUCKETS

    key = f"{SLO_STAGE}_buckets"
    seq = serve["flat"]["sequential"][key]
    con = serve["flat"]["concurrent"][0][key]

    def above(counts, target_s):  # the share the master counts slower
        bad, total = _bad_from_buckets(counts, target_s)
        return bad / max(1.0, total)

    def fitting(targets):
        return [t for t in targets if above(seq, t) <= SLO_SEQ_MAX_BAD
                and above(con, t) >= SLO_MIN_BAD]

    lows = (0.0,) + tuple(STAGE_SECONDS_BUCKETS[:-1])
    fits = fitting(STAGE_SECONDS_BUCKETS) or fitting(sorted(
        lo + (hi - lo) * k / SLO_TARGET_STEPS
        for lo, hi in zip(lows, STAGE_SECONDS_BUCKETS)
        for k in range(1, SLO_TARGET_STEPS)))
    if not fits:
        raise AssertionError(f"no target separates 5c's one-client and "
                             f"64-client {SLO_STAGE} observations: {seq}, "
                             f"{con}")
    pick = fits[-1]
    p99 = quantile_from_buckets(con, 0.99)
    row = {"target_ms": round(pick * 1e3, 6),
           "sequential_share_above": above(seq, pick),
           "concurrent_share_above": above(con, pick),
           "concurrent_p99_ms": p99 * 1e3 if p99 is not None else None,
           "sequential_p99_ms": (quantile_from_buckets(seq, 0.99) or 0) * 1e3,
           "sequential_buckets": seq, "concurrent_buckets": con}
    row["fraction_of_concurrent_p99"] = row["target_ms"] / row["concurrent_p99_ms"]
    log("cluster_slo_target", stage=SLO_STAGE, **row)
    return row


def _cluster_critpath(cl: _Cluster, traces: list) -> dict:
    """9a step 6: the master's /debug/critpath (its fan-out over every
    node's /debug/traces, clocks reconciled by the heartbeat skew) of the
    CRITPATH_SLOWEST slowest gathers, each anchored on the client's time.
    At least one must join B's GET with A's VolumeEcShardRead legs."""
    rows = []
    for sec, tid in sorted(traces, reverse=True)[:CRITPATH_SLOWEST]:
        doc = _get_json(cl.master_http, f"/debug/critpath?id={tid}"
                        f"&client_total_us={int(sec * 1e6)}")
        names = [p["name"] for p in doc["participants"]]
        rows.append({
            "client_ms": sec * 1e3, "total_us": doc["total_us"],
            "front": sum(n.startswith("GET /") for n in names),
            "legs": sum(n == "grpc VolumeEcShardRead" for n in names),
            "segments_pct": doc["segments_pct"],
            "coverage_pct": doc["coverage_pct"],
            "fetch_errors": doc.get("fetch_errors", {})})
        if sum(doc["segments_us"].values()) != doc["total_us"]:
            raise AssertionError(f"critpath {tid}: segments do not sum to "
                                 f"the client's time: {doc['segments_us']}")
    crossed = [r for r in rows if r["front"] and r["legs"]]
    if not crossed:
        raise AssertionError(f"no gather assembled across B and A: {rows}")
    mean = {seg: statistics.fmean(r["segments_pct"][seg] for r in rows)
            for seg in rows[0]["segments_pct"]}
    out = {"gathers": len(traces), "slowest": rows,
           "cross_server": len(crossed), "mean_segments_pct": mean}
    log("cluster_critpath", **out)
    return out


def _cluster_slo(cl: _Cluster, slo: dict, seq_a: list, seq_b: list,
                 seed: int, sink: "_PushSink") -> dict:
    """9a step 7: 64 clients on A (resident reads: K2+K3, judged by the
    read_p99 SLO through A's batch_dispatch digests) and 64 on B (the
    step-6 gathers: K1) at once, until the master's SLO has fired, its
    one bundle has landed, and `cluster.slo -json; cluster.incident.dump
    -json` has run through the shell.  Then every check of the incident
    plane, each fatal: the bundle's parts, its CUPTI capture naming a
    port kernel with device time, the forced second bundle, the merged
    digests against A's and B's /metrics, the pushes, /debug/stacks."""
    import concurrent.futures

    from seaweedfs_tpu_torch.stats.cluster import quantile_from_buckets
    from seaweedfs_tpu_torch.stats.metrics import STAGE_SECONDS_BUCKETS
    from seaweedfs_tpu_torch.utils import devtime

    a_url, b_url = cl.url("A"), cl.url("B")
    inc_dir = cl.incident_dir
    stop = os.path.join(cl.dir, "slo_stop")
    loads: dict = {}

    def load(name: str, seq: list) -> None:
        try:
            loads[name] = _serve_concurrent(
                cl.ports[name][0], seq, seed, reads=1 << 40,
                procs=SLO_LOAD_PROCS, seconds=SLO_LOAD_MAX_S, stop_path=stop)
        except BaseException as e:  # noqa: BLE001 — judged below
            loads[name] = e

    def objective() -> dict:
        return cl.health()["slo"]["objectives"]["read_p99"]

    def bundles(kind: str) -> list:
        names = os.listdir(inc_dir) if os.path.isdir(inc_dir) else []
        return sorted(f for f in names
                      if f.startswith("incident-") and f.endswith(f"-{kind}.json"))

    # a process's first capture pays the profiler's start (CUPTI, seconds):
    # pay it on A and B before the load, or the bundle's capture of a
    # loaded server on a slow host can outlast its profileSeconds + 30 s
    # (an open fault of the server's; the bundle's seconds here exclude
    # that first start)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(_get_json, cl.ports[n][0],
                              "/debug/profile?seconds=0.2")
                  for n in ("A", "B")]:
            f.result()
    if objective()["violations_total"]:
        raise AssertionError(f"the SLO fired before its window: {objective()}")
    k0 = {n: _k_counts(_scrape(cl.ports[n][0])) for n in ("A", "B")}
    threads = [threading.Thread(target=load, args=(n, q))
               for n, q in (("A", seq_a), ("B", seq_b))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    try:
        fired_s = cl.wait("the read_p99 SLO to fire",
                          lambda: objective()["violations_total"] >= 1,
                          SLO_LOAD_MAX_S)
        bundle_s = cl.wait("its incident bundle",
                           lambda: bundles("read_p99"), SLO_LOAD_MAX_S) + fired_s
        shell_out, shell_wall = cl.shell(
            "cluster.slo -json; cluster.incident.dump -json")
    finally:
        with open(stop, "w"):
            pass
        for th in threads:
            th.join()
    wall = time.perf_counter() - t0
    for name in ("A", "B"):
        if isinstance(loads.get(name), BaseException) or name not in loads:
            raise AssertionError(f"the SLO window's readers on {name}: "
                                 f"{loads.get(name)!r}")
    launches = {n: _delta(k0[n], _k_counts(_scrape(cl.ports[n][0])))
                for n in ("A", "B")}
    # 2. fired once, judged in the shell while the readers still burned
    dec = json.JSONDecoder()
    slo_doc, end = dec.raw_decode(shell_out[shell_out.index("{"):])
    rest = shell_out[shell_out.index("{") + end:]
    dump, _ = dec.raw_decode(rest[rest.index("{"):])
    rp = slo_doc["objectives"]["read_p99"]
    if not rp["violations_total"] or rp["budget_remaining"] >= 1 \
            or rp["stage"] != SLO_STAGE:
        raise AssertionError(f"cluster.slo -json: {rp}")
    # 3. exactly one bundle of the fire: a burn that dips under the
    # threshold and rises again is a second violation, and the rate limit
    # (SLO_MIN_INTERVAL_S) holds it to the one bundle
    fired = bundles("read_p99")
    violations = objective()["violations_total"]
    if len(fired) != 1:
        raise AssertionError(f"SLO bundles {fired}, {objective()}")
    with open(os.path.join(inc_dir, fired[0])) as f:
        bundle = json.load(f)
    nodes = bundle["nodes"]
    tl_nodes = {n for row in (bundle["timeline"] or {}).get("samples", [])
                for n in row["nodes"]}
    prof = bundle["profile"] or {}
    problems = []
    if "slo" not in bundle["health"]:
        problems.append("health has no slo block")
    if not {a_url, b_url} <= tl_nodes:
        problems.append(f"timeline samples of {sorted(tl_nodes)}")
    for u in (a_url, b_url):
        if u not in nodes or "error" in nodes[u]:
            problems.append(f"node {u}: {nodes.get(u)}")
    if not bundle["critpaths"]:
        problems.append("no critical path")
    if "error" in prof or not prof.get("trace_dir"):
        problems.append(f"profile {prof}")
    kernels: dict = {}
    if not problems:
        for name, _, dur in devtime.kernel_events(
                os.path.join(prof["trace_dir"], "trace.json")):
            port_kernel = next((k for k in ("fused_reconstruct", "gf2_matmul")
                                if k in name), None)
            if port_kernel:
                row = kernels.setdefault(name, {"count": 0, "ms": 0.0})
                row["count"] += 1
                row["ms"] += dur / 1e3
        if not any(r["ms"] > 0 for r in kernels.values()):
            problems.append(f"the capture on {prof['node']} names no port "
                            "kernel with device time")
    if problems:
        raise AssertionError(f"incident bundle {fired[0]}: {problems}")
    # 4. the operator's dump: a second bundle past the rate limit
    if not dump["path"].endswith("-manual.json") or not os.path.exists(
            dump["path"]) or len(bundles("manual")) != 1:
        raise AssertionError(f"cluster.incident.dump: {dump}")
    # 1. A's (and B's) stage digests reached the master: once all are
    # shipped and acknowledged, the merged p50/p99 sit within one bucket
    # of the estimate from the servers' own /metrics histograms
    stages = {}
    for stage in (SLO_STAGE, "queue_wait"):
        def local():
            per = [_stage_buckets(_scrape(cl.ports[n][0]), stage)
                   for n in ("A", "B")]
            return [a + b for a, b in zip(*per)]

        def merged():
            return cl.health()["cluster"]["stages"].get(stage, {})

        cl.wait(f"the merged {stage} digest",
                lambda: merged().get("count") == sum(local()), 30.0)
        counts, doc = local(), merged()
        row = {"count": doc["count"]}
        for q in (50, 99):
            mine = quantile_from_buckets(counts, q / 100)
            theirs = doc[f"p{q}_seconds"]
            idx = [next((i for i, e in enumerate(STAGE_SECONDS_BUCKETS)
                         if v <= e), len(STAGE_SECONDS_BUCKETS))
                   for v in (mine, theirs)]
            if abs(idx[0] - idx[1]) > 1:
                raise AssertionError(f"{stage} p{q}: master {theirs} s, "
                                     f"/metrics {mine} s")
            row[f"p{q}_ms"] = theirs * 1e3
            row[f"metrics_p{q}_ms"] = mine * 1e3
        stages[stage] = row
    # 6. the pushes, and the master's /debug/stacks
    jobs = {(job, inst) for job, inst, n in sink.pushes if n}
    want = {("master", f"127.0.0.1:{cl.master_http}"),
            ("volumeServer", a_url), ("volumeServer", b_url)}
    if not want <= jobs:
        raise AssertionError(f"pushes {sorted(jobs)}, wanted {sorted(want)}")
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{cl.master_http}/debug/stacks",
            timeout=30) as r:
        stacks = (r.status, len(r.read()))
    if stacks[0] != 200:
        raise AssertionError(f"/debug/stacks answered {stacks[0]}")
    reads = {n: {"reads": len(loads[n]["lat"]),
                 "p50_ms": _pct(loads[n]["lat"], 50),
                 "p99_ms": _pct(loads[n]["lat"], 99),
                 "reads_per_s": len(loads[n]["lat"]) / loads[n]["wall"],
                 "launches": launches[n]}
             for n in ("A", "B")}
    out = {"target_ms": slo["target_ms"], "fired_s": fired_s,
           "violations": violations,
           "bundle_s": bundle_s, "window_s": wall,
           "shell_wall_s": shell_wall,
           "budget_remaining": rp["budget_remaining"],
           "fast_burn": rp["fast_burn"], "slow_burn": rp["slow_burn"],
           "window_p99_ms": (rp["window_p99_seconds"] or 0) * 1e3,
           "bundle": {"bytes": os.path.getsize(os.path.join(inc_dir, fired[0])),
                      "nodes": sorted(nodes), "critpaths": len(bundle["critpaths"]),
                      "correlation": {k: len(v) if isinstance(v, list) else v
                                      for k, v in bundle["correlation"].items()},
                      "timeline_rows": len(bundle["timeline"]["samples"])},
           "profile": {"node": "A" if prof["node"] == a_url else "B",
                       "seconds": prof["seconds"], "kernels": kernels},
           "dump_bytes": os.path.getsize(dump["path"]),
           "merged_stages": stages,
           "pushes": len(sink.pushes), "stacks_bytes": stacks[1],
           "reads": reads}
    log("cluster_slo", **out)
    return out


def _cluster_full_width(cl: _Cluster, workdir: str, vol: dict, deg: dict,
                        seed: int, slo: dict, sink: "_PushSink") -> dict:
    """9a: the main 11 GiB volume at full width, by hard links (no byte
    written).  A pins all 14 shards and ec.scrub runs B5 there; shard 0
    moves to B; A serves shard 0's needles from the card (K2-K5, no remote
    hop); B serves needles of shards 1-9 from A over VolumeEcShardRead, in
    sequence and with 64 clients; with shard 5 gone too, B gathers shard 0
    and 9 remote survivors through the hedged gather and reconstructs on
    the card (K1's host degraded read), and the master's /debug/critpath
    assembles the slowest gathers across B and A.  Then the SLO window
    (_cluster_slo): A's resident reads and B's gathers at once until the
    master's latency SLO fires and its incident bundle lands."""
    import numpy as np

    from seaweedfs_tpu_torch.storage import ec, needle as needle_mod
    from seaweedfs_tpu_torch.storage.ec import layout
    from seaweedfs_tpu_torch.storage import types as t

    # 9a's losses are its own (shard 5 unmounted at step 6): no repair
    # behind its back, and no K1 rebuild inside its timed reads
    if not cl.repair("pause")["paused"]:
        raise AssertionError("volume.repair.pause left the plane running")
    # both push to the phase's pushgateway sink and keep step 6's traces
    common = ["-metrics.address", sink.address, "-metrics.intervalSeconds",
              "1", "-obs.traceRing", str(SLO_TRACE_RING)]
    cl.start_servers({"A": ["-ec.deviceCacheMB", str(CLUSTER_CACHE_MB),
                            *common],
                      "B": ["-ec.deviceCacheMB", "0", *common]})
    a_port, b_port = cl.ports["A"][0], cl.ports["B"][0]
    base = os.path.join(workdir, "1")
    sidecars = [x for x in (".ecx", ".ecj", ".vif") if os.path.exists(base + x)]

    def link(name: str, exts: list) -> None:
        for ext in exts:
            os.link(base + ext, os.path.join(cl.dir, name, "1" + ext))

    link("A", [ec.to_ext(s) for s in range(14)] + sidecars)
    t0 = time.perf_counter()
    cl.vstub("A").VolumeEcShardsMount(cl.vpb.VolumeEcShardsMountRequest(
        volume_id=1, shard_ids=list(range(14))), timeout=60)

    def resident(n):
        ecv = _get_json(a_port, "/status")["EcVolumes"]
        return ecv and ecv[0]["serving"] and len(ecv[0]["resident"]) == n

    cl.wait("A's 14 shards pinned", lambda: resident(14))
    pin_s = time.perf_counter() - t0
    cl.wait("the master lists A's 14 shards",
            lambda: cl.shards(1) == {s: [cl.url("A")] for s in range(14)})
    telemetry = _cluster_telemetry(cl, a_port)
    # 2. the shell's ec.scrub: one VolumeEcShardsVerify(all_resident) on A
    k0 = _k_counts(_scrape(a_port))
    scrub_out, scrub_wall = cl.shell("ec.scrub")
    scrub_launches = _k_counts(_scrape(a_port))["scrub"] - k0["scrub"]
    if "ec volume 1: OK" not in scrub_out or not scrub_launches:
        raise AssertionError(f"ec.scrub: {scrub_out!r}, {scrub_launches} "
                             "launches")
    # 3. shard 0 moves to B: unmounted on A, linked and mounted on B
    cl.vstub("A").VolumeEcShardsUnmount(cl.vpb.VolumeEcShardsUnmountRequest(
        volume_id=1, shard_ids=[0]), timeout=60)
    link("B", [ec.to_ext(0)] + sidecars)
    cl.vstub("B").VolumeEcShardsMount(cl.vpb.VolumeEcShardsMountRequest(
        volume_id=1, shard_ids=[0]), timeout=60)
    want = {s: [cl.url("B") if s == 0 else cl.url("A")] for s in range(14)}
    cl.wait("the master lists shard 0 on B, 1-13 on A",
            lambda: cl.shards(1) == want)
    cl.wait("A's 13 shards resident", lambda: resident(13))

    deleted = set(deg["deleted"])
    dat_size = layout.DATA_SHARDS * os.path.getsize(base + ec.to_ext(1))
    by_shard: dict = {}
    spans: dict = {}
    for nid, (off, body, _, _) in vol["needles"].items():
        if nid in deleted:
            continue
        ivs = layout.locate_data(
            dat_size, off, needle_mod.actual_size(body, needle_mod.CURRENT_VERSION))
        sids = {iv.to_shard_and_offset()[0] for iv in ivs}
        spans[nid] = (ivs, sids)
        for s in sids:
            by_shard.setdefault(s, []).append(nid)
    rng = np.random.default_rng(seed + 9)
    shard0 = sorted(by_shard[0])
    others = [n for n in vol["needles"] if n not in deleted and 0 not in spans[n][1]]
    seq4 = shard0 + rng.choice(others, size=min(SERVE_EXTRA, len(others)),
                               replace=False).tolist()
    seq4 = rng.choice(seq4, size=min(CLUSTER_SEQ_READS, len(seq4)),
                      replace=False).tolist()

    def item(nid):
        _, _, digest, cookie = vol["needles"][nid]
        return "/" + t.format_fid(1, nid, cookie), digest

    def quiet(step: str, m0: dict) -> list:
        """The master's SLO stays quiet through `step` (it must fire in
        step 7 only): -> A's SLO_STAGE digest of the step, which an early
        fire prints."""
        digest = [b - a for a, b in zip(_stage_buckets(m0, SLO_STAGE),
                                        _stage_buckets(_scrape(a_port),
                                                       SLO_STAGE))]
        o = cl.health()["slo"]["objectives"]["read_p99"]
        if o["violations_total"]:
            raise AssertionError(f"the SLO fired by the end of step {step}: "
                                 f"{o}; A's {SLO_STAGE} digest of the step "
                                 f"{digest}")
        return digest

    # 4. A: shard 0 reconstructed from the 13 resident shards, no remote hop
    m4 = _scrape(a_port)
    row4, d4 = _timed_gets(a_port, [item(n) for n in seq4], 1, a_port)
    row4[f"{SLO_STAGE}_buckets"] = quiet("4", m4)
    if d4["remote_ok"] or d4["remote_miss"] or d4["native"] \
            or not d4["fused_reconstruct"]:
        raise AssertionError(f"A's shard-0 reads: {d4}")
    # 5. B: needles wholly on shards 1-9, deep in the large-block row, in
    # the small-block rows, and across block boundaries
    remote = [n for n, (ivs, sids) in spans.items()
              if sids and sids <= set(range(1, 10))]
    multi = [n for n in remote if len(spans[n][0]) > 1]
    deep = [n for n in remote if spans[n][0][0].is_large_block
            and spans[n][0][0].inner_block_offset >= 512 << 20]
    small = [n for n in remote if not spans[n][0][0].is_large_block]
    want_n = len(seq4)
    pick = multi[:want_n]
    for pool_, share in ((deep, 2), (small, 1), (remote, 1)):
        rest = sorted(set(pool_) - set(pick))
        k = min(len(rest), (want_n - len(pick)) // share)
        if k:
            pick += rng.choice(rest, size=k, replace=False).tolist()
    seq5 = pick
    m5 = _scrape(a_port)
    row5, d5 = _timed_gets(b_port, [item(n) for n in seq5], 1, b_port)
    if d5["remote_ok"] < len(seq5) or d5["remote_miss"]:
        raise AssertionError(f"B's remote reads: {d5}")
    before = _peer_counts(_scrape(b_port))
    con = _serve_concurrent(b_port, [
        (n, vol["needles"][n][3], vol["needles"][n][2]) for n in seq5],
        seed + 9, reads=CLUSTER_CONCURRENT_READS)
    d5c = _delta(before, _peer_counts(_scrape(b_port)))
    row5c = _read_row(con["lat"], con["wall"], d5c, con["bytes"])
    row5c.update(clients=SERVE_CLIENTS, client_procs=SERVE_CLIENT_PROCS)
    quiet("5", m5)
    # 6. shard 5 gone too: B's survivor gather (shard 0 local + 9 remote)
    cl.vstub("A").VolumeEcShardsUnmount(cl.vpb.VolumeEcShardsUnmountRequest(
        volume_id=1, shard_ids=[5]), timeout=60)
    cl.wait("the master drops shard 5", lambda: 5 not in cl.shards(1))
    seq6 = sorted(rng.choice(by_shard[5], size=min(
        CLUSTER_GATHER_READS, len(by_shard[5])), replace=False).tolist())
    traces6: list = []
    row6, d6 = _timed_gets(b_port, [item(n) for n in seq6], SERVE_CLIENTS,
                           b_port, traces6)
    k1_6 = d6["gf2_matmul"] + d6["gf2_matmul_small"]
    if not k1_6 or d6["remote_ok"] < 9 * len(seq6):
        raise AssertionError(f"B's survivor gather: {d6}")
    critpath = _cluster_critpath(cl, traces6)
    quiet("6", m5)
    # 6b. the reconstruct memo: needles of shard 5 not in seq6, read twice
    # on B; the second pass within the memo's TTL pulls nothing off A and
    # launches no K1
    row6b = _cluster_memo(b_port, spans, by_shard, set(seq6), item, rng)
    quiet("6b", m5)
    # 7. the SLO window: A's resident reads (K2+K3, the batch_dispatch
    # stage the SLO judges) and B's gathers (K1) at once
    triple = lambda nid: (nid, vol["needles"][nid][3], vol["needles"][nid][2])
    b7 = _peer_counts(_scrape(b_port))
    slo_row = _cluster_slo(cl, slo, [triple(n) for n in seq4],
                           [triple(n) for n in seq6], seed + 9, sink)
    d7 = _delta(b7, _peer_counts(_scrape(b_port)))
    # B's K1 launches and memo outcomes over step 7's re-reads of seq6
    # (400 needles, far more than the memo's budget)
    slo_row["B_memo"] = {"k1": d7["gf2_matmul"] + d7["gf2_matmul_small"],
                         "memo_hit": d7["memo_hit"],
                         "memo_miss": d7["memo_miss"],
                         "remote_ok": d7["remote_ok"]}
    a_final, b_final = _k_counts(_scrape(a_port)), _k_counts(_scrape(b_port))
    out = {"pin_s": pin_s, "scrub_wall_s": scrub_wall,
           "scrub_launches": scrub_launches, "telemetry_A": telemetry,
           "step4_resident_on_A": row4, "step5_remote_on_B": row5,
           "step5_remote_on_B_64_clients": row5c,
           "step6_gather_on_B": row6, "step6_critpath": critpath,
           "step6b_memo_on_B": row6b,
           "step7_slo": slo_row,
           "launches": {"A": a_final, "B": b_final}}
    log("cluster_full_width", needles=len(vol["needles"]),
        shards={"A": "1-13 (0 to B; 5 unmounted at step 6)", "B": "0"},
        scrub_shell=scrub_out.strip().splitlines()[-1], **out)
    return out


def _cluster_memo(b_port: int, spans: dict, by_shard: dict, skip: set,
                  item, rng) -> dict:
    """9a step 6b: up to MEMO_NEEDLES needles wholly inside one interval of
    shard 5 (missing since step 6) and outside step 6's sample, whose
    intervals sum to at most half of RECONSTRUCT_MEMO_BUDGET (reckoned from
    the needle map), read on B by one client twice.  The first pass
    gathers >=9 survivors an interval from A and launches K1, each
    interval a memo miss; the second, within RECONSTRUCT_MEMO_TTL_S of the
    first's start, is all hits: no remote fetch, no K1 launch, the same
    bytes (each body is checked against the needle's sha256 on both
    passes).  Each failure is fatal; writes nothing."""
    from seaweedfs_tpu_torch.storage.ec import volume as ec_volume

    budget = ec_volume.RECONSTRUCT_MEMO_BUDGET // 2
    cands = sorted(n for n in by_shard[5] if n not in skip
                   and spans[n][1] == {5} and len(spans[n][0]) == 1)
    pick, total = [], 0
    for n in rng.permutation(cands).tolist():
        size = spans[n][0][0].size
        if total + size <= budget:
            pick.append(n)
            total += size
            if len(pick) == MEMO_NEEDLES:
                break
    if len(pick) < MEMO_NEEDLES // 2:
        raise AssertionError(f"memo step: {len(pick)} needles of shard 5 "
                             f"fit {budget} B ({len(cands)} candidates)")
    items = [item(n) for n in pick]
    t0 = time.monotonic()
    row1, d1 = _timed_gets(b_port, items, 1, b_port)
    row2, d2 = _timed_gets(b_port, items, 1, b_port)
    span_s = time.monotonic() - t0
    n = len(pick)
    k1 = [d["gf2_matmul"] + d["gf2_matmul_small"] for d in (d1, d2)]
    if d1["remote_ok"] < 9 * n or not k1[0] or d1["memo_miss"] != n \
            or d1["memo_hit"]:
        raise AssertionError(f"memo step, first pass over {n} intervals: "
                             f"{d1}")
    if span_s >= ec_volume.RECONSTRUCT_MEMO_TTL_S:
        raise AssertionError(f"memo step: the two passes took {span_s} s, "
                             "past the memo's TTL")
    if d2["remote_ok"] or k1[1] or d2["memo_hit"] != n or d2["memo_miss"]:
        raise AssertionError(f"memo step, second pass over {n} intervals: "
                             f"{d2}")
    return {"needles": n, "memo_bytes": total, "budget_half": budget,
            "two_passes_s": span_s,
            "first": {**row1, "memo": {"hit": d1["memo_hit"],
                                       "miss": d1["memo_miss"]},
                      "remote_ok": d1["remote_ok"], "k1": k1[0]},
            "second": {**row2, "memo": {"hit": d2["memo_hit"],
                                        "miss": d2["memo_miss"]},
                       "remote_ok": d2["remote_ok"], "k1": k1[1]}}


async def _cluster_writes(master: str, pool: bytes, needles: list,
                          n_writers: int, collection: str = CLUSTER_COLLECTION,
                          replication: str = "") -> tuple[list, list]:
    """`n_writers` writers: each assigns a fid from the master (of
    `collection`, placed for `replication`) and POSTs its next needle on a
    keep-alive connection to the assigned server, until all are written:
    -> ([(fid, url, sha256 digest)], ack seconds per write)."""
    from seaweedfs_tpu_torch.operation import assign, upload_data
    from seaweedfs_tpu_torch.server.http import Client

    queue = list(reversed(needles))
    written, lat = [], []

    async def writer(i: int) -> None:
        clients: dict = {}
        try:
            while queue:
                _, _, off, size = queue.pop()
                data = pool[off:off + size]
                t0 = time.perf_counter()
                a = await assign(master, collection=collection,
                                 replication=replication)
                if a.url not in clients:
                    host, port = a.url.rsplit(":", 1)
                    clients[a.url] = Client(host, int(port))
                await upload_data(f"http://{a.url}/{a.fid}", data,
                                  f"w{i}-{len(written)}.bin",
                                  client=clients[a.url])
                lat.append(time.perf_counter() - t0)
                written.append((a.fid, a.url, hashlib.sha256(data).digest()))
        finally:
            for c in clients.values():
                await c.close()

    await asyncio.gather(*(writer(i) for i in range(n_writers)))
    from seaweedfs_tpu_torch.pb import close_all_channels

    await close_all_channels()
    return written, lat


async def _delete_each(port: int, fids: list, n_clients: int,
                       method: str = "DELETE", want: int = 200) -> None:
    """`method` every fid over `n_clients` keep-alive clients; each must
    answer `want` (DELETE: 200; GET of a deleted needle: 404)."""
    from seaweedfs_tpu_torch.server.http import Client

    queue = list(reversed(fids))

    async def client() -> None:
        c = Client("127.0.0.1", port)
        try:
            while queue:
                fid = queue.pop()
                status, _, _ = await c.request(method, "/" + fid)
                if status != want:
                    raise AssertionError(f"{method} /{fid}: HTTP {status}, "
                                         f"not {want}")
        finally:
            await c.close()

    await asyncio.gather(*(client() for _ in range(n_clients)))


def _cluster_vacuum(cl: _Cluster, vid: int, holder: str, dat: str,
                    written: list, seed: int) -> tuple[dict, list]:
    """9b's vacuum, between the writes and ec.encode.  The trap: the
    holder's ingest pipeline streamed rows of this volume on the card (K1)
    while the writes landed, and a vacuum moves every needle's offset.  A
    seeded VACUUM_DELETE_SHARE of the needles deleted over HTTP, then
    `volume.vacuum -volumeId N` through the shell (the master's pass:
    VacuumVolumeCheck, Compact and Commit on the holder) and a second
    pass under `volume.vacuum.disable`: revision 1 and one call of each
    rpc, the .dat shrunk by exactly the deleted records' bytes, the
    pipeline made invalid by the vacuum, every live needle byte-equal and
    every deleted one 404.  -> (the step's row, the live (fid, url,
    digest) entries)."""
    import numpy as np

    from seaweedfs_tpu_torch.storage import idx, needle
    from seaweedfs_tpu_torch.storage.types import parse_fid

    port = cl.ports[holder][0]
    stub = cl.vstub(holder)

    def pipeline() -> dict:
        return next((p for p in _get_json(port, "/status").get("Ingest", [])
                     if p["volume"] == vid), {})

    def revision() -> int:
        return stub.VolumeStatus(cl.vpb.VolumeStatusRequest(volume_id=vid),
                                 timeout=30).compact_revision

    armed = pipeline()
    if not (armed.get("valid") and armed.get("rows_device", 0) > 0):
        raise AssertionError("the holder's pipeline streamed no row on the "
                             f"card before the vacuum: {armed}")
    rng = np.random.default_rng(seed + 93)
    pick = set(rng.choice(len(written), int(len(written) * VACUUM_DELETE_SHARE),
                          replace=False).tolist())
    deleted = [w for i, w in enumerate(written) if i in pick]
    live = [w for i, w in enumerate(written) if i not in pick]
    sizes = {nid: size for nid, _, size in idx.walk(dat[:-4] + ".idx")}
    reclaim = sum(needle.actual_size(sizes[parse_fid(fid)[1]],
                                     needle.CURRENT_VERSION)
                  for fid, _, _ in deleted)
    size0 = os.path.getsize(dat)
    t0 = time.perf_counter()
    asyncio.run(_delete_each(port, [f for f, _, _ in deleted], CLUSTER_WRITERS))
    delete_wall = time.perf_counter() - t0
    garbage = stub.VacuumVolumeCheck(cl.vpb.VacuumVolumeCheckRequest(
        volume_id=vid), timeout=30).garbage_ratio
    m0 = _scrape(port)
    # the pass, then a second one under volume.vacuum.disable: one shell
    # (a shell process takes seconds to start); the second must do nothing
    vacuum = (f"volume.vacuum -garbageThreshold {VACUUM_THRESHOLD} "
              f"-volumeId {vid}")
    _, wall = cl.shell(f"{vacuum}; volume.vacuum.disable; {vacuum}; "
                       "volume.vacuum.enable")
    m1 = _scrape(port)
    rpc = {k: {"wall_s": m1[VACUUM_WALLS % ("sum", k)]
               - m0[VACUUM_WALLS % ("sum", k)],
               "calls": m1[VACUUM_WALLS % ("count", k)]
               - m0[VACUUM_WALLS % ("count", k)]}
           for k in ("check", "compact", "commit")}
    size1 = os.path.getsize(dat)
    after = pipeline()
    if revision() != 1 or any(r["calls"] != 1 for r in rpc.values()):
        raise AssertionError(f"the vacuum passes left revision "
                             f"{revision()}, rpcs {rpc}: one pass, and none "
                             "while vacuum was disabled")
    if size1 != size0 - reclaim:
        raise AssertionError(f"the .dat went {size0} -> {size1} bytes, not "
                             f"less the deleted records' {reclaim}")
    if after.get("valid", True) or "vacuum" not in after.get("reason", ""):
        raise AssertionError(f"the vacuum left the pipeline {after}")
    items = [("/" + fid, digest) for fid, _, digest in live]
    t0 = time.perf_counter()
    lat, _ = asyncio.run(_get_each(port, items, CLUSTER_READERS))
    read_wall = time.perf_counter() - t0
    asyncio.run(_delete_each(port, [f for f, _, _ in deleted], CLUSTER_READERS,
                             method="GET", want=404))
    row = {"needles": len(written), "deleted": len(deleted),
           "deleted_share": len(deleted) / len(written),
           "garbage_ratio": garbage, "delete_wall_s": delete_wall,
           "dat_bytes": [size0, size1], "reclaimed_bytes": size0 - size1,
           "rpc": rpc, "shell_wall_s": wall,
           "pipeline": {"before": armed, "after": after},
           "live_reads": {"reads": len(lat), "p50_ms": _pct(lat, 50),
                          "p99_ms": _pct(lat, 99),
                          "reads_per_s": len(lat) / read_wall,
                          "bodies_equal": True},
           "deleted_404": len(deleted), "revision": 1}
    log("cluster_vacuum", **row)
    return row, live


async def _redirected_gets(port: int, items: list) -> tuple[list, set]:
    """GET every (path, digest) on a server that answers 301: follow each
    Location once and verify the body -> (seconds per read, the hosts the
    redirects named)."""
    from seaweedfs_tpu_torch.server.http import Client

    lat, hosts = [], set()
    c = Client("127.0.0.1", port)
    peers: dict = {}
    try:
        for path, digest in items:
            t0 = time.perf_counter()
            status, h, _ = await c.request("GET", path)
            loc = h.get("Location", "")
            if status != 301 or not loc.startswith("http://"):
                raise AssertionError(f"{path}: HTTP {status}, Location {loc!r}")
            host, _, rest = loc[len("http://"):].partition("/")
            hosts.add(host)
            if host not in peers:
                name, port_s = host.rsplit(":", 1)
                peers[host] = Client(name, int(port_s))
            status, _, body = await peers[host].request("GET", "/" + rest)
            lat.append(time.perf_counter() - t0)
            if status != 200 or hashlib.sha256(body).digest() != digest:
                raise AssertionError(f"{loc}: HTTP {status}, the body differs")
    finally:
        await c.close()
        for p in peers.values():
            await p.close()
    return lat, hosts


def _cluster_replicated(cl: _Cluster, seed: int, unreplicated: dict) -> dict:
    """9b's replicated writes: /vol/grow of a `001` volume (collection
    ec9r: two copies on two of C, D, E), 32 writers assign and POST the
    4 KB-1 MB mix until it holds 64 MiB, each write fanned out by the
    holder that took it to the other copy.  Every fid is then read with a
    sha256 check on both holders, on the third server (which proxies to a
    holder), and on a fourth started with `-readMode redirect` (each 301
    followed).  Writes/s and ack p50/p99 beside 9b's unreplicated ones."""
    import urllib.request

    from seaweedfs_tpu_torch.pb import master_pb2

    with urllib.request.urlopen(
            f"http://127.0.0.1:{cl.master_http}/vol/grow?count=1"
            f"&collection={REPL_COLLECTION}&replication=001",
            timeout=60) as r:
        vid = json.loads(r.read())["vids"][0]
    needles = _ingest_needles(seed + 91, REPL_DAT_BYTES)
    pool = _ingest_pool(seed + 91)
    t0 = time.perf_counter()
    written, ack = asyncio.run(_cluster_writes(
        cl.master, pool, needles, CLUSTER_WRITERS, REPL_COLLECTION, "001"))
    wall = time.perf_counter() - t0
    if any(not f.startswith(f"{vid},") for f, _, _ in written):
        raise AssertionError(f"replicated writes left volume {vid}")
    resp = cl.mstub.LookupVolume(
        master_pb2.LookupVolumeRequest(volume_or_file_ids=[str(vid)]),
        timeout=10)
    holders = sorted(l.url for e in resp.volume_id_locations
                     for l in e.locations)
    by_url = {cl.url(n): n for n in ("C", "D", "E")}
    if len(holders) != 2 or not set(holders) <= set(by_url):
        raise AssertionError(f"the 001 volume {vid} is on {holders}")
    other = next(n for n in ("C", "D", "E") if cl.url(n) not in holders)
    items = [("/" + fid, digest) for fid, _, digest in written]
    out = {"vid": vid, "holders": [by_url[u] for u in holders],
           "writes": {"needles": len(written), "writers": CLUSTER_WRITERS,
                      "dat_bytes": sum(n[3] for n in needles),
                      "wall_s": wall, "writes_per_s": len(written) / wall,
                      "MBps": sum(n[3] for n in needles) / wall / 1e6,
                      "ack_p50_ms": _pct(ack, 50), "ack_p99_ms": _pct(ack, 99)},
           "unreplicated": {k: unreplicated[k] for k in (
               "writes_per_s", "MBps", "ack_p50_ms", "ack_p99_ms")}}
    for url in holders:
        n = by_url[url]
        lat, _ = asyncio.run(_get_each(cl.ports[n][0], items, CLUSTER_READERS))
        out[f"reads_holder_{n}"] = {"reads": len(lat), "p50_ms": _pct(lat, 50)}
    t0 = time.perf_counter()
    lat, _ = asyncio.run(_get_each(cl.ports[other][0], items, CLUSTER_READERS))
    out["reads_proxy"] = {"server": other, "reads": len(lat),
                          "reads_per_s": len(lat) / (time.perf_counter() - t0),
                          "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99)}
    cl.start_servers({"F": ["-readMode", "redirect", "-index", "native"]})
    t0 = time.perf_counter()
    lat, hosts = asyncio.run(_redirected_gets(cl.ports["F"][0], items))
    if not hosts <= set(holders):
        raise AssertionError(f"redirects named {hosts}, not the holders")
    out["reads_redirect"] = {"server": "F", "reads": len(lat),
                             "reads_per_s": len(lat) / (time.perf_counter() - t0),
                             "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99),
                             "redirected_to": sorted(by_url[h] for h in hosts)}
    out["movers"] = _cluster_movers(cl, vid, [by_url[u] for u in holders],
                                    written, seed)
    cl.kill("F")
    log("cluster_replicated", **out, bodies_equal=True, reduced={
        "dat_mib": REPL_DAT_BYTES >> 20,
        "why": "the write budget: two copies of this .dat"})
    return out


def _cluster_movers(cl: _Cluster, vid: int, holders: list, written: list,
                    seed: int) -> dict:
    """9b's `.dat` movers, on the 001 volume both holders streamed stripe
    rows of on the card while its writes landed.  H, the holder whose
    pipeline holds rows on the card, moves its .dat to its local tier
    (VolumeMarkReadonly, VolumeTierMoveDatToRemote): the pipeline goes
    invalid (TIER_UPLOAD), the local .dat goes, the tier object is the
    .dat's bytes, and every fid reads byte-equal from the tier.  Then back
    (VolumeTierMoveDatFromRemote): the .dat's bytes again, the object
    deleted, 64 seeded fids read.  Then VolumeCopy onto F (`-index
    native`): its .dat and .idx equal H's, its .ndx exists, every fid is
    served by F itself, and F deletes it.  Then the seal on H
    (VolumeEcShardsGenerate): offline, with K1 on the card, its 14 shards
    equal to the native codec's encode of H's .dat; the seal's files are
    removed.  Every failed check is fatal."""
    import numpy as np

    from seaweedfs_tpu_torch.storage.store import TIER_DOWNLOAD, TIER_UPLOAD

    def pipeline(name: str) -> dict:
        return next((p for p in _get_json(cl.ports[name][0], "/status").get(
            "Ingest", []) if p["volume"] == vid), {})

    armed = {n: pipeline(n) for n in holders}
    h = next((n for n in holders if armed[n].get("valid")
              and armed[n].get("rows_device", 0) > 0), None)
    if h is None:
        raise AssertionError(f"neither holder streamed a row of volume {vid} "
                             f"on the card: {armed}")
    stub, vpb = cl.vstub(h), cl.vpb
    stem = f"{REPL_COLLECTION}_{vid}"
    base = os.path.join(cl.dir, h, stem)
    tier = os.path.join(cl.dir, h, "tier")
    items = [("/" + fid, digest) for fid, _, digest in written]
    port = cl.ports[h][0]
    walls: dict = {}

    def timed(name: str, call):
        t0 = time.perf_counter()
        out = call()
        walls[name] = time.perf_counter() - t0
        return out

    def gets(server: str, sample: list) -> dict:
        t0 = time.perf_counter()
        lat, _ = asyncio.run(_get_each(cl.ports[server][0], sample,
                                       CLUSTER_READERS))
        return {"server": server, "reads": len(lat),
                "reads_per_s": len(lat) / (time.perf_counter() - t0),
                "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99)}

    dat_sha = sha256_file(base + ".dat")
    dat_bytes = os.path.getsize(base + ".dat")
    timed("VolumeMarkReadonly", lambda: stub.VolumeMarkReadonly(
        vpb.VolumeMarkReadonlyRequest(volume_id=vid), timeout=60))
    up = timed("VolumeTierMoveDatToRemote", lambda: list(
        stub.VolumeTierMoveDatToRemote(vpb.VolumeTierMoveDatToRemoteRequest(
            volume_id=vid, collection=REPL_COLLECTION,
            destination_backend_name="local.default"), timeout=300)))
    after_up = pipeline(h)
    objects = os.listdir(tier)
    if (after_up.get("valid", True) or after_up.get("reason") != TIER_UPLOAD
            or os.path.exists(base + ".dat") or len(objects) != 1
            or sha256_file(os.path.join(tier, objects[0])) != dat_sha
            or [r.processed for r in up] != [dat_bytes]):
        raise AssertionError(f"the upload left the pipeline {after_up}, the "
                             f"tier {objects}, the .dat there: "
                             f"{os.path.exists(base + '.dat')}")
    tiered = gets(h, items)
    timed("VolumeTierMoveDatFromRemote", lambda: list(
        stub.VolumeTierMoveDatFromRemote(
            vpb.VolumeTierMoveDatFromRemoteRequest(
                volume_id=vid, collection=REPL_COLLECTION), timeout=300)))
    after_down = pipeline(h)
    if (after_down.get("valid", True)
            or after_down.get("reason") != TIER_DOWNLOAD
            or sha256_file(base + ".dat") != dat_sha or os.listdir(tier)):
        raise AssertionError(f"the download left the pipeline {after_down}, "
                             f"the tier {os.listdir(tier)}")
    rng = np.random.default_rng(seed + 94)
    sample = [items[i] for i in sorted(rng.choice(
        len(items), min(64, len(items)), replace=False).tolist())]
    local = gets(h, sample)
    fbase = os.path.join(cl.dir, "F", stem)
    fstub = cl.vstub("F")
    copied = timed("VolumeCopy", lambda: list(fstub.VolumeCopy(
        vpb.VolumeCopyRequest(volume_id=vid, collection=REPL_COLLECTION,
                              source_data_node=f"127.0.0.1:{cl.ports[h][1]}"),
        timeout=300)))
    if (sha256_file(fbase + ".dat") != dat_sha
            or sha256_file(fbase + ".idx") != sha256_file(base + ".idx")
            or not os.path.exists(fbase + ".ndx")):
        raise AssertionError("F's copy differs from H's files, or has no "
                             ".ndx")
    # every fid served by F itself: _get_each fails on the 301 F would
    # answer for a volume it does not hold
    on_f = gets("F", items)
    timed("VolumeDelete_F", lambda: fstub.VolumeDelete(
        vpb.VolumeDeleteRequest(volume_id=vid), timeout=60))
    m0 = _scrape(port)
    timed("VolumeEcShardsGenerate", lambda: stub.VolumeEcShardsGenerate(
        vpb.VolumeEcShardsGenerateRequest(volume_id=vid,
                                          collection=REPL_COLLECTION),
        timeout=600))
    m1 = _scrape(port)
    seals = {p: m1[SEALS % p] - m0[SEALS % p] for p in ("offline", "streamed")}
    k1 = _delta(_k_counts(m0), _k_counts(m1))
    native, native_s = _native_shard_hashes(base + ".dat")
    shards = [sha256_file(base + ec_ext) for ec_ext in (
        f".ec{i:02d}" for i in range(14))]
    if seals != {"offline": 1, "streamed": 0}:
        raise AssertionError(f"the seal after the movers ran {seals}")
    if k1["gf2_matmul"] + k1["gf2_matmul_small"] < 1:
        raise AssertionError(f"the seal launched no K1 on {h}: {k1}")
    if shards != native:
        raise AssertionError("the seal's shards differ from the native "
                             f"codec's: {[i for i in range(14) if shards[i] != native[i]]}")
    for ext in [f".ec{i:02d}" for i in range(14)] + [".ecx"]:
        os.remove(base + ext)
    row = {"holder": h, "vid": vid, "rpc_wall_s": walls,
           "pipeline": {"before": armed[h], "after_upload": after_up,
                        "after_download": after_down},
           "tiered_reads": tiered, "local_reads": local,
           "copy": {"bytes": copied[0].processed_bytes if copied else 0,
                    "wall_s": walls["VolumeCopy"], "reads_on_F": on_f,
                    "redirects": 0},
           "seal": {"wall_s": walls["VolumeEcShardsGenerate"], "seals": seals,
                    "k1_launches": k1["gf2_matmul"] + k1["gf2_matmul_small"],
                    "native_s": native_s, "shards_equal": True},
           "dat_sha256_equal": True,
           "reduced": {"dat_mib": REPL_DAT_BYTES >> 20,
                       "why": "the write budget"}}
    log("cluster_movers", **row)
    return row


def _cluster_shell_verbs(cl: _Cluster, seed: int) -> dict:
    """9b: the shell's verbs that write, on a fresh 192 MiB volume of
    collection ec9 over three servers (C, D, E, no cache): writes through
    the master's assign (the holder's ingest plane streams their stripe
    rows on the card), the vacuum (_cluster_vacuum), `ec.encode` (the
    offline seal: K1 on the holder, then the spread), GETs, the loss of
    the server with the fewest shards, GETs from the survivors (remote
    survivors, K1), `ec.rebuild -force`, `ec.balance -force`,
    `ec.decode`.  Every shard is held against the native codec's encode
    of the compacted .dat (hashed in memory), the decoded .dat against a
    hard link of the compacted one, taken after the vacuum's commit."""
    import urllib.request

    from seaweedfs_tpu_torch.storage import ec

    names = ("C", "D", "E")
    # each with a local tier (the `.dat` movers' step, _cluster_movers)
    cl.start_servers({n: ["-tier.dir", os.path.join(cl.dir, n, "tier")]
                      for n in names})
    with urllib.request.urlopen(
            f"http://127.0.0.1:{cl.master_http}/vol/grow?count=1"
            f"&collection={CLUSTER_COLLECTION}", timeout=60) as r:
        vid = json.loads(r.read())["vids"][0]
    needles = _ingest_needles(seed + 90, CLUSTER_DAT_BYTES)
    pool = _ingest_pool(seed + 90)
    t0 = time.perf_counter()
    written, ack = asyncio.run(_cluster_writes(cl.master, pool, needles,
                                               CLUSTER_WRITERS))
    write_wall = time.perf_counter() - t0
    urls = {url for _, url, _ in written}
    holder = next(n for n in names if cl.url(n) in urls)
    if len(urls) != 1 or any(not f.startswith(f"{vid},") for f, _, _ in written):
        raise AssertionError(f"writes left volume {vid}: {sorted(urls)}")
    stem = f"{CLUSTER_COLLECTION}_{vid}"
    dat = os.path.join(cl.dir, holder, stem + ".dat")
    dat_bytes = os.path.getsize(dat)
    if dat_bytes < CLUSTER_DAT_BYTES:
        raise AssertionError(f"the .dat holds {dat_bytes} bytes")
    writes = {"needles": len(written), "dat_bytes": dat_bytes,
              "writers": CLUSTER_WRITERS, "wall_s": write_wall,
              "writes_per_s": len(written) / write_wall,
              "MBps": sum(n[3] for n in needles) / write_wall / 1e6,
              "ack_p50_ms": _pct(ack, 50), "ack_p99_ms": _pct(ack, 99)}
    vacuum, written = _cluster_vacuum(cl, vid, holder, dat, written, seed)
    # the compacted .dat's bytes (vacuum's commit replaced the inode),
    # kept past the encode's delete
    oracle = os.path.join(cl.dir, "oracle.dat")
    os.link(dat, oracle)
    native, native_s = _native_shard_hashes(oracle)
    dat_sha = sha256_file(oracle)
    replicated = _cluster_replicated(cl, seed, writes)

    def shard_files() -> dict:
        """shard id -> [(server, sha256)] of every .ecNN on disk."""
        out: dict = {}
        for n in names:
            if n in cl.killed:
                continue
            for sid in range(14):
                path = os.path.join(cl.dir, n, stem + ec.to_ext(sid))
                if os.path.exists(path):
                    out.setdefault(sid, []).append((n, sha256_file(path)))
        return out

    def held_once() -> bool:
        locs = cl.shards(vid)
        return sorted(locs) == list(range(14)) and all(
            len(v) == 1 for v in locs.values())

    def listed_where_stored() -> bool:
        """The master lists each shard once, on the server whose disk holds
        its file.  A verb's shell returns before the servers' heartbeat
        deltas reach the master (up to a pulse later), and the state before
        a spread or a balance also lists each shard once."""
        on_disk = {sid: [cl.url(n) for n in names if n not in cl.killed
                         and os.path.exists(os.path.join(
                             cl.dir, n, stem + ec.to_ext(sid)))]
                   for sid in range(14)}
        locs = cl.shards(vid)
        return all(len(on_disk[sid]) == 1 and locs.get(sid) == on_disk[sid]
                   for sid in range(14))

    def placement() -> dict:
        by_url = {cl.url(n): n for n in names}
        return {sid: by_url[u[0]] for sid, u in sorted(cl.shards(vid).items())}

    def check_shards(what: str) -> None:
        files = shard_files()
        for sid in range(14):
            got = files.get(sid, [])
            if len(got) != 1 or got[0][1] != native[sid]:
                raise AssertionError(f"{what}: shard {sid} on disk {got}, "
                                     "not the native codec's bytes")

    def reads(reader: str) -> dict:
        items = [("/" + fid, digest) for fid, _, digest in written]
        row, _ = _timed_gets(cl.ports[reader][0], items, CLUSTER_READERS,
                             cl.ports[reader][0])
        row["server"] = reader
        return row

    verbs = {}
    m_holder0 = _scrape(cl.ports[holder][0])
    k_holder0 = _k_counts(m_holder0)
    _, verbs["ec.encode"] = cl.shell(
        f"lock; ec.encode -volumeId {vid}; unlock")
    cl.wait("the master lists 14 spread shards", listed_where_stored)
    m_holder1 = _scrape(cl.ports[holder][0])
    encode_k1 = {k: v - k_holder0[k] for k, v in _k_counts(m_holder1).items()}
    if not encode_k1["gf2_matmul"] + encode_k1["gf2_matmul_small"]:
        raise AssertionError(f"ec.encode launched no K1 on {holder}")
    seal = {p: m_holder1[SEALS % p] - m_holder0[SEALS % p]
            for p in ("streamed", "offline")}
    if seal != {"streamed": 0, "offline": 1}:
        raise AssertionError(f"the vacuumed volume's seal on {holder}: {seal}"
                             " (the vacuum must leave it offline)")
    check_shards("ec.encode")
    spread = placement()
    counts = {n: sum(1 for v in spread.values() if v == n) for n in names}
    most = max(names, key=lambda n: counts[n])
    read_spread = reads(most)
    victim = min(names, key=lambda n: counts[n])
    if not 0 < counts[victim] <= 4:
        raise AssertionError(f"placement after ec.encode: {spread}")
    finals = {victim: _k_counts(_scrape(cl.ports[victim][0]))}
    cl.kill(victim)
    cl.wait(f"the master drops {victim}",
            lambda: cl.url(victim) not in (cl._try(cl.nodes) or [cl.url(victim)]))
    survivors = [n for n in names if n != victim]
    read_lost = reads(most)
    if not (read_lost["launches"]["gf2_matmul"]
            + read_lost["launches"]["gf2_matmul_small"]):
        raise AssertionError("reads after the loss launched no K1")
    k_before = {n: _k_counts(_scrape(cl.ports[n][0])) for n in survivors}
    _, verbs["ec.rebuild"] = cl.shell("lock; ec.rebuild -force; unlock")
    cl.wait("the master lists 14 shards again", listed_where_stored)
    check_shards("ec.rebuild")
    rebuild_k1 = sum(
        _k_counts(_scrape(cl.ports[n][0]))[k] - k_before[n][k]
        for n in survivors for k in ("gf2_matmul", "gf2_matmul_small"))
    if not rebuild_k1:
        raise AssertionError("ec.rebuild launched no K1")
    rebuilt = placement()
    auto = _cluster_auto_repair(cl, vid, survivors, rebuilt, held_once,
                                listed_where_stored, check_shards, placement)
    _, verbs["ec.balance"] = cl.shell("lock; ec.balance -force; unlock")
    cl.wait("the master lists 14 balanced shards", listed_where_stored)
    check_shards("ec.balance")
    balanced = placement()
    _, verbs["ec.decode"] = cl.shell(f"lock; ec.decode -volumeId {vid}; unlock")
    cl.wait("the master drops the EC shards", lambda: not cl.shards(vid))
    decoded = [n for n in survivors
               if os.path.exists(os.path.join(cl.dir, n, stem + ".dat"))]
    if len(decoded) != 1 or sha256_file(os.path.join(
            cl.dir, decoded[0], stem + ".dat")) != dat_sha:
        raise AssertionError(f"decoded .dat on {decoded} differs from the "
                             "original")
    for n in survivors:
        finals[n] = _k_counts(_scrape(cl.ports[n][0]))
    out = {"vid": vid, "writes": writes, "replicated": replicated,
           "vacuum": vacuum, "seal": seal,
           "native_encode_in_memory_s": native_s,
           "verb_wall_s": verbs, "holder": holder, "victim": victim,
           "auto_repair": auto,
           "placement": {"encode": spread, "rebuild": rebuilt,
                         "repair": auto["placement"], "balance": balanced},
           "reads_spread": read_spread, "reads_after_loss": read_lost,
           "k1": {"encode": encode_k1, "rebuild": rebuild_k1},
           "shards_equal_native": True, "decoded_dat_equal": True,
           "launches": finals}
    log("cluster_shell_verbs", **out, reduced={
        "dat_gib": [FULL_VOLUME_GIB, CLUSTER_DAT_BYTES / (1 << 30)],
        "why": "the write budget: a call may write 45 GiB, deleted files "
               "counted; the main path writes 3.8x its 11 GiB volume and "
               "the vacuum and the verbs about 6x this .dat"})
    return out


def _cluster_auto_repair(cl: _Cluster, vid: int, survivors: list,
                         rebuilt: dict, held_once, listed_where_stored,
                         check_shards, placement) -> dict:
    """9b's second loss, after ec.rebuild healed the first: the repair
    plane resumed, two shards unmounted and deleted on the survivor that
    holds more, and the master brings the volume back to 14 shards with no
    shell verb (its job's VolumeEcShardsRebuild is K1 on the rebuilder's
    card).  Every shard is held against the native codec's; the plane is
    paused again for ec.balance and ec.decode."""
    tth = "SeaweedFS_master_repair_time_to_healthy_seconds"
    cl.shell("volume.repair.resume")
    # the resumed plane's first cycle closes the episode vid 1 opened
    cl.wait("the repair plane's first cycle",
            lambda: cl.health()["repair"]["last_time_to_healthy_s"]
            is not None)
    m0 = _scrape(cl.master_http)
    k_before = {n: _k_counts(_scrape(cl.ports[n][0])) for n in survivors}
    loser = max(survivors,
                key=lambda n: sum(1 for v in rebuilt.values() if v == n))
    lost = sorted(sid for sid, n in rebuilt.items() if n == loser)[:2]
    stub = cl.vstub(loser)
    t0 = time.perf_counter()
    stub.VolumeEcShardsUnmount(cl.vpb.VolumeEcShardsUnmountRequest(
        volume_id=vid, shard_ids=lost), timeout=60)
    stub.VolumeEcShardsDelete(cl.vpb.VolumeEcShardsDeleteRequest(
        volume_id=vid, collection=CLUSTER_COLLECTION, shard_ids=lost),
        timeout=60)

    def observed() -> bool:
        return _scrape(cl.master_http)[tth + "_count"] > m0[tth + "_count"]

    cl.wait("the master sees the loss",
            lambda: not held_once() or observed())
    cl.wait("the master lists 14 shards, healed with no shell verb",
            held_once)
    listed_wall = time.perf_counter() - t0
    # the job done (its spread too) and the census healthy again
    cl.wait("the repair's time to healthy", observed)
    heal_wall = time.perf_counter() - t0
    cl.wait("the master lists the healed shards where they are stored",
            listed_where_stored)
    m1 = _scrape(cl.master_http)
    st = cl.health()["repair"]
    v = st["volumes"][str(vid)]
    by_url = {cl.url(n): n for n in survivors}
    rebuilder = by_url[v["last_result"]["rebuilder"]]
    k_after = _k_counts(_scrape(cl.ports[rebuilder][0]))
    k1 = {k: k_after[k] - k_before[rebuilder][k]
          for k in ("gf2_matmul", "gf2_matmul_small")}
    if not sum(k1.values()):
        raise AssertionError(f"the repair on {rebuilder} launched no K1")
    check_shards("the master's repair")
    if not cl.repair("pause")["paused"]:
        raise AssertionError("volume.repair.pause left the plane running")
    row = {"lost": {"server": loser, "shards": lost},
           "listed_wall_s": listed_wall, "heal_wall_s": heal_wall,
           "time_to_healthy_s": m1[tth + "_sum"] - m0[tth + "_sum"],
           "status_time_to_healthy_s": st["last_time_to_healthy_s"],
           "completed": st["totals"]["completed"],
           "totals": st["totals"], "rebuilder": rebuilder,
           "rebuilt": v["last_result"]["rebuilt"],
           "spread": {by_url.get(u, u): sids for u, sids
                      in v["last_result"]["spread"].items()},
           "rebuilder_k1": k1, "placement": placement(),
           "shards_equal_native": True}
    log("cluster_auto_repair", **row)
    return row


def _vid1_unrecoverable(cl: _Cluster) -> dict:
    """Between 9a and 9b, A killed and B holding shard 0: the repair plane
    resumed until its status flags vid 1 unrecoverable, then paused again
    for 9b's first loss.  9a ran paused, so vid 1 was never queued."""
    cl.wait("the master drops A", lambda: len(cl.shards(1)) == 1)
    cl.shell("volume.repair.resume")

    def seen() -> bool:
        v = cl.health()["repair"]["volumes"].get("1", {})
        return v.get("state") == "unrecoverable"

    cl.wait("vid 1 flagged unrecoverable", seen)
    st = cl.repair("pause")
    v = st["volumes"]["1"]
    if st["totals"]["queued"] or st["inflight"] or not st["paused"]:
        raise AssertionError(f"vid 1 was queued for repair: {st}")
    row = {"state": v["state"], "healthy_shards": v["healthy_shards"],
           "missing": v["missing"], "totals": st["totals"]}
    log("cluster_repair_9a", **row)
    return row


# 9c: the leader's SIGKILL mid-life of an EC volume: three masters under
# raft, a master.follower and three volume servers; the volume the writers
# fill through the leader's assign (64 MiB, 6x of writes with its shards
# and the rebuilt two, §4 of PERF.md)
HA_DAT_BYTES = 64 << 20
HA_COLLECTION = "ec9c"
HA_MASTERS = ("M1", "M2", "M3")
HA_SERVERS = ("X", "Y", "Z")


class _HaGroup:
    """9c's processes, as users start them: three `master -peers ...
    -mdir ...`, one `master.follower -masters ...` and three `volume
    -mserver M1,M2,M3 -ec.backend cuda` (no device cache), and the calls
    the step makes to them over the RPC plane and HTTP."""

    def __init__(self, workdir: str, stack: contextlib.ExitStack):
        from seaweedfs_tpu_torch.pb import (
            Stub, master_pb2, sync_channel_cached, volume_server_pb2)

        self.pb, self.vpb = master_pb2, volume_server_pb2
        self._stub, self._chan = Stub, sync_channel_cached
        self.dir = workdir
        self.stack = stack
        self.env = {"TMPDIR": os.path.join(workdir, "tmp")}
        os.makedirs(self.env["TMPDIR"])
        self.ports = {}
        for n in HA_MASTERS + HA_SERVERS + ("F",):
            http, grpc = _free_port(), _free_port()
            while grpc == http + 10000:  # a master would advertise the
                grpc = _free_port()      # short form -peers does not spell
            self.ports[n] = (http, grpc)
        self.peers = ",".join(self.advertise(n) for n in HA_MASTERS)
        self.procs: dict = {}
        self.killed: set = set()

    def advertise(self, name: str) -> str:
        http, grpc = self.ports[name]
        return f"127.0.0.1:{http}.{grpc}"

    def url(self, name: str) -> str:
        return f"127.0.0.1:{self.ports[name][0]}"

    def start(self, name: str) -> None:
        http, grpc = self.ports[name]
        base = ["-port", str(http), "-port.grpc", str(grpc)]
        if name in HA_MASTERS:
            command, args = "master", base + [
                "-peers", self.peers, "-mdir", os.path.join(self.dir, name),
                "-pulseSeconds", "1", "-ec.repair.intervalSeconds", "1"]
        elif name == "F":
            command, args = "master.follower", base + ["-masters", self.peers]
        else:
            d = os.path.join(self.dir, name)
            os.makedirs(d, exist_ok=True)
            command, args = "volume", base + [
                "-dir", d, "-mserver", self.peers, "-ec.backend", "cuda",
                "-pulseSeconds", "1"]
        log_path = os.path.join(self.dir, f"{name}.log")
        if name in self.procs:  # a restart keeps the first life's log
            log_path = os.path.join(self.dir, f"{name}-restart.log")
        self.killed.discard(name)
        self.procs[name] = self.stack.enter_context(_volume_server(
            args, log_path, self.env, command=command))

    def kill(self, name: str) -> None:
        """SIGKILL, as a crash."""
        self.killed.add(name)
        self.procs[name].kill()
        self.procs[name].wait(30)

    def mstub(self, name: str):
        return self._stub(self._chan(f"127.0.0.1:{self.ports[name][1]}"),
                          self.pb, "Seaweed")

    def vstub(self, name: str):
        return self._stub(self._chan(f"127.0.0.1:{self.ports[name][1]}"),
                          self.vpb, "VolumeServer")

    def wait(self, what: str, pred, timeout: float = CLUSTER_WAIT_S) -> float:
        """Poll `pred` until true: -> seconds waited.  A process that exits
        meanwhile is fatal."""
        t0 = time.perf_counter()
        while not _Cluster._try(pred):
            for name, proc in self.procs.items():
                if proc.poll() is not None and name not in self.killed:
                    raise AssertionError(f"{name} exited ({proc.returncode})")
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"timed out waiting for {what}")
            time.sleep(0.05)
        return time.perf_counter() - t0

    def raft(self, name: str) -> dict:
        """RaftListClusterServers on one master: term, members, leader."""
        resp = self.mstub(name).RaftListClusterServers(
            self.pb.RaftListClusterServersRequest(), timeout=5)
        return {"term": resp.term,
                "members": sorted(s.id for s in resp.cluster_servers),
                "leader": [s.id for s in resp.cluster_servers if s.is_leader]}

    def agreed_leader(self, names) -> str | None:
        """The master every one of `names` names as the one leader, in one
        term, itself among `names`; else None."""
        views = [self.raft(n) for n in names]
        leaders = {tuple(v["leader"]) for v in views}
        if len(leaders) != 1 or len({v["term"] for v in views}) != 1:
            return None
        (leader,) = leaders
        if len(leader) != 1:
            return None
        by_adv = {self.advertise(n): n for n in names}
        return by_adv.get(leader[0])

    def nodes(self, master: str) -> set:
        info = json.loads(self.mstub(master).VolumeList(
            self.pb.VolumeListRequest(), timeout=10).topology_info_json)
        return {n["id"] for dc in info["data_centers"]
                for r in dc["racks"] for n in r["nodes"]}

    def shards(self, master: str, vid: int) -> dict:
        from seaweedfs_tpu_torch.pb import RpcError, StatusCode

        try:
            resp = self.mstub(master).LookupEcVolume(
                self.pb.LookupEcVolumeRequest(volume_id=vid), timeout=10)
        except RpcError as e:
            if e.code() == StatusCode.NOT_FOUND:
                return {}
            raise
        return {e.shard_id: sorted(l.url for l in e.locations)
                for e in resp.shard_id_locations}

    def shell(self, script: str) -> str:
        proc = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell", "-master",
             self.peers, "-c", script],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"shell {script!r} failed: {proc.stdout}"
                                 f"{proc.stderr[-4000:]}")
        return proc.stdout


def _http_status(port: int, path: str) -> tuple[int, dict, bytes]:
    """One GET that follows no redirect: -> (status, headers, body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _fid_key(fid: str) -> int:
    return int(fid.split(",")[1][:-8], 16)


def _cluster_ha(workdir: str, seed: int) -> dict:
    """9c: three masters under raft, a master.follower and three volume
    servers, started together.  The leader as `cluster.raft.ps` names it;
    a volume of collection ec9c grown through the leader, a /dir/assign at
    a follower answered 307 to the leader, 32 writers filling 64 MiB
    through the leader's assign, `ec.encode` (K1 on the holder; every
    shard equal to the native codec's).  Then the leader SIGKILLed: the
    seconds to one new leader (RaftListClusterServers on each survivor),
    to the three servers and 14 shards listed where stored, to the
    follower naming the new leader and answering /dir/lookup; the new
    leader's repair totals then (none queued; its plane running, as
    PauseRepair is one master's); an assign's fid key and a growth's vid
    past every one before the kill; every needle read back byte-equal
    through the new leader's lookup (32 clients); two shards unmounted
    and deleted on a holder and healed by the new leader's repair plane
    (K1 on the rebuilder, every shard equal to the native codec's); the
    killed master restarted on its -mdir: a follower at the new term or
    later, three members and one leader on every master, its MaxVolumeId
    the leader's."""
    from seaweedfs_tpu_torch.storage import ec

    tth = "SeaweedFS_master_repair_time_to_healthy_seconds"
    row: dict = {}
    with contextlib.ExitStack() as stack:
        g = _HaGroup(workdir, stack)
        t_start = time.perf_counter()
        for name in HA_MASTERS + ("F",) + HA_SERVERS:
            g.start(name)
        g.wait("a single leader",
               lambda: g.agreed_leader(HA_MASTERS) is not None)
        row["election_s"] = time.perf_counter() - t_start
        leader = g.agreed_leader(HA_MASTERS)
        row["terms"] = {n: g.raft(n)["term"] for n in HA_MASTERS}
        out = g.shell("cluster.raft.ps")
        named = [ln.split()[0] for ln in out.splitlines()
                 if ln.strip().endswith("leader")]
        if named != [g.advertise(leader)]:
            raise AssertionError(f"cluster.raft.ps names {named}, not "
                                 f"{leader}: {out}")
        row["raft_ps"] = out.strip().splitlines()
        urls = {g.url(n): n for n in HA_SERVERS}
        g.wait("three servers at the leader",
               lambda: g.nodes(leader) == set(urls))
        row["servers_registered_s"] = time.perf_counter() - t_start
        lport = g.ports[leader][0]
        vid = _get_json(lport, f"/vol/grow?count=1&collection="
                        f"{HA_COLLECTION}")["vids"][0]
        other = next(n for n in HA_MASTERS if n != leader)
        status, headers, _ = _http_status(
            g.ports[other][0], f"/dir/assign?collection={HA_COLLECTION}")
        want = f"http://{g.url(leader)}/dir/assign?collection={HA_COLLECTION}"
        if status != 307 or headers.get("Location") != want:
            raise AssertionError(f"/dir/assign at {other}: {status} "
                                 f"{headers.get('Location')}, not 307 {want}")
        needles = _ingest_needles(seed + 93, HA_DAT_BYTES)
        pool = _ingest_pool(seed + 93)
        t0 = time.perf_counter()
        written, ack = asyncio.run(_cluster_writes(
            g.advertise(leader), pool, needles, CLUSTER_WRITERS,
            collection=HA_COLLECTION))
        wall = time.perf_counter() - t0
        hosts = {u for _, u, _ in written}
        if len(hosts) != 1 or any(not f.startswith(f"{vid},")
                                  for f, _, _ in written):
            raise AssertionError(f"writes left volume {vid}: {sorted(hosts)}")
        holder = urls[hosts.pop()]
        row["writes"] = {"needles": len(written), "wall_s": wall,
                         "writes_per_s": len(written) / wall,
                         "ack_p50_ms": _pct(ack, 50),
                         "ack_p99_ms": _pct(ack, 99)}
        keys_before = max(_fid_key(f) for f, _, _ in written)
        stem = f"{HA_COLLECTION}_{vid}"
        oracle = os.path.join(workdir, "oracle.dat")
        os.link(os.path.join(workdir, holder, stem + ".dat"), oracle)
        native, _ = _native_shard_hashes(oracle)

        def where_stored() -> dict:
            return {sid: [g.url(n) for n in HA_SERVERS if os.path.exists(
                os.path.join(workdir, n, stem + ec.to_ext(sid)))]
                for sid in range(14)}

        def listed(master: str) -> bool:
            on_disk = where_stored()
            locs = g.shards(master, vid)
            return all(len(on_disk[s]) == 1 and locs.get(s) == on_disk[s]
                       for s in range(14))

        def check_shards(what: str) -> None:
            for sid in range(14):
                got = [sha256_file(os.path.join(workdir, n,
                                                stem + ec.to_ext(sid)))
                       for n in HA_SERVERS if os.path.exists(os.path.join(
                           workdir, n, stem + ec.to_ext(sid)))]
                if got != [native[sid]]:
                    raise AssertionError(f"{what}: shard {sid} {got}, not "
                                         "the native codec's bytes")

        k0 = _k_counts(_scrape(g.ports[holder][0]))
        g.shell(f"lock; ec.encode -volumeId {vid}; unlock")
        g.wait("the leader lists 14 spread shards", lambda: listed(leader))
        k1 = _k_counts(_scrape(g.ports[holder][0]))
        encode_k1 = {k: k1[k] - k0[k] for k in ("gf2_matmul",
                                                "gf2_matmul_small")}
        if not sum(encode_k1.values()):
            raise AssertionError(f"ec.encode launched no K1 on {holder}")
        check_shards("ec.encode")
        vids_before = _get_json(lport, "/cluster/status")["MaxVolumeId"]
        row.update(vid=vid, holder=holder, encode_k1=encode_k1,
                   max_key_before=keys_before, max_vid_before=vids_before)

        # the leader's SIGKILL
        survivors = [n for n in HA_MASTERS if n != leader]
        t_kill = time.perf_counter()
        g.kill(leader)
        g.wait("one new leader among the survivors",
               lambda: g.agreed_leader(survivors) is not None)
        row["new_leader_s"] = time.perf_counter() - t_kill
        new = g.agreed_leader(survivors)
        row["new_term"] = g.raft(new)["term"]
        g.wait("the servers and 14 shards at the new leader",
               lambda: g.nodes(new) == set(urls) and listed(new))
        row["reregistered_s"] = time.perf_counter() - t_kill
        fport = g.ports["F"][0]

        def follower_switched() -> bool:
            st = _get_json(fport, "/cluster/status")
            code, _, _ = _http_status(fport, f"/dir/lookup?volumeId={vid}")
            return st["Leader"] == g.advertise(new) and code == 200

        g.wait("the follower on the new leader", follower_switched)
        row["follower_switch_s"] = time.perf_counter() - t_kill
        nport = g.ports[new][0]
        health = _get_json(nport, "/cluster/health.json")["repair"]
        row["repair_at_14"] = {"totals": health["totals"],
                               "paused": health["paused"]}
        if health["totals"]["queued"] or health["paused"]:
            raise AssertionError(f"the new leader's repair plane: {health}")

        # past the kill: ids above every one handed out before
        a = _get_json(nport, f"/dir/assign?collection={HA_COLLECTION}")
        grown = _get_json(nport, "/vol/grow?count=1")["vids"]
        row["key_after"] = _fid_key(a["fid"])
        row["vid_after"] = min(grown + [int(a["fid"].split(",")[0])])
        if row["key_after"] <= keys_before or row["vid_after"] <= vids_before:
            raise AssertionError(f"ids re-minted after the kill: {a}, "
                                 f"{grown}, before {keys_before}, "
                                 f"{vids_before}")
        look = _get_json(nport, f"/dir/lookup?volumeId={vid}")
        reader = urls[look["locations"][0]["url"]]
        items = [("/" + fid, digest) for fid, _, digest in written]
        read, _ = _timed_gets(g.ports[reader][0], items, CLUSTER_READERS,
                              g.ports[reader][0])
        read["server"] = reader
        row["reads"] = read

        # the loss, healed by the new leader's repair plane
        counts = {n: sum(1 for locs in g.shards(new, vid).values()
                         if g.url(n) in locs) for n in HA_SERVERS}
        loser = max(HA_SERVERS, key=lambda n: counts[n])
        lost = sorted(s for s, locs in g.shards(new, vid).items()
                      if g.url(loser) in locs)[:2]
        # the new leader's census runs from its election: a cycle that saw
        # only part of the re-registered servers opened an unhealthy
        # episode, closed by the first cycle that sees all 14 shards
        def census_whole() -> bool:
            rep = _get_json(nport, "/cluster/health.json")["repair"]
            v = rep["volumes"].get(str(vid))
            return not rep["queue_depth"] and (v is None
                                               or v["state"] == "healthy")

        g.wait("the new leader's census whole", census_whole)
        rep = _get_json(nport, "/cluster/health.json")["repair"]
        row["partial_view_seen"] = str(vid) in rep["volumes"]
        m0 = _scrape(nport)
        kb = {n: _k_counts(_scrape(g.ports[n][0])) for n in HA_SERVERS}
        t0 = time.perf_counter()
        stub = g.vstub(loser)
        stub.VolumeEcShardsUnmount(g.vpb.VolumeEcShardsUnmountRequest(
            volume_id=vid, shard_ids=lost), timeout=60)
        stub.VolumeEcShardsDelete(g.vpb.VolumeEcShardsDeleteRequest(
            volume_id=vid, collection=HA_COLLECTION, shard_ids=lost),
            timeout=60)
        g.wait("the new leader lists 14 shards again, healed",
               lambda: _scrape(nport)[tth + "_count"] > m0[tth + "_count"]
               and listed(new))
        heal = time.perf_counter() - t0
        m1 = _scrape(nport)
        st = _get_json(nport, "/cluster/health.json")["repair"]
        rebuilder = urls[st["volumes"][str(vid)]["last_result"]["rebuilder"]]
        ka = _k_counts(_scrape(g.ports[rebuilder][0]))
        k1_rebuild = {k: ka[k] - kb[rebuilder][k]
                      for k in ("gf2_matmul", "gf2_matmul_small")}
        if not sum(k1_rebuild.values()):
            raise AssertionError(f"the repair on {rebuilder} launched no K1")
        check_shards("the new leader's repair")
        row["loss"] = {"server": loser, "shards": lost, "heal_wall_s": heal,
                       "time_to_healthy_s": m1[tth + "_sum"] - m0[tth + "_sum"],
                       "totals": st["totals"], "rebuilder": rebuilder,
                       "rebuilder_k1": k1_rebuild}

        # the killed master back on its -mdir
        t0 = time.perf_counter()
        g.start(leader)

        def settled() -> bool:
            views = {n: g.raft(n) for n in HA_MASTERS}
            back = views[leader]
            return (all(len(v["members"]) == 3 and v["leader"]
                        == [g.advertise(new)] for v in views.values())
                    and back["term"] >= row["new_term"]
                    and _get_json(g.ports[leader][0], "/cluster/status")[
                        "MaxVolumeId"] == _get_json(
                            nport, "/cluster/status")["MaxVolumeId"])

        g.wait("the restarted master a follower, caught up", settled)
        row["restart"] = {"rejoin_s": time.perf_counter() - t0,
                          "term": g.raft(leader)["term"],
                          "max_volume_id": _get_json(
                              g.ports[leader][0],
                              "/cluster/status")["MaxVolumeId"]}
        row.update(killed=leader, new_leader=new,
                   shards_equal_native=True,
                   launches={n: _k_counts(_scrape(g.ports[n][0]))
                             for n in HA_SERVERS})
    log("cluster_ha", **row, reduced={
        "dat_mib": [FULL_VOLUME_GIB * 1024, HA_DAT_BYTES >> 20],
        "why": "the run's time and write budgets: 9c has 90 s and about "
               "0.17 GiB of writes"})
    return row


# 9d: the all-in-one `server` (a master and a volume server in one
# process, S) that encodes on the card, then evacuated onto two `volume`
# processes (G, H) and retired.  The volume the writers fill (32 MiB, cut
# from 30 GiB for the write budget: about 0.15 GiB with its shards, the
# spread, the evacuation's copies and the benchmark's 8 MiB, §4 of
# PERF.md), the benchmark command's load, and the slots each server gets
# (the master grows seven volumes for the bench collection on S, all of
# which the evacuation moves onto one of G and H)
SRV_DAT_BYTES = 32 << 20
SRV_COLLECTION = "ec9d"
SRV_BENCH_COLLECTION = "ec9dbench"
SRV_BENCH = ["-c", "16", "-n", "2048", "-size", "4096"]
SRV_MAX_VOLUMES = 16
SRV_CACHE_MB = 2048
SRV_SERVERS = ("S", "G", "H")
RESIDENT = "SeaweedFS_volumeServer_ec_resident_bytes"


class _AllInOne:
    """9d's processes, as users start them: `python3 -m
    seaweedfs_tpu_torch server` (S: its master and volume server), and
    `volume -mserver <S's master>` for G and H; the calls the step makes
    to them over the RPC plane and HTTP, and the shell."""

    def __init__(self, workdir: str, stack: contextlib.ExitStack,
                 backend: str):
        from seaweedfs_tpu_torch.pb import (
            Stub, master_pb2, sync_channel_cached)

        self.dir = workdir
        self.stack = stack
        self.backend = backend
        self.env = {"TMPDIR": os.path.join(workdir, "tmp")}
        os.makedirs(self.env["TMPDIR"])
        # S's master and volume server, G's and H's volume servers
        self.ports = {n: (_free_port(), _free_port())
                      for n in ("M",) + SRV_SERVERS}
        http, grpc = self.ports["M"]
        self.master = f"127.0.0.1:{http}.{grpc}"
        self.master_http = http
        self.mstub = Stub(sync_channel_cached(f"127.0.0.1:{grpc}"),
                          master_pb2, "Seaweed")
        self.pb = master_pb2
        self.procs: dict = {}
        self.killed: set = set()  # none: every exit is fatal

    def url(self, name: str) -> str:
        return f"127.0.0.1:{self.ports[name][0]}"

    def start(self, name: str) -> None:
        d = os.path.join(self.dir, name)
        os.makedirs(d)
        http, grpc = self.ports[name]
        if name == "S":
            mhttp, mgrpc = self.ports["M"]
            command, args = "server", [
                "-dir", d, "-master.port", str(mhttp),
                "-master.port.grpc", str(mgrpc), "-volume.port", str(http),
                "-volume.port.grpc", str(grpc),
                "-volume.max", str(SRV_MAX_VOLUMES),
                "-ec.backend", self.backend,
                "-ec.deviceCacheMB", str(SRV_CACHE_MB), "-pulseSeconds", "1"]
        else:
            command, args = "volume", [
                "-dir", d, "-port", str(http), "-port.grpc", str(grpc),
                "-mserver", self.master, "-max", str(SRV_MAX_VOLUMES),
                "-ec.backend", self.backend, "-pulseSeconds", "1"]
        self.procs[name] = self.stack.enter_context(_volume_server(
            args, os.path.join(self.dir, f"{name}.log"), self.env,
            command=command))

    wait = _HaGroup.wait
    shell = _Cluster.shell

    def topology(self) -> dict:
        """server url -> ({vid: collection}, {ec vid: shard ids}) as the
        master's VolumeList says."""
        info = json.loads(self.mstub.VolumeList(
            self.pb.VolumeListRequest(), timeout=10).topology_info_json)
        return {n["id"]: ({v["id"]: v["collection"] for v in n["volumes"]},
                          {s["id"]: [i for i in range(14)
                                     if s["ec_index_bits"] >> i & 1]
                           for s in n["ec_shards"]})
                for dc in info["data_centers"] for r in dc["racks"]
                for n in r["nodes"]}


def _bench_report(out: str) -> dict:
    """The benchmark command's two reports: per title, the completed and
    failed requests, requests/s and the latency columns (ms)."""
    rows, title = {}, None
    for line in out.splitlines():
        if line.endswith("Benchmark:"):
            title = line[:-len(" Benchmark:")].lower()
            rows[title] = {}
        elif title and ":" in line:
            key, _, value = line.partition(":")
            rows[title][key.strip()] = value.strip()
    parsed = {}
    for title, r in rows.items():
        lat = [float(x) for x in r["Latency ms (avg/p50/p95/p99/max)"].split(" / ")]
        parsed[title] = {
            "completed": int(r["Completed requests"]),
            "failed": int(r["Failed requests"]),
            "per_s": float(r["Requests per second"]),
            "KBps": float(r["Transfer rate"].split()[0]),
            "avg_ms": lat[0], "p50_ms": lat[1], "p95_ms": lat[2],
            "p99_ms": lat[3], "max_ms": lat[4]}
    return parsed


def _cluster_server(workdir: str, seed: int, backend: str = "cuda",
                    dat_bytes: int = SRV_DAT_BYTES) -> dict:
    """9d: `server -ec.backend cuda -ec.deviceCacheMB ...` as one process
    (S), `/vol/grow` of collection ec9d, 32 writers filling its volume on S
    through the master's assign (a hard link of the .dat kept as the
    oracle), the `benchmark` command as a process (writes and reads of
    collection ec9dbench, 0 failures), G and H started as `volume -mserver
    <S>`, `cluster.check` (3/3 reachable), `collection.list` and
    `volume.list` through the shell; `lock; ec.encode` (K1 on S, the
    shards spread over S, G and H; S's cache use once its shards are
    pinned); `volume.server.evacuate -node <S> -force` (0 skipped; every
    shard and bench volume listed on G or H, none on S; S's cache use
    after); every ec9d needle read back through the master's lookup (32
    clients), every shard on G and H equal to the native codec's encode of
    the oracle; `volume.server.leave` and S gone from the topology.
    `backend` and `dat_bytes` are the card's and 32 MiB; a rehearsal on
    the CPU passes torch and less."""
    from seaweedfs_tpu_torch.storage import ec

    row: dict = {"backend": backend}
    with contextlib.ExitStack() as stack:
        g = _AllInOne(workdir, stack, backend)
        s_url = g.url("S")
        t0 = time.perf_counter()
        g.start("S")
        row["master_answers_s"] = g.wait(
            "S's master", lambda: g.topology() is not None)
        g.wait("S's volume server at its master",
               lambda: set(g.topology()) == {s_url})
        row["registered_s"] = time.perf_counter() - t0
        mport, sport = g.master_http, g.ports["S"][0]

        vid = _get_json(mport, f"/vol/grow?count=1&collection="
                        f"{SRV_COLLECTION}")["vids"][0]
        needles = _ingest_needles(seed + 94, dat_bytes)
        pool = _ingest_pool(seed + 94)
        t0 = time.perf_counter()
        written, ack = asyncio.run(_cluster_writes(
            g.master, pool, needles, CLUSTER_WRITERS,
            collection=SRV_COLLECTION))
        wall = time.perf_counter() - t0
        hosts = {u for _, u, _ in written}
        if hosts != {s_url} or any(not f.startswith(f"{vid},")
                                   for f, _, _ in written):
            raise AssertionError(f"writes left volume {vid} on S: "
                                 f"{sorted(hosts)}")
        row["writes"] = {"needles": len(written), "wall_s": wall,
                         "writes_per_s": len(written) / wall,
                         "ack_p50_ms": _pct(ack, 50),
                         "ack_p99_ms": _pct(ack, 99)}
        stem = f"{SRV_COLLECTION}_{vid}"
        oracle = os.path.join(workdir, "oracle.dat")
        os.link(os.path.join(workdir, "S", stem + ".dat"), oracle)

        t0 = time.perf_counter()
        bench = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "benchmark",
             "-master", g.master, "-collection", SRV_BENCH_COLLECTION,
             *SRV_BENCH], cwd=HERE, capture_output=True, text=True,
            timeout=600)
        report = _bench_report(bench.stdout)
        if bench.returncode != 0 or set(report) != {"write", "read"} or any(
                r["failed"] or r["completed"] != int(SRV_BENCH[3])
                for r in report.values()):
            raise AssertionError(f"benchmark: {bench.stdout}"
                                 f"{bench.stderr[-4000:]}")
        row["benchmark"] = {**report, "wall_s": time.perf_counter() - t0,
                            "lines": [ln for ln in bench.stdout.splitlines()
                                      if "per second" in ln
                                      or ln.startswith("Latency")]}
        bench_vids = sorted(v for v, c in g.topology()[s_url][0].items()
                            if c == SRV_BENCH_COLLECTION)

        t0 = time.perf_counter()
        g.start("G")
        g.start("H")
        urls = {g.url(n): n for n in SRV_SERVERS}
        g.wait("G and H at S's master", lambda: set(g.topology()) == set(urls))
        row["volume_servers_registered_s"] = time.perf_counter() - t0
        out, wall = g.shell("cluster.check; collection.list; volume.list")
        lines = out.splitlines()
        want_vol = f"  volume id:{vid} "
        start = next(i for i, ln in enumerate(lines)
                     if ln.endswith("/" + s_url))
        s_block = list(itertools.takewhile(lambda ln: ln.startswith("  "),
                                           lines[start + 1:]))
        if ("3/3 volume servers reachable" not in lines
                or f"  {SRV_COLLECTION}" not in lines
                or f"  {SRV_BENCH_COLLECTION}" not in lines
                or not any(ln.startswith(want_vol)
                           and f"collection:'{SRV_COLLECTION}'" in ln
                           for ln in s_block)):
            raise AssertionError(f"cluster.check / collection.list / "
                                 f"volume.list: {out}")
        row["shell_checks"] = {"wall_s": wall, "lines": [
            ln for ln in lines if "reachable" in ln or "collections" in ln
            or ln.startswith("total ")]}

        def where_stored() -> dict:
            return {sid: [g.url(n) for n in SRV_SERVERS if os.path.exists(
                os.path.join(workdir, n, stem + ec.to_ext(sid)))]
                for sid in range(14)}

        def listed_where_stored() -> bool:
            topo, on_disk = g.topology(), where_stored()
            listed = {sid: sorted(u for u, (_, ecs) in topo.items()
                                  if sid in ecs.get(vid, []))
                      for sid in range(14)}
            return all(len(on_disk[s]) == 1 and listed[s] == on_disk[s]
                       for s in range(14))

        k0 = _k_counts(_scrape(sport))
        out, wall = g.shell(f"lock; ec.encode -volumeId {vid} -collection "
                            f"{SRV_COLLECTION}; unlock")
        g.wait("14 spread shards listed where stored", listed_where_stored)
        k1 = _k_counts(_scrape(sport))
        encode_k1 = {k: k1[k] - k0[k] for k in ("gf2_matmul",
                                                "gf2_matmul_small")}
        if backend == "cuda" and not sum(encode_k1.values()):
            raise AssertionError(f"ec.encode launched no K1 on S: {encode_k1}")
        placed = {sid: urls[u[0]] for sid, u in where_stored().items()}
        on_s = sorted(s for s, n in placed.items() if n == "S")

        def s_pinned() -> bool:
            st = _get_json(sport, "/status")
            ecv = [v for v in st["EcVolumes"] if v["id"] == vid]
            return bool(ecv) and sorted(ecv[0].get("resident", [])) == on_s

        pin_s = g.wait("S's shards pinned", s_pinned) if on_s else 0.0
        row["encode"] = {"wall_s": wall, "k1_on_S": encode_k1,
                         "shards": {n: sorted(s for s, p in placed.items()
                                              if p == n)
                                    for n in SRV_SERVERS},
                         "pin_wait_s": pin_s,
                         "S_resident_bytes": _scrape(sport).get(RESIDENT)}

        # the master's repair plane paused for the decommission: between a
        # shard's unmount on S and its mount on G or H being listed, a
        # repair cycle sees it lost and rebuilds it on S (on the card, a
        # cycle once rebuilt S's four moving shards there)
        g.shell("volume.repair.pause")
        t0 = time.perf_counter()
        out, wall = g.shell(f"lock; volume.server.evacuate -node {s_url} "
                            "-force; unlock")
        last = next((ln for ln in out.splitlines()
                     if " moves applied, " in ln), "")
        if not last.endswith(" moves applied, 0 skipped"):
            raise AssertionError(f"volume.server.evacuate: {out}")

        def evacuated() -> bool:
            topo = g.topology()
            gh = [u for u in topo if u != s_url]
            return (topo[s_url] == ({}, {}) and listed_where_stored()
                    and all(where_stored()[s][0] != s_url for s in range(14))
                    and all(any(v in topo[u][0] for u in gh)
                            for v in bench_vids))

        g.wait("S empty, every shard and bench volume on G or H", evacuated)
        moved = time.perf_counter() - t0
        g.shell("volume.repair.resume")
        try:
            cache_empty_s = g.wait("S's cache empty", lambda: _scrape(
                sport).get(RESIDENT) == 0, timeout=15)
        except AssertionError:
            cache_empty_s = None  # recorded beside the bytes, not fatal
        row["evacuate"] = {"wall_s": wall, "last_line": last,
                           "moves": int(last.split()[0]),
                           "listed_s": moved,
                           "S_resident_bytes_after": _scrape(sport).get(
                               RESIDENT),
                           "cache_empty_s": cache_empty_s,
                           "shards": {n: sorted(s for s, u in where_stored()
                                                .items() if u == [g.url(n)])
                                      for n in ("G", "H")},
                           "bench_volumes": len(bench_vids)}

        look = _get_json(mport, f"/dir/lookup?volumeId={vid}")
        reader = urls[look["locations"][0]["url"]]
        items = [("/" + fid, digest) for fid, _, digest in written]
        read, _ = _timed_gets(g.ports[reader][0], items, CLUSTER_READERS,
                              g.ports[reader][0])
        read["server"] = reader
        row["reads"] = read
        native, _ = _native_shard_hashes(oracle)
        for sid in range(14):
            got = [sha256_file(os.path.join(workdir, n, stem + ec.to_ext(sid)))
                   for n in ("G", "H") if os.path.exists(
                       os.path.join(workdir, n, stem + ec.to_ext(sid)))]
            if got != [native[sid]]:
                raise AssertionError(f"shard {sid} on G and H: {got}, not "
                                     "the native codec's bytes")
        row["shards_equal_native"] = 14

        out, wall = g.shell(f"lock; volume.server.leave -node "
                            f"127.0.0.1:{g.ports['S'][1]}; unlock")
        gone = g.wait("S gone from the topology",
                      lambda: set(g.topology()) == {g.url("G"), g.url("H")})
        row["leave"] = {"wall_s": wall, "gone_s": gone,
                        "line": next(ln for ln in out.splitlines()
                                     if "asked to leave" in ln)}
        row["launches"] = {n: _k_counts(_scrape(g.ports[n][0]))
                           for n in SRV_SERVERS}
    log("cluster_server", **row, reduced={
        "dat_mib": [FULL_VOLUME_GIB * 1024, dat_bytes >> 20],
        "why": "the run's write budget: 9d writes about 0.15 GiB"})
    return row


# 9e: the filer over an EC-encoded volume.  Files of the BASELINE mix
# (log-uniform 4 KB-1 MB) to about FILER_FILE_BYTES, under FILER_DIRS
# directories, plus one file of three 4 MiB chunks and one text file the
# filer stores compressed
FILER_COLLECTION = "ec9e"
FILER_FILE_BYTES = 24 << 20
FILER_BIG_BYTES = 12 << 20
FILER_TEXT_BYTES = 1 << 20
FILER_MAX_MB = 4
FILER_DIRS = 8
FILER_WRITERS = 16
FILER_READERS = 32
FILER_CACHE_MB = 1024
FILER_HIT = 'SeaweedFS_filer_chunk_cache_total{result="hit"}'


async def _filer_puts(port: int, files: list, n_clients: int) -> list:
    """PUT every (path, body, headers) of `files` over `n_clients`
    keep-alive clients to the filer: -> ack seconds per file."""
    from seaweedfs_tpu_torch.server.http import Client

    queue = list(reversed(files))
    lat: list = []

    async def client() -> None:
        c = Client("127.0.0.1", port)
        try:
            while queue:
                path, body, headers = queue.pop()
                t0 = time.perf_counter()
                status, _, text = await c.request("PUT", path, headers, body)
                lat.append(time.perf_counter() - t0)
                if status != 201:
                    raise AssertionError(f"PUT {path}: HTTP {status} {text!r}")
        finally:
            await c.close()

    await asyncio.gather(*(client() for _ in range(n_clients)))
    return lat


def _filer_listing(stub, pb, dirs: list) -> dict:
    """{path: (is dir, size, [chunk fids], compressed flags)} under `dirs`,
    from the filer's ListEntries."""
    out = {}
    for d in dirs:
        for r in stub.ListEntries(pb.ListEntriesRequest(directory=d),
                                  timeout=30):
            e = r.entry
            out[f"{d}/{e.name}"] = (
                e.is_directory, max(e.attributes.file_size, sum(
                    int(c.size) for c in e.chunks)),
                [c.file_id for c in e.chunks],
                [c.is_compressed for c in e.chunks])
    return out


def _bytes_by_data_shard(dat_size: int, idx_path: str) -> dict:
    """Data shard id -> bytes of live needles on it, by the volume's
    needle map (.idx)."""
    from seaweedfs_tpu_torch.storage import idx as idx_mod
    from seaweedfs_tpu_torch.storage import needle as needle_mod
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout

    with open(idx_path, "rb") as f:
        ids, offs, sizes = idx_mod.parse_buffer(f.read())
    live = {}
    for nid, off, size in zip(ids.tolist(), offs.tolist(), sizes.tolist()):
        if t.size_is_valid(size):
            live[nid] = (off, size)
        else:
            live.pop(nid, None)
    out = {s: 0 for s in range(layout.DATA_SHARDS)}
    for off, size in live.values():
        for iv in layout.locate_data(
                dat_size, off, needle_mod.actual_size(size,
                                                      needle_mod.CURRENT_VERSION)):
            out[iv.to_shard_and_offset()[0]] += iv.size
    return out


def _cluster_filer(workdir: str, seed: int) -> dict:
    """9e: a master, two volume servers (P, Q; `-ec.deviceCacheMB`) and a
    filer as processes, as users start them; files written through the
    filer into one volume of collection ec9e, checked by `fs.ls` /
    `fs.du` and `volume.fsck`; the volume `ec.encode`d (K1 on its holder)
    and spread; repair paused and the two data shards with the most file
    bytes deleted; the filer restarted on its store; every file read back
    through the filer (its chunks by the servers' degraded reads) and
    every remaining shard held to the native codec."""
    import numpy as np

    from seaweedfs_tpu_torch.pb import Stub, filer_pb2, sync_channel_cached
    from seaweedfs_tpu_torch.shell.command_fs import _fmt_size
    from seaweedfs_tpu_torch.storage import ec

    row: dict = {}
    with contextlib.ExitStack() as stack:
        cl = _Cluster(workdir, stack)
        cl.start_servers({n: ["-ec.deviceCacheMB", str(FILER_CACHE_MB)]
                          for n in ("P", "Q")})
        fport, fgrpc, fmetrics = _free_port(), _free_port(), _free_port()
        db = os.path.join(workdir, "filer.kv")
        fargs = ["-ip", "127.0.0.1", "-port", str(fport), "-port.grpc",
                 str(fgrpc), "-metricsPort", str(fmetrics), "-master",
                 cl.master, "-collection", FILER_COLLECTION, "-maxMB",
                 str(FILER_MAX_MB), "-store", "native", "-db", db]
        fstub = Stub(sync_channel_cached(f"127.0.0.1:{fgrpc}"), filer_pb2,
                     "SeaweedFiler")

        def filer_up() -> bool:
            return cl._try(lambda: fstub.GetFilerConfiguration(
                filer_pb2.GetFilerConfigurationRequest(), timeout=5)) \
                is not None

        t0 = time.perf_counter()
        cl._start("filer", "filer", fargs)
        cl.wait("the filer", filer_up)
        row["filer_up_s"] = time.perf_counter() - t0

        vid = _get_json(cl.master_http, f"/vol/grow?count=1&collection="
                        f"{FILER_COLLECTION}")["vids"][0]
        stem = f"{FILER_COLLECTION}_{vid}"
        holder = next(n for n in ("P", "Q") if os.path.exists(
            os.path.join(workdir, n, stem + ".dat")))
        oracle = os.path.join(workdir, "oracle")
        for ext in (".dat", ".idx"):
            os.link(os.path.join(workdir, holder, stem + ext), oracle + ext)

        rng = np.random.default_rng(seed + 95)
        pool = _ingest_pool(seed + 95)
        files = []
        for i, (_, _, off, size) in enumerate(
                _ingest_needles(seed + 95, FILER_FILE_BYTES)):
            files.append((f"/data/d{i % FILER_DIRS}/f{i:04d}.bin",
                          pool[off:off + size], {}))
        big_off = int(rng.integers(0, len(pool) - FILER_BIG_BYTES))
        files.append(("/data/big.bin",
                      pool[big_off:big_off + FILER_BIG_BYTES], {}))
        words = [b"needle", b"shard", b"filer", b"volume", b"parity"]
        text = b" ".join(words[int(w)] for w in rng.integers(
            0, len(words), FILER_TEXT_BYTES // 6))[:FILER_TEXT_BYTES]
        files.append(("/data/notes.txt", text,
                      {"Content-Type": "text/plain"}))
        digest = {p: hashlib.sha256(b).digest() for p, b, _ in files}
        body = {p: b for p, b, _ in files}
        total = sum(len(b) for _, b, _ in files)
        t0 = time.perf_counter()
        ack = asyncio.run(_filer_puts(fport, files, FILER_WRITERS))
        wall = time.perf_counter() - t0
        row["writes"] = {"files": len(files), "bytes": total, "wall_s": wall,
                         "writes_per_s": len(files) / wall,
                         "MBps": total / wall / 1e6,
                         "ack_p50_ms": _pct(ack, 50),
                         "ack_p99_ms": _pct(ack, 99)}

        dirs = ["/data"] + [f"/data/d{i}" for i in range(FILER_DIRS)]
        listing = _filer_listing(fstub, filer_pb2, dirs)
        fids = [f for (d, _, fs, _) in listing.values() if not d for f in fs]
        if {int(f.split(",")[0]) for f in fids} != {vid}:
            raise AssertionError(f"filer chunks left volume {vid}: "
                                 f"{sorted({f.split(',')[0] for f in fids})}")
        if len(listing["/data/big.bin"][2]) != FILER_BIG_BYTES // (
                FILER_MAX_MB << 20):
            raise AssertionError(f"big.bin chunks: {listing['/data/big.bin']}")
        if listing["/data/notes.txt"][3] != [True]:
            raise AssertionError(f"notes.txt not compressed: "
                                 f"{listing['/data/notes.txt']}")
        row["chunks"] = {"files": len(files), "chunks": len(fids),
                         "big_chunks": len(listing["/data/big.bin"][2])}

        out, wall = cl.shell("fs.ls /data; fs.du /data; lock; "
                             "volume.fsck -cutoffMinutes 0; unlock")
        lines = out.splitlines()
        want_du = (f"/data: {_fmt_size(total)} in {len(files)} files, "
                   f"{FILER_DIRS} dirs")
        fsck = next((ln for ln in lines if ln.startswith("fsck: ")), "")
        if (want_du not in lines
                or sorted(ln for ln in lines if ln.startswith("d") and
                          ln.endswith("/")) != [f"d{i}/" for i in range(
                              FILER_DIRS)]
                or not fsck.endswith(" 0 orphan needles, 0 broken references")):
            raise AssertionError(f"fs.ls / fs.du / volume.fsck: {out}")
        row["shell"] = {"wall_s": wall, "du": want_du, "fsck": fsck}

        def where_stored() -> dict:
            return {sid: [cl.url(n) for n in ("P", "Q") if os.path.exists(
                os.path.join(workdir, n, stem + ec.to_ext(sid)))]
                for sid in range(14)}

        def listed_where_stored() -> bool:
            listed, on_disk = cl._try(lambda: cl.shards(vid)), where_stored()
            return bool(listed) and all(
                len(on_disk[s]) == 1 and listed.get(s) == on_disk[s]
                for s in range(14)) and len({u[0] for u in on_disk.values()}) == 2

        hport = cl.ports[holder][0]
        k0 = _k_counts(_scrape(hport))
        out, wall = cl.shell(f"lock; ec.encode -volumeId {vid} -collection "
                             f"{FILER_COLLECTION}; unlock")
        cl.wait("14 spread shards listed where stored", listed_where_stored)
        k1 = _k_counts(_scrape(hport))
        encode_k1 = {k: k1[k] - k0[k] for k in ("gf2_matmul",
                                                "gf2_matmul_small")}
        if not sum(encode_k1.values()):
            raise AssertionError(f"ec.encode launched no K1 on {holder}: "
                                 f"{encode_k1}")
        placed = {sid: u[0] for sid, u in where_stored().items()}
        row["encode"] = {"wall_s": wall, "holder": holder,
                         "k1_on_holder": encode_k1,
                         "shards": {n: sorted(s for s, u in placed.items()
                                              if u == cl.url(n))
                                    for n in ("P", "Q")}}

        cl.repair("pause")
        dat_size = os.path.getsize(oracle + ".dat")
        by_shard = _bytes_by_data_shard(dat_size, oracle + ".idx")
        lost = sorted(sorted(by_shard, key=lambda s: (-by_shard[s], s))[:2])
        for sid in lost:
            name = next(n for n in ("P", "Q") if placed[sid] == cl.url(n))
            stub = cl.vstub(name)
            stub.VolumeEcShardsUnmount(cl.vpb.VolumeEcShardsUnmountRequest(
                volume_id=vid, shard_ids=[sid]), timeout=60)
            stub.VolumeEcShardsDelete(cl.vpb.VolumeEcShardsDeleteRequest(
                volume_id=vid, collection=FILER_COLLECTION,
                shard_ids=[sid]), timeout=60)
        cl.wait("the master lists the two lost shards nowhere",
                lambda: set(cl._try(lambda: cl.shards(vid)) or ()) ==
                set(range(14)) - set(lost))
        row["lost"] = {"shards": lost,
                       "file_bytes": {s: by_shard[s] for s in lost},
                       "holders": {s: placed[s] for s in lost}}

        proc = cl.procs["filer"]
        cl.killed.add("filer")
        proc.terminate()
        proc.wait(30)
        t0 = time.perf_counter()
        cl._start("filer2", "filer", fargs)
        cl.wait("the restarted filer's listing", lambda: cl._try(
            lambda: _filer_listing(fstub, filer_pb2, dirs)) == listing)
        row["restart_to_listing_s"] = time.perf_counter() - t0

        counts0 = {n: _peer_counts(_scrape(cl.ports[n][0]))
                   for n in ("P", "Q")}
        hits0 = _scrape(fmetrics).get(FILER_HIT, 0.0)
        big = body["/data/big.bin"]
        chunk = FILER_MAX_MB << 20
        ranges = [(b - 1000, b + 1000)
                  for b in range(chunk, FILER_BIG_BYTES, chunk)]

        async def range_gets() -> list:
            from seaweedfs_tpu_torch.server.http import Client

            c = Client("127.0.0.1", fport)
            try:
                got = []
                for a, b in ranges:
                    st, h, part = await c.request(
                        "GET", "/data/big.bin", {"Range": f"bytes={a}-{b - 1}"})
                    if st != 206 or part != big[a:b]:
                        raise AssertionError(f"Range {a}-{b - 1}: HTTP {st}")
                    got.append(h.get("Content-Range"))
                return got
            finally:
                await c.close()

        row["range_gets"] = asyncio.run(range_gets())
        items = [(p, digest[p]) for p, _, _ in files]
        t0 = time.perf_counter()
        lat, nbytes = asyncio.run(_get_each(fport, items, FILER_READERS))
        wall = time.perf_counter() - t0
        hits = _scrape(fmetrics).get(FILER_HIT, 0.0) - hits0
        per = {n: _delta(counts0[n], _peer_counts(_scrape(cl.ports[n][0])))
               for n in ("P", "Q")}
        degraded = {n: d["memo_miss"] for n, d in per.items()}
        kern = {n: {k: d[k] for k in _k_counts({})} for n, d in per.items()}
        launched = sum(d[k] for d in kern.values() for k in (
            "gf2_matmul", "gf2_matmul_small", "fused_reconstruct",
            "fused_reconstruct_blockdiag"))
        if not sum(degraded.values()) or not launched:
            raise AssertionError(f"the filer's reads caused no degraded read "
                                 f"or kernel launch: {degraded}, {kern}")
        if hits:
            raise AssertionError(f"the filer served {hits} chunks from its "
                                 "cache in the read pass")
        row["reads"] = {"files": len(lat), "sha256_equal": len(lat),
                        "wall_s": wall, "reads_per_s": len(lat) / wall,
                        "MBps": nbytes / wall / 1e6,
                        "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99),
                        "chunk_cache_hits": hits,
                        "degraded_reads": degraded, "launches": kern,
                        "remote_fetches": {n: d["remote_ok"]
                                           for n, d in per.items()}}

        native, _ = _native_shard_hashes(oracle + ".dat")
        equal = 0
        for sid in range(14):
            got = [sha256_file(os.path.join(workdir, n, stem + ec.to_ext(sid)))
                   for n in ("P", "Q") if os.path.exists(
                       os.path.join(workdir, n, stem + ec.to_ext(sid)))]
            want = [] if sid in lost else [native[sid]]
            if got != want:
                raise AssertionError(f"shard {sid} on P and Q: {got}, not "
                                     f"{want}")
            equal += bool(got)
        row["shards_equal_native"] = equal
        row["launches"] = {n: _k_counts(_scrape(cl.ports[n][0]))
                           for n in ("P", "Q")}
    log("cluster_filer", **row, reduced={
        "file_mib": [None, (FILER_FILE_BYTES + FILER_BIG_BYTES
                            + FILER_TEXT_BYTES) >> 20],
        "why": "the run's write budget: 9e writes about 0.09 GiB"})
    return row


def phase_cluster(torch, workdir: str, vol: dict, deg: dict, serve: dict,
                  seed: int) -> dict:
    """The cluster as users run it: `python3 -m seaweedfs_tpu_torch master`,
    volume servers started with `volume -mserver ... -ec.backend cuda` and
    the shell as `python3 -m seaweedfs_tpu_torch shell`, every wait on the
    state the master reports (VolumeList, LookupEcVolume) or a server's
    /status.  The master judges a read_p99 SLO on the servers'
    batch_dispatch digests, its target from 5c (`serve`), and writes its
    incident bundles under the phase's directory.  -> 9a's and 9b's rows
    and every server's kernel launches."""
    torch.cuda.empty_cache()
    cdir = os.path.join(workdir, "cluster")
    os.makedirs(cdir)
    slo = _slo_target(serve)
    inc_dir = os.path.join(cdir, "incidents")
    try:
        with contextlib.ExitStack() as stack:
            sink = _PushSink()
            stack.callback(sink.close)
            cl = _Cluster(cdir, stack, [
                "-obs.slo.readP99Ms", repr(slo["target_ms"]),
                "-obs.slo.readStage", SLO_STAGE,
                "-obs.slo.fastWindowSeconds", str(SLO_FAST_S),
                "-obs.slo.slowWindowSeconds", str(SLO_SLOW_S),
                "-obs.incident.dir", inc_dir,
                "-obs.incident.profileSeconds", str(SLO_PROFILE_S),
                "-obs.incident.minIntervalSeconds", str(SLO_MIN_INTERVAL_S),
                "-metrics.address", sink.address,
                "-metrics.intervalSeconds", "1"])
            cl.incident_dir = inc_dir
            full = _cluster_full_width(cl, workdir, vol, deg, seed, slo, sink)
            # their HBM and page cache go to 9b; with A gone B's shard 0 is
            # all of vid 1 the master knows: the planner must call it
            # unrecoverable and queue nothing
            cl.kill("A")
            full["repair_after_9a"] = _vid1_unrecoverable(cl)
            cl.kill("B")
            verbs = _cluster_shell_verbs(cl, seed)
        ha_dir = os.path.join(cdir, "ha")
        os.makedirs(ha_dir)
        ha = _cluster_ha(ha_dir, seed)
        srv_dir = os.path.join(cdir, "server")
        os.makedirs(srv_dir)
        srv = _cluster_server(srv_dir, seed)
        fil_dir = os.path.join(cdir, "filer")
        os.makedirs(fil_dir)
        fil = _cluster_filer(fil_dir, seed)
    finally:
        shutil.rmtree(cdir, ignore_errors=True)
    launches = {k: sum(c[k] for part in (full, verbs, ha, srv, fil)
                       for c in part["launches"].values())
                for k in _k_counts({})}
    return {"full": full, "verbs": verbs, "ha": ha, "server": srv,
            "filer": fil, "launches": launches}


# -------------------------------------------------------------- phase 10

# 10a: a cache on two lanes of one card (the mesh layout's stripes, two
# launches a burst) beside the one-device cache: 12 survivors each
MESH_BUDGET = 16 << 30
# 10a reads every needle with bytes on shard 0 plus this many others
MESH_EXTRA_READS = 400
# 10b: the row the distributed programs encode, [10, MESH_ROW] (about 1
# GiB of input), and the column slice the plain version is timed on
MESH_ROW = 100 << 20
MESH_PLAIN_COLS = 4 << 20
# 10c: shard-0 intervals of 10a's needles reconstructed by
# distributed_degraded_read, and the requests a call
MESH_DEGRADED = 512
MESH_DEGRADED_CALL = 128
MESH_RANK_TIMEOUT_S = 240


def _mesh_row(workdir: str, np) -> "np.ndarray":
    """[10, MESH_ROW] of vid 1: the head of each data shard's first row."""
    from seaweedfs_tpu_torch.storage import ec

    base = os.path.join(workdir, "1")
    return np.stack([np.fromfile(base + ec.to_ext(s), dtype=np.uint8,
                                 count=MESH_ROW) for s in range(10)])


def _mesh_rank_main(argv) -> int:
    """One rank of 10b (run as `chip_smoke.py --mesh-rank ...`): join the
    group (two gloo ranks sharing cuda:0, or NCCL at world size 1 with
    both lanes here), run distributed_apply_matrix and
    distributed_encode_blockdiag over a (2, 1) mesh of cuda:0 on the
    [10, MESH_ROW] row, time this rank's K1 launch and the all_gather of
    its partials with CUDA events, and write the outputs' sha256 and the
    counts as JSON."""
    import numpy as np
    import torch
    import torch.distributed as dist

    p = argparse.ArgumentParser()
    for name in ("--mesh-rank", "--mesh-world", "--mesh-port"):
        p.add_argument(name, type=int, required=True)
    for name in ("--mesh-backend", "--mesh-workdir", "--mesh-out"):
        p.add_argument(name, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    from seaweedfs_tpu_torch.ops import gf256, rs_cuda
    from seaweedfs_tpu_torch.parallel import distributed as dist_mod
    from seaweedfs_tpu_torch.parallel import mesh as mesh_mod

    torch.cuda.set_device(0)
    dist.init_process_group(
        backend=args.mesh_backend,
        init_method=f"tcp://127.0.0.1:{args.mesh_port}",
        world_size=args.mesh_world, rank=args.mesh_rank)
    try:
        devs = mesh_mod.global_devices("cuda")
        mesh = mesh_mod.make_mesh(2, 1, devices=devs * (2 // len(devs)))
        data = _mesh_row(args.mesh_workdir, np)
        pm = gf256.parity_matrix(10, 14)
        k0 = rs_cuda.gf2_matmul.launches
        timing: dict = {}
        out = dist_mod.distributed_apply_matrix(mesh, pm, data, timing=timing)
        apply_sha = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        blk = dist_mod.distributed_encode_blockdiag(mesh, pm, data)
        launches = rs_cuda.gf2_matmul.launches - k0
        # this rank's lane: its K1 alone, and the collective alone
        lane = mesh.local_lanes()[0]
        a = dist_mod._lane_matrix(
            dist_mod.split_matrix_bitmajor(pm, 2)[lane].tobytes(), 4, 5,
            "cuda:0")
        x = torch.from_numpy(data[5 * lane : 5 * lane + 5]).cuda()
        k1_ms = _median_ms(torch, lambda: rs_cuda.gf2_matmul(a, x, 4), 5)
        xs = x[:, :MESH_PLAIN_COLS].contiguous()
        k1_slice_ms = _median_ms(torch, lambda: rs_cuda.gf2_matmul(a, xs, 4), 5)
        plain_ms = _median_ms(torch, lambda: rs_cuda._apply_torch(a, xs, 4), 3)
        plain_err = int((rs_cuda.gf2_matmul(a, xs, 4).int()
                         - rs_cuda._apply_torch(a, xs, 4).int())
                        .abs().max())
        part = torch.stack([rs_cuda.gf2_matmul(a, x, 4)] * len(
            mesh.local_lanes()))
        bufs = [torch.empty_like(part) for _ in range(args.mesh_world)]
        coll = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_gather(bufs, part)
            torch.cuda.synchronize()
            coll.append(time.perf_counter() - t0)
        with open(args.mesh_out, "w") as f:
            json.dump({
                "rank": args.mesh_rank, "world": args.mesh_world,
                "backend": args.mesh_backend, "processes": mesh.processes,
                "apply_sha256": apply_sha,
                "blockdiag_sha256": hashlib.sha256(blk.tobytes()).hexdigest(),
                "gf2_matmul_launches": launches, "timing_s": timing,
                "k1_ms": k1_ms, "k1_slice_ms": k1_slice_ms,
                "plain_slice_ms": plain_ms, "plain_max_abs_err": plain_err,
                "collective_ms": statistics.median(coll) * 1e3,
                "partial_bytes": int(part.numel()),
            }, f)
    finally:
        dist.destroy_process_group()
    return 0


def _mesh_ranks(workdir: str, backend: str, world: int) -> list:
    """10b's processes: `world` ranks of `backend` on cuda:0, started
    together -> their JSON records."""
    port = _free_port()
    procs = []
    for rank in range(world):
        out = os.path.join(workdir, f"mesh_{backend}_{rank}.json")
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--mesh-rank", str(rank), "--mesh-world", str(world),
             "--mesh-port", str(port), "--mesh-backend", backend,
             "--mesh-workdir", workdir, "--mesh-out", out],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    records = []
    try:
        for out, proc in procs:
            try:
                text, _ = proc.communicate(timeout=MESH_RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
            if proc.returncode != 0:
                raise AssertionError(f"mesh rank {out} failed:\n"
                                     + text.decode(errors="replace")[-6000:])
            with open(out) as f:
                records.append(json.load(f))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    return records


def phase_mesh(torch, workdir: str, vol: dict, deg: dict, seed: int) -> dict:
    """The mesh on one card (lanes on one card; no multi-GPU figure).
    10a: vid 1's 12 survivors pinned in a cache whose mesh has two lanes,
    both on cuda:0 (`make_mesh(devices=...)`, test construction), beside
    the one-device cache; every needle with bytes on shard 0 plus 400,
    shuffled, read in bursts of 64 in both layouts through each cache:
    every body equal between the two and to the written needle; a burst
    is one ragged launch a lane with work.  10b: distributed_apply_matrix
    and distributed_encode_blockdiag on [10, 100 MiB] of vid 1 on two gloo
    ranks sharing the card and on NCCL at world size 1, equal to the
    one-card K1 and the native codec.  10c: distributed_degraded_read of
    10a's shard-0 intervals over a (2, 1) mesh of the card, equal to the
    one-device resident read and the shard file."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import gf256, rs_cpu, rs_cuda
    from seaweedfs_tpu_torch.ops import rs_resident as rr
    from seaweedfs_tpu_torch.parallel import distributed as dist_mod
    from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
    from seaweedfs_tpu_torch.storage import ec

    torch.cuda.empty_cache()
    kernels = {"flat": rr.fused_reconstruct,
               "blockdiag": rr.fused_reconstruct_blockdiag}
    for kern in (*kernels.values(), rs_cuda.gf2_matmul,
                 rs_cuda.gf2_matmul_small):
        kern.launches = 0
    cuda0 = torch.device("cuda", 0)
    lanes_mesh = mesh_mod.make_mesh(2, 1, devices=[cuda0, cuda0])
    one = rr.DeviceShardCache(device="cuda", budget_bytes=RESIDENT_BUDGET)
    lanes = rr.DeviceShardCache(device="cuda", budget_bytes=MESH_BUDGET,
                                mesh=lanes_mesh)
    ev = ec.EcVolume(workdir, 1)
    try:
        for sid in range(14):
            if sid not in (0, 11):
                ev.add_shard(sid)
        pins = {}
        for name, cache in (("one", one), ("lanes", lanes)):
            t0 = time.perf_counter()
            if ev.load_shards_to_device(cache) != 12:
                raise AssertionError(f"{name}: pinned {cache.shard_ids(1)}")
            torch.cuda.synchronize()
            pins[name] = time.perf_counter() - t0
        if lanes.placement(1) != "mesh":
            raise AssertionError(f"placement {lanes.placement(1)}")
        deleted = set(deg["deleted"])
        shard0 = [n for n in deg["on_shard0"] if n not in deleted]
        others = [n for n in deg["picks"] if n not in deleted
                  and n not in set(shard0)][:MESH_EXTRA_READS]
        ids = shard0 + others
        np.random.default_rng(seed + 10).shuffle(ids)
        reads: dict = {}
        for layout, kern in kernels.items():
            digests = {}
            for name, cache in (("one", one), ("lanes", lanes)):
                ev.device_cache = cache
                cache.layout = layout
                k0 = kern.launches
                lat, per_call, got = [], [], []
                for i in range(0, len(ids), BURST):
                    burst = ids[i : i + BURST]
                    c0 = kern.launches
                    t0 = time.perf_counter()
                    res = ev.read_needles_batch(burst, backend="cuda")
                    lat.append(time.perf_counter() - t0)
                    per_call.append(kern.launches - c0)
                    got += list(zip(burst, res))
                for nid, n in got:
                    _, _, digest, cookie = vol["needles"][nid]
                    if isinstance(n, Exception) or n.cookie != cookie or \
                            hashlib.sha256(n.data).digest() != digest:
                        raise AssertionError(f"{name} {layout}: needle {nid} "
                                             "differs from the written one")
                    digests[(name, nid)] = hashlib.sha256(n.data).digest()
                reads[(layout, name)] = {
                    "bursts": len(lat), "burst_p50_ms": _pct(lat, 50),
                    "burst_p99_ms": _pct(lat, 99),
                    "launches": kern.launches - k0,
                    "launches_per_call": (kern.launches - k0) / len(lat),
                    "calls_with_2_launches": sum(1 for c in per_call if c == 2),
                    "max_launches_a_call": max(per_call)}
            if any(digests[("one", n)] != digests[("lanes", n)] for n in ids):
                raise AssertionError(f"{layout}: mesh bodies differ")
        if ev.device_misses:
            raise AssertionError(f"{ev.device_misses} intervals fell back")
        for layout in kernels:
            r = reads[(layout, "lanes")]
            if r["max_launches_a_call"] > 2 or not r["calls_with_2_launches"]:
                raise AssertionError(f"{layout}: launches a call {r}")
        # the sharded program's lane kernel: lane 0's ragged launch of one
        # burst, timed alone, against its plain version and bound
        burst_reqs = []
        for nid in ids[:BURST]:
            for iv in ev.locate_needle(nid)[2]:
                sid, off = iv.to_shard_and_offset()
                if sid == 0:
                    burst_reqs.append((0, off, iv.size))
        rmat, use, row_of, got = rr._survivors(lanes, 1, burst_reqs, 10, 14)
        lane_rows = {}
        for layout in kernels:
            groups = lanes.groups if layout == "blockdiag" else 1
            _, calls = rr._pack_calls_sharded(lanes, burst_reqs, row_of, groups)
            lane = min(calls)
            part, words, fetches, _ = calls[lane][0]
            surv = tuple(buf[lane] for buf, _ in got)
            a = rr._prepared_for(lanes, rmat, layout, cuda0)
            kw = dict(k_true=len(use), w_true=rmat.shape[0], groups=groups,
                      tile=groups * rr.FUSED_ALIGN)
            run = lambda: rr._ragged(a, surv, words, fetches, **kw)  # noqa: E731
            ms = _median_ms(torch, run, 20)
            plain = lambda: rr._fused_reconstruct_ragged_torch(  # noqa: E731
                a, surv, words, fetches, **kw)
            plain_ms = _median_ms(torch, plain, 3)
            err = int((run()[0].int() - plain().int()).abs().max())
            bound_ms, bound_by = _fused_bound(len(use), fetches,
                                              rmat.shape[0], groups)
            lane_rows[layout] = {"requests": len(part), "ms": ms,
                                 "plain_ms": plain_ms, "max_abs_err": err,
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 "lane_calls": {d: len(c) for d, c in
                                                calls.items()}}
        # 10c: the bulk plane's degraded read of the same needles' shard-0
        # intervals, against the one-device resident read and shard 0's file
        reqs = []
        for nid in ids:
            for iv in ev.locate_needle(nid)[2]:
                sid, off = iv.to_shard_and_offset()
                if sid == 0 and len(reqs) < MESH_DEGRADED:
                    reqs.append((off, iv.size))
        maps = {s: np.memmap(os.path.join(workdir, "1" + ec.to_ext(s)),
                             dtype=np.uint8, mode="r") for s in range(11)}
        ids10 = list(range(1, 11))

        class _Rows:
            """survivors[order, lo:hi] over the shard files."""

            def __getitem__(self, key):
                order, cols = key
                return np.stack([maps[ids10[i]][cols] for i in order])

        mesh21 = mesh_mod.make_mesh(2, 1, devices=[cuda0, cuda0])
        k0 = rs_cuda.gf2_matmul.launches
        t0 = time.perf_counter()
        pieces = []
        for i in range(0, len(reqs), MESH_DEGRADED_CALL):
            pieces += dist_mod.distributed_degraded_read(
                mesh21, _Rows(), ids10, 0, reqs[i : i + MESH_DEGRADED_CALL])
        degraded_s = time.perf_counter() - t0
        degraded_k1 = rs_cuda.gf2_matmul.launches - k0
        one.layout = "flat"
        resident = rr.reconstruct_intervals(one, 1, [(0, o, n) for o, n in reqs])
        for (off, n), piece, res in zip(reqs, pieces, resident):
            if piece != res or piece != maps[0][off : off + n].tobytes():
                raise AssertionError(f"10c: interval {off}+{n} differs")
        stats = {"one": one.device_stats(), "lanes": lanes.device_stats()}
    finally:
        ev.close()
        one.clear()
        lanes.clear()
        torch.cuda.empty_cache()
    # 10b: two gloo ranks sharing the card, then NCCL at world size 1,
    # against the one-card K1 and the native codec
    records = _mesh_ranks(workdir, "gloo", 2) + _mesh_ranks(workdir, "nccl", 1)
    data = _mesh_row(workdir, np)
    pm = gf256.parity_matrix(10, 14)
    t0 = time.perf_counter()
    native = rs_cpu.apply_matrix_native(pm, data)
    native_s = time.perf_counter() - t0
    x = torch.from_numpy(data).cuda()
    a_one = rs_cuda.prepare_matrix(pm, device="cuda")
    one_ms = _median_ms(torch, lambda: rs_cuda.gf2_matmul(a_one, x, 4), 5)
    card = rs_cuda.gf2_matmul(a_one, x, 4).cpu().numpy()
    want = hashlib.sha256(native.tobytes()).hexdigest()
    if hashlib.sha256(card.tobytes()).hexdigest() != want:
        raise AssertionError("10b: the one-card K1 differs from the native codec")
    for r in records:
        if r["apply_sha256"] != want or r["blockdiag_sha256"] != want:
            raise AssertionError(f"10b: rank {r['rank']} ({r['backend']}) "
                                 "differs from the native codec")
        if r["gf2_matmul_launches"] != 2 * (3 - r["world"]) or \
                r["plain_max_abs_err"]:
            raise AssertionError(f"10b: rank record {r}")
    del x
    torch.cuda.empty_cache()
    launches = {"fused_reconstruct": sum(
        reads[(l, n)]["launches"] for l in ("flat",) for n in ("one", "lanes")),
        "fused_reconstruct_blockdiag": sum(
        reads[("blockdiag", n)]["launches"] for n in ("one", "lanes")),
        "gf2_matmul": degraded_k1 + sum(r["gf2_matmul_launches"]
                                        for r in records),
        "gf2_matmul_small": rs_cuda.gf2_matmul_small.launches}
    out = {"pin_s": pins, "reads": {f"{l}/{n}": v for (l, n), v in
                                    reads.items()},
           "needles": len(ids), "device_stats": stats,
           "stripe": lanes.stripe, "lane_kernel": lane_rows,
           "ranks": records, "one_card_k1_ms": one_ms,
           "native_apply_s": native_s, "row_bytes": int(data.size),
           "degraded": {"intervals": len(reqs), "calls": -(-len(reqs)
                        // MESH_DEGRADED_CALL), "wall_s": degraded_s,
                        "k1_launches": degraded_k1},
           "launches": launches}
    log("mesh", **out, lanes_on_one_card=True,
        note="two lanes on one card: a check of the mesh code's bytes and "
             "launches, not a multi-GPU figure")
    return out


def _b6_entries(mesh: dict) -> list:
    """The kernels line's rows for B6's two programs (phase 10): each
    runs the port's kernels on every lane, so a row times one lane's
    launch, and the bound is the lane's bytes over the card's memory rate
    plus the collective's wire bytes over the same rate (a rough figure:
    two lanes share one card)."""
    lanes = mesh["lane_kernel"]
    reads = mesh["reads"]
    ranks = mesh["ranks"]
    gloo = [r for r in ranks if r["backend"] == "gloo"]
    b = mesh["row_bytes"] // 10
    lane_bytes = (5 + 4) * b  # a lane's 5 shard rows in, 4 partial rows out
    wire = 2 * 4 * b  # the gathered partials: n_shard x the output
    return [{
        "name": "sharded_gather_reconstruct",
        "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/fused_reconstruct.cu",
        "program": "seaweedfs_tpu_torch/ops/rs_resident.py "
                   "_reconstruct_sharded",
        "replaces": "seaweedfs_tpu/ops/rs_resident.py:1597",
        "launches": sum(reads[f"{l}/lanes"]["launches"]
                        for l in ("flat", "blockdiag")),
        "launches_per_call": {l: reads[f"{l}/lanes"]["launches_per_call"]
                              for l in ("flat", "blockdiag")},
        "max_abs_err": max(r["max_abs_err"] for r in lanes.values()),
        "shape": f"one lane's ragged launch of a burst of {BURST} reads, "
                 f"{lanes['flat']['requests']} requests, flat",
        "ms": lanes["flat"]["ms"],
        "plain_ms": lanes["flat"]["plain_ms"],
        "bound_ms": lanes["flat"]["bound_ms"],
        "bound_by": lanes["flat"]["bound_by"],
        "library_ms": None,
        "library_note": NO_LIBRARY_CALL,
        "collective_ms": None,
        "collective_note": "one process: no collective, one D2H a lane",
        "blockdiag": lanes["blockdiag"],
        "burst_p50_ms": {k: v["burst_p50_ms"] for k, v in reads.items()},
        "lanes_on_one_card": 2,
    }, {
        "name": "distributed_apply",
        "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf2_matmul.cu",
        "program": "seaweedfs_tpu_torch/parallel/distributed.py "
                   "_distributed_apply",
        "replaces": "seaweedfs_tpu/parallel/distributed.py:65",
        "launches": mesh["launches"]["gf2_matmul"],
        "launches_by_leg": {"ranks": {f"{r['backend']}{r['rank']}":
                                      r["gf2_matmul_launches"] for r in ranks},
                            "degraded_read": mesh["degraded"]["k1_launches"]},
        "max_abs_err": max(r["plain_max_abs_err"] for r in ranks),
        "shape": f"a lane's x[5, {b}] of [10, {b}], (2, 1) mesh",
        "ms": statistics.median(r["k1_ms"] for r in gloo),
        "plain_ms": statistics.median(r["plain_slice_ms"] for r in gloo),
        "plain_shape": f"x[5, {MESH_PLAIN_COLS}] (the kernel there: "
                       f"{statistics.median(r['k1_slice_ms'] for r in gloo)}"
                       " ms)",
        "bound_ms": (lane_bytes + wire) / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        # the lane's K1 alone: its rows in, its partial out
        "k1_bound_ms": lane_bytes / PEAK_BYTES_PER_S * 1e3,
        "library_ms": None,
        "library_note": "no single PyTorch call applies a GF(256) matrix",
        "collective_ms": {f"{r['backend']}{r['rank']}": r["collective_ms"]
                          for r in ranks},
        "one_card_k1_ms": mesh["one_card_k1_ms"],
        "lanes_on_one_card": 2,
    }]


# ------------------------------------------------------------------ main


def main() -> int:
    if sys.argv[1:2] == ["--mesh-rank"]:  # one of phase 10b's processes
        return _mesh_rank_main(sys.argv[1:])
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--volume-gib", type=float, default=11.0,
                   help="volume size; users run 30 (the -volumeSizeLimitMB default)")
    args = p.parse_args()

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from seaweedfs_tpu_torch.ops import rs_cuda
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    workdir = os.path.join(HERE, "chip_smoke_work")
    phase = "device"
    walls: list = []

    def run(name: str, fn, *fn_args):
        """One phase: its wall and this process's bytes written by its
        end, logged and kept for the phase_walls line."""
        nonlocal phase
        phase = name
        t0 = time.monotonic()
        out = fn(*fn_args)
        walls.append({"name": name, "wall_s": time.monotonic() - t0,
                      "run_s": time.monotonic() - START, "wchar": _wchar()})
        log("phase_end", **walls[-1])
        return out

    try:
        info = run("device", phase_device, torch)
        k1 = run("kernel", phase_kernel, torch, args.seed)
        shapes = k1["shapes"]
        fused = run("resident_kernel", phase_resident_kernels, torch, args.seed)
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        vol = run("volume", phase_volume, workdir, args.seed,
                  int(args.volume_gib * (1 << 30)))
        # the main path: encode, verify, degraded read, rebuild, decode
        k1_wrappers = (rs_cuda.gf2_matmul, rs_cuda.gf2_matmul_small)
        enc = run("encode", phase_encode, torch, workdir, vol["dat_size"],
                  k1_wrappers, args.seed)
        deg = run("degraded_read", phase_degraded, workdir, vol,
                  enc["shard_size"], k1_wrappers, args.seed)
        res = run("resident_read", phase_resident, torch, workdir, vol, deg,
                  args.seed)
        serve = run("serve", phase_serve, torch, workdir, vol, deg, args.seed)
        reb = run("rebuild", phase_rebuild, workdir, enc["shard_size"],
                  k1_wrappers)
        scr = run("scrub", phase_scrub, torch, workdir, args.seed)
        scs = run("scrub_serve", phase_scrub_serve, torch, workdir, vol, deg,
                  serve, args.seed)
        run("decode", phase_decode, workdir, vol)
        ing = run("ingest", phase_ingest, torch, workdir, args.seed)
        tier = run("tiering", phase_tiering, torch, workdir, vol, deg,
                   args.seed)
        clu = run("cluster", phase_cluster, torch, workdir, vol, deg, serve,
                  args.seed)
        mesh = run("mesh", phase_mesh, torch, workdir, vol, deg, args.seed)
    except Exception:  # noqa: BLE001 — every phase is fatal
        traceback.print_exc()
        print(json.dumps({"phase_walls": walls, "failed": phase,
                          "run_s": time.monotonic() - START,
                          "wchar": _wchar()}), flush=True)
        print(f"chip_smoke: FAILED in phase {phase}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"phase_walls": walls, "run_s": time.monotonic() - START,
                      "wchar": _wchar()}), flush=True)

    cluster_k = clu["launches"]
    mesh_k = mesh["launches"]
    main_paths = {**enc["load_paths"], "degraded_read": deg["load_paths"],
                  "rebuild": reb["load_paths"],
                  "ingest": ing["launches"],
                  "cluster": {k: cluster_k[k] for k in (
                      "gf2_matmul", "gf2_matmul_small")},
                  "mesh": {k: mesh_k[k] for k in (
                      "gf2_matmul", "gf2_matmul_small")}}
    launches = {name: sum(p[name] for p in main_paths.values())
                for name in ("gf2_matmul", "gf2_matmul_small")}
    if not all(launches.values()):
        print(f"chip_smoke: a K1 kernel was not launched on the main path: "
              f"{launches}", file=sys.stderr)
        return 1
    if not ing["launches"]["gf2_matmul"] or not tier["launches"]:
        print(f"chip_smoke: the ingest or tiering phase launched no kernel: "
              f"{ing['launches']}, {tier['launches']}", file=sys.stderr)
        return 1
    if not (cluster_k["gf2_matmul"] + cluster_k["gf2_matmul_small"]) \
            or not cluster_k["fused_reconstruct"] or not cluster_k["scrub"]:
        print(f"chip_smoke: the cluster phase left a kernel unlaunched: "
              f"{cluster_k}", file=sys.stderr)
        return 1
    if not scr["launches"] or not scs["launches"]:
        print(f"chip_smoke: the scrub kernel was not launched on the main "
              f"path: {scr['launches']}, {scs['launches']}", file=sys.stderr)
        return 1
    srow = scr["rows"]
    scrub_entry = {
        "name": "scrub",
        "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/scrub.cu",
        "replaces": "seaweedfs_tpu/ops/rs_resident.py:2873",
        "also_replaces": ["seaweedfs_tpu/ops/rs_resident.py:2901",
                          "seaweedfs_tpu/ops/rs_resident.py:3074"],
        "launches": scr["launches"] + scs["launches"] + cluster_k["scrub"],
        "launches_by_phase": {"scrub": scr["launches"],
                              "scrub_serve": scs["launches"],
                              "cluster": cluster_k["scrub"]},
        "max_abs_err": max(r["max_abs_err"] for r in srow.values()),
        "mismatched_bytes": sum(r["mismatched_bytes"] for r in srow.values()),
        "shape": f"volume 1: 14 x {srow['flat']['n_lanes']} resident bytes, flat",
        "ms": srow["flat"]["ms"],
        "plain_ms": srow["flat"]["plain_ms"],
        "bound_ms": srow["flat"]["bound_ms"],
        "bound_by": srow["flat"]["bound_by"],
        "library_ms": None,
        "library_note": NO_SCRUB_LIBRARY_CALL,
        "redesigned": "PR 7",
        # the CUDA-core kernel it replaced, timed in turns with it
        "previous_ms": srow["flat"]["previous_ms"],
        "blockdiag": {key: srow["blockdiag"][key] for key in (
            "n_lanes", "ms", "previous_ms", "plain_ms", "bound_ms",
            "bound_by", "share_of_bound")},
        "share_of_bound": srow["flat"]["share_of_bound"],
        "d2h_bytes_per_call": scr["d2h_bytes_per_call"],
    }
    small_row = shapes["reconstruct_1row_64k"]
    flat = shapes["encode_flat"]
    resident = []
    for layout, name, line in (
        ("flat", "fused_reconstruct", 1184),
        ("blockdiag", "fused_reconstruct_blockdiag", 1364),
    ):
        rows = fused[layout]
        rep = next(r for r in rows if r["shape"] == RESIDENT_REPORT)
        burst = fused[layout + "_burst"]
        resident.append({
            "name": name,
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/csrc/fused_reconstruct.cu",
            "replaces": f"seaweedfs_tpu/ops/rs_resident.py:{line}",
            "launches": res[name] + serve[layout]["launches"]
                        + (tier["launches"] if layout == "flat" else 0)
                        + cluster_k[name] + mesh_k[name],
            "launches_by_phase": {"resident_read": res[name],
                                  "serve": serve[layout]["launches"],
                                  "tiering": (tier["launches"]
                                              if layout == "flat" else 0),
                                  "cluster": cluster_k[name],
                                  "mesh": mesh_k[name]},
            "max_abs_err": max([r["max_abs_err"] for r in rows]
                               + [burst["max_abs_err"]]),
            "mismatched_bytes": sum(r["mismatched_bytes"] for r in rows)
                                + burst["mismatched_bytes"],
            "shape": f"N={rep['shape'][0]} fetch={rep['fetch']} "
                     f"w_true={rep['shape'][2]}",
            "ms": rep["ms"],
            "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"],
            "library_ms": None,
            "library_note": NO_LIBRARY_CALL,
            # a burst of BURST needle reads as one ragged launch (kernel
            # alone, and the device window of launch + D2H) against one
            # uniform call per size bucket on the same kernel
            "burst": {key: burst[key] for key in (
                "kernel_ms", "bound_ms", "share_of_bound", "launches_B",
                "launches_A", "window_B_ms", "window_A_ms", "d2h_B",
                "d2h_A", "plain_ms")},
            "launches_per_main_burst": res["per_main_burst"][name],
            # phase 5c: the dispatcher's batches of concurrent HTTP reads
            "launches_per_served_batch": serve[layout]["launches_per_batch"],
        })
    print(json.dumps({"kernels": [{
        "name": "gf2_matmul",
        "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf2_matmul.cu",
        "replaces": "seaweedfs_tpu/ops/rs_tpu.py:201",
        "launches": launches["gf2_matmul"],
        "launches_by_phase": main_paths,
        "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
        "mismatched_bytes": sum(r["mismatched_bytes"] for r in shapes.values()),
        "shape": "encode_flat",
        "ms": flat["ms"],
        "plain_ms": flat["plain_ms"],
        "bound_ms": flat["bound_ms"],
        "bound_by": flat["bound_by"],
        "library_ms": flat["library_ms"],
        "launch_floor_ms": k1["launch_floor_ms"],
        "timed_shapes": {
            name: {key: r[key] for key in ("b", "m_out", "load_path", "routed_to",
                                           "ms", "small_ms", "bound_ms",
                                           "share_of_bound", "plain_ms",
                                           "library_ms") if key in r}
            for name, r in shapes.items() if "ms" in r},
        # phase 8: the streamed stripe row, x[10, 1 MiB] -> 4 parity rows
        "ingest_row": {key: ing["k1"][key] for key in (
            "shape", "ms", "window_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "share_of_bound", "window_share_of_bound",
            "encode_call_ms", "max_abs_err")},
        "ingest_launches": ing["launches"]["gf2_matmul"],
        # phase 9b: the master's repair job, on its rebuilder, and the
        # vacuumed volume's offline seal, on its holder (in "cluster")
        "repair_launches": clu["verbs"]["auto_repair"]["rebuilder_k1"][
            "gf2_matmul"],
        "vacuum_seal_launches": clu["verbs"]["k1"]["encode"]["gf2_matmul"],
        # phase 9c: the new leader's repair job after the leader's kill,
        # on its rebuilder, and the encode under the first leader
        "failover_repair_launches": clu["ha"]["loss"]["rebuilder_k1"][
            "gf2_matmul"],
        "failover_encode_launches": clu["ha"]["encode_k1"]["gf2_matmul"],
        # phase 9d: the all-in-one server's encode, on S
        "server_encode_launches": clu["server"]["encode"]["k1_on_S"][
            "gf2_matmul"],
        # phase 9e: the filer's volume's encode, on its holder
        "filer_encode_launches": clu["filer"]["encode"]["k1_on_holder"][
            "gf2_matmul"],
    }, {
        "name": "gf2_matmul_small",
        "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf2_matmul_small.cu",
        "replaces": "seaweedfs_tpu/ops/rs_tpu.py:201",
        "launches": launches["gf2_matmul_small"],
        "launches_by_phase": {name: p["gf2_matmul_small"]
                              for name, p in main_paths.items()},
        "max_abs_err": max(r["small_max_abs_err"] for r in shapes.values()),
        "mismatched_bytes": sum(r.get("small_mismatched_bytes", 0)
                                for r in shapes.values()),
        "shape": "reconstruct_1row_64k",
        "ms": small_row["small_ms"],
        "plain_ms": small_row["plain_ms"],
        "bound_ms": small_row["bound_ms"],
        "bound_by": small_row["bound_by"],
        "library_ms": small_row["library_ms"],
        "repair_launches": clu["verbs"]["auto_repair"]["rebuilder_k1"][
            "gf2_matmul_small"],
        "vacuum_seal_launches": clu["verbs"]["k1"]["encode"][
            "gf2_matmul_small"],
        "failover_repair_launches": clu["ha"]["loss"]["rebuilder_k1"][
            "gf2_matmul_small"],
        "failover_encode_launches": clu["ha"]["encode_k1"][
            "gf2_matmul_small"],
        "server_encode_launches": clu["server"]["encode"]["k1_on_S"][
            "gf2_matmul_small"],
    }, *resident, scrub_entry, *_b6_entries(mesh)]}), flush=True)
    print(SMI, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
