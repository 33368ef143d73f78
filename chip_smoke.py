#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seaweedfs_tpu_torch) once on an NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--volume-gib G]

Builds the port's kernel (csrc/gf2_matmul.cu, nvcc for sm_90a) and host
library (csrc/host/*.cpp, g++) from this checkout, holds the kernel
byte-equal to its plain PyTorch version on the card at the shapes the main
path gives it, then runs the EC main path through the port's entry points
on a real volume:

  1. device      CUDA device, both builds
  2. kernel      gf2_matmul vs _apply_torch (+ numpy oracle sample), times
  3. volume      write a volume of mixed 4 KB-1 MB needles from --seed
  4. encode      write_ec_files + write_sorted_file_from_idx under
                 torch.profiler (the card's busy share), verify_ec_files
  5. degraded    .ec00 and .ec11 down: EcVolume.read_needle of every needle
                 with bytes on shard 0, plus others
  6. rebuild     shards 0, 5, 10, 13 removed: rebuild_ec_files +
                 rebuild_ecx_file, sha256 of every rebuilt shard
  7. decode      original .dat deleted: write_dat_file, sha256 of the .dat

Every phase is fatal.  Prints one line per phase, a {"kernels": [...]}
line, the nvidia-smi name/power-limit line, and as the last line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when no
CUDA device is present or the port is not beside this script.  The volume
lives in chip_smoke_work/ beside this script and is removed at the end.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import hashlib
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

SMI = "unknown"


def log(phase: str, **fields) -> None:
    """One line per phase; every time or rate carries the card's nvidia-smi
    name and power limit."""
    print(json.dumps({"phase": phase, "gpu": SMI, **fields}), flush=True)


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
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": {k: round(v, 3) for k, v in _build.build_seconds.items()},
        "build_wall_s": round(time.perf_counter() - t0, 3),
    }
    log("device", **info)
    return info


# --------------------------------------------------------------- phase 2


def _median_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound(k: int, b: int, m_out: int, a_shape, groups: int = 1) -> tuple[float, str]:
    """Least time for the function on these inputs: each input byte read
    once and each output byte written once over HBM, against the int8
    ops of the product the function needs, the m_out true output rows by
    the k true input columns in bits: 2*8m_out*8k*b.  Padding is not work,
    and neither are the zero blocks of a `groups`-block-diagonal system
    (each group's m_out/groups rows meet only its k/groups columns)."""
    nbytes = k * b + m_out * b + a_shape[0] * a_shape[1]
    ops = 2 * (8 * m_out) * (8 * k) * b // groups
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel(torch, seed: int) -> dict:
    import numpy as np

    from seaweedfs_tpu_torch.ops import gf256, rs_cpu, rs_cuda

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
        ("rebuild_4row", rebuild4, 10, 4 * mib, 4, 1, True),
        ("encode_flat_ragged", parity, 10, 4 * mib + 37, 4, 1, True),
    ]
    for k in (1, 3, 7, 10, 13, 16):
        m = int(rng.integers(1, 15))
        mat = rng.integers(0, 256, (m, k), dtype=np.uint8)
        shapes.append((f"random_k{k}_m{m}", mat, k, 65536 + k, m, 1, k == 16))

    results = {}
    for name, mat, k, b, m_out, groups, timed in shapes:
        a = rs_cuda.prepare_matrix(mat, dev)
        if m_out > a.shape[0] // 8:
            raise AssertionError(f"{name}: m_out {m_out} > m_pad")
        x = torch.randint(0, 256, (k, b), dtype=torch.uint8, device=dev,
                          generator=gen)
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
            "mismatched_bytes": mismatched, "max_abs_err": max_err,
            "oracle_sample_mismatched": oracle_bad,
        }
        if mismatched or oracle_bad:
            log("kernel", shape=name, **row)
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        if timed:
            bound_ms, bound_by = _bound(k, b, m_out, a.shape, groups)
            row["ms"] = _median_ms(torch, lambda: rs_cuda.gf2_matmul(a, x, m_out), 20)
            row["plain_ms"] = _median_ms(
                torch, lambda: rs_cuda._apply_torch(a, x, m_out), 5, warmup=1
            )
            row["bound_ms"] = bound_ms
            row["bound_by"] = bound_by
            row["library_ms"] = _int_mm_ms(torch, a, x)
            row["input_GBps"] = k * b / (row["ms"] * 1e-3) / 1e9
            row["share_of_bound"] = bound_ms / row["ms"]
        results[name] = row
        log("kernel", shape=name, **row)
        del x, got, ref, diff

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
    return results


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
                 "why": "one H100 machine's disk and the run's time limit; "
                        "11 GiB is the smallest volume with a 1 GiB "
                        "large-block row and 1 MiB small-block rows"},
    )
    return {"needles": needles, "dat_size": dat_size, "dat_sha": dat_sha}


# --------------------------------------------------------------- phase 4


def _device_time(trace_path: str) -> dict:
    """Device busy time from a torch.profiler chrome trace: the union of
    every kernel/memcpy/memset interval on the card, and the kernel's own
    sum.  Empty when the trace holds no device event."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans, kernel_us, copy_us = [], 0.0, 0.0
    for e in events:
        cat = e.get("cat", "")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset") or "dur" not in e:
            continue
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        if cat == "kernel" and "gf2_matmul" in e.get("name", ""):
            kernel_us += float(e["dur"])
        elif cat == "gpu_memcpy":
            copy_us += float(e["dur"])
    if not spans:
        return {}
    spans.sort()
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return {"device_events": len(spans), "busy_s": busy_us * 1e-6,
            "gf2_matmul_s": kernel_us * 1e-6, "memcpy_s": copy_us * 1e-6}


def phase_encode(torch, workdir: str, dat_size: int, kernel, seed: int) -> dict:
    import numpy as np

    from seaweedfs_tpu_torch.ops import gf256, rs_cpu
    from seaweedfs_tpu_torch.storage import ec

    base = os.path.join(workdir, "1")
    stats: dict = {}
    kernel.launches = 0
    # traced, to read the card's busy and idle share of the encode
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ec.write_ec_files(base, backend="cuda", stats=stats)
        ec.write_sorted_file_from_idx(base)
        wall = time.perf_counter() - t0
    enc_launches = kernel.launches
    if enc_launches == 0:
        raise AssertionError("encode launched no gf2_matmul kernel")
    trace_path = os.path.join(workdir, "encode_trace.json")
    prof.export_chrome_trace(trace_path)
    dev = _device_time(trace_path)
    os.remove(trace_path)
    if dev:
        dev["busy_share"] = dev["busy_s"] / wall
        dev["idle_share"] = 1.0 - dev["busy_share"]
    else:
        print("chip_smoke: the profiler recorded no device event in the "
              "encode; device busy share not measured", file=sys.stderr)
    shard_size = os.path.getsize(base + ec.to_ext(0))
    log("encode", GBps=dat_size / wall / 1e9, wall_s=wall, shard_bytes=shard_size,
        launches=enc_launches, stats=stats,
        overlapped=stats["read_s"] + stats["write_s"] + stats["device_busy_s"]
        > stats["wall_s"] - stats["fsync_s"],
        device_trace=dev or "not measured")

    kernel.launches = 0
    vstats: dict = {}
    t0 = time.perf_counter()
    mism, verified = ec.verify_ec_files(base, backend="cuda", stats=vstats)
    vwall = time.perf_counter() - t0
    ver_launches = kernel.launches
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
        mismatches=mism, launches=ver_launches, oracle_stripes=checked,
        stats=vstats)
    return {"wall_s": wall, "shard_size": shard_size,
            "launches": {"encode": enc_launches, "verify": ver_launches}}


# --------------------------------------------------------------- phase 5


def phase_degraded(workdir: str, vol: dict, shard_size: int, kernel, seed: int) -> dict:
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
    kernel.launches = 0
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
    launches = kernel.launches
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

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs) * 1e3, q)) if xs else None

    both = lat_deg + lat_local
    log("degraded_read", shards_down=[0, 11], reads=len(picks),
        degraded_reads=len(lat_deg), launches=launches,
        p50_ms=pct(both, 50), p99_ms=pct(both, 99),
        degraded_p50_ms=pct(lat_deg, 50), degraded_p99_ms=pct(lat_deg, 99),
        local_p50_ms=pct(lat_local, 50), local_p99_ms=pct(lat_local, 99))
    return {"launches": launches, "deleted": deleted}


# --------------------------------------------------------------- phase 6


def phase_rebuild(workdir: str, shard_size: int, kernel) -> dict:
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
    kernel.launches = 0
    t0 = time.perf_counter()
    rebuilt = ec.rebuild_ec_files(base, backend="cuda", stats=stats)
    ec.rebuild_ecx_file(base)
    wall = time.perf_counter() - t0
    launches = kernel.launches
    if sorted(rebuilt) != list(lost) or launches == 0:
        raise AssertionError(f"rebuilt {rebuilt} with {launches} launches")
    for sid in lost:
        if sha256_file(base + ec.to_ext(sid)) != before[sid]:
            raise AssertionError(f"rebuilt shard {sid} differs from the original")
    if os.path.exists(base + ".ecj"):
        raise AssertionError("rebuild_ecx_file left the .ecj journal")
    log("rebuild", shards=list(lost), GBps=10 * shard_size / wall / 1e9,
        wall_s=wall, launches=launches, stats=stats)
    return {"wall_s": wall, "launches": launches}


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


# ------------------------------------------------------------------ main


def main() -> int:
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
    try:
        info = phase_device(torch)
        phase = "kernel"
        shapes = phase_kernel(torch, args.seed)
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        phase = "volume"
        vol = phase_volume(workdir, args.seed, int(args.volume_gib * (1 << 30)))
        # the main path: encode, verify, degraded read, rebuild, decode
        kernel = rs_cuda.gf2_matmul
        phase = "encode"
        enc = phase_encode(torch, workdir, vol["dat_size"], kernel, args.seed)
        phase = "degraded_read"
        deg = phase_degraded(workdir, vol, enc["shard_size"], kernel, args.seed)
        phase = "rebuild"
        reb = phase_rebuild(workdir, enc["shard_size"], kernel)
        phase = "decode"
        phase_decode(workdir, vol)
    except Exception:  # noqa: BLE001 — every phase is fatal
        traceback.print_exc()
        print(f"chip_smoke: FAILED in phase {phase}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    main_launches = {**enc["launches"], "degraded_read": deg["launches"],
                     "rebuild": reb["launches"]}
    flat = shapes["encode_flat"]
    print(json.dumps({"kernels": [{
        "name": "gf2_matmul",
        "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf2_matmul.cu",
        "replaces": "seaweedfs_tpu/ops/rs_tpu.py:201",
        "launches": sum(main_launches.values()),
        "launches_by_path": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
        "mismatched_bytes": sum(r["mismatched_bytes"] for r in shapes.values()),
        "shape": "encode_flat",
        "ms": flat["ms"],
        "plain_ms": flat["plain_ms"],
        "bound_ms": flat["bound_ms"],
        "bound_by": flat["bound_by"],
        "library_ms": flat["library_ms"],
    }]}), flush=True)
    print(SMI, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
