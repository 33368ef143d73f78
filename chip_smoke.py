#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seaweedfs_tpu_torch) once on an NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--volume-gib G]

Builds the port's kernels (csrc/gf2_matmul.cu and csrc/fused_reconstruct.cu,
nvcc for sm_90a, one library) and host library (csrc/host/*.cpp, g++) from
this checkout, holds each kernel byte-equal to its plain PyTorch version on
the card at the shapes the main path gives it, then runs the EC main path
through the port's entry points on a real volume:

  1. device      CUDA device, both builds
  2. kernel      gf2_matmul vs _apply_torch (+ numpy oracle sample), times
  2b. resident_kernel
                 fused_reconstruct and fused_reconstruct_blockdiag vs their
                 plain versions (+ numpy oracle sample) on 10 x 256 MiB
                 synthetic survivors, times against the bound
  3. volume      write a volume of mixed 4 KB-1 MB needles from --seed
  4. encode      write_ec_files + write_sorted_file_from_idx under
                 torch.profiler (the card's busy share), verify_ec_files
  5. degraded    .ec00 and .ec11 down: EcVolume.read_needle of every needle
                 with bytes on shard 0, plus others (the host path)
  5b. resident_read
                 the same reads with the 12 survivors pinned in a
                 DeviceShardCache, in bursts (read_needles_batch) and
                 singly (read_needle), block-diagonal and flat; no read may
                 fall back to the host path
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
NO_LIBRARY_CALL = "no single PyTorch call gathers, reconstructs and selects"
# bursts of BURST re-read under torch.profiler for the busy share
TRACED_BURSTS = 32

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

    # timed inputs rotate through copies that together exceed the 50 MB
    # L2, so each launch finds its input cold, as the main path does
    l2_cold = 128 << 20
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
            bound_ms, bound_by = _bound(k, b, m_out, groups)
            xs = itertools.cycle([x] + [
                torch.randint(0, 256, (k, b), dtype=torch.uint8, device=dev,
                              generator=gen)
                for _ in range(-(-l2_cold // x.numel()) - 1)])
            row["ms"] = _median_ms(
                torch, lambda: rs_cuda.gf2_matmul(a, next(xs), m_out), 20)
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


def _fused_bound(k: int, n: int, fetch: int, rows: int,
                 groups: int = 1) -> tuple[float, str]:
    """Least time for one fused reconstruct call: the n requests' k survivor
    windows and their meta words read once, the [n, fetch] rows written
    once, and of the prepared matrix only what the function needs, 8
    output bits by 8k input bits for each of the `rows` wanted rows in
    each of the `groups` diagonal blocks (pad rows and zero blocks are
    not read); against the int8 ops of the one wanted row per byte."""
    nbytes = (k + 1) * n * fetch + 4 * n + groups * rows * 8 * (8 * k)
    return _roofline(nbytes, 2 * 8 * (8 * k) * n * fetch)


def _launch_ms(torch, launch, metas) -> float:
    """CUDA-event median of one kernel launch for each meta vector after
    the first two (warm-up).  Each vector asks for fresh random windows, so
    the survivors' bytes are cold in L2 as a serving call finds them; a
    device-side spin before each start event keeps the host's launch time
    out of the window."""
    times = []
    for i, meta in enumerate(metas):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        a.record()
        launch(meta)
        b.record()
        b.synchronize()
        if i >= 2:
            times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_resident_kernels(torch, seed: int) -> dict:
    """Both fused reconstruct kernels against their plain versions (and a
    numpy-oracle sample) on synthetic resident survivors, at the shapes a
    degraded-read burst gives them, flat and block-diagonal."""
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

            def meta_of():
                units = rng.integers(0, last + 1, n)
                units[-1] = last  # the last legal window
                rows = rng.integers(0, w, n)
                return torch.from_numpy(
                    ((units << rr.META_ROW_BITS) | rows).astype(np.int32)
                ).to(dev)

            meta = meta_of()
            got = fn(a, surv, meta, **kw, **fkw)
            want = plain(a, surv, meta, **kw, **pkw)
            torch.cuda.synchronize()
            diff = got.to(torch.int16) - want.to(torch.int16)
            mismatched = int((diff != 0).sum().item())
            max_err = int(diff.abs().max().item())
            # the first and the last (last legal window) request against the
            # numpy table oracle: the same bytes in either layout
            oracle_bad = 0
            host_meta = meta.cpu().numpy()
            sample = min(f, 65536)
            for j in (0, n - 1):
                start = int(host_meta[j] >> rr.META_ROW_BITS) * rr.FUSED_ALIGN
                r = int(host_meta[j] & ((1 << rr.META_ROW_BITS) - 1))
                x = np.stack([s[start : start + sample].cpu().numpy() for s in surv])
                ref = rs_cpu.apply_matrix_numpy(mat[r : r + 1], x)[0]
                oracle_bad += int((got[j, :sample].cpu().numpy() != ref).sum())
            row = {"layout": layout, "shape": [n, fetch, w], "fetch": f,
                   "tile": tile, "a": list(a.shape),
                   "mismatched_bytes": mismatched, "max_abs_err": max_err,
                   "oracle_sample_mismatched": oracle_bad}
            if mismatched or oracle_bad:
                log("resident_kernel", **row)
                raise AssertionError(f"{layout} {n}x{f}: kernel disagrees "
                                     "with its plain version")
            metas = [meta_of() for _ in range(22)]
            row["ms"] = _launch_ms(
                torch,
                lambda m: rr._launch(fn, a, surv, m, f, w, launch_g,
                                     launch_tile),
                metas,
            )
            # the median of the timed calls' bounds, each with the rows its
            # requests want
            row_mask = (1 << rr.META_ROW_BITS) - 1
            bounds = [_fused_bound(10, n, f, len(torch.unique(m & row_mask)),
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
    del surv
    torch.cuda.empty_cache()
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
    dev = _device_time(prof, os.path.join(workdir, "encode_trace.json"), wall,
                       ("gf2_matmul",))
    if not dev:
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
    both = lat_deg + lat_local
    host = {"p50_ms": _pct(both, 50), "p99_ms": _pct(both, 99),
            "degraded_p50_ms": _pct(lat_deg, 50),
            "degraded_p99_ms": _pct(lat_deg, 99)}
    log("degraded_read", shards_down=[0, 11], reads=len(picks),
        degraded_reads=len(lat_deg), launches=launches, **host,
        local_p50_ms=_pct(lat_local, 50), local_p99_ms=_pct(lat_local, 99))
    return {"launches": launches, "deleted": deleted, "picks": picks,
            "on_shard0": on_shard0, "host": host}


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
        for kern in (*kernels.values(), rs_cuda.gf2_matmul):
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

        for layout, kern in kernels.items():
            cache.layout = layout
            k0, d2h0, h2d0 = (kern.launches, cache.pipeline.d2h_bytes,
                              cache.pipeline.h2d_bytes)
            # the first burst grows the slot's pinned result buffer
            t0 = time.perf_counter()
            check(ids[:BURST], ev.read_needles_batch(ids[:BURST], backend="cuda"))
            first_ms = (time.perf_counter() - t0) * 1e3
            main = bursts(BURST, ids)
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
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    bursts(BURST, ids[: TRACED_BURSTS * BURST], keep=kept)
                    wall = time.perf_counter() - t0
                for burst, got in kept:
                    check(burst, got)
                trace = _device_time(
                    prof, os.path.join(workdir, "resident_trace.json"), wall,
                    ("fused_reconstruct", "gf2_matmul"),
                )
                if trace:
                    trace["wall_s"] = wall
                else:
                    trace = "not measured"
            launches = kern.launches - k0
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
                d2h_bytes=cache.pipeline.d2h_bytes - d2h0,
                h2d_bytes=cache.pipeline.h2d_bytes - h2d0,
                host_route=deg["host"], device_trace=trace)
        # a journaled delete still fails in its own slot of a burst
        got = ev.read_needles_batch([min(deleted), ids[0]], backend="cuda")
        if not isinstance(got[0], ec.NeedleNotFound):
            raise AssertionError(f"deleted needle read as {got[0]!r}")
        check(ids[:1], got[1:])
        if ev.device_misses or rs_cuda.gf2_matmul.launches:
            raise AssertionError(
                f"{ev.device_misses} intervals fell back to the host path "
                f"({rs_cuda.gf2_matmul.launches} gf2_matmul launches)")
        out = {kern.__name__: kern.launches for kern in kernels.values()}
    finally:
        ev.close()
        cache.clear()
        torch.cuda.empty_cache()
    return out


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
        phase = "resident_kernel"
        fused = phase_resident_kernels(torch, args.seed)
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
        phase = "resident_read"
        res = phase_resident(torch, workdir, vol, deg, args.seed)
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
    resident = []
    for layout, name, line in (
        ("flat", "fused_reconstruct", 1184),
        ("blockdiag", "fused_reconstruct_blockdiag", 1364),
    ):
        rows = fused[layout]
        rep = next(r for r in rows if r["shape"] == RESIDENT_REPORT)
        resident.append({
            "name": name,
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/csrc/fused_reconstruct.cu",
            "replaces": f"seaweedfs_tpu/ops/rs_resident.py:{line}",
            "launches": res[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "mismatched_bytes": sum(r["mismatched_bytes"] for r in rows),
            "shape": f"N={rep['shape'][0]} fetch={rep['fetch']} "
                     f"w_true={rep['shape'][2]}",
            "ms": rep["ms"],
            "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"],
            "library_ms": None,
            "library_note": NO_LIBRARY_CALL,
        })
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
    }, *resident]}), flush=True)
    print(SMI, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
