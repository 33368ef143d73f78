"""Builds and loads the port's native libraries at first use.

Two shared libraries, each compiled from the sources in this package into
``seaweedfs_tpu_torch/_build/`` (git-ignored) and loaded with ctypes:

  * ``kernels()`` — ``csrc/gf2_matmul.cu``, ``csrc/gf2_matmul_small.cu``,
    ``csrc/fused_reconstruct.cu`` and ``csrc/scrub.cu`` with ``nvcc`` for
    ``sm_90a`` into one library: a plain C interface, so the build takes
    seconds (no PyTorch headers).
  * ``host()`` — ``csrc/host/crc32c.cpp``, ``gf256.cpp`` and
    ``kvstore.cpp`` with ``g++``: CRC32C, the CPU GF(256) codec (the CPU
    yardstick) and the embedded KV store under ``-index native``.

Each source compiles to an object in its own compiler process, all started
together, and the objects link into the library.  The output name carries
a hash of the sources and flags, so an edited source rebuilds and two
processes never load each other's half-written file (each builds into a
temporary name and renames).  A failed build raises: no caller carries on
without the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers and shared memory, in the log
]
_GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall"]

# one lock per library, so the two builds can run at the same time
_locks = {name: threading.Lock()
          for name in ("swfs_kernels", "swfs_host", "swfs_mma_rate")}
_loaded: dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 = reused)
build_seconds: dict[str, float] = {}
# the compiler's output for each library (nvcc -Xptxas -v: registers,
# shared memory and spills of every kernel), kept beside the library
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _build(name: str, compiler: str, flags: list[str], sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")
    log = so + ".log"
    if os.path.exists(so):
        build_seconds[name] = 0.0
        if os.path.exists(log):
            with open(log) as f:
                build_logs[name] = f.read()
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
    procs = [
        subprocess.Popen([compiler, *flags, "-c", "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for src, obj in zip(sources, objs)
    ]
    try:
        logs = [f"== {os.path.basename(src)}\n{proc.communicate(timeout=600)[0]}"
                for src, proc in zip(sources, procs)]
        failed = any(proc.returncode != 0 for proc in procs)
        if not failed:
            link = subprocess.run([compiler, *flags, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True, timeout=600)
            logs.append(link.stdout + link.stderr)
            failed = link.returncode != 0
    finally:
        for proc in procs:
            proc.kill()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    if failed:
        raise RuntimeError(f"building {name} failed ({compiler}):\n" + "".join(logs))
    build_logs[name] = "".join(logs)
    with open(f"{log}.{os.getpid()}.tmp", "w") as f:
        f.write(build_logs[name])
    os.replace(f"{log}.{os.getpid()}.tmp", log)
    os.replace(tmp, so)
    build_seconds[name] = time.perf_counter() - t0
    return so


def _load(name: str, compiler, flags: list[str], sources: list[str], bind) -> ctypes.CDLL:
    with _locks[name]:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name, compiler(), flags, sources))
            bind(lib)
            _loaded[name] = lib
        return lib


def _bind_kernels(lib: ctypes.CDLL) -> None:
    fn = lib.gf2_matmul_launch
    fn.argtypes = [
        ctypes.c_void_p,  # a_bm  int8 [8*m_pad, 8*k_pad]
        ctypes.c_int,  # m_pad
        ctypes.c_int,  # k_pad
        ctypes.c_void_p,  # x     u8 [k, b] row-major
        ctypes.c_int,  # k
        ctypes.c_long,  # b
        ctypes.c_void_p,  # out   u8 [m_out, b] row-major
        ctypes.c_int,  # m_out
        ctypes.c_void_p,  # cudaStream_t
        ctypes.POINTER(ctypes.c_int),  # out: load path taken (0 or 1)
    ]
    fn.restype = ctypes.c_int
    lib.gf2_matmul_error_string.argtypes = [ctypes.c_int]
    lib.gf2_matmul_error_string.restype = ctypes.c_char_p
    fn = lib.gf2_matmul_small_launch
    fn.argtypes = [
        ctypes.c_void_p,  # a_bm  int8 [8*m_pad, 8*k_pad]
        ctypes.c_int,  # m_pad
        ctypes.c_int,  # k_pad
        ctypes.c_void_p,  # x     u8 [k, b] row-major
        ctypes.c_int,  # k
        ctypes.c_long,  # b
        ctypes.c_void_p,  # out   u8 [m_out, b] row-major
        ctypes.c_int,  # m_out
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    lib.gf2_matmul_small_error_string.argtypes = [ctypes.c_int]
    lib.gf2_matmul_small_error_string.restype = ctypes.c_char_p
    fn = lib.fused_reconstruct_launch
    fn.argtypes = [
        ctypes.c_void_p,  # masks u8 [groups*rows*8, 16] on the host
        ctypes.c_int,  # rows (wanted rows per group)
        ctypes.c_int,  # groups (1: the flat system)
        ctypes.c_int,  # tile (block-diagonal)
        ctypes.POINTER(ctypes.c_void_p),  # k survivor device pointers
        ctypes.c_int,  # k
        ctypes.c_void_p,  # words     int32 [n] meta words, on the host
        ctypes.c_void_p,  # fetch_kib int32 [n] on the host
        ctypes.c_int,  # n
        ctypes.c_void_p,  # out   u8 on the device
        ctypes.c_void_p,  # cudaStream_t
        ctypes.POINTER(ctypes.c_int),  # out: launches made
        ctypes.POINTER(ctypes.c_longlong),  # out: parameter bytes sent
    ]
    fn.restype = ctypes.c_int
    fn = lib.fused_reconstruct_work_list
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_long]
    fn.restype = ctypes.c_long
    lib.fused_reconstruct_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.fused_reconstruct_limits.restype = None
    lib.fused_reconstruct_error_string.argtypes = [ctypes.c_int]
    lib.fused_reconstruct_error_string.restype = ctypes.c_char_p
    # the tensor-core scrub and its earlier CUDA-core form take the same
    # arguments
    for fn in (lib.scrub_launch, lib.scrub_cuda_cores_launch):
        fn.argtypes = [
            ctypes.c_void_p,  # masks u8 [groups*p*8, 16] on the host
            ctypes.c_int,  # k (data shards)
            ctypes.c_int,  # p (parity shards)
            ctypes.c_int,  # groups (1: the flat system)
            ctypes.POINTER(ctypes.c_void_p),  # vols*(k+p) shard device pointers
            ctypes.c_int,  # vols
            ctypes.c_long,  # n_lanes
            ctypes.c_int,  # seg_log2
            ctypes.c_void_p,  # partials int32 [vols, p, n_seg] on the device
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
    lib.scrub_limits.argtypes = [ctypes.POINTER(ctypes.c_long)] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.scrub_limits.restype = None
    fn = lib.scrub_fragments
    fn.argtypes = [
        ctypes.c_void_p,  # masks u8 [groups*p*8, 16] on the host
        ctypes.c_int,  # k
        ctypes.c_int,  # p
        ctypes.c_int,  # groups
        ctypes.c_void_p,  # out uint32 [groups*ceil(p/4)*128] on the host
    ]
    fn.restype = ctypes.c_int
    lib.scrub_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    lib.scrub_blocks_per_sm.restype = ctypes.c_int
    lib.scrub_error_string.argtypes = [ctypes.c_int]
    lib.scrub_error_string.restype = ctypes.c_char_p


# kv_iterate's callback: (key, key length, value, value length, context)
KV_ITER_CB = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
    ctypes.c_void_p,
)


def _bind_host(lib: ctypes.CDLL) -> None:
    lib.swfs_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]
    lib.swfs_crc32c.restype = ctypes.c_uint32
    lib.gf256_apply_matrix.argtypes = [
        ctypes.c_void_p,  # matrix [m,k]
        ctypes.c_int,  # m
        ctypes.c_int,  # k
        ctypes.c_void_p,  # shards [k,B] row-major
        ctypes.c_void_p,  # out [m,B]
        ctypes.c_long,  # B
    ]
    lib.gf256_apply_matrix.restype = None
    # the embedded KV store (csrc/host/kvstore.cpp; storage/kvstore.py)
    lib.kv_open.argtypes = [ctypes.c_char_p]
    lib.kv_open.restype = ctypes.c_void_p
    lib.kv_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                           ctypes.c_char_p, ctypes.c_uint32]
    lib.kv_put.restype = ctypes.c_int
    lib.kv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                           ctypes.c_void_p, ctypes.c_uint64]
    lib.kv_get.restype = ctypes.c_int64
    lib.kv_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_uint32]
    lib.kv_delete.restype = ctypes.c_int
    lib.kv_count.argtypes = [ctypes.c_void_p]
    lib.kv_count.restype = ctypes.c_uint64
    lib.kv_dead_bytes.argtypes = [ctypes.c_void_p]
    lib.kv_dead_bytes.restype = ctypes.c_uint64
    lib.kv_flush.argtypes = [ctypes.c_void_p]
    lib.kv_flush.restype = ctypes.c_int
    lib.kv_iterate.argtypes = [ctypes.c_void_p, KV_ITER_CB, ctypes.c_void_p]
    lib.kv_iterate.restype = ctypes.c_int
    lib.kv_iterate_keys.argtypes = [ctypes.c_void_p, KV_ITER_CB,
                                    ctypes.c_void_p]
    lib.kv_iterate_keys.restype = ctypes.c_int
    lib.kv_compact.argtypes = [ctypes.c_void_p]
    lib.kv_compact.restype = ctypes.c_int64
    lib.kv_close.argtypes = [ctypes.c_void_p]
    lib.kv_close.restype = None


def kernels() -> ctypes.CDLL:
    """The CUDA kernel library (csrc/gf2_matmul.cu, gf2_matmul_small.cu,
    fused_reconstruct.cu and scrub.cu), typed."""
    return _load(
        "swfs_kernels", _nvcc, _NVCC_FLAGS,
        [os.path.join(_CSRC, name) for name in (
            "gf2_matmul.cu", "gf2_matmul_small.cu", "fused_reconstruct.cu",
            "scrub.cu")], _bind_kernels,
    )


def _bind_mma_rate(lib: ctypes.CDLL) -> None:
    lib.mma_rate_run.argtypes = [
        ctypes.c_int,  # form: 0 u8 k32, 1 b1 k128, 2 b1 k256
        ctypes.c_int,  # iters
        ctypes.c_int,  # blocks
        ctypes.POINTER(ctypes.c_float),  # elapsed ms
    ]
    lib.mma_rate_run.restype = ctypes.c_int
    lib.mma_rate_chains.restype = ctypes.c_int
    lib.mma_rate_threads.restype = ctypes.c_int


def mma_rate() -> ctypes.CDLL:
    """The tensor-core rate microbenchmark (csrc/mma_rate.cu), typed."""
    return _load(
        "swfs_mma_rate", _nvcc, _NVCC_FLAGS,
        [os.path.join(_CSRC, "mma_rate.cu")], _bind_mma_rate,
    )


def host() -> ctypes.CDLL:
    """The host C++ library (CRC32C, the CPU GF(256) codec and the
    embedded KV store), typed."""
    return _load(
        "swfs_host", lambda: "g++", _GXX_FLAGS,
        [os.path.join(_CSRC, "host", name)
         for name in ("crc32c.cpp", "gf256.cpp", "kvstore.cpp")], _bind_host,
    )
