"""Builds and loads the port's native libraries at first use.

Two shared libraries, each compiled from the sources in this package into
``seaweedfs_tpu_torch/_build/`` (git-ignored) and loaded with ctypes:

  * ``kernels()`` — ``csrc/gf2_matmul.cu``, ``csrc/gf2_matmul_small.cu``
    and ``csrc/fused_reconstruct.cu`` with ``nvcc`` for ``sm_90a`` into one
    library: a plain C interface, so the build takes seconds (no PyTorch
    headers).
  * ``host()`` — ``csrc/host/crc32c.cpp`` and ``gf256.cpp`` with ``g++``:
    CRC32C and the CPU GF(256) codec (the CPU yardstick).

The output name carries a hash of the sources and flags, so an edited
source rebuilds and two processes never load each other's half-written
file (each builds into a temporary name and renames).  A failed build
raises: no caller carries on without the library.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers and shared memory, in the log
]
_GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

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
    proc = subprocess.run(
        [compiler, *flags, "-o", tmp, *sources],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({compiler}):\n{proc.stdout}{proc.stderr}"
        )
    build_logs[name] = proc.stdout + proc.stderr
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
        ctypes.c_void_p,  # a     int8 [8*m_pad, 8*k_pad]
        ctypes.c_int,  # m_pad
        ctypes.c_int,  # k_pad
        ctypes.POINTER(ctypes.c_void_p),  # k survivor device pointers
        ctypes.c_int,  # k
        ctypes.c_void_p,  # meta  int32 [n] on the device
        ctypes.c_int,  # n
        ctypes.c_int,  # fetch
        ctypes.c_void_p,  # out   u8 [n, fetch]
        ctypes.c_int,  # w_true
        ctypes.c_int,  # groups (1: the flat system)
        ctypes.c_int,  # tile
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    lib.fused_reconstruct_error_string.argtypes = [ctypes.c_int]
    lib.fused_reconstruct_error_string.restype = ctypes.c_char_p


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


def kernels() -> ctypes.CDLL:
    """The CUDA kernel library (csrc/gf2_matmul.cu, gf2_matmul_small.cu and
    fused_reconstruct.cu), typed."""
    return _load(
        "swfs_kernels", _nvcc, _NVCC_FLAGS,
        [os.path.join(_CSRC, "gf2_matmul.cu"),
         os.path.join(_CSRC, "gf2_matmul_small.cu"),
         os.path.join(_CSRC, "fused_reconstruct.cu")], _bind_kernels,
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
    """The host C++ library (CRC32C + CPU GF(256) codec), typed."""
    return _load(
        "swfs_host", lambda: "g++", _GXX_FLAGS,
        [os.path.join(_CSRC, "host", "crc32c.cpp"),
         os.path.join(_CSRC, "host", "gf256.cpp")], _bind_host,
    )
