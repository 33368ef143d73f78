"""CPU Reed-Solomon backends: the numpy table oracle and the native codec.

Both implement one primitive,

    apply_matrix(M [m,k] GF(256), shards [k,B] u8) -> [m,B] u8,

from which encode and reconstruct are built in ops/rs.py.  The numpy
version is the parity oracle of the tests; the native one
(csrc/host/gf256.cpp, AVX2/GFNI) is the CPU yardstick the GPU kernel is
measured against (BASELINE.md).
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import _build, gf256


def apply_matrix_numpy(m: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """XOR-accumulate of full-multiply-table gathers. Pure numpy."""
    m = np.asarray(m, dtype=np.uint8)
    shards = np.asarray(shards, dtype=np.uint8)
    t = gf256.mul_table()
    out = np.empty((m.shape[0], shards.shape[1]), dtype=np.uint8)
    for i in range(m.shape[0]):
        acc = t[m[i, 0]][shards[0]]
        for j in range(1, m.shape[1]):
            c = m[i, j]
            if c == 0:
                continue
            acc = acc ^ t[c][shards[j]]
        out[i] = acc
    return out


def apply_matrix_native(m: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """The C++ codec (built at first use; raises if the build fails)."""
    lib = _build.host()
    m = np.ascontiguousarray(m, dtype=np.uint8)
    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    rows, k = m.shape
    if shards.shape[0] != k:
        raise ValueError(f"matrix takes {k} shards, got {shards.shape[0]}")
    b = shards.shape[1]
    out = np.empty((rows, b), dtype=np.uint8)
    lib.gf256_apply_matrix(
        m.ctypes.data_as(ctypes.c_void_p),
        rows,
        k,
        shards.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        b,
    )
    return out
