"""GF(2^8) arithmetic and Reed-Solomon generator matrices.

Implements the same field and matrix construction as the reference's RS
dependency (klauspost/reedsolomon, used via reedsolomon.New(10,4) at
the reference's weed/storage/erasure_coding/ec_encoder.go:198): the field
GF(256) with primitive polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11D) and a
systematic generator matrix derived from a Vandermonde matrix, so shard bytes
produced here are byte-identical to the reference's shard files.

Also provides the *bit-domain* expansion used by the GPU backend: every
multiply-by-constant in GF(256) is a GF(2)-linear map on the 8 bits of the
operand, so an RS code over GF(256) with generator G[m,k] becomes a GF(2)
matrix A[m*8, k*8].  Encoding is then `out_bits = A @ in_bits (mod 2)` —
a plain matmul with parity reduction, which the GPU kernel computes
with bitwise AND/XOR and byte parity.  See ops/rs_cuda.py.
"""
from __future__ import annotations

import functools

import numpy as np

# --- field tables -----------------------------------------------------------

_POLY = 0x11D  # x^8+x^4+x^3+x^2+1, generator element 2


def _build_tables():
    exp = np.zeros(512, dtype=np.uint8)  # doubled to skip mod 255 in lookups
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[0:255]
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP_TABLE[LOG_TABLE[a] + LOG_TABLE[b]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(256) division by zero")
    if a == 0:
        return 0
    return int(EXP_TABLE[LOG_TABLE[a] - LOG_TABLE[b] + 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of zero")
    return int(EXP_TABLE[255 - LOG_TABLE[a]])


def gf_exp(a: int, n: int) -> int:
    """a**n in GF(256) (matches reference dep's galExp)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] * n) % 255])


@functools.lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """Full 256x256 GF multiply table (uint8). ~64KB, built once."""
    a = np.arange(256)
    la = LOG_TABLE[a]
    t = EXP_TABLE[(la[:, None] + la[None, :]) % 255].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    t.setflags(write=False)  # cached singleton: a caller mutation would corrupt all GF math
    return t


# --- matrix algebra over GF(256) -------------------------------------------


def gf_mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(256). a:[m,k] b:[k,n] uint8 -> [m,n] uint8."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    t = mul_table()
    # products[m,k,n] then XOR-reduce over k
    prod = t[a[:, :, None], b[None, :, :]]
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(256) by Gauss-Jordan elimination.

    Raises ValueError if singular (mirrors the reference dep returning
    errSingular from InvertMatrix).
    """
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError("matrix must be square")
    t = mul_table()
    aug = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        # find pivot
        pivot = -1
        for r in range(col, n):
            if aug[r, col] != 0:
                pivot = r
                break
        if pivot < 0:
            raise ValueError("singular matrix over GF(256)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        # scale pivot row to 1
        inv = gf_inv(int(aug[col, col]))
        aug[col] = t[inv, aug[col]]
        # eliminate all other rows
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] = aug[r] ^ t[int(aug[r, col]), aug[col]]
    return aug[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """vm[r,c] = r**c in GF(256) (reference dep's vandermonde())."""
    vm = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            vm[r, c] = gf_exp(r, c)
    return vm


@functools.lru_cache(maxsize=16)
def build_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """Systematic RS generator matrix [total,data], identity on top.

    Same construction as the reference dep's default buildMatrix: a
    Vandermonde matrix right-multiplied by the inverse of its top square, so
    any `data_shards` rows are invertible and the first `data_shards` outputs
    equal the inputs.
    """
    vm = vandermonde(total_shards, data_shards)
    top_inv = gf_mat_inv(vm[:data_shards])
    g = gf_mat_mul(vm, top_inv)
    g.setflags(write=False)
    return g


def parity_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """Bottom (total-data) parity rows of the generator matrix."""
    return build_matrix(data_shards, total_shards)[data_shards:]


def reconstruction_matrix(
    data_shards: int,
    total_shards: int,
    present: list[int],
    wanted: list[int],
) -> tuple[np.ndarray, list[int]]:
    """(R, use) s.t. shards[wanted] = R @ shards[use] over GF(256).

    `present` must contain at least `data_shards` shard indices. `use` is the
    subset of `present` the matrix columns correspond to — callers must stack
    shards in exactly that order (single source of truth; like the reference
    dep's Reconstruct, which picks the first k valid shards). `wanted` may
    name any shard indices (data or parity).
    """
    if len(present) < data_shards:
        raise ValueError(
            f"need {data_shards} shards to reconstruct, have {len(present)}"
        )
    use = sorted(present)[:data_shards]
    g = build_matrix(data_shards, total_shards)
    sub = g[use]  # [k,k]
    sub_inv = gf_mat_inv(sub)  # data = sub_inv @ shards[use]
    out_rows = g[list(wanted)]  # wanted = out_rows @ data
    return gf_mat_mul(out_rows, sub_inv), use  # R: [len(wanted), k]


# --- GF(2) bit-domain expansion (the TPU formulation) -----------------------


@functools.lru_cache(maxsize=1)
def _bit_matrices() -> np.ndarray:
    """bm[c] is the 8x8 GF(2) matrix of multiply-by-c.

    Column j holds the bits of c*(1<<j); bit i of the product is
    XOR_j bm[c,i,j] & in_bit_j.  Shape [256,8,8] uint8 (0/1).
    """
    t = mul_table()
    bm = np.zeros((256, 8, 8), dtype=np.uint8)
    for j in range(8):
        col = t[:, 1 << j]  # c * 2^j for all c
        for i in range(8):
            bm[:, i, j] = (col >> i) & 1
    return bm


def expand_to_gf2(m: np.ndarray) -> np.ndarray:
    """Expand a GF(256) matrix [r,c] to its GF(2) form [r*8, c*8] (0/1 u8).

    out_bits = expand_to_gf2(M) @ in_bits (mod 2)  computes the same linear
    map as  out = M ⊗ in  over GF(256), where a byte x maps to bits
    [x>>0 & 1, ..., x>>7 & 1].
    """
    m = np.asarray(m, dtype=np.uint8)
    r, c = m.shape
    bm = _bit_matrices()[m]  # [r,c,8,8]
    return bm.transpose(0, 2, 1, 3).reshape(r * 8, c * 8).copy()


def bytes_to_bits(x: np.ndarray) -> np.ndarray:
    """[k, B] uint8 -> [k*8, B] uint8 bits, bit i of byte d at row d*8+i."""
    x = np.asarray(x, dtype=np.uint8)
    k, b = x.shape
    bits = (x[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1
    return bits.reshape(k * 8, b)


def bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    """[m*8, B] bits -> [m, B] uint8 bytes (inverse of bytes_to_bits)."""
    mb, b = bits.shape
    assert mb % 8 == 0
    w = (1 << np.arange(8, dtype=np.uint16))[None, :, None]
    return (
        (bits.reshape(mb // 8, 8, b).astype(np.uint16) * w).sum(axis=1)
    ).astype(np.uint8)
