"""Reed-Solomon codec front-end over the port's backends.

The reference calls reedsolomon.New(10,4) / Encode / Reconstruct /
ReconstructData (weed/storage/erasure_coding/ec_encoder.go:198,
weed/storage/store_ec.go:342-384).  Every operation is one linear
primitive, apply_matrix over GF(256).

Backends:
  "cuda"   — the hand-written kernels (ops/rs_cuda.gf2_matmul, and
             gf2_matmul_small for small one-row calls); the default.
             Raises when no CUDA device is present: nothing drops to the CPU
             on its own.
  "torch"  — the kernel's plain PyTorch version, on the CPU
  "numpy"  — numpy table gathers (the oracle)
"""
from __future__ import annotations

import numpy as np
import torch

from . import gf256, rs_cpu, rs_cuda

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = 14

BACKENDS = ("cuda", "torch", "numpy")


def resolve_backend(name: str) -> str:
    """Validate a backend name; "cuda" without a CUDA device raises."""
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r} (choose from {BACKENDS})")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "backend 'cuda' needs a CUDA device and none is available; "
            "name backend='torch' or 'numpy' to run on the CPU"
        )
    return name


class RSCodec:
    """RS(k, p) systematic erasure codec over GF(256).

    Shards are uint8 arrays of equal length B, stacked [k or total, B].
    Shard indices 0..k-1 are data, k..k+p-1 parity, matching the reference's
    .ec00-.ec13 file naming (ec_encoder.go:17-23).
    """

    def __init__(
        self,
        data_shards: int = DATA_SHARDS,
        parity_shards: int = PARITY_SHARDS,
        backend: str = "cuda",
    ):
        self.k = data_shards
        self.p = parity_shards
        self.n = data_shards + parity_shards
        self.backend = resolve_backend(backend)
        self.matrix = gf256.build_matrix(self.k, self.n)

    # -- primitive ----------------------------------------------------------

    def apply_matrix(self, m: np.ndarray, shards: np.ndarray) -> np.ndarray:
        """out[i] = XOR_j m[i,j] (x) shards[j] over GF(256)."""
        if self.backend == "numpy":
            return rs_cpu.apply_matrix_numpy(m, shards)
        device = "cuda" if self.backend == "cuda" else "cpu"
        return rs_cuda.apply_matrix(m, shards, device=device)

    # -- RS surface ---------------------------------------------------------

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data [k,B] -> parity [p,B]."""
        data = np.asarray(data, dtype=np.uint8)
        if data.shape[0] != self.k:
            raise ValueError(f"expected {self.k} data shards, got {data.shape[0]}")
        return self.apply_matrix(self.matrix[self.k :], data)

    def encode_all(self, data: np.ndarray) -> np.ndarray:
        """data [k,B] -> all shards [n,B] (data rows are copies)."""
        parity = self.encode(data)
        return np.concatenate([np.asarray(data, dtype=np.uint8), parity], axis=0)

    def reconstruct(
        self, shards: dict[int, np.ndarray], wanted: list[int] | None = None
    ) -> dict[int, np.ndarray]:
        """Recompute missing shards from any >=k present ones.

        `shards` maps shard index -> [B] u8 array.  Returns
        {wanted_index: array}; `wanted=None` means all missing indices
        (reference Reconstruct); pass only missing *data* indices for the
        ReconstructData fast path used by degraded reads (store_ec.go:384).
        """
        present = sorted(shards.keys())
        if wanted is None:
            wanted = [i for i in range(self.n) if i not in shards]
        if not wanted:
            return {}
        r, use = gf256.reconstruction_matrix(self.k, self.n, present, wanted)
        stack = np.stack([np.asarray(shards[i], dtype=np.uint8) for i in use])
        out = self.apply_matrix(r, stack)
        return {w: out[i] for i, w in enumerate(wanted)}

    def verify(self, shards: np.ndarray) -> bool:
        """shards [n,B]: recompute parity from data rows and compare."""
        shards = np.asarray(shards, dtype=np.uint8)
        parity = self.encode(shards[: self.k])
        return bool(np.array_equal(parity, shards[self.k :]))
