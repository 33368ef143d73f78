"""Tensor-core rates of the two forms of the GF(2) product, on the card.

    python3 -m seaweedfs_tpu_torch.ops.mma_rate

csrc/gf2_matmul.cu computes out = pack(parity(A . bits(x))) on the tensor
cores.  Two instructions can carry that product on Hopper:

  * "u8":  mma.sync m16n8k32 u8 x u8 -> s32.  K runs over (shard, bit):
    the data operand is x & 2^j, the matrix operand A * 2^(7-j), and bit 7
    of the sum is the parity.  One K step of 32 is 4 shards.
  * "b1":  mma.sync m16n8k128 / k256 b1 AND+POPC -> s32.  The data
    operand is the shard bytes of a column side by side, and bit 0 of the
    count is the parity.  One K step of 128 is 16 shards.

NVIDIA's H100 data sheet gives no binary tensor rate, so this measures
each instruction's issue rate on a full grid (csrc/mma_rate.cu) and
projects the tensor time of the flat RS(10,4) encode at the default 4 MiB
stride: x[10, 4 MiB] -> 4 rows, N = 32 output bits, K = 80 bits rounded
up to the instruction's K.  Prints one JSON object.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json

from . import _build

# (form id, name, K of one instruction)
FORMS = (
    (0, "u8_m16n8k32", 32),
    (1, "b1_m16n8k128", 128),
    (2, "b1_m16n8k256", 256),
)
ENCODE_COLS = 4 << 20
ENCODE_K_BITS = 8 * 10
ENCODE_N = 32


def measure(iters: int = 4096, blocks_per_sm: int = 4) -> dict:
    """Rate of each form: instructions/s, dense ops/s (2*16*8*K per
    instruction) and the projected tensor time of the flat encode."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("mma_rate needs a CUDA device")
    lib = _build.mma_rate()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * blocks_per_sm
    warps = blocks * lib.mma_rate_threads() // 32
    out: dict = {"device": torch.cuda.get_device_name(0), "sms": sms,
                 "blocks": blocks, "iters": iters, "forms": {}}
    for form, name, k in FORMS:
        ms = ctypes.c_float()
        for _ in range(2):  # the first run warms the clocks up
            rc = lib.mma_rate_run(form, iters, blocks, ctypes.byref(ms))
            if rc != 0:
                raise RuntimeError(f"mma_rate form {name} failed ({rc})")
        instr = warps * iters * lib.mma_rate_chains()
        rate = instr / (ms.value * 1e-3)
        # the encode needs, per 16 columns, one instruction per n8 tile per
        # K step
        need = (ENCODE_COLS // 16) * (ENCODE_N // 8) * -(-ENCODE_K_BITS // k)
        out["forms"][name] = {
            "ms": ms.value, "instructions": instr,
            "instr_per_s": rate, "dense_ops_per_s": rate * 2 * 16 * 8 * k,
            "encode_instructions": need,
            "encode_tensor_ms": need / rate * 1e3,
        }
    return out


if __name__ == "__main__":
    print(json.dumps(measure()))
