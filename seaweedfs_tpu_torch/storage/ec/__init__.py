"""Erasure coding: RS(10,4) striping of volumes into 14 shard files.

Reference: weed/storage/erasure_coding/.  File formats are preserved
byte-for-byte (.ec00-.ec13, .ecx, .ecj), and byte-identical to the JAX
package's output; the GF(256) math runs on the card (ops/rs_cuda.py).
"""
from .layout import (
    DATA_SHARDS,
    LARGE_BLOCK_SIZE,
    PARITY_SHARDS,
    SMALL_BLOCK_SIZE,
    TOTAL_SHARDS,
    Interval,
    ShardBits,
    locate_data,
    to_ext,
)
from .encoder import (
    ec_base_name,
    rebuild_ec_files,
    verify_ec_files,
    write_ec_files,
    write_sorted_file_from_idx,
)
from .decoder import find_dat_file_size, write_dat_file
from .volume import EcVolume, EcVolumeShard, NeedleNotFound, rebuild_ecx_file

__all__ = [
    "DATA_SHARDS",
    "PARITY_SHARDS",
    "TOTAL_SHARDS",
    "LARGE_BLOCK_SIZE",
    "SMALL_BLOCK_SIZE",
    "Interval",
    "ShardBits",
    "locate_data",
    "to_ext",
    "ec_base_name",
    "write_ec_files",
    "rebuild_ec_files",
    "verify_ec_files",
    "write_sorted_file_from_idx",
    "write_dat_file",
    "find_dat_file_size",
    "EcVolume",
    "EcVolumeShard",
    "NeedleNotFound",
    "rebuild_ecx_file",
]
