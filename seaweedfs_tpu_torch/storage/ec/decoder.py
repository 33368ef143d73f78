"""EC decode: shard files -> back to a plain `.dat` + `.idx` volume.

Port of seaweedfs_tpu/storage/ec/decoder.py.  Reference: the reference's
weed/storage/erasure_coding/ec_decoder.go (WriteDatFile :154-201,
WriteIdxFileFromEcIndex :18-43, FindDatFileSize :48-70).  Used by `ec.decode` to turn a cold EC volume
back into a normal one.  Only data shards are read; missing data shards
must be rebuilt first (rebuild_ec_files) — same contract as the
reference.
"""
from __future__ import annotations

from .. import idx as idx_mod
from .. import needle as needle_mod
from .. import types as t
from ..super_block import SUPER_BLOCK_SIZE, SuperBlock
from .layout import DATA_SHARDS, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, to_ext


def read_ec_volume_version(base_name: str) -> int:
    """Volume version from the superblock at the head of .ec00 (block 0 of
    the stripe is the head of the original .dat) — ec_decoder.go:120-138."""
    with open(base_name + to_ext(0), "rb") as f:
        sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
    return sb.version


def find_dat_file_size(base_name: str) -> int:
    """Max (offset + actual needle size) over live .ecx entries
    (ec_decoder.go:48-70): the original .dat size up to trailing deletes."""
    version = read_ec_volume_version(base_name)
    dat_size = SUPER_BLOCK_SIZE
    with open(base_name + ".ecx", "rb") as f:
        ids, offs, sizes = idx_mod.parse_buffer(f.read())
    for i in range(len(ids)):
        size = int(sizes[i])
        if not t.size_is_valid(size):
            continue
        stop = int(offs[i]) + needle_mod.actual_size(size, version)
        dat_size = max(dat_size, stop)
    return dat_size


def write_dat_file(
    base_name: str,
    dat_size: int | None = None,
    large_block: int = LARGE_BLOCK_SIZE,
    small_block: int = SMALL_BLOCK_SIZE,
    chunk: int = 4 * 1024 * 1024,
) -> int:
    """Concatenate the 10 data shards back into <base>.dat: large rows while
    more than one full large row remains, then small rows, truncated to
    dat_size (WriteDatFile ec_decoder.go:154-201)."""
    if dat_size is None:
        dat_size = find_dat_file_size(base_name)
    inputs = [open(base_name + to_ext(i), "rb") for i in range(DATA_SHARDS)]
    try:
        with open(base_name + ".dat", "wb") as out:
            remaining = dat_size
            # mirror the encoder's two-phase row loop
            while remaining > large_block * DATA_SHARDS:
                for i in range(DATA_SHARDS):
                    _copy_n(inputs[i], out, large_block, chunk)
                remaining -= large_block * DATA_SHARDS
            while remaining > 0:
                for i in range(DATA_SHARDS):
                    n = min(small_block, remaining)
                    _copy_n(inputs[i], out, small_block, chunk, keep=n)
                    remaining -= n
                    if remaining == 0:
                        break
    finally:
        for f in inputs:
            f.close()
    return dat_size


def _copy_n(src, dst, n: int, chunk: int, keep: int | None = None) -> None:
    """Copy n bytes from src's cursor; write only the first `keep` of them
    (the zero-pad tail of the last small row is dropped)."""
    keep = n if keep is None else keep
    done = 0
    while done < n:
        buf = src.read(min(chunk, n - done))
        if not buf:
            buf = b"\0" * min(chunk, n - done)
        if done < keep:
            dst.write(buf[: max(0, keep - done)])
        done += len(buf)


def write_idx_file_from_ec_index(base_name: str) -> None:
    """<base>.ecx + <base>.ecj -> <base>.idx: copy the sorted entries, then
    append a tombstone entry per journaled deletion
    (WriteIdxFileFromEcIndex ec_decoder.go:18-43)."""
    from .volume import iter_ecj

    with open(base_name + ".ecx", "rb") as f:
        ecx = f.read()
    with open(base_name + ".idx", "wb") as out:
        out.write(ecx)
        for nid in iter_ecj(base_name + ".ecj"):
            out.write(idx_mod.pack_entry(nid, 0, t.TOMBSTONE_FILE_SIZE))
