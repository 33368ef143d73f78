"""EC striping layout: volume offsets <-> (shard id, shard file offset).

A volume `.dat` of size S is striped row-major over 10 data shards: rows of
10 x 1GB "large blocks" while more than one full large row remains, then
rows of 10 x 1MB "small blocks" (zero-padded tail).  Shard i < 10 holds
blocks {row*10 + i}; shards 10-13 hold per-row parity.  Mirrors
the reference's weed/storage/erasure_coding/ec_locate.go:15-87 and the
encode loop ec_encoder.go:194-231.
"""
from __future__ import annotations

from dataclasses import dataclass

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS
LARGE_BLOCK_SIZE = 1024 * 1024 * 1024  # 1GB
SMALL_BLOCK_SIZE = 1024 * 1024  # 1MB


def to_ext(shard_id: int) -> str:
    """Shard file extension: .ec00 .. .ec13 (ec_encoder.go ToExt)."""
    return f".ec{shard_id:02d}"


@dataclass(frozen=True)
class Interval:
    """One contiguous run inside a single striped block (ec_locate.go:7-13)."""

    block_index: int
    inner_block_offset: int
    size: int
    is_large_block: bool
    large_block_rows: int

    def to_shard_and_offset(
        self,
        large_block_size: int = LARGE_BLOCK_SIZE,
        small_block_size: int = SMALL_BLOCK_SIZE,
    ) -> tuple[int, int]:
        """-> (shard_id, offset within the .ecNN file) (ec_locate.go:77-87)."""
        off = self.inner_block_offset
        row = self.block_index // DATA_SHARDS
        if self.is_large_block:
            off += row * large_block_size
        else:
            off += self.large_block_rows * large_block_size + row * small_block_size
        return self.block_index % DATA_SHARDS, off


def _locate_offset(
    large_block: int, small_block: int, dat_size: int, offset: int
) -> tuple[int, bool, int]:
    large_row = large_block * DATA_SHARDS
    n_large_rows = dat_size // large_row
    if offset < n_large_rows * large_row:
        return offset // large_block, True, offset % large_block
    offset -= n_large_rows * large_row
    return offset // small_block, False, offset % small_block


def locate_data(
    dat_size: int,
    offset: int,
    size: int,
    large_block: int = LARGE_BLOCK_SIZE,
    small_block: int = SMALL_BLOCK_SIZE,
) -> list[Interval]:
    """Map a (offset, size) run of the original volume to shard intervals
    (ec_locate.go:15-52).  `large_block_rows` is derived from dat_size the
    same way the reference derives it so shard-file offsets agree."""
    block_index, is_large, inner = _locate_offset(
        large_block, small_block, dat_size, offset
    )
    n_large_rows = (dat_size + DATA_SHARDS * small_block) // (
        large_block * DATA_SHARDS
    )
    intervals: list[Interval] = []
    while size > 0:
        block_remaining = (large_block if is_large else small_block) - inner
        take = min(size, block_remaining)
        intervals.append(
            Interval(
                block_index=block_index,
                inner_block_offset=inner,
                size=take,
                is_large_block=is_large,
                large_block_rows=n_large_rows,
            )
        )
        size -= take
        block_index += 1
        if is_large and block_index == n_large_rows * DATA_SHARDS:
            is_large = False
            block_index = 0
        inner = 0
    return intervals


def shard_file_size(dat_size: int, large_block: int = LARGE_BLOCK_SIZE,
                    small_block: int = SMALL_BLOCK_SIZE) -> int:
    """Size every .ecNN file ends up after encode: full large rows while
    more than one large row of data remains, then zero-padded small rows
    (the loop structure of ec_encoder.go:219-230)."""
    remaining = dat_size
    size = 0
    while remaining > large_block * DATA_SHARDS:
        size += large_block
        remaining -= large_block * DATA_SHARDS
    while remaining > 0:
        size += small_block
        remaining -= small_block * DATA_SHARDS
    return size


class ShardBits(int):
    """uint32 bitmask of mounted shard ids, carried in heartbeats
    (ec_volume_info.go:65-117)."""

    def add(self, shard_id: int) -> "ShardBits":
        return ShardBits(self | (1 << shard_id))

    def remove(self, shard_id: int) -> "ShardBits":
        return ShardBits(self & ~(1 << shard_id))

    def has(self, shard_id: int) -> bool:
        return bool(self & (1 << shard_id))

    def shard_ids(self) -> list[int]:
        return [i for i in range(TOTAL_SHARDS) if self.has(i)]

    def count(self) -> int:
        return bin(self).count("1")

    def plus(self, other: int) -> "ShardBits":
        return ShardBits(self | other)

    def minus(self, other: int) -> "ShardBits":
        return ShardBits(self & ~other)

    def minus_parity(self) -> "ShardBits":
        b = self
        for i in range(DATA_SHARDS, TOTAL_SHARDS):
            b = b.remove(i)
        return b
