"""EC encode / rebuild / verify: volume `.dat` -> 14 shard files, missing-
shard repair, parity scrub over the shard files.

Port of seaweedfs_tpu/storage/ec/encoder.py.  Reference behavior: the
reference's weed/storage/erasure_coding/ec_encoder.go (WriteEcFiles :57,
RebuildEcFiles :61, encodeDatFile :194, rebuildEcFiles :233).  The unit of
work is a [10, stride] uint8 stripe batch handed to the codec leg, and the
three pipelines share the staged executor in bulk.py: a prefetching reader
leg (vectored preadv), the codec worker (pinned H2D / gf2_matmul kernel /
D2H on the card, or a CPU backend), and a dedicated writer leg, so host
read, matrix math and shard write overlap (see the stats contract in
bulk.py).  Every entry point runs on the card unless the caller names
backend "torch" or "numpy"; without a CUDA device "cuda" raises.

File formats are byte-identical to the reference, so `.ec00-.ec13` produced
here can be mounted by a Go volume server and vice versa.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ...ops import gf256
from .. import needle_map
from . import bulk
from .bulk import read_stripe, write_or_seek
from .layout import (
    DATA_SHARDS,
    LARGE_BLOCK_SIZE,
    SMALL_BLOCK_SIZE,
    TOTAL_SHARDS,
    to_ext,
)


def ec_base_name(dirname: str, vid: int, collection: str = "") -> str:
    """<dir>/<collection>_<vid> or <dir>/<vid> (ec_shard.go:63-70)."""
    stem = f"{collection}_{vid}" if collection else str(vid)
    return os.path.join(dirname, stem)


def _iter_rows(dat_size: int, large_block: int, small_block: int):
    """Yield (row_start_offset, block_size) per stripe row — the two-phase
    loop of encodeDatFile (ec_encoder.go:214-230)."""
    remaining = dat_size
    processed = 0
    while remaining > large_block * DATA_SHARDS:
        yield processed, large_block
        processed += large_block * DATA_SHARDS
        remaining -= large_block * DATA_SHARDS
    while remaining > 0:
        yield processed, small_block
        processed += small_block * DATA_SHARDS
        remaining -= small_block * DATA_SHARDS


def _save_vif_from_superblock(src_path: str, base_name: str) -> None:
    """Persist the volume version alongside the shards when no .vif exists
    yet, reading the superblock from `src_path` (the .dat on encode, the
    .ec00 — whose first bytes are the .dat's first bytes — on rebuild), as
    the reference's VolumeEcShardsGenerate does
    (volume_grpc_erasure_coding.go:74)."""
    from ..super_block import SUPER_BLOCK_SIZE, SuperBlock
    from ..volume_info import load_volume_info, save_volume_info

    if load_volume_info(base_name + ".vif"):
        return
    try:
        with open(src_path, "rb") as f:
            sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
        save_volume_info(base_name + ".vif", {"version": sb.version})
    except (ValueError, OSError):
        pass  # raw/synthetic volume without a superblock: no .vif


def _resolve_stride(stride: int | None) -> int:
    return stride or bulk.DEFAULT.stride or bulk.DEFAULT_STRIDE


def _finish_outputs(outputs, fsync: bool, t: dict) -> None:
    """Materialize trailing holes left by write_or_seek (the shard file's
    SIZE must match the layout math even when its tail is all zeros) and
    optionally fsync.  The final fsync follows the LAST write by
    definition, so it can never overlap the device leg — it is durability
    tail latency, not hideable host work, hence its separate clock."""
    for o in outputs:
        o.truncate(o.tell())
    if fsync:
        t0 = time.perf_counter()
        for o in outputs:
            o.flush()
            os.fsync(o.fileno())
        t["fsync_s"] += time.perf_counter() - t0


def write_ec_files(
    base_name: str,
    backend: str = "cuda",
    stride: int | None = None,
    large_block: int = LARGE_BLOCK_SIZE,
    small_block: int = SMALL_BLOCK_SIZE,
    fsync: bool = False,
    stats: dict | None = None,
    overlap: bool | None = None,
    prefetch: int | None = None,
) -> int:
    """Generate <base>.ec00 .. <base>.ec13 from <base>.dat; returns bytes
    encoded.  Equivalent of WriteEcFiles (ec_encoder.go:57).

    `fsync=True` makes the shard files durable before returning (the
    benchmark's honest-throughput mode).  `stats`, when passed, is filled
    with the pipeline's wall-clock decomposition (bulk.py stats contract):
    overlap happened iff read_s + write_s + device_busy_s > wall_s.
    `overlap`/`prefetch`/`stride` default to the -ec.bulk.* config
    (bulk.DEFAULT)."""
    dat_path = base_name + ".dat"
    dat_size = os.path.getsize(dat_path)
    stride = _resolve_stride(stride)
    use_overlap = bulk.DEFAULT.overlap if overlap is None else bool(overlap)
    codec = bulk.Codec(
        gf256.parity_matrix(DATA_SHARDS, TOTAL_SHARDS), backend,
        threaded=use_overlap, workload="bulk",
    )
    _save_vif_from_superblock(dat_path, base_name)

    plan = []
    for row_start, block_size in _iter_rows(dat_size, large_block, small_block):
        step = min(stride, block_size)
        if block_size % step:
            step = block_size  # keep batches aligned to the block
        for off in range(0, block_size, step):
            plan.append((row_start, block_size, off, step))

    outputs = [open(base_name + to_ext(i), "wb") for i in range(TOTAL_SHARDS)]
    t_start = time.perf_counter()
    try:
        with open(dat_path, "rb") as f:

            def read_batch(desc):
                row_start, block_size, off, step = desc
                return read_stripe(f, dat_size, row_start, block_size, off, step)

            def write_batch(desc, data, parity):
                for i in range(DATA_SHARDS):
                    write_or_seek(outputs[i], data[i])
                for i in range(codec.rows):
                    write_or_seek(outputs[DATA_SHARDS + i], parity[i])

            t = bulk.run(
                "encode", plan, read_batch, codec, write_batch,
                overlap=use_overlap, prefetch=prefetch,
            )
        _finish_outputs(outputs, fsync, t)
    finally:
        codec.shutdown()
        for o in outputs:
            o.close()
    t["wall_s"] = time.perf_counter() - t_start
    bulk.publish("encode", t)
    if stats is not None:
        stats.update(t)
    return dat_size


def rebuild_ec_files(
    base_name: str,
    backend: str = "cuda",
    stride: int | None = None,
    fsync: bool = False,
    stats: dict | None = None,
    overlap: bool | None = None,
    prefetch: int | None = None,
) -> list[int]:
    """Regenerate missing .ecNN files from the >=10 present ones; returns the
    list of generated shard ids.  Equivalent of RebuildEcFiles
    (ec_encoder.go:61, rebuildEcFiles :233-287) except the per-stride
    Reconstruct is one precomputed reconstruction matrix applied as a single
    batched multiply, staged through the same overlapped executor as encode.

    Output goes through write_or_seek + a final truncate, so a rebuilt
    shard of a sparse volume is sparse too (byte-identical on read); the
    .vif sidecar is preserved/recreated from the .ec00 superblock like the
    encode path; `fsync=True` makes the rebuilt shards durable before
    returning (the ec.rebuild -fsync flag)."""
    present = [i for i in range(TOTAL_SHARDS) if os.path.exists(base_name + to_ext(i))]
    missing = [i for i in range(TOTAL_SHARDS) if i not in present]
    if not missing:
        return []
    if len(present) < DATA_SHARDS:
        raise ValueError(
            f"cannot rebuild: only {len(present)} of {TOTAL_SHARDS} shards present"
        )

    rmat, use = gf256.reconstruction_matrix(
        DATA_SHARDS, TOTAL_SHARDS, present, missing
    )
    stride = _resolve_stride(stride)
    use_overlap = bulk.DEFAULT.overlap if overlap is None else bool(overlap)
    codec = bulk.Codec(rmat, backend, threaded=use_overlap, workload="repair")

    shard_size = os.path.getsize(base_name + to_ext(present[0]))
    inputs = {i: open(base_name + to_ext(i), "rb") for i in use}
    outputs = {i: open(base_name + to_ext(i), "wb") for i in missing}
    plan = [
        (off, min(stride, shard_size - off))
        for off in range(0, shard_size, stride)
    ]
    t_start = time.perf_counter()
    try:

        def read_batch(desc):
            off, n = desc
            return bulk.read_shard_rows(inputs, use, n, off)

        def write_batch(desc, payload, out):
            for j, shard_id in enumerate(missing):
                write_or_seek(outputs[shard_id], out[j])

        t = bulk.run(
            "rebuild", plan, read_batch, codec, write_batch,
            overlap=use_overlap, prefetch=prefetch,
        )
        _finish_outputs(list(outputs.values()), fsync, t)
    finally:
        codec.shutdown()
        for h in list(inputs.values()) + list(outputs.values()):
            h.close()
    # shard 0 exists now (present or just rebuilt): its head is the .dat's
    # head, so a missing .vif can be restored exactly like encode does
    _save_vif_from_superblock(base_name + to_ext(0), base_name)
    t["wall_s"] = time.perf_counter() - t_start
    bulk.publish("rebuild", t)
    if stats is not None:
        stats.update(t)
    return missing


def verify_ec_files(
    base_name: str,
    backend: str = "cuda",
    stride: int | None = None,
    stats: dict | None = None,
    overlap: bool | None = None,
    prefetch: int | None = None,
) -> tuple[list[int], int]:
    """Parity scrub over the shard FILES: recompute parity from the data
    shards chunk by chunk and count mismatching bytes per parity shard.
    -> ([mismatches per parity shard], bytes verified per shard)
    (reference analogue: the read-verify passes of volume.fsck /
    ec.rebuild).  Staged like encode/rebuild: the "write" leg here is the
    parity comparison."""
    paths = [base_name + to_ext(i) for i in range(TOTAL_SHARDS)]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"scrub needs all shards: missing {missing}")
    shard_size = os.path.getsize(paths[0])
    stride = _resolve_stride(stride)
    use_overlap = bulk.DEFAULT.overlap if overlap is None else bool(overlap)
    codec = bulk.Codec(
        gf256.parity_matrix(DATA_SHARDS, TOTAL_SHARDS), backend,
        threaded=use_overlap, workload="scrub",
    )
    mism = np.zeros(TOTAL_SHARDS - DATA_SHARDS, dtype=np.int64)
    handles = [open(p, "rb") for p in paths]
    plan = [
        (off, min(stride, shard_size - off))
        for off in range(0, shard_size, stride)
    ]
    t_start = time.perf_counter()
    try:

        def read_batch(desc):
            off, n = desc
            return bulk.read_shard_rows(handles, range(TOTAL_SHARDS), n, off)

        def write_batch(desc, payload, parity):
            np.add(
                mism,
                (parity != payload[DATA_SHARDS:]).sum(axis=1),
                out=mism,
            )

        t = bulk.run(
            "verify", plan, read_batch, codec, write_batch,
            overlap=use_overlap, prefetch=prefetch,
            to_codec=lambda payload: payload[:DATA_SHARDS],
        )
    finally:
        codec.shutdown()
        for h in handles:
            h.close()
    t["wall_s"] = time.perf_counter() - t_start
    bulk.publish("verify", t)
    if stats is not None:
        stats.update(t)
    return [int(v) for v in mism], shard_size


def write_sorted_file_from_idx(base_name: str, ext: str = ".ecx") -> None:
    """<base>.idx -> <base><ext>, entries sorted ascending by needle id,
    deletions dropped (WriteSortedFileFromIdx ec_encoder.go:27-54)."""
    needle_map.write_sorted_file_from_idx(base_name + ".idx", base_name + ext)
