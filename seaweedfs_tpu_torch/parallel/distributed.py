"""Mesh-parallel GF(256) linear algebra: encode/rebuild over many cards.

Port of seaweedfs_tpu/parallel/distributed.py.  Two parallel axes:

  "shard" — the RS shard dimension.  The bitsliced apply
            out = pack((A @ bits(x)) & 1) splits over column groups: the
            lane holding shard rows [s*k_loc, (s+1)*k_loc) runs K1
            (csrc/gf2_matmul.cu) over column block s of A and its rows,
            and the lanes' packed partials XOR together into the output.
  "batch" — the byte dimension, data-parallel (no collective).

What differs from the JAX package: the reference sums int8 parity planes
with one psum over the shard axis.  NCCL and gloo have no XOR reduction,
so each lane runs K1 unchanged (packed output), the partials are
gathered, and the XOR fold replaces the reduction: n_shard bytes cross
the wire per output byte (the reference's planes are 8 bytes per output
byte).  Without a process group the lanes are driven directly and the
fold copies the partials to the first lane's device; in a
torch.distributed group the partials travel by one all_gather of the
lanes' tensors (CUDA tensors under NCCL, and under gloo too, which
carries them through host memory; CPU tensors on gloo's CPU ranks).
A failed launch or collective raises; nothing falls back.
"""
from __future__ import annotations

import contextlib
import functools
import time

import numpy as np
import torch

from ..ops import gf256, rs_cuda
from . import mesh as mesh_mod
from .mesh import make_mesh  # noqa: F401  (re-export, as the reference)


def split_matrix_bitmajor(m_gf: np.ndarray, n_groups: int) -> np.ndarray:
    """GF(256) matrix [m, k] -> per-group bit-major GF(2) blocks
    [n_groups, 8m, 8*(k/n_groups)] int8, group g covering input shards
    [g*k/n, (g+1)*k/n).  Each block is bit-major over its LOCAL k."""
    m_gf = np.asarray(m_gf, dtype=np.uint8)
    m, k = m_gf.shape
    if k % n_groups:
        raise ValueError(f"k={k} not divisible by {n_groups} shard groups")
    k_loc = k // n_groups
    a_std = gf256.expand_to_gf2(m_gf)  # [8m, 8k], row p*8+i, col d*8+j
    a = a_std.reshape(m, 8, k, 8)  # [p, i, d, j]
    a_bm_rows = a.transpose(1, 0, 3, 2).reshape(8 * m, 8, k)  # [row, j, d]
    groups = []
    for g in range(n_groups):
        blk = a_bm_rows[:, :, g * k_loc : (g + 1) * k_loc]  # [8m, 8, k_loc]
        groups.append(blk.reshape(8 * m, 8 * k_loc))
    return np.stack(groups).astype(np.int8)


@functools.lru_cache(maxsize=64)
def _lane_matrix(group_bytes: bytes, m: int, k_loc: int,
                 device: str) -> torch.Tensor:
    """One group's bit-major block in K1's prepared layout [8*m_pad,
    8*k_pad] (rows padded to 4, columns to rs_cuda.K_ALIGN, both with
    zero bits), on `device`."""
    m_pad = m + (-m) % 4
    k_pad = k_loc + (-k_loc) % rs_cuda.K_ALIGN
    blk = np.frombuffer(group_bytes, dtype=np.int8).reshape(8, m, 8, k_loc)
    out = np.zeros((8, m_pad, 8, k_pad), dtype=np.int8)
    out[:, :m, :, :k_loc] = blk
    return torch.from_numpy(out.reshape(8 * m_pad, 8 * k_pad)).to(device)


def _sync(devices) -> None:
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def _distributed_apply(mesh, a_groups: np.ndarray, x_lanes: dict,
                       m_rows: int, timing: dict | None = None):
    """a_groups [S, 8m, 8k_loc] (split_matrix_bitmajor); x_lanes {lane:
    u8 [k_loc, B_loc] on the lane's device} for this process's lanes of
    the (shard, batch) mesh -> u8 [m_rows, B] on the first local lane's
    device, every batch column.  Each local lane runs one
    K1 launch; `timing` (when given) gets the K1 and collective seconds."""
    n_shard = mesh.shape[mesh_mod.SHARD_AXIS]
    n_batch = mesh.shape.get(mesh_mod.BATCH_AXIS, 1)
    k_loc = a_groups.shape[2] // 8
    t0 = time.perf_counter()
    parts = {}
    for lane, x in x_lanes.items():
        s = lane // n_batch
        dev = mesh.devices[lane]
        a = _lane_matrix(a_groups[s].tobytes(), m_rows, k_loc, str(dev))
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            parts[lane] = rs_cuda.apply_matrix_device(a, x, k_true=k_loc)
    _sync(mesh.devices[i] for i in x_lanes)
    t1 = time.perf_counter()
    home = mesh.devices[min(x_lanes)]
    if mesh_mod._dist() is not None:  # a process group: the partials meet
        parts = _gather_partials(mesh, parts)
    t2 = time.perf_counter()
    cols = []
    for b in range(n_batch):
        acc = parts[mesh.lane(0, b)].to(home, copy=True)
        for s in range(1, n_shard):
            acc ^= parts[mesh.lane(s, b)].to(home)
        cols.append(acc)
    out = torch.cat(cols, dim=1) if n_batch > 1 else cols[0]
    _sync([home])
    if timing is not None:
        timing.update(k1_s=t1 - t0, collective_s=t2 - t1,
                      fold_s=time.perf_counter() - t2)
    return out


def _gather_partials(mesh, parts: dict) -> dict:
    """All-gather every process's packed partials -> {lane: partial} for
    the whole mesh.  Every process must own the same number of lanes."""
    dist = torch.distributed
    world = dist.get_world_size()
    mine = sorted(parts)
    counts = [len(mesh.local_lanes(r)) for r in range(world)]
    if len(set(counts)) != 1:
        raise ValueError(f"processes own unequal lane counts {counts}")
    buf = torch.stack([parts[lane] for lane in mine])
    got = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(got, buf)
    out = {}
    for rank, t in enumerate(got):
        for lane, part in zip(mesh.local_lanes(rank), t):
            out[lane] = part
    return out


def _check_batch(mesh, b: int) -> int:
    n_batch = mesh.shape.get(mesh_mod.BATCH_AXIS, 1)
    if b % n_batch:
        raise ValueError(
            f"batch of {b} bytes not divisible by {n_batch} batch lanes")
    return b // n_batch


def _pad_rows(m_gf: np.ndarray, pad_rows_to: int) -> np.ndarray:
    rows, k = m_gf.shape
    pad = (-rows) % pad_rows_to
    if pad:
        m_gf = np.concatenate([m_gf, np.zeros((pad, k), dtype=np.uint8)])
    return m_gf


def distributed_apply_matrix(mesh, m_gf: np.ndarray, shards,
                             pad_rows_to: int = 4,
                             timing: dict | None = None) -> torch.Tensor:
    """out[i] = XOR_j m_gf[i,j] (x) shards[j], computed over the mesh.

    `shards` is [k, B] uint8 (numpy or a tensor), the whole input on every
    process; k must divide over the mesh's shard axis and B over its
    batch axis.  Each of this process's lanes takes its block to its own
    device.  -> u8 [rows, B] on the first local lane's device."""
    m_gf = np.asarray(m_gf, dtype=np.uint8)
    rows = m_gf.shape[0]
    m_gf = _pad_rows(m_gf, pad_rows_to)
    n_shard = mesh.shape[mesh_mod.SHARD_AXIS]
    n_batch = mesh.shape.get(mesh_mod.BATCH_AXIS, 1)
    a_groups = split_matrix_bitmajor(m_gf, n_shard)
    x = shards if isinstance(shards, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(shards, dtype=np.uint8))
    k_loc = x.shape[0] // n_shard
    b_loc = _check_batch(mesh, x.shape[1])
    x_lanes = {}
    for lane in mesh.local_lanes():
        s, b = divmod(lane, n_batch)
        x_lanes[lane] = x[s * k_loc : (s + 1) * k_loc,
                          b * b_loc : (b + 1) * b_loc].to(
            mesh.devices[lane]).contiguous()
    out = _distributed_apply(mesh, a_groups, x_lanes, m_gf.shape[0], timing)
    return out[:rows]


def shard_parallel_apply(mesh, m_gf: np.ndarray, shards) -> np.ndarray:
    """Host-convenience wrapper returning numpy."""
    return distributed_apply_matrix(mesh, m_gf, shards).cpu().numpy()


def distributed_encode_blockdiag(mesh, parity_m: np.ndarray, shards,
                                 groups: int = 4,
                                 timing: dict | None = None) -> np.ndarray:
    """Block-diagonal bulk encode over the mesh: the g-group block-diagonal
    system of the one-card path, run through the generic sharded apply
    (any column partition of a GF matrix is valid for the shard axis; the
    host stages the segment-stacked layout)."""
    parity_m = np.asarray(parity_m, dtype=np.uint8)
    rows = parity_m.shape[0]
    shards = np.asarray(shards, dtype=np.uint8)
    blk = rs_cuda.blockdiag_system(parity_m, groups)
    stacked = rs_cuda.stack_segments(shards, groups)  # [g*k, B/g]
    out = distributed_apply_matrix(mesh, blk, stacked, timing=timing)
    return rs_cuda.unstack_segments(out.cpu().numpy(), rows, groups)


def distributed_degraded_read(
    mesh,
    survivors: np.ndarray,  # [k, L] survivor shard bytes (k = data_shards)
    survivor_ids: list[int],
    wanted: int,  # shard id to reconstruct
    requests: list[tuple[int, int]],  # (offset, size) within the shard
    data_shards: int = 10,
    total_shards: int = 14,
) -> list[bytes]:
    """Batched degraded read over the mesh: every requested interval's
    survivor slices batch along the byte axis into one sharded apply."""
    rmat, use = gf256.reconstruction_matrix(
        data_shards, total_shards, survivor_ids, [wanted]
    )
    order = [survivor_ids.index(s) for s in use]
    n_batch = mesh.shape.get(mesh_mod.BATCH_AXIS, 1)
    tile = 128 * n_batch
    # each request contributes only its own tile-rounded span
    spans = []
    col = 0
    for off, size in requests:
        lo = off - off % 128
        span = -(-(off + size - lo) // tile) * tile
        spans.append((lo, span, col))
        col += span
    x = np.zeros((len(use), col), dtype=np.uint8)
    for lo, span, c in spans:
        seg = survivors[order, lo : lo + span]
        x[:, c : c + seg.shape[1]] = seg
    out = distributed_apply_matrix(mesh, rmat, x).cpu().numpy()
    return [
        out[0, c + (off - lo) : c + (off - lo) + size].tobytes()
        for (off, size), (lo, _, c) in zip(requests, spans)
    ]


# ---- multi-process host staging --------------------------------------------


def staged_apply_matrix(mesh, m_gf: np.ndarray, local_x: np.ndarray,
                        global_b: int, pad_rows_to: int = 4,
                        timing: dict | None = None) -> np.ndarray:
    """Multi-process distributed_apply_matrix: each process contributes
    only the input its own lanes hold (rows of its shard positions,
    columns of its batch positions, as one [k_local, b_local] block), and
    the partials meet in the all_gather.  -> the [m, global_b] output,
    which every process assembles whole."""
    m_gf = np.asarray(m_gf, dtype=np.uint8)
    rows, k = m_gf.shape
    m_gf = _pad_rows(m_gf, pad_rows_to)
    n_shard = mesh.shape[mesh_mod.SHARD_AXIS]
    n_batch = mesh.shape.get(mesh_mod.BATCH_AXIS, 1)
    a_groups = split_matrix_bitmajor(m_gf, n_shard)
    k_loc = k // n_shard
    b_loc = _check_batch(mesh, global_b)
    lanes = mesh.local_lanes()
    s0 = min(lane // n_batch for lane in lanes)
    b0 = min(lane % n_batch for lane in lanes)
    x = torch.from_numpy(np.ascontiguousarray(local_x, dtype=np.uint8))
    x_lanes = {}
    for lane in lanes:
        s, b = divmod(lane, n_batch)
        x_lanes[lane] = x[(s - s0) * k_loc : (s - s0 + 1) * k_loc,
                          (b - b0) * b_loc : (b - b0 + 1) * b_loc].to(
            mesh.devices[lane]).contiguous()
    out = _distributed_apply(mesh, a_groups, x_lanes, m_gf.shape[0], timing)
    return out[:rows].cpu().numpy()


def _local_shard_rows(mesh) -> slice:
    """The shard-axis positions this process's lanes hold."""
    n_batch = mesh.shape.get(mesh_mod.BATCH_AXIS, 1)
    rows = sorted({lane // n_batch for lane in mesh.local_lanes()})
    return slice(rows[0], rows[-1] + 1)


def _staged_worker_main(argv) -> None:
    """One process of the host-staging check: join the group, stage this
    process's rows of a seeded [10, 1 MiB] input, run the sharded encode
    and hold the result against the numpy oracle.  Run as `python -m
    seaweedfs_tpu_torch.parallel.distributed --staged-worker
    --coordinator H:P --nproc N --pid I [--device cpu|cuda]`."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--pid", type=int, required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    mesh_mod.initialize_distributed(
        args.coordinator, args.pid, args.nproc,
        backend="nccl" if args.device == "cuda" else "gloo")
    try:
        mesh = make_mesh(args.nproc, devices=mesh_mod.global_devices(
            args.device))
        from ..ops import rs_cpu

        rng = np.random.default_rng(42)
        k, b = 10, 1 << 20
        data = rng.integers(0, 256, size=(k, b), dtype=np.uint8)
        parity_m = gf256.parity_matrix(k, k + 4)
        rows = _local_shard_rows(mesh)
        k_loc = k // args.nproc
        local = data[rows.start * k_loc : rows.stop * k_loc]
        out = staged_apply_matrix(mesh, parity_m, local, b)
        want = rs_cpu.apply_matrix_numpy(parity_m, data)
        np.testing.assert_array_equal(out, want)
        print(f"staged worker {args.pid}: ok {out.shape}")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "--staged-worker":
        _staged_worker_main(sys.argv[2:])
