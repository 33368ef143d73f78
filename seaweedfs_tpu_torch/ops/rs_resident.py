"""Device-resident EC shard cache + batched degraded-read reconstruction.

Port of the single-device serving half of seaweedfs_tpu/ops/rs_resident.py.
A volume's surviving shards are pinned in device memory once
(DeviceShardCache); a burst of degraded needle reads then becomes one
device call per size-bucket group (reconstruct_intervals): only one packed
int32 meta word per request goes up, only the reconstructed bytes come
down, and no survivor byte crosses PCIe per read.

The calls run the hand-written kernel of csrc/fused_reconstruct.cu through
two wrappers, fused_reconstruct (flat system) and
fused_reconstruct_blockdiag (the g-group block-diagonal system), each call
one launch that reads the survivors straight from the resident buffers and
writes only each request's wanted row.  A
CPU tensor takes the kernels' plain PyTorch versions below (the CPU tests);
a CUDA tensor takes the kernel or raises.

What differs from the JAX package:
  * one fused launch replaces each gather + select pallas_call pair (the
    split was a Mosaic layout workaround), so no gathered intermediate is
    written to device memory;
  * a call launches with its TRUE request count: the JAX package pads the
    count to COUNT_BUCKETS only so that XLA compiles few shapes, and the
    kernels here take runtime shapes.  The returned bytes are the same;
  * nothing compiles per shape, so ColdShape is never raised (it stays a
    CacheMiss subclass so callers read the same).

Not ported here (ROADMAP): the mesh and pod placement (A8), scrub (A5), the
XLA-fallback gather programs (B4), the AOT warm grid and observed-shape
persistence, trace spans and metrics (A7), and the Store/dispatcher (A4).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from . import _build, gf256, rs_cuda

DATA_SHARDS = 10
TOTAL_SHARDS = 14

LANE = 128  # request offsets first align down to this (the planner's unit)
# fused offsets align down to this; the <=1023-byte residual joins the
# host-trimmed delta, and every load of the kernels is then word-aligned
FUSED_ALIGN = 1024
SIZE_BUCKETS = (2048, 8192, 32768, 131072, 524288, 2 * 1024 * 1024)
COUNT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 256)
MAX_TILE = SIZE_BUCKETS[-1]
# split oversized intervals into chunks that fit the largest bucket even
# after the <=FUSED_ALIGN-1 alignment residual
CHUNK = MAX_TILE - FUSED_ALIGN
SHARD_QUANTUM = 64 * 1024 * 1024

# one packed int32 meta word per request:
# (offset in FUSED_ALIGN units) << META_ROW_BITS | wanted matrix row
META_ROW_BITS = 5
_META_ROW_MASK = (1 << META_ROW_BITS) - 1


class CacheMiss(LookupError):
    """Not enough resident shards to serve the request."""


class ColdShape(CacheMiss):
    """Kept for the JAX package's contract (a device shape not compiled
    yet).  The port's kernels take runtime shapes, so it is never raised."""


def _bucket(values: tuple[int, ...], need: int) -> int:
    for v in values:
        if need <= v:
            return v
    raise ValueError(f"{need} exceeds largest bucket {values[-1]}")


# bound per-call output (count * size bucket)
_MAX_CALL_OUT = 32 * 1024 * 1024
# bound aggregate un-fetched output across the calls of one batch
_MAX_PENDING_OUT = 128 * 1024 * 1024


def _max_count(size_bucket: int) -> int:
    return max(1, min(COUNT_BUCKETS[-1], _MAX_CALL_OUT // size_bucket))


# "flat": the plain [8m, 8k] reconstruction system.  "blockdiag": the same
# resident bytes served through the g-group block-diagonal system (each
# request's tile splits into g contiguous segments).
LAYOUTS = ("flat", "blockdiag")

FUSED_GROUP = 8  # the JAX kernels' requests per grid step (kept for parity)
FUSED_TILE = 4096  # per-request chunk of the fetch ladder


# --- staging ----------------------------------------------------------------


class StagingArena:
    """Per-slot reusable host staging for a call's packed meta words:
    pinned int32 rows of COUNT_BUCKETS[-1] words, and a pinned uint8 result
    buffer for the calls' D2H, grown on demand up to _MAX_PENDING_OUT (plus
    one call).  The meta block is a small ring of rows, each with the event
    recorded after the call that copied it: staging waits on that event, so
    a row is never rewritten while its H2D copy is still in flight."""

    # meta rows in the ring: a call restages a row only after the call
    # that used it RING calls earlier has finished with it
    RING = 4

    def __init__(self, width: int | None = None):
        self.width = width or COUNT_BUCKETS[-1]
        self._meta = torch.empty(
            (self.RING, self.width), dtype=torch.int32, pin_memory=True
        )
        self._copied: list = [None] * self.RING
        self._next = 0
        self._last = 0
        self.result = torch.empty(0, dtype=torch.uint8, pin_memory=True)

    def stage_fused(self, packed: list[int]) -> torch.Tensor:
        """-> [n] pinned int32 view of a ring row holding the packed meta,
        after the H2D out of that row's previous use has completed."""
        i = self._next
        self._next = (i + 1) % self.RING
        if self._copied[i] is not None:
            self._copied[i].synchronize()
            self._copied[i] = None
        self._last = i
        view = self._meta[i, : len(packed)]
        view.copy_(torch.tensor(packed, dtype=torch.int32))
        return view

    def mark_copied(self, stream) -> None:
        """Record, on `stream`, the point after which the row staged last
        may be rewritten (called right after the call that read it)."""
        ev = torch.cuda.Event()
        ev.record(stream)
        self._copied[self._last] = ev

    def ensure_result(self, nbytes: int) -> torch.Tensor:
        """The result buffer, grown to hold `nbytes` (called only while no
        D2H into it is pending)."""
        if self.result.numel() < nbytes:
            self.result = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return self.result


class PipelineSlot:
    """What DevicePipeline.slot() yields: the slot-acquisition wait, the
    slot's staging arena and its CUDA stream (both None on the CPU, where
    a slot stages into fresh tensors and runs in order)."""

    __slots__ = ("wait_s", "arena", "stream")

    def __init__(self, wait_s: float, arena, stream):
        self.wait_s = wait_s
        self.arena = arena
        self.stream = stream


class DevicePipeline:
    """Staging gate for the device leg of batched reconstruct calls:
    `slots=2` lets batch N+1 pack (outside the slot) and ship + execute
    (inside it) on its own stream while batch N drains its D2H.  `slots=1`
    is the serial baseline.  `last_overlap` is device-section busy seconds
    over wall seconds of the current batch window (>1 means two slots
    genuinely overlapped); `total_busy_s` never resets.  `h2d_bytes` and
    `d2h_bytes` count what the calls moved across PCIe."""

    def __init__(self, slots: int = 2, device="cpu"):
        self.device = torch.device(device)
        self._cond = threading.Condition()
        self._slots = max(1, slots)
        self._active = 0
        self._busy_s = 0.0
        self.total_busy_s = 0.0
        self._window_t0 = 0.0
        self.last_overlap = 0.0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        # one (arena, stream) per concurrently held slot, grown on demand
        self._lanes: list[tuple] = []
        self._free: list[int] = []

    @property
    def slots(self) -> int:
        return self._slots

    def set_slots(self, n: int) -> None:
        with self._cond:
            self._slots = max(1, int(n))
            self._cond.notify_all()

    def _new_lane(self) -> tuple:
        if self.device.type != "cuda":
            return (None, None)
        return (StagingArena(), torch.cuda.Stream(device=self.device))

    @contextlib.contextmanager
    def slot(self):
        t_req = time.perf_counter()
        with self._cond:
            while self._active >= self._slots:
                self._cond.wait()
            self._active += 1
            if self._active == 1:
                self._window_t0 = time.perf_counter()
                self._busy_s = 0.0
            idx = self._free.pop() if self._free else None
        if idx is None:
            lane = self._new_lane()
            with self._cond:
                self._lanes.append(lane)
                idx = len(self._lanes) - 1
        arena, stream = self._lanes[idx]
        t0 = time.perf_counter()
        try:
            yield PipelineSlot(t0 - t_req, arena, stream)
        finally:
            dur = time.perf_counter() - t0
            with self._cond:
                self._active -= 1
                self._free.append(idx)
                self._busy_s += dur
                self.total_busy_s += dur
                wall = time.perf_counter() - self._window_t0
                if wall > 0:
                    self.last_overlap = self._busy_s / wall
                self._cond.notify()


# --- the cache --------------------------------------------------------------


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "DeviceShardCache(device='cuda') needs a CUDA device and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no resident cache for device {dev}")
    return dev


class DeviceShardCache:
    """LRU cache of EC shard bytes pinned in device memory (one device).

    Keyed by (vid, shard_id).  `budget_bytes` bounds padded device bytes;
    inserting past the budget evicts least-recently-used shards (whole
    shards: a partially resident volume fails over to the host path via
    CacheMiss).  Each shard is padded to its true size + MAX_TILE, rounded
    up to `shard_quantum`, so a request window never runs past the buffer.
    `device` defaults to "cuda" and raises without a card.

    The mesh and pod layouts of the JAX cache (`mesh_devices`,
    `global_mesh`) are ROADMAP A8 and raise NotImplementedError here."""

    def __init__(
        self,
        budget_bytes: int = 8 << 30,
        shard_quantum: int = SHARD_QUANTUM,
        layout: str = "flat",
        groups: int = rs_cuda.BLOCKDIAG_GROUPS,
        device="cuda",
        mesh_devices: int | None = None,
        global_mesh: bool = False,
    ):
        if mesh_devices is not None or global_mesh:
            raise NotImplementedError(
                "mesh-sharded and pod residency are not ported yet (ROADMAP A8)"
            )
        if layout not in LAYOUTS:
            raise ValueError(f"unknown resident layout {layout!r}")
        if groups < 1 or SIZE_BUCKETS[0] % (groups * LANE):
            raise ValueError(
                f"groups={groups} must split the {SIZE_BUCKETS[0]}-byte "
                "size bucket into lane-aligned segments"
            )
        self.device = _resolve_device(device)
        self.budget = budget_bytes
        self.quantum = shard_quantum
        self.n_devices = 1
        # mutable at run time: the bytes are layout-agnostic (blockdiag
        # segments are contiguous slices of the same flat buffers)
        self.layout = layout
        self.groups = groups
        self.pipeline = DevicePipeline(device=self.device)
        self._lock = threading.Lock()
        self._arrays: OrderedDict[tuple[int, int], torch.Tensor] = OrderedDict()
        self._true_sizes: dict[tuple[int, int], int] = {}
        # event recorded after each put's copies: a reader on another
        # stream waits on it before it touches the bytes
        self._ready: dict[tuple[int, int], torch.cuda.Event] = {}
        # vid -> the disk-location directory whose shard files were pinned
        self._pin_source: dict[int, str] = {}
        self._vid_counts: dict[int, int] = {}
        self._vid_place: dict[int, int] = {}
        self._dev_bytes: list[int] = [0]
        self.evictions = 0
        self.pin_claims = 0

    def _padded_len(self, n: int) -> int:
        need = n + MAX_TILE
        return -(-need // self.quantum) * self.quantum

    @property
    def bytes_used(self) -> int:
        return sum(self._dev_bytes)

    @property
    def device_budget(self) -> int:
        return self.budget // self.n_devices

    def placement(self, vid: int):
        """0 once anything of `vid` was placed, else None (one device)."""
        with self._lock:
            return self._vid_place.get(vid)

    def put(self, vid: int, shard_id: int, data) -> None:
        host = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)
        ) else np.asarray(data, dtype=np.uint8).reshape(-1)
        with self._lock:
            self._vid_place.setdefault(vid, 0)
        # allocate the padded buffer on the device, copy the true bytes
        # into its head and zero only the tail there: no padded host copy
        padded = self._padded_len(host.size)
        buf = torch.empty(padded, dtype=torch.uint8, device=self.device)
        if host.size:
            src = torch.from_numpy(
                host if host.flags.writeable else host.copy()
            )
            buf[: host.size].copy_(src)
        buf[host.size:].zero_()
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        key = (vid, shard_id)
        budget = self.device_budget
        with self._lock:
            if self._vid_place.get(vid) is None:
                # evict()/clear() between the claim and here: drop the
                # buffer rather than resurrect a released volume
                return
            if key in self._arrays:
                self._drop_key_locked(key)
            while self._arrays and self._dev_bytes[0] + padded > budget:
                self._drop_key_locked(next(iter(self._arrays)))
                self.evictions += 1
                # the evicted vid keeps its pin-source claim (see the JAX
                # cache): only explicit evict()/clear() release it
            self._arrays[key] = buf
            self._true_sizes[key] = host.size
            if ready is not None:
                self._ready[key] = ready
            self._vid_counts[vid] = self._vid_counts.get(vid, 0) + 1
            self._dev_bytes[0] += padded

    def _drop_key_locked(self, key: tuple[int, int]) -> None:
        buf = self._arrays.pop(key)
        self._true_sizes.pop(key, None)
        self._ready.pop(key, None)
        self._dev_bytes[0] -= buf.numel()
        self._vid_counts[key[0]] -= 1
        if not self._vid_counts[key[0]]:
            del self._vid_counts[key[0]]

    def resident_count(self, vid: int) -> int:
        with self._lock:
            return self._vid_counts.get(vid, 0)

    def _forget_if_gone(self, vid: int) -> None:
        if not self._vid_counts.get(vid):
            self._vid_counts.pop(vid, None)
            self._pin_source.pop(vid, None)
            self._vid_place.pop(vid, None)

    def claim_pin_source(self, vid: int, source: str) -> str:
        """Atomically claim which disk location's shard files back this
        vid's resident bytes; returns the winning source."""
        with self._lock:
            if vid not in self._pin_source:
                self.pin_claims += 1
            return self._pin_source.setdefault(vid, source)

    def release_pin_source(self, vid: int, source: str) -> None:
        """Release `source`'s claim if nothing of `vid` is resident."""
        with self._lock:
            if (
                self._pin_source.get(vid) == source
                and not self._vid_counts.get(vid)
            ):
                del self._pin_source[vid]

    def pin_source(self, vid: int) -> str | None:
        with self._lock:
            return self._pin_source.get(vid)

    def get(self, vid: int, shard_id: int):
        return self._get_ready(vid, shard_id)[0]

    def _get_ready(self, vid: int, shard_id: int):
        """(buffer, put event) with the LRU refresh of get()."""
        with self._lock:
            key = (vid, shard_id)
            arr = self._arrays.get(key)
            if arr is None:
                return None, None
            self._arrays.move_to_end(key)
            return arr, self._ready.get(key)

    def shard_size(self, vid: int, shard_id: int) -> int | None:
        return self._true_sizes.get((vid, shard_id))

    def stats(self) -> tuple[int, int]:
        """(resident shard count, padded device bytes held)."""
        with self._lock:
            return len(self._arrays), self.bytes_used

    def resident_by_vid(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        with self._lock:
            for v, s in self._arrays:
                out.setdefault(v, []).append(s)
        for ids in out.values():
            ids.sort()
        return out

    def shard_ids(self, vid: int) -> list[int]:
        with self._lock:
            return sorted(s for (v, s) in self._arrays if v == vid)

    def evict(self, vid: int, shard_id: int | None = None) -> None:
        with self._lock:
            keys = [
                k
                for k in self._arrays
                if k[0] == vid and (shard_id is None or k[1] == shard_id)
            ]
            for k in keys:
                self._drop_key_locked(k)
            if shard_id is None or keys:
                self._forget_if_gone(vid)

    def clear(self) -> None:
        with self._lock:
            self._arrays.clear()
            self._true_sizes.clear()
            self._ready.clear()
            self._pin_source.clear()
            self._vid_counts.clear()
            self._vid_place.clear()
            self._dev_bytes = [0]


# --- planner helpers (copied from the JAX package, pinned equal by tests) --


def _plan(requests: list[tuple[int, int, int]], l_loc: int = 0):
    """Split/align requests into device sub-requests.

    Each request (wanted_shard, offset, size) becomes >=1 sub-requests
    (req_index, aligned_off, delta, take, bucket) with delta+take <= bucket.

    `l_loc` > 0 is the mesh layout's stripe width (ROADMAP A8): every
    sub-request's whole bucket window must then sit inside one stripe, so
    requests additionally split at stripe boundaries and a window that
    would overhang its boundary is backward-aligned to end there.
    """
    cap = SIZE_BUCKETS[-1]
    if l_loc:
        cap = max(v for v in SIZE_BUCKETS if v <= l_loc)
    subs = []
    for idx, (_, off, size) in enumerate(requests):
        pos = off
        remaining = size
        while remaining > 0:
            take = min(remaining, CHUNK)
            if l_loc:
                boundary = (pos // l_loc + 1) * l_loc
                take = min(take, boundary - pos)
                aligned = pos - (pos % LANE)
                delta = pos - aligned
                if delta + take > cap:
                    take = cap - delta
                bucket = _bucket(SIZE_BUCKETS, delta + take)
                if aligned + bucket > boundary:
                    aligned = boundary - bucket
                    delta = pos - aligned
            else:
                aligned = pos - (pos % LANE)
                delta = pos - aligned
                bucket = _bucket(SIZE_BUCKETS, delta + take)
            subs.append((idx, aligned, delta, take, bucket))
            pos += take
            remaining -= take
    return subs


def _fetch_cover(span: int) -> int:
    """Smallest of {2^n, 3*2^(n-1)} covering span (min 2048)."""
    p = max(1 << (span - 1).bit_length(), 2048)
    three_halves = 3 * (p >> 2)
    return three_halves if three_halves >= max(span, 2048) else p


def _fused_tile_for(fetch: int) -> int:
    """Largest per-chunk tile <= FUSED_TILE dividing fetch (fetch is
    2^n or 3*2^(n-1), so halving always lands on a divisor >= 1024)."""
    t = FUSED_TILE
    while fetch % t:
        t //= 2
    return t


def _fused_vectors(part, requests, row_of):
    """Re-align each sub-request down to FUSED_ALIGN: offsets become unit
    counts, the residual joins the host-trimmed delta.  -> (packed,
    deltas, fetch): `packed` is the [N] list of int32 meta words
    ((units << META_ROW_BITS) | row) and fetch covers the largest
    delta+take."""
    packed, deltas = [], []
    for _, s in part:
        extra = s[1] % FUSED_ALIGN
        units = (s[1] - extra) // FUSED_ALIGN
        if units >= 1 << (31 - META_ROW_BITS):  # 64GB shard: unreachable
            raise ValueError(f"offset {s[1]} exceeds packed meta range")
        packed.append(
            (units << META_ROW_BITS) | row_of[requests[s[0]][0]]
        )
        deltas.append(s[2] + extra)
    span = max(d + s[3] for d, (_, s) in zip(deltas, part))
    fetch = _fetch_cover(span)
    return packed, deltas, fetch


def _blockdiag_fetch_tile(fetch: int, groups: int) -> tuple[int, int]:
    """(fetch, tile) for the block-diagonal kernel: fetch rounds up to a
    multiple of groups*FUSED_ALIGN and tile is the groups*FUSED_ALIGN-
    aligned chunk (= FUSED_TILE for g=4) whose g segments map onto the
    system's g diagonal blocks."""
    q = groups * FUSED_ALIGN
    fetch = -(-fetch // q) * q
    tile = FUSED_TILE if FUSED_TILE % q == 0 and fetch % FUSED_TILE == 0 else q
    return fetch, tile


# --- the kernels' plain versions --------------------------------------------

# columns of one plain apply: bounds its float32 bit planes (8*k_pad rows)
_PLAIN_COLS = 1 << 20


def _meta_fields(meta: torch.Tensor, device) -> tuple[torch.Tensor, torch.Tensor]:
    m = meta.to(device=device, dtype=torch.int64)
    return (m >> META_ROW_BITS) * FUSED_ALIGN, m & _META_ROW_MASK


def _fused_reconstruct_torch(a_bm, survivors, meta, *, tile, fetch, k_true):
    """Plain version of the flat kernel: gather each request's survivor
    slices [start, start+fetch) by indexing, apply the bit matrix
    (rs_cuda._apply_torch), keep each request's wanted row.  -> [N, fetch]
    u8.  The output does not depend on `tile`."""
    k = len(survivors)
    dev = survivors[0].device
    m_pad = a_bm.shape[0] // 8
    starts, rows = _meta_fields(meta, dev)
    n = starts.numel()
    out = torch.empty((n, fetch), dtype=torch.uint8, device=dev)
    step = max(1, _PLAIN_COLS // fetch)
    cols = torch.arange(fetch, device=dev)
    for lo in range(0, n, step):
        idx = starts[lo : lo + step, None] + cols  # [c, fetch]
        c = idx.shape[0]
        x = torch.stack([s[idx] for s in survivors])  # [k, c, fetch]
        y = rs_cuda._apply_torch(a_bm, x.reshape(k, c * fetch), m_pad)
        y = y.view(m_pad, c, fetch)
        out[lo : lo + c] = y[rows[lo : lo + c], torch.arange(c, device=dev)]
    return out


def _fused_reconstruct_blockdiag_torch(
    a_blk, survivors, meta, *, tile, fetch, k_true, w_true, groups
):
    """Plain version of the block-diagonal kernel: each request's `tile`
    chunk splits into `groups` segments; segment jg of survivor s becomes
    input row jg*k + s, one apply of the block-diagonal system
    reconstructs every segment, and row jg*w_true + row of the output is
    the wanted shard's bytes of segment jg.  -> [N, fetch] u8."""
    k = len(survivors)
    dev = survivors[0].device
    m_pad = a_blk.shape[0] // 8
    seg = tile // groups
    chunks = fetch // tile
    starts, rows = _meta_fields(meta, dev)
    n = starts.numel()
    out = torch.empty((n, fetch), dtype=torch.uint8, device=dev)
    # byte position of (chunk j, segment jg, lane c) inside a request
    pos = (
        (torch.arange(chunks, device=dev) * tile)[:, None, None]
        + (torch.arange(groups, device=dev) * seg)[None, :, None]
        + torch.arange(seg, device=dev)
    )  # [chunks, groups, seg]
    step = max(1, _PLAIN_COLS // (chunks * seg))
    for lo in range(0, n, step):
        idx = starts[lo : lo + step, None, None, None] + pos
        c = idx.shape[0]
        x = torch.stack([s[idx] for s in survivors])  # [k, c, chunks, g, seg]
        x = x.permute(3, 0, 1, 2, 4).reshape(groups * k, c * chunks * seg)
        y = rs_cuda._apply_torch(a_blk, x, m_pad).view(m_pad, c, chunks, seg)
        r = rows[lo : lo + c]
        ar = torch.arange(c, device=dev)
        sel = torch.stack(
            [y[jg * w_true + r, ar] for jg in range(groups)], dim=2
        )  # [c, chunks, groups, seg]
        out[lo : lo + c] = sel.reshape(c, fetch)
    return out


# --- the kernels ------------------------------------------------------------

# counts of the two wrappers' `.launches`, bumped from several threads
_launch_lock = threading.Lock()


def _check_call(a, survivors, meta, tile, fetch, k_true, w_true, groups) -> None:
    """Host checks shared by both routes; raises on any violation."""
    if not isinstance(survivors, (tuple, list)) or not survivors:
        raise ValueError("survivors must be a non-empty tuple of tensors")
    k = len(survivors)
    if k_true is not None and k != k_true:
        raise ValueError(f"{k} survivors but matrix was built for {k_true}")
    dev = survivors[0].device
    for s in survivors:
        if s.dtype != torch.uint8 or s.dim() != 1:
            raise TypeError("survivors must be 1-D uint8 tensors")
        if s.device != dev or not s.is_contiguous():
            raise ValueError("survivors must be contiguous, on one device")
    if a.device != dev:
        raise ValueError(f"matrix on {a.device} but survivors on {dev}")
    if a.dtype != torch.int8 or a.dim() != 2 or a.shape[0] % 8 or a.shape[1] % 8:
        raise TypeError(f"matrix must be bit-major int8, got {a.dtype} "
                        f"{tuple(a.shape)}")
    if meta.dtype != torch.int32 or meta.dim() != 1:
        raise TypeError("meta must be a 1-D int32 tensor")
    m_pad, k_pad = a.shape[0] // 8, a.shape[1] // 8
    if groups * k > k_pad:
        raise ValueError(f"{groups}x{k} survivor columns exceed k_pad {k_pad}")
    if groups > 1:
        if tile % (groups * FUSED_ALIGN):
            raise ValueError(f"tile {tile} is not a multiple of "
                             f"{groups}*{FUSED_ALIGN}")
        if groups * w_true > m_pad:
            raise ValueError(f"{groups}x{w_true} rows exceed m_pad {m_pad}")
    if fetch <= 0 or tile <= 0 or fetch % tile or fetch % FUSED_ALIGN:
        raise ValueError(f"fetch {fetch} must be a positive multiple of the "
                         f"tile {tile} and of {FUSED_ALIGN}")
    host = meta if meta.device.type == "cpu" else meta.cpu()
    if host.numel():
        if int(host.min()) < 0:
            raise ValueError("negative meta word")
        # the offset units are the high bits: the largest word holds them
        units_max = int(host.max()) >> META_ROW_BITS
        length = min(s.numel() for s in survivors)
        if units_max * FUSED_ALIGN + fetch > length:
            raise ValueError(
                f"request window {units_max * FUSED_ALIGN}+{fetch} runs past "
                f"the {length}-byte survivors"
            )
        row_max = int((host & _META_ROW_MASK).max())
        rows = w_true if w_true is not None else m_pad
        if row_max >= rows:
            raise ValueError(f"wanted row {row_max} >= {rows}")


def _launch(wrapper, a, survivors, meta, fetch, w_true, groups, tile):
    """Launch csrc/fused_reconstruct.cu on the current stream (groups 1:
    the flat system) and add one to `wrapper.launches` when it launched.
    The C entry checks the kernel's own limits (k, groups, n)."""
    if any(s.data_ptr() % 16 for s in survivors):
        raise ValueError("survivor buffers must be 16-byte aligned")
    k = len(survivors)
    n = meta.numel()
    dev = survivors[0].device
    out = torch.empty((n, fetch), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    lib = _build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        if meta.device.type == "cpu":
            meta = meta.to(dev, non_blocking=meta.is_pinned())
        ptrs = (ctypes.c_void_p * k)(*[s.data_ptr() for s in survivors])
        rc = lib.fused_reconstruct_launch(
            a.data_ptr(), a.shape[0] // 8, a.shape[1] // 8, ptrs, k,
            meta.data_ptr(), n, fetch, out.data_ptr(), w_true, groups, tile,
            stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_reconstruct_launch failed ({rc}): "
            f"{lib.fused_reconstruct_error_string(rc).decode()}"
        )
    with _launch_lock:
        wrapper.launches += 1
    return out


def fused_reconstruct(a_bm, survivors, meta, *, tile, fetch, k_true,
                      w_true=None):
    """The flat fused gather + reconstruct + select (the port of the JAX
    `_fused_reconstruct`, K2+K3): survivors is a tuple of [L] u8 resident
    shards in matrix column order, meta [N] int32 packed words.  -> [N,
    fetch] u8, the raw reconstruction from each request's FUSED_ALIGN-
    aligned offset (the caller trims the delta).  CPU survivors take the
    plain version; CUDA survivors launch csrc/fused_reconstruct.cu on the
    current stream (meta may be a pinned host tensor, copied up there) or
    raise.  `w_true`, when given, bounds the rows.  `.launches` counts
    kernel launches."""
    _check_call(a_bm, survivors, meta, tile, fetch, k_true, w_true, 1)
    if survivors[0].device.type == "cpu":
        return _fused_reconstruct_torch(
            a_bm, survivors, meta, tile=tile, fetch=fetch, k_true=k_true
        )
    if survivors[0].device.type != "cuda":
        raise ValueError(f"no fused reconstruct for {survivors[0].device}")
    return _launch(fused_reconstruct, a_bm, survivors, meta, fetch, 0, 1,
                   fetch)


fused_reconstruct.launches = 0


def fused_reconstruct_blockdiag(a_blk, survivors, meta, *, tile, fetch,
                                k_true, w_true, groups):
    """Block-diagonal twin (the port of `_fused_reconstruct_blockdiag`,
    K4+K5): each request's `tile` chunk splits into `groups` segments and
    segment jg is reconstructed through diagonal block jg of `a_blk`, row
    jg*w_true + row.  Same contract as fused_reconstruct; the caller
    guarantees tile % (groups*FUSED_ALIGN) == 0 and fetch % tile == 0
    (checked)."""
    _check_call(a_blk, survivors, meta, tile, fetch, k_true, w_true, groups)
    if survivors[0].device.type == "cpu":
        return _fused_reconstruct_blockdiag_torch(
            a_blk, survivors, meta, tile=tile, fetch=fetch, k_true=k_true,
            w_true=w_true, groups=groups,
        )
    if survivors[0].device.type != "cuda":
        raise ValueError(f"no fused reconstruct for {survivors[0].device}")
    return _launch(fused_reconstruct_blockdiag, a_blk, survivors, meta,
                   fetch, w_true, groups, tile)


fused_reconstruct_blockdiag.launches = 0


# --- the serving call -------------------------------------------------------


def _check_blockdiag(a: torch.Tensor, w: int, k: int, groups: int) -> None:
    """The block-diagonal kernel reads only diagonal block jg's columns for
    group jg's rows: prove every other entry of the prepared matrix is 0."""
    m_pad, k_pad = a.shape[0] // 8, a.shape[1] // 8
    bits = a.cpu().numpy().reshape(8, m_pad, 8, k_pad)
    for jg in range(groups + 1):
        rows = bits[:, jg * w : (jg + 1) * w if jg < groups else m_pad]
        off = np.ones(k_pad, dtype=bool)
        if jg < groups:
            off[jg * k : (jg + 1) * k] = False
        if rows[..., off].any():
            raise AssertionError(f"prepared system is not block-diagonal "
                                 f"in block {jg}")


@functools.lru_cache(maxsize=16)
def _prepared_blockdiag(matrix_bytes: bytes, m: int, k: int, groups: int,
                        device: str) -> torch.Tensor:
    a = rs_cuda._prepared_blockdiag(matrix_bytes, m, k, groups, device)
    _check_blockdiag(a, m, k, groups)
    return a


def _resolve_codec(cache, vid, requests, data_shards, total_shards, layout):
    """Reconstruction matrix (flat or block-diagonal, per the layout) on the
    cache's device + the resident survivors in its column order, each with
    the event its put recorded."""
    wanted = sorted({r[0] for r in requests})
    resident = cache.shard_ids(vid)
    present = [s for s in resident if s not in wanted]
    if len(present) < data_shards:
        raise CacheMiss(
            f"vid {vid}: {len(present)} resident survivors, need {data_shards}"
        )
    rmat, use = gf256.reconstruction_matrix(
        data_shards, total_shards, present, wanted
    )
    dev = str(cache.device)
    if layout == "blockdiag":
        a_prep = _prepared_blockdiag(rmat.tobytes(), *rmat.shape,
                                     cache.groups, dev)
    else:
        a_prep = rs_cuda._prepared(rmat.tobytes(), *rmat.shape, dev)
    got = [cache._get_ready(vid, s) for s in use]
    if any(buf is None for buf, _ in got):  # evicted between listing and get
        raise CacheMiss(f"vid {vid}: survivor shard evicted mid-request")
    survivors = tuple(buf for buf, _ in got)
    events = [ev for _, ev in got if ev is not None]
    row_of = {sid: i for i, sid in enumerate(wanted)}
    return a_prep, survivors, events, row_of, use, rmat.shape[0]


def _pack_calls(cache, vid, requests, layout, data_shards, total_shards):
    """Resolve the codec, split/align the requests and group them into
    device calls, one per size bucket present (more where _max_count caps
    a call's output).  Each call is (part, packed, fetch, tile, deltas)
    with the TRUE request count: nothing here compiles per shape, so the
    JAX package's count padding would only ship zero rows."""
    a_prep, survivors, events, row_of, use, w_true = _resolve_codec(
        cache, vid, requests, data_shards, total_shards, layout
    )
    groups = cache.groups if layout == "blockdiag" else 1
    subs = _plan(requests)
    calls = []
    for bucket in SIZE_BUCKETS:
        group = [(i, s) for i, s in enumerate(subs) if s[4] == bucket]
        if not group:
            continue
        n_bucket = _bucket(COUNT_BUCKETS, min(len(group), _max_count(bucket)))
        for start in range(0, len(group), n_bucket):
            part = group[start : start + n_bucket]
            packed, deltas, fetch = _fused_vectors(part, requests, row_of)
            if layout == "blockdiag":
                fetch, tile = _blockdiag_fetch_tile(fetch, groups)
            else:
                tile = _fused_tile_for(fetch)
            calls.append((part, packed, fetch, tile, deltas))
    return calls, subs, survivors, events, a_prep, use, w_true, groups


def _stage_call_vec(packed: list[int], arena=None) -> torch.Tensor:
    """One call's [n] int32 meta: into the held slot's pinned arena on the
    card, a fresh tensor on the CPU."""
    if arena is not None:
        return arena.stage_fused(packed)
    return torch.tensor(packed, dtype=torch.int32)


def _dispatch_call(meta, a_prep, survivors, n_use, w_true, groups, tile,
                   fetch) -> torch.Tensor:
    """Route one call to its kernel (flat or block-diagonal)."""
    if groups > 1:
        return fused_reconstruct_blockdiag(
            a_prep, survivors, meta, tile=tile, fetch=fetch, k_true=n_use,
            w_true=w_true, groups=groups,
        )
    return fused_reconstruct(
        a_prep, survivors, meta, tile=tile, fetch=fetch, k_true=n_use,
        w_true=w_true,
    )


def _trim(out: np.ndarray, part, deltas, sub_out) -> None:
    """The host trims each sub-request's alignment delta."""
    for j, (sub_idx, (_, _, _, take, _)) in enumerate(part):
        d = deltas[j]
        sub_out[sub_idx] = out[j, d : d + take].tobytes()


def reconstruct_intervals(
    cache: DeviceShardCache,
    vid: int,
    requests: list[tuple[int, int, int]],
    data_shards: int = DATA_SHARDS,
    total_shards: int = TOTAL_SHARDS,
    layout: str | None = None,
) -> list[bytes]:
    """Reconstruct interval bytes for a batch of degraded reads in as few
    device calls as possible (one per size bucket present).

    requests: [(wanted_shard_id, shard_offset, size)].  All gather inputs
    are resident shards; per call, H2D is the packed meta words and D2H the
    reconstructed rows.  Raises CacheMiss, before any device work, when
    fewer than `data_shards` non-wanted shards of `vid` are resident.
    `layout` (None = the cache's) picks the flat or block-diagonal kernel.
    On the card the batch runs on its pipeline slot's stream: every call
    is enqueued (meta H2D, kernel, D2H into the slot's pinned buffer)
    before the first is waited on, and the calls drain once more than
    _MAX_PENDING_OUT bytes are pending.  -> one bytes per request, in
    order."""
    if not requests:
        return []
    if layout is None:
        layout = cache.layout
    if layout not in LAYOUTS:
        raise ValueError(f"unknown resident layout {layout!r}")
    calls, subs, survivors, events, a_prep, use, w_true, groups = _pack_calls(
        cache, vid, requests, layout, data_shards, total_shards
    )
    sub_out: list[bytes | None] = [None] * len(subs)
    pipe = cache.pipeline
    with pipe.slot() as pslot:
        if pslot.stream is None:
            for part, packed, fetch, tile, deltas in calls:
                out = _dispatch_call(
                    _stage_call_vec(packed), a_prep, survivors, len(use),
                    w_true, groups, tile, fetch,
                )
                _trim(out.numpy(), part, deltas, sub_out)
        else:
            _run_on_stream(pipe, pslot, calls, survivors, events, a_prep,
                           len(use), w_true, groups, sub_out)
    outputs: list[list[bytes]] = [[] for _ in requests]
    for (idx, *_), piece in zip(subs, sub_out):
        outputs[idx].append(piece)  # subs are in offset order per request
    return [b"".join(parts) for parts in outputs]


def _run_on_stream(pipe, pslot, calls, survivors, events, a_prep, n_use,
                   w_true, groups, sub_out) -> None:
    stream, arena = pslot.stream, pslot.arena
    pending: list[tuple] = []

    def drain() -> None:
        for part, deltas, host, done in pending:
            done.synchronize()
            _trim(host.numpy(), part, deltas, sub_out)
        pending.clear()

    with torch.cuda.device(pipe.device), torch.cuda.stream(stream):
        # the survivors were written on the put's stream, and an eviction
        # during the batch must not hand their blocks to another allocation
        # while this stream still reads them
        for ev in events:
            stream.wait_event(ev)
        for s in survivors:
            s.record_stream(stream)
        sizes = [len(packed) * fetch for _, packed, fetch, _, _ in calls]
        # one pinned buffer for the batch's results, grown only here while
        # nothing is pending; more than _MAX_PENDING_OUT drains first
        result = arena.ensure_result(
            max(max(sizes), min(sum(sizes), _MAX_PENDING_OUT))
        )
        off = 0
        for (part, packed, fetch, tile, deltas), nbytes in zip(calls, sizes):
            if pending and off + nbytes > result.numel():
                drain()
                off = 0
            meta = _stage_call_vec(packed, arena)
            out = _dispatch_call(meta, a_prep, survivors, n_use, w_true,
                                 groups, tile, fetch)
            arena.mark_copied(stream)
            host = result[off : off + nbytes].view(len(packed), fetch)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
            pending.append((part, deltas, host, done))
            off += nbytes
            pipe.h2d_bytes += meta.numel() * 4
            pipe.d2h_bytes += nbytes
        drain()


def make_batched_call(
    cache: DeviceShardCache,
    vid: int,
    requests: list[tuple[int, int, int]],
    layout: str | None = None,
):
    """Zero-arg thunk running the ONE device call a homogeneous batch of
    requests (one size bucket, count <= COUNT_BUCKETS[-1]) maps to, and
    returning the un-copied [N * fetch] device tensor (a benchmark times the
    serving call with it, without host copies)."""
    if layout is None:
        layout = cache.layout
    groups = cache.groups if layout == "blockdiag" else 1
    a_prep, survivors, events, row_of, use, w_true = _resolve_codec(
        cache, vid, requests, DATA_SHARDS, TOTAL_SHARDS, layout
    )
    subs = _plan(requests)
    if len({s[4] for s in subs}) != 1 or len(subs) > COUNT_BUCKETS[-1]:
        raise ValueError("bench batch must be one homogeneous bucket group")
    part = list(enumerate(subs))
    packed, _deltas, fetch = _fused_vectors(part, requests, row_of)
    if groups > 1:
        fetch, tile = _blockdiag_fetch_tile(fetch, groups)
    else:
        tile = _fused_tile_for(fetch)

    def thunk():
        if cache.device.type == "cuda":
            stream = torch.cuda.current_stream(cache.device)
            for ev in events:
                stream.wait_event(ev)
        meta = torch.tensor(packed, dtype=torch.int32)
        return _dispatch_call(meta, a_prep, survivors, len(use), w_true,
                              groups, tile, fetch).reshape(-1)

    return thunk
