"""Device-resident EC shard cache + batched degraded-read reconstruction.

Port of the single-device serving half of seaweedfs_tpu/ops/rs_resident.py.
A volume's surviving shards are pinned in device memory once
(DeviceShardCache); a burst of degraded needle reads then becomes one
ragged device call (reconstruct_intervals): one launch and one D2H, each
request fetched at its own length, nothing copied up (the work list and
bit masks ride in the kernel's parameters), only the reconstructed bytes
copied down, and no survivor byte crosses PCIe per read.

The calls run the hand-written kernel of csrc/fused_reconstruct.cu through
fused_reconstruct_ragged, and its uniform form through fused_reconstruct
(flat system) and fused_reconstruct_blockdiag (the g-group block-diagonal
system): one launch reads the survivors straight from the resident
buffers and writes only each request's wanted row.  A CPU tensor takes
the kernels' plain PyTorch versions below (the CPU tests); a CUDA tensor
takes the kernel or raises.

What differs from the JAX package:
  * one fused launch replaces each gather + select pallas_call pair (the
    split was a Mosaic layout workaround), so no gathered intermediate is
    written to device memory;
  * a burst is one ragged call, not one call per size bucket padded to
    COUNT_BUCKETS: the JAX package groups requests by size only so that
    XLA compiles few shapes, and the kernel here takes runtime shapes and
    a per-request fetch.  The returned bytes are the same;
  * nothing compiles per shape, so ColdShape is never raised (it stays a
    CacheMiss subclass so callers read the same).

The parity scrub (scrub_volume, scrub_all_resident) runs the hand-written
kernel of csrc/scrub.cu through `scrub`: the resident data shards are read
once, the parity is recomputed and compared in registers, and only the
int32 mismatch partials come down.

reconstruct_intervals is traced as the reference's is (obs/trace.py):
`batch_pack` around the packing, `device_execute` around the slot (launch
to the kernel's completion) and `d2h_copy` around each call's copy and
trim.  On the card each launch records an event right after the kernel
and another after its D2H, both enqueued before any wait: the drain waits
on the first inside `device_execute`, then opens `d2h_copy` around the
second, so the kernel's time never reads as copy time and the stream
never idles for the split.  Nothing is copied up (the work list rides in
the launch's parameters), so there is no `h2d_copy` span.  `hot_shapes`
keeps a dispatch count and a dispatch->ready latency EWMA per call class
(kernel, system, output size) for /debug/device/hot.

The mesh layout (parallel/mesh.py, -ec.serving.mesh.*): a lane-sharded
volume's stripes are spread over the mesh's lanes (stripe c on lane
c % n), and a burst is one ragged launch of the same kernel on every lane
with work, over the lane's own stripes at lane-local offsets, then one
D2H a lane (`_reconstruct_sharded`, the port of the reference's
`_sharded_gather_reconstruct`); no survivor byte crosses lanes.  In a pod
(torch.distributed, `global_mesh`) each process runs its own lanes and
one all_gather shares the rows.  The scrub checks a lane-sharded volume
lane by lane with the same scrub kernel.

Not ported here (ROADMAP): the XLA-fallback gather programs (B4), and the
AOT warm grid and observed-shape persistence (nothing compiles per shape
here).  make_batched_call takes one-device and whole-pinned volumes only.
The Store and the serving dispatcher that call reconstruct_intervals are
storage/store.py and serving/.
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

from ..obs import devledger
from ..obs import trace as obs_trace
from ..stats import metrics as stats_metrics
from ..parallel import mesh as mesh_mod
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


# bound per-call output (the sum of the call's fetches)
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
    """Per-slot reusable host staging: a pinned uint8 result buffer for the
    calls' D2H, grown on demand up to _MAX_PENDING_OUT (plus one call).
    Nothing is staged for the way up: a call's work list and bit masks
    ride in the kernel's parameters."""

    def __init__(self):
        self.result = torch.empty(0, dtype=torch.uint8, pin_memory=True)

    def ensure_result(self, nbytes: int) -> torch.Tensor:
        """The result buffer, grown to hold `nbytes` (called only while no
        D2H into it is pending)."""
        if self.result.numel() < nbytes:
            self.result = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return self.result


class PipelineSlot:
    """What DevicePipeline.slot() yields: the slot-acquisition wait and,
    for each lane, the slot's staging arena and CUDA stream on the lane's
    device (`on(lane)`; both None on the CPU, where a slot stages into
    fresh tensors and runs in order).  `arena` and `stream` are the first
    local lane's."""

    __slots__ = ("wait_s", "_lane", "_pipe")

    def __init__(self, wait_s: float, lane: dict, pipe: "DevicePipeline"):
        self.wait_s = wait_s
        self._lane = lane
        self._pipe = pipe

    def on(self, lane: int | None = None) -> tuple:
        """(arena, stream) of `lane` (default: the first local lane),
        made on first use; one holder uses a slot at a time."""
        lane = self._pipe.primary if lane is None else lane
        got = self._lane.get(lane)
        if got is None:
            got = self._lane[lane] = self._pipe._resources(lane)
        return got

    @property
    def arena(self):
        return self.on()[0]

    @property
    def stream(self):
        return self.on()[1]


class DevicePipeline:
    """Staging gate for the device leg of batched reconstruct calls:
    `slots=2` lets batch N+1 pack (outside the slot) and ship + execute
    (inside it) on its own stream while batch N drains its D2H.  `slots=1`
    is the serial baseline.  `last_overlap` is device-section busy seconds
    over wall seconds of the current batch window (>1 means two slots
    genuinely overlapped); `total_busy_s` never resets.  `h2d_bytes` and
    `d2h_bytes` count what the calls moved across PCIe.  `devices` are
    the mesh lanes' devices (None for another process's lane); the
    default is the one `device`."""

    def __init__(self, slots: int = 2, device="cpu", devices=None):
        self.devices = ([torch.device(device)] if devices is None else
                        [None if d is None else torch.device(d)
                         for d in devices])
        self.primary = next(i for i, d in enumerate(self.devices)
                            if d is not None)
        self.device = self.devices[self.primary]
        self._cond = threading.Condition()
        self._slots = max(1, slots)
        self._active = 0
        self._busy_s = 0.0
        self.total_busy_s = 0.0
        self._window_t0 = 0.0
        self.last_overlap = 0.0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        # one {lane: (arena, stream)} per concurrently held slot, grown
        # on demand
        self._lanes: list[dict] = []
        self._free: list[int] = []

    @property
    def slots(self) -> int:
        return self._slots

    def set_slots(self, n: int) -> None:
        with self._cond:
            self._slots = max(1, int(n))
            self._cond.notify_all()

    def _resources(self, lane: int) -> tuple:
        dev = self.devices[lane]
        if dev is None:
            raise ValueError(f"lane {lane} belongs to another process")
        if dev.type != "cuda":
            return (None, None)
        return (StagingArena(), torch.cuda.Stream(device=dev))

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
            with self._cond:
                self._lanes.append({})
                idx = len(self._lanes) - 1
        t0 = time.perf_counter()
        try:
            yield PipelineSlot(t0 - t_req, self._lanes[idx], self)
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
                    stats_metrics.VOLUME_SERVER_EC_OVERLAP_FRACTION.set(
                        self.last_overlap)
                self._cond.notify()
            # the slot's seconds are the device section's busy time, so the
            # ledger's per-class sums conserve against total_busy_s (the
            # workload and device ride the caller's context)
            devledger.record(busy_s=dur, queue_wait_s=t0 - t_req)


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
    """LRU cache of EC shard bytes pinned in device memory.

    Keyed by (vid, shard_id).  `budget_bytes` bounds padded device bytes;
    inserting past the budget evicts least-recently-used shards (whole
    shards: a partially resident volume fails over to the host path via
    CacheMiss).  Each shard is padded to its true size + MAX_TILE, rounded
    up to `shard_quantum`, so a request window never runs past the buffer.
    `device` defaults to "cuda" and raises without a card.

    Mesh residency (-ec.serving.mesh.*): with `mesh_devices` set (0 =
    every local device of the cache's type, n = the first n; a mesh of one
    degrades to the one-device layout) or an explicit `mesh`
    (parallel/mesh.py; lanes may share a device), the cache lays volumes
    out across the lanes.  A volume whose shard files reach
    `mesh_min_shard_bytes` is lane-sharded: its padded buffer splits into
    `stripe`-byte stripes and stripe c lives on lane c % n (owner-major:
    lane d holds stripes d, d+n, d+2n, ... back to back), so the volume's
    resident capacity is every lane's budget and a batch's work splits
    over the lanes.  Smaller volumes pin whole onto the least-loaded lane.
    Budgets are kept per lane (`budget_bytes / n` each): eviction pressure
    targets the lane that is actually full, and the residency ladder
    judges each lane's fit (serving/tiering.py).

    Pod mode (`global_mesh=True`, -ec.mesh.*): the mesh spans every
    process of a torch.distributed group, and each process holds only its
    own lanes' stripes.  The mesh/whole choice is a pure function of the
    shard size, a whole pin lands on one of this process's lanes, and
    eviction is partitioned (mesh puts evict only mesh-placed victims,
    judged by mesh bytes alone; whole-pin puts never evict them), so the
    set of mesh-placed volumes is the same on every process."""

    def __init__(
        self,
        budget_bytes: int = 8 << 30,
        shard_quantum: int = SHARD_QUANTUM,
        layout: str = "flat",
        groups: int = rs_cuda.BLOCKDIAG_GROUPS,
        device="cuda",
        mesh_devices: int | None = None,
        mesh_min_shard_bytes: int = 8 << 20,
        global_mesh: bool = False,
        mesh=None,
    ):
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
        # the serving mesh: None = the one-device layout.  mesh_devices
        # None keeps it off; a resolved 1-wide mesh degrades to None
        if mesh is None and mesh_devices is not None:
            build = (mesh_mod.global_serving_mesh if global_mesh
                     else mesh_mod.serving_mesh)
            mesh = build(mesh_devices, self.device.type)
        if mesh is not None and mesh.size < 2:
            mesh = None
        self.mesh = mesh
        self.n_devices = mesh.size if mesh is not None else 1
        # pod bookkeeping: the hosts the mesh spans and this process's
        # lanes (every lane in one process)
        self.n_hosts = max(1, len(mesh_mod.mesh_hosts(mesh)))
        self.multiprocess = self.n_hosts > 1
        if mesh is not None:
            self._local_dev_indices = mesh.local_lanes()
            if not self._local_dev_indices:
                raise ValueError("the mesh holds no lane of this process")
            self.lane_devices = [
                _resolve_device(d) if i in self._local_dev_indices else None
                for i, d in enumerate(mesh.devices)
            ]
            self.device = self.lane_devices[self._local_dev_indices[0]]
        else:
            self._local_dev_indices = [0]
            self.lane_devices = [self.device]
        self.mesh_min_shard_bytes = mesh_min_shard_bytes
        # interleaved stripe width of the lane-sharded layout: stripe c
        # lives on lane c % n.  Interleaving keeps ownership even at any
        # volume size (a contiguous chunk a lane would park a small
        # volume and every hot byte range on the first lanes).  Each
        # stripe holds the largest window placeable in it and stays
        # FUSED_ALIGN-aligned.
        self.stripe = 0
        if self.mesh is not None:
            q = self.n_devices * max(FUSED_ALIGN, SIZE_BUCKETS[0])
            self.quantum = -(-self.quantum // q) * q
            self.stripe = self.quantum // self.n_devices
        # mutable at run time: the bytes are layout-agnostic (blockdiag
        # segments are contiguous slices of the same flat buffers)
        self.layout = layout
        self.groups = groups
        self.pipeline = DevicePipeline(devices=self.lane_devices)
        self._lock = threading.Lock()
        # key -> buffer (a whole pin), or one buffer a lane (lane-sharded;
        # None for another process's lane)
        self._arrays: OrderedDict[tuple[int, int], object] = OrderedDict()
        self._true_sizes: dict[tuple[int, int], int] = {}
        # key -> the event(s) recorded after the put's copies: a reader on
        # another stream waits on them before it touches the bytes
        self._ready: dict[tuple[int, int], object] = {}
        # vid -> the disk-location directory whose shard files were pinned
        self._pin_source: dict[int, str] = {}
        self._vid_counts: dict[int, int] = {}
        # padded bytes held a lane, and the mesh-placed share of them (the
        # pressure signal of the pod's partitioned eviction)
        self._dev_bytes: list[int] = [0] * self.n_devices
        self._mesh_dev_bytes: list[int] = [0] * self.n_devices
        # vid -> "mesh" | lane index, claimed at the first put
        self._vid_place: dict[int, object] = {}
        # key -> (place, padded size): what evicting the key frees
        self._foot: dict[tuple[int, int], tuple[object, int]] = {}
        self.evictions = 0
        self.pin_claims = 0
        # puts in flight, puts started: the serving QoS reads them
        self._puts = [0, 0]

    def _padded_len(self, n: int) -> int:
        need = n + MAX_TILE
        return -(-need // self.quantum) * self.quantum

    # ------------------------------------------------- per-lane accounting

    @property
    def bytes_used(self) -> int:
        return sum(self._dev_bytes)

    @property
    def device_budget(self) -> int:
        """Per-lane budget: the total split evenly over the mesh."""
        return self.budget // self.n_devices

    def _shares(self, place, size: int) -> list[tuple[int, int]]:
        """(lane, padded bytes) pairs one buffer of `size` costs under
        `place` ("mesh" = an even split)."""
        if place == "mesh":
            per = size // self.n_devices
            return [(d, per) for d in range(self.n_devices)]
        return [(int(place), size)]

    def _publish_dev_gauges(self) -> None:
        for d, used in enumerate(self._dev_bytes):
            stats_metrics.VOLUME_SERVER_EC_DEVICE_CACHE_BYTES.labels(
                device=str(d)
            ).set(used)

    def _place_for(self, shard_bytes: int):
        """The placement rule (caller holds the lock): lane-sharded for
        volumes worth spreading, a pure function of the size so every
        process of a pod claims alike; else whole onto the least-loaded
        lane of this process."""
        if self.mesh is None:
            return 0
        if shard_bytes >= self.mesh_min_shard_bytes:
            return "mesh"
        return min(self._local_dev_indices, key=lambda d: self._dev_bytes[d])

    def _claim_place_locked(self, vid: int, shard_bytes: int):
        """The first put of a vid claims its placement; later puts follow
        the claim (one volume never straddles placements)."""
        place = self._vid_place.get(vid)
        if place is None:
            place = self._vid_place[vid] = self._place_for(shard_bytes)
        return place

    def placement(self, vid: int):
        """"mesh" | lane index | None (nothing of `vid` was placed)."""
        with self._lock:
            return self._vid_place.get(vid)

    def vid_sharded(self, vid: int) -> bool:
        with self._lock:
            return self._vid_place.get(vid) == "mesh"

    def device_stats(self) -> list[dict]:
        """Per-lane [{"used_bytes", "budget_bytes"}]."""
        budget = self.device_budget
        with self._lock:
            return [{"used_bytes": used, "budget_bytes": budget}
                    for used in self._dev_bytes]

    def pressure_devices(self) -> list[int]:
        """Lanes over their budget, fullest first."""
        budget = self.device_budget
        with self._lock:
            over = [(used - budget, d) for d, used in enumerate(self._dev_bytes)
                    if used > budget]
        return [d for _, d in sorted(over, reverse=True)]

    def device_bytes_by_vid(self) -> dict[int, dict[int, int]]:
        """vid -> {lane -> padded bytes} in one locked pass."""
        out: dict[int, dict[int, int]] = {}
        with self._lock:
            for (vid, _sid), (place, size) in self._foot.items():
                dev = out.setdefault(vid, {})
                for d, share in self._shares(place, size):
                    dev[d] = dev.get(d, 0) + share
        return out

    def plan_pin(self, n_shards: int, shard_bytes: int,
                 vid: int | None = None) -> dict[int, int]:
        """lane -> padded bytes a full pin of (n_shards x shard_bytes)
        would add.  An existing claim of `vid` wins over the least-loaded
        preview: an evicted volume keeps its claim, and its re-pin lands
        back there."""
        padded = self._padded_len(shard_bytes)
        with self._lock:
            place = self._vid_place.get(vid) if vid is not None else None
            if place is None:
                place = self._place_for(shard_bytes)
        return {d: n_shards * share
                for d, share in self._shares(place, padded)}

    def pin_activity(self) -> tuple[int, int]:
        """(puts in flight, puts started so far)."""
        with self._lock:
            return self._puts[0], self._puts[1]

    def _device_of(self, place):
        """The device a whole pin stages to, or every lane's device (None
        for another process's) for a lane-sharded one."""
        if place == "mesh":
            return self.lane_devices
        return self.lane_devices[int(place)]

    def put(self, vid: int, shard_id: int, data) -> None:
        with self._lock:
            self._puts[0] += 1
            self._puts[1] += 1
        try:
            self._put(vid, shard_id, data)
        finally:
            with self._lock:
                self._puts[0] -= 1

    def _stage(self, host: np.ndarray, padded: int, dev):
        """A padded buffer of `host` on `dev` (true bytes at its head, the
        tail zeroed there: no padded host copy), with its ready event."""
        buf = torch.empty(padded, dtype=torch.uint8, device=dev)
        if host.size:
            buf[: host.size].copy_(torch.from_numpy(host))
        buf[host.size:].zero_()
        return buf, _record_ready(dev)

    def _stage_lanes(self, host: np.ndarray, padded: int, devs):
        """This process's lanes of a lane-sharded buffer: lane d gets
        stripes d, d+n, ... of the padded bytes back to back, plus a
        groups*FUSED_ALIGN zero tail (a block-diagonal fetch rounds its
        window up past the last stripe's end)."""
        n, stripe = self.n_devices, self.stripe
        per = padded // n
        bufs, events = [], []
        for d, dev in enumerate(devs):
            if dev is None:
                bufs.append(None)
                events.append(None)
                continue
            buf = torch.zeros(per + self.groups * FUSED_ALIGN,
                              dtype=torch.uint8, device=dev)
            for j, c in enumerate(range(d, padded // stripe, n)):
                lo = c * stripe
                if lo >= host.size:
                    break
                src = host[lo : min(lo + stripe, host.size)]
                buf[j * stripe : j * stripe + src.size].copy_(
                    torch.from_numpy(src))
            bufs.append(buf)
            events.append(_record_ready(dev))
        return bufs, events

    def _put(self, vid: int, shard_id: int, data) -> None:
        host = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)
        ) else np.asarray(data, dtype=np.uint8).reshape(-1)
        if not host.flags.writeable:  # torch.from_numpy wants it writable
            host = host.copy()
        with self._lock:
            place = self._claim_place_locked(vid, host.size)
        padded = self._padded_len(host.size)
        if place == "mesh":
            arr, ready = self._stage_lanes(host, padded, self._device_of(place))
        else:
            arr, ready = self._stage(host, padded, self._device_of(place))
        key = (vid, shard_id)
        shares = self._shares(place, padded)
        budget = self.device_budget
        with self._lock:
            if self._vid_place.get(vid) != place:
                # the claim this buffer was staged for vanished (evict()
                # or clear() between the claim and here): drop it rather
                # than let one vid straddle placements
                return
            if key in self._arrays:
                self._drop_key_locked(key)
            # evict while any lane the incoming buffer lands on would pass
            # its budget: LRU order, only keys holding bytes on an
            # over-budget lane.  One forward pass: dropping victims only
            # shrinks the over set.  The pod's partition: mesh puts judge
            # mesh bytes and evict only mesh victims; whole-pin puts never
            # evict a mesh victim.
            mesh_only = self.multiprocess and place == "mesh"
            skip_mesh = self.multiprocess and place != "mesh"
            pressure = self._mesh_dev_bytes if mesh_only else self._dev_bytes
            lru = iter(list(self._arrays))
            while self._arrays:
                over = {d for d, share in shares
                        if pressure[d] + share > budget}
                if not over:
                    break
                victim = next(
                    (k for k in lru
                     if not (mesh_only and self._foot[k][0] != "mesh")
                     and not (skip_mesh and self._foot[k][0] == "mesh")
                     and any(d in over
                             for d, _ in self._shares(*self._foot[k]))),
                    None,
                )
                if victim is None:
                    break  # the pressure is on lanes nothing else holds
                self._drop_key_locked(victim)
                self.evictions += 1
                # the evicted vid keeps its pin-source claim and its
                # placement: only explicit evict()/clear() release them
            self._arrays[key] = arr
            self._true_sizes[key] = host.size
            self._ready[key] = ready
            self._foot[key] = (place, padded)
            self._vid_counts[vid] = self._vid_counts.get(vid, 0) + 1
            for d, share in shares:
                self._dev_bytes[d] += share
                if place == "mesh":
                    self._mesh_dev_bytes[d] += share
            self._publish_dev_gauges()

    def _drop_key_locked(self, key: tuple[int, int]) -> None:
        self._arrays.pop(key)
        self._true_sizes.pop(key, None)
        self._ready.pop(key, None)
        place, size = self._foot.pop(key)
        for d, share in self._shares(place, size):
            self._dev_bytes[d] -= share
            if place == "mesh":
                self._mesh_dev_bytes[d] -= share
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
        """The resident buffer (a lane list when lane-sharded) or None."""
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
            self._publish_dev_gauges()

    def clear(self) -> None:
        with self._lock:
            self._arrays.clear()
            self._true_sizes.clear()
            self._ready.clear()
            self._pin_source.clear()
            self._vid_counts.clear()
            self._vid_place.clear()
            self._foot.clear()
            self._dev_bytes = [0] * self.n_devices
            self._mesh_dev_bytes = [0] * self.n_devices
            self._publish_dev_gauges()


def _record_ready(dev):
    """An event after the work queued so far on `dev`'s current stream
    (None on the CPU, where copies are done when they return)."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


# --- planner helpers (copied from the JAX package, pinned equal by tests) --


def _plan(requests: list[tuple[int, int, int]], l_loc: int = 0):
    """Split/align requests into device sub-requests.

    Each request (wanted_shard, offset, size) becomes >=1 sub-requests
    (req_index, aligned_off, delta, take, bucket) with delta+take <= bucket.

    `l_loc` > 0 is the mesh layout's stripe width: every
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


def _offsets(fetches: np.ndarray) -> np.ndarray:
    """Each request's byte offset in the packed output."""
    fetches = np.asarray(fetches, dtype=np.int64)
    return np.cumsum(fetches) - fetches


def _fused_reconstruct_ragged_torch(a, survivors, words, fetches, *, k_true,
                                    w_true, groups, tile):
    """Plain version of a ragged call, built from the uniform plain versions
    one fetch length at a time: request n's [fetches[n]] bytes land at its
    offset in one packed output.  -> [sum(fetches)] u8."""
    words = np.asarray(words, dtype=np.int64)
    fetches = np.asarray(fetches, dtype=np.int64)
    dev = survivors[0].device
    offsets = _offsets(fetches)
    out = torch.empty(int(fetches.sum()), dtype=torch.uint8, device=dev)
    for f in np.unique(fetches).tolist():
        idx = np.flatnonzero(fetches == f)
        meta = torch.from_numpy(words[idx].astype(np.int32))
        if groups > 1:
            y = _fused_reconstruct_blockdiag_torch(
                a, survivors, meta, tile=tile, fetch=f, k_true=k_true,
                w_true=w_true, groups=groups)
        else:
            y = _fused_reconstruct_torch(a, survivors, meta, tile=f, fetch=f,
                                         k_true=k_true)
        pos = torch.from_numpy(offsets[idx])[:, None] + torch.arange(f)
        out[pos.reshape(-1).to(dev)] = y.reshape(-1)
    return out


# --- the kernel's work list (a model of its launch entry) and bit masks ------

# csrc/fused_reconstruct.cu's constants (checked against the library when it
# loads): bytes one block covers, and the most work entries one launch
# takes (its largest parameter block)
RAGGED_SPAN = 4096
RAGGED_MAX_BLOCKS = 3816
# a work entry is two uint32: x = (survivor offset in KiB) << 5 | row, the
# meta word advanced by the span; y = (output offset in KiB) << _OUT_SHIFT
# | (tile phase in KiB) << _LEN_BITS | (length in KiB - 1)
_LEN_BITS = 2
_PHASE_BITS = 10
_OUT_SHIFT = _LEN_BITS + _PHASE_BITS


def _work_list(words, fetches, groups: int, tile: int) -> np.ndarray:
    """Model of the work list the launch entry of csrc/fused_reconstruct.cu
    builds (held equal to it on the card): one entry per (request,
    RAGGED_SPAN span), requests in order, spans in order, outputs packed
    in that order.  -> [blocks, 2] int64 (x, y), y's output field not yet
    rebased to a launch."""
    words = np.asarray(words, dtype=np.int64)
    fk = np.asarray(fetches, dtype=np.int64) // FUSED_ALIGN
    span_kib = RAGGED_SPAN // FUSED_ALIGN
    nb = -(-fk // span_kib)
    req = np.repeat(np.arange(fk.size), nb)
    first = _offsets(nb)
    pos = (np.arange(int(nb.sum())) - np.repeat(first, nb)) * span_kib
    length = np.minimum(span_kib, fk[req] - pos)
    phase = pos % (tile // FUSED_ALIGN) if groups > 1 else np.zeros_like(pos)
    out_kib = _offsets(fk)[req] + pos
    x = words[req] + (pos << META_ROW_BITS)
    y = (out_kib << _OUT_SHIFT) | (phase << _LEN_BITS) | (length - 1)
    return np.stack([x, y], axis=1)


def _launch_lists(work: np.ndarray) -> list[tuple[int, np.ndarray]]:
    """Model of how the launch entry splits a work list into launches of
    at most RAGGED_MAX_BLOCKS entries: -> [(output byte offset of the
    launch, its [n, 2] uint32 list with output offsets relative to
    it)]."""
    out = []
    for lo in range(0, len(work), RAGGED_MAX_BLOCKS):
        chunk = work[lo : lo + RAGGED_MAX_BLOCKS].copy()
        base = int(chunk[0, 1]) >> _OUT_SHIFT
        chunk[:, 1] -= base << _OUT_SHIFT
        if int(chunk.max()) >= 1 << 32:
            raise ValueError("a launch's work entry exceeds 32 bits")
        out.append((base * FUSED_ALIGN, chunk.astype(np.uint32)))
    return out


def _launch_model(work: np.ndarray, masks: np.ndarray, survivors, *,
                  rows: int, groups: int, tile: int,
                  out_len: int) -> tuple[np.ndarray, np.ndarray]:
    """numpy model of one launch of csrc/fused_reconstruct.cu: each block
    decodes its entry and each of its threads reads its 16 bytes of every
    survivor, applies the row's masks (parity of mask & byte for each output
    bit) and writes its 16 bytes.  -> (out [out_len] u8, writes [out_len]:
    how many threads wrote each byte)."""
    out = np.zeros(out_len, dtype=np.uint8)
    writes = np.zeros(out_len, dtype=np.int64)
    k = len(survivors)
    table = masks.reshape(groups, rows, 8, 16)
    local = np.arange(RAGGED_SPAN // 16) * 16
    for x, y in work.astype(np.int64):
        length = ((y & ((1 << _LEN_BITS) - 1)) + 1) * FUSED_ALIGN
        lanes = local[local < length]  # threads past the length return
        row = x & _META_ROW_MASK
        src = (x >> META_ROW_BITS) * FUSED_ALIGN + lanes
        jg = np.zeros_like(lanes)
        if groups > 1:
            phase = (y >> _LEN_BITS) & ((1 << _PHASE_BITS) - 1)
            jg = ((phase * FUSED_ALIGN + lanes) % tile) // (tile // groups)
        cols = (src[:, None] + np.arange(16)).reshape(-1)
        xs = np.stack([s[cols] for s in survivors])  # [k, lanes*16]
        m = table[np.repeat(jg, 16), row][:, :, :k].transpose(1, 2, 0)
        par = np.bitwise_xor.reduce(m & xs[None], axis=1)  # [8, lanes*16]
        bits = (np.unpackbits(par[..., None], axis=-1).sum(-1) & 1).astype(
            np.int64)
        dst = ((y >> _OUT_SHIFT) * FUSED_ALIGN + lanes[:, None]
               + np.arange(16)).reshape(-1)
        out[dst] = (bits << np.arange(8)[:, None]).sum(0)
        np.add.at(writes, dst, 1)
    return out, writes


def _bit_masks(a: torch.Tensor, k: int, rows: int, groups: int,
               w_true: int) -> np.ndarray:
    """The kernel's mask table: [groups*rows*8, 16] u8 whose row
    (jg*rows + r)*8 + i holds at byte s < k the mask of survivor s for
    output bit i of wanted row r in group jg: bit j is set iff
    A[i*m_pad + jg*w_true + r, j*k_pad + jg*k + s] != 0.  Computed once per
    prepared system and kept on the tensor (a matrix on the card is read
    back once)."""
    key = (a._version, k, rows, groups, w_true if groups > 1 else 0)
    kept = getattr(a, "_swfs_bit_masks", None)
    if kept is None:
        kept = {}
        a._swfs_bit_masks = kept
    if key not in kept:
        m_pad, k_pad = a.shape[0] // 8, a.shape[1] // 8
        bits = (a.cpu().numpy() != 0).reshape(8, m_pad, 8, k_pad)
        weights = (1 << np.arange(8)).reshape(1, 1, 8, 1)
        table = np.zeros((groups, rows, 8, 16), dtype=np.uint8)
        for jg in range(groups):
            r0 = jg * w_true if groups > 1 else 0
            sub = bits[:, r0 : r0 + rows, :, jg * k : jg * k + k]
            # rows past m_pad (a flat w_true above it) stay zero
            table[jg, : sub.shape[1], :, :k] = (
                (sub * weights).sum(axis=2).transpose(1, 0, 2))
        kept[key] = table.reshape(-1, 16)
    return kept[key]


# --- the kernels ------------------------------------------------------------

# counts of the two wrappers' `.launches`, bumped from several threads
_launch_lock = threading.Lock()


def _check_system(a, survivors, k_true, w_true, groups, tile) -> None:
    """Host checks of the matrix, the survivors and the block-diagonal
    tile, shared by every route; raises on any violation."""
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
    m_pad, k_pad = a.shape[0] // 8, a.shape[1] // 8
    if groups * k > k_pad:
        raise ValueError(f"{groups}x{k} survivor columns exceed k_pad {k_pad}")
    if groups > 1:
        if tile <= 0 or tile % (groups * FUSED_ALIGN):
            raise ValueError(f"tile {tile} is not a multiple of "
                             f"{groups}*{FUSED_ALIGN}")
        if groups * w_true > m_pad:
            raise ValueError(f"{groups}x{w_true} rows exceed m_pad {m_pad}")


def _check_windows(a, survivors, words: np.ndarray, fetches: np.ndarray,
                   w_true) -> None:
    """Every request's window inside the survivors and its row inside the
    wanted rows (all of the matrix's rows when w_true is None)."""
    if not words.size:
        return
    if int(words.min()) < 0:
        raise ValueError("negative meta word")
    if int(words.max()) >= 1 << 31:
        raise ValueError("meta word exceeds 31 bits")
    length = min(s.numel() for s in survivors)
    ends = (words >> META_ROW_BITS) * FUSED_ALIGN + fetches
    if int(ends.max()) > length:
        j = int(ends.argmax())
        raise ValueError(
            f"request window {int(words[j] >> META_ROW_BITS) * FUSED_ALIGN}"
            f"+{int(fetches[j])} runs past the {length}-byte survivors"
        )
    row_max = int((words & _META_ROW_MASK).max())
    rows = w_true if w_true is not None else a.shape[0] // 8
    if row_max >= rows:
        raise ValueError(f"wanted row {row_max} >= {rows}")


def _check_call(a, survivors, meta, tile, fetch, k_true, w_true, groups) -> None:
    """Host checks of a uniform call, shared by both routes; raises on any
    violation."""
    _check_system(a, survivors, k_true, w_true, groups, tile)
    if meta.dtype != torch.int32 or meta.dim() != 1:
        raise TypeError("meta must be a 1-D int32 tensor")
    if fetch <= 0 or tile <= 0 or fetch % tile or fetch % FUSED_ALIGN:
        raise ValueError(f"fetch {fetch} must be a positive multiple of the "
                         f"tile {tile} and of {FUSED_ALIGN}")
    words = meta.cpu().numpy().astype(np.int64)
    _check_windows(a, survivors, words, np.full(words.size, fetch), w_true)


@functools.cache
def _kernel_lib():
    """The kernel library, its constants checked against this module's."""
    lib = _build.kernels()
    span, blocks = ctypes.c_int(), ctypes.c_int()
    lib.fused_reconstruct_limits(ctypes.byref(span), ctypes.byref(blocks))
    if (span.value, blocks.value) != (RAGGED_SPAN, RAGGED_MAX_BLOCKS):
        raise RuntimeError(
            f"csrc/fused_reconstruct.cu has span {span.value} and "
            f"{blocks.value} entries a launch; rs_resident expects "
            f"{RAGGED_SPAN} and {RAGGED_MAX_BLOCKS}"
        )
    return lib


def _launch(wrapper, a, survivors, words, fetches, w_true, groups, tile):
    """Run csrc/fused_reconstruct.cu over one ragged list on the current
    stream (groups 1: the flat system) and add to `wrapper.launches` the
    launches it made: one, or more where the list does not fit one
    launch's parameters.  `words` and `fetches` are host sequences; the
    launch entry builds the work list (_work_list is its model).  -> (out
    [sum(fetches)] u8, offsets [N], parameter bytes sent)."""
    if any(s.data_ptr() % 16 for s in survivors):
        raise ValueError("survivor buffers must be 16-byte aligned")
    words = np.ascontiguousarray(words, dtype=np.int32)
    fetches = np.asarray(fetches, dtype=np.int64)
    fetch_kib = np.ascontiguousarray(fetches // FUSED_ALIGN, dtype=np.int32)
    # the mask table's rows per group (the C entry refuses more than its
    # 16 (group, row) sets, and a block-diagonal tile past 1 MiB)
    rows = w_true if groups > 1 or w_true is not None else int(
        (words & _META_ROW_MASK).max(initial=0)) + 1
    k = len(survivors)
    dev = survivors[0].device
    out = torch.empty(int(fetches.sum()), dtype=torch.uint8, device=dev)
    offsets = _offsets(fetches)
    if not words.size:
        return out, offsets, 0
    lib = _kernel_lib()
    masks = _bit_masks(a, k, rows, groups, w_true)
    launches, sent = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(dev):
        ptrs = (ctypes.c_void_p * k)(*[s.data_ptr() for s in survivors])
        rc = lib.fused_reconstruct_launch(
            masks.ctypes.data, rows, groups, tile, ptrs, k, words.ctypes.data,
            fetch_kib.ctypes.data, words.size, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(launches),
            ctypes.byref(sent))
    with _launch_lock:
        wrapper.launches += launches.value
    if rc != 0:
        raise RuntimeError(
            f"fused_reconstruct_launch failed ({rc}): "
            f"{lib.fused_reconstruct_error_string(rc).decode()}"
        )
    return out, offsets, sent.value


def fused_reconstruct(a_bm, survivors, meta, *, tile, fetch, k_true,
                      w_true=None):
    """The flat fused gather + reconstruct + select (the port of the JAX
    `_fused_reconstruct`, K2+K3): survivors is a tuple of [L] u8 resident
    shards in matrix column order, meta [N] int32 packed words.  -> [N,
    fetch] u8, the raw reconstruction from each request's FUSED_ALIGN-
    aligned offset (the caller trims the delta).  CPU survivors take the
    plain version; CUDA survivors launch csrc/fused_reconstruct.cu with a
    uniform work list on the current stream or raise (meta is read on the
    host: its words ride in the launch's parameters).  `w_true`, when
    given, bounds the rows.  `.launches` counts kernel launches, this
    wrapper's and fused_reconstruct_ragged's of the flat system."""
    _check_call(a_bm, survivors, meta, tile, fetch, k_true, w_true, 1)
    if survivors[0].device.type == "cpu":
        return _fused_reconstruct_torch(
            a_bm, survivors, meta, tile=tile, fetch=fetch, k_true=k_true
        )
    if survivors[0].device.type != "cuda":
        raise ValueError(f"no fused reconstruct for {survivors[0].device}")
    n = meta.numel()
    out, _, _ = _launch(fused_reconstruct, a_bm, survivors, meta.cpu().numpy(),
                        [fetch] * n, w_true, 1, fetch)
    return out.view(n, fetch)


fused_reconstruct.launches = 0


def fused_reconstruct_blockdiag(a_blk, survivors, meta, *, tile, fetch,
                                k_true, w_true, groups):
    """Block-diagonal twin (the port of `_fused_reconstruct_blockdiag`,
    K4+K5): each request's `tile` chunk splits into `groups` segments and
    segment jg is reconstructed through diagonal block jg of `a_blk`, row
    jg*w_true + row.  Same contract as fused_reconstruct; the caller
    guarantees tile % (groups*FUSED_ALIGN) == 0 and fetch % tile == 0
    (checked).  `.launches` counts this wrapper's launches and
    fused_reconstruct_ragged's of the block-diagonal system."""
    _check_call(a_blk, survivors, meta, tile, fetch, k_true, w_true, groups)
    if survivors[0].device.type == "cpu":
        return _fused_reconstruct_blockdiag_torch(
            a_blk, survivors, meta, tile=tile, fetch=fetch, k_true=k_true,
            w_true=w_true, groups=groups,
        )
    if survivors[0].device.type != "cuda":
        raise ValueError(f"no fused reconstruct for {survivors[0].device}")
    n = meta.numel()
    out, _, _ = _launch(fused_reconstruct_blockdiag, a_blk, survivors,
                        meta.cpu().numpy(), [fetch] * n, w_true, groups, tile)
    return out.view(n, fetch)


fused_reconstruct_blockdiag.launches = 0


def _ragged(a, survivors, words, fetches, *, k_true, w_true, groups, tile):
    """fused_reconstruct_ragged, with the parameter bytes its launches sent
    (0 on the CPU)."""
    _check_system(a, survivors, k_true, w_true, groups, tile)
    words = np.asarray(words, dtype=np.int64).reshape(-1)
    fetches = np.asarray(fetches, dtype=np.int64).reshape(-1)
    if words.shape != fetches.shape:
        raise ValueError(f"{words.size} meta words but {fetches.size} fetches")
    unit = tile if groups > 1 else FUSED_ALIGN
    if fetches.size and (int(fetches.min()) <= 0 or (fetches % unit).any()):
        raise ValueError(f"every fetch must be a positive multiple of {unit}")
    _check_windows(a, survivors, words, fetches, w_true)
    dev = survivors[0].device
    if dev.type == "cpu":
        out = _fused_reconstruct_ragged_torch(
            a, survivors, words, fetches, k_true=k_true, w_true=w_true,
            groups=groups, tile=tile)
        return out, _offsets(fetches), 0
    if dev.type != "cuda":
        raise ValueError(f"no fused reconstruct for {dev}")
    wrapper = fused_reconstruct_blockdiag if groups > 1 else fused_reconstruct
    return _launch(wrapper, a, survivors, words, fetches, w_true, groups, tile)


def fused_reconstruct_ragged(a, survivors, words, fetches, *, k_true, w_true,
                             groups, tile=None):
    """One call of the fused reconstruct over a ragged list: request n has
    its own packed meta word words[n] and its own fetch length fetches[n]
    (a multiple of FUSED_ALIGN flat, of `tile` block-diagonal; `tile`
    defaults to groups*FUSED_ALIGN).  groups 1 is the flat system (K2+K3),
    groups > 1 the block-diagonal one (K4+K5).  -> (out [sum(fetches)] u8,
    offsets [N]): request n's bytes are out[offsets[n] : offsets[n] +
    fetches[n]].  CPU survivors take the plain version; CUDA survivors
    launch csrc/fused_reconstruct.cu on the current stream, once, or once
    per RAGGED_MAX_BLOCKS work entries, each launch counted on
    fused_reconstruct.launches (flat) or fused_reconstruct_blockdiag.launches."""
    if tile is None:
        tile = groups * FUSED_ALIGN
    out, offsets, _ = _ragged(a, survivors, words, fetches, k_true=k_true,
                              w_true=w_true, groups=groups, tile=tile)
    return out, offsets


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


def _prepared_for(cache, rmat: np.ndarray, layout: str, dev) -> torch.Tensor:
    """The reconstruction system (flat or block-diagonal) on `dev`."""
    if layout == "blockdiag":
        return _prepared_blockdiag(rmat.tobytes(), *rmat.shape, cache.groups,
                                   str(dev))
    return rs_cuda._prepared(rmat.tobytes(), *rmat.shape, str(dev))


def _survivors(cache, vid, requests, data_shards, total_shards):
    """The reconstruction matrix of a batch and its resident survivors in
    column order -> (rmat, use, row_of, [(buffer, put event)]); a buffer
    is a lane list for a lane-sharded volume."""
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
    got = [cache._get_ready(vid, s) for s in use]
    if any(buf is None for buf, _ in got):  # evicted between listing and get
        raise CacheMiss(f"vid {vid}: survivor shard evicted mid-request")
    row_of = {sid: i for i, sid in enumerate(wanted)}
    return rmat, use, row_of, got


def _resolve_codec(cache, vid, requests, data_shards, total_shards, layout):
    """Reconstruction matrix (flat or block-diagonal, per the layout) on the
    survivors' device + the resident survivors of a one-device (or
    whole-pinned) volume in its column order, each with the event its put
    recorded."""
    rmat, use, row_of, got = _survivors(cache, vid, requests, data_shards,
                                        total_shards)
    survivors = tuple(buf for buf, _ in got)
    if isinstance(survivors[0], list):
        raise CacheMiss(f"vid {vid}: lane-sharded (placement changed)")
    a_prep = _prepared_for(cache, rmat, layout, survivors[0].device)
    events = [ev for _, ev in got if ev is not None]
    return a_prep, survivors, events, row_of, use, rmat.shape[0]


def _ragged_calls(subs, requests, row_of, groups: int) -> list[tuple]:
    """Pack a burst's sub-requests into ragged calls: each sub-request is
    fetched at its own delta+take rounded up to groups*FUSED_ALIGN (1 KiB
    flat, 4 KiB for g = 4), and a call ends only where one more
    sub-request would take its work list past one launch
    (RAGGED_MAX_BLOCKS) or its output past _MAX_CALL_OUT.  -> [(part,
    words, fetches, deltas)], part the call's [(sub index, sub)]."""
    part = list(enumerate(subs))
    words, deltas, _ = _fused_vectors(part, requests, row_of) if part else (
        [], [], 0)
    q = groups * FUSED_ALIGN
    calls: list[tuple] = []
    cur: list[int] = []
    blocks = out = 0
    for j, (_, s) in enumerate(part):
        fetch = -(-(deltas[j] + s[3]) // q) * q
        nb = -(-fetch // RAGGED_SPAN)
        if cur and (blocks + nb > RAGGED_MAX_BLOCKS
                    or out + fetch > _MAX_CALL_OUT):
            calls.append(cur)
            cur, blocks, out = [], 0, 0
        cur.append((j, fetch))
        blocks += nb
        out += fetch
    if cur:
        calls.append(cur)
    return [([part[j] for j, _ in c], [words[j] for j, _ in c],
             [f for _, f in c], [deltas[j] for j, _ in c]) for c in calls]


def _pack_calls(cache, vid, requests, layout, data_shards, total_shards):
    """Resolve the codec, split/align the requests (_plan) and pack them
    into ragged device calls: one for a burst, more only where
    _ragged_calls must split.  -> (calls, subs, survivors, events, a_prep,
    use, w_true, groups, tile)."""
    a_prep, survivors, events, row_of, use, w_true = _resolve_codec(
        cache, vid, requests, data_shards, total_shards, layout
    )
    groups = cache.groups if layout == "blockdiag" else 1
    subs = _plan(requests)
    calls = _ragged_calls(subs, requests, row_of, groups)
    tile = groups * FUSED_ALIGN
    return calls, subs, survivors, events, a_prep, use, w_true, groups, tile


def _dispatch_call(a_prep, survivors, words, fetches, n_use, w_true, groups,
                   tile):
    """Run one ragged call (flat or block-diagonal) -> (out, offsets,
    parameter bytes sent)."""
    return _ragged(a_prep, survivors, words, fetches, k_true=n_use,
                   w_true=w_true, groups=groups, tile=tile)


def _trim(out: np.ndarray, part, deltas, offsets, sub_out) -> None:
    """The host slices each sub-request's [delta, delta+take) out of the
    packed output."""
    for j, (sub_idx, (_, _, _, take, _)) in enumerate(part):
        lo = int(offsets[j]) + deltas[j]
        sub_out[sub_idx] = out[lo : lo + take].tobytes()


def reconstruct_intervals(
    cache: DeviceShardCache,
    vid: int,
    requests: list[tuple[int, int, int]],
    data_shards: int = DATA_SHARDS,
    total_shards: int = TOTAL_SHARDS,
    layout: str | None = None,
) -> list[bytes]:
    """Reconstruct interval bytes for a batch of degraded reads in one
    device call: one ragged launch and one D2H (more only where a burst
    outgrows one launch's work list or _MAX_CALL_OUT).

    requests: [(wanted_shard_id, shard_offset, size)].  All gather inputs
    are resident shards; each request is fetched at its own length
    (rounded up to 1 KiB, to groups*1 KiB block-diagonal).  Nothing is
    copied up: the work list and bit masks ride in the launch's
    parameters; the reconstructed bytes come down packed.  Raises
    CacheMiss, before any device work, when fewer than `data_shards`
    non-wanted shards of `vid` are resident.  `layout` (None = the
    cache's) picks the flat or block-diagonal kernel.  On the card the
    batch runs on its pipeline slot's stream: every call is enqueued
    (kernel, D2H into the slot's pinned buffer) before the first is waited
    on, and the calls drain once more than _MAX_PENDING_OUT bytes are
    pending.  -> one bytes per request, in order."""
    if not requests:
        return []
    if layout is None:
        layout = cache.layout
    if layout not in LAYOUTS:
        raise ValueError(f"unknown resident layout {layout!r}")
    place = cache.placement(vid)
    if place == "mesh":
        return _reconstruct_sharded(cache, vid, requests, layout,
                                    data_shards, total_shards)
    lane = 0 if place is None else int(place)
    with obs_trace.span(
        "batch_pack", requests=len(requests), layout=layout
    ):
        (calls, subs, survivors, events, a_prep, use, w_true, groups,
         tile) = _pack_calls(cache, vid, requests, layout, data_shards,
                             total_shards)
    kernel = (fused_reconstruct_blockdiag if groups > 1
              else fused_reconstruct).__name__
    keys = [_call_key(kernel, groups, w_true, sum(fetches), len(part))
            for part, _, fetches, _ in calls]
    # the device-execute stage of the request trace: the launches up to
    # each kernel's completion, annotated with what the batch moved
    dev_span = obs_trace.span(
        "device_execute", requests=len(requests), layout=layout,
        kernel=kernel,
    )
    sub_out: list[bytes | None] = [None] * len(subs)
    pipe = cache.pipeline
    with devledger.device(str(lane) if cache.mesh is not None else "default"
                          ), pipe.slot() as pslot, dev_span:
        if pslot.on(lane)[1] is None:
            h2d = d2h = 0
            for (part, words, fetches, deltas), key in zip(calls, keys):
                t_dispatch = time.perf_counter()
                out, offsets, _ = _dispatch_call(
                    a_prep, survivors, words, fetches, len(use), w_true,
                    groups, tile)
                _note_call_latency(key, time.perf_counter() - t_dispatch)
                with obs_trace.span("d2h_copy", bytes=int(out.numel())):
                    _trim(out.numpy(), part, deltas, offsets, sub_out)
                d2h += int(out.numel())
        else:
            h2d, d2h = _run_on_stream(pipe, pslot.on(lane), lane, calls, keys,
                                      survivors, events, a_prep, len(use),
                                      w_true, groups, tile, sub_out)
        # the reference's keys: no call compiles here (compile_misses 0),
        # and h2d_bytes are the launches' parameter bytes
        dev_span.annotate(
            device_calls=len(calls), compile_misses=0, h2d_bytes=h2d,
            d2h_bytes=d2h, slot_wait_us=int(pslot.wait_s * 1e6),
        )
        # busy seconds and queue wait are the slot's (recorded on exit);
        # dispatches and boundary bytes are this batch's
        devledger.record(dispatches=len(calls),
                         nbytes=h2d + d2h if pslot.on(lane)[1] is not None
                         else 0)
    outputs: list[list[bytes]] = [[] for _ in requests]
    for (idx, *_), piece in zip(subs, sub_out):
        outputs[idx].append(piece)  # subs are in offset order per request
    return [b"".join(parts) for parts in outputs]


def _run_on_stream(pipe, resources, lane, calls, keys, survivors, events,
                   a_prep, n_use, w_true, groups, tile,
                   sub_out) -> tuple[int, int]:
    """Enqueue and drain a batch's calls on the slot's stream of `lane`
    (`resources`: its arena and stream); -> the bytes they moved across
    PCIe (parameters up, results down).  Each
    call enqueues its launch, an event (`ready`), its D2H and a second
    event (`done`) before anything is waited on; the drain waits on
    `ready` inside the caller's device_execute span, then on `done`
    inside a d2h_copy span."""
    arena, stream = resources
    h2d = d2h = 0
    pending: list[tuple] = []

    def drain() -> None:
        for part, deltas, offsets, host, ready, done, key, t0 in pending:
            ready.synchronize()  # the kernel's completion boundary
            _note_call_latency(key, time.perf_counter() - t0)
            with obs_trace.span("d2h_copy", bytes=int(host.numel())):
                done.synchronize()
                _trim(host.numpy(), part, deltas, offsets, sub_out)
        pending.clear()

    with torch.cuda.device(pipe.devices[lane]), torch.cuda.stream(stream):
        # the survivors were written on the put's stream, and an eviction
        # during the batch must not hand their blocks to another allocation
        # while this stream still reads them
        for ev in events:
            stream.wait_event(ev)
        for s in survivors:
            s.record_stream(stream)
        sizes = [sum(fetches) for _, _, fetches, _ in calls]
        # one pinned buffer for the batch's results, grown only here while
        # nothing is pending; more than _MAX_PENDING_OUT drains first
        result = arena.ensure_result(
            max(max(sizes), min(sum(sizes), _MAX_PENDING_OUT))
        )
        off = 0
        for (part, words, fetches, deltas), nbytes, key in zip(
                calls, sizes, keys):
            if pending and off + nbytes > result.numel():
                drain()
                off = 0
            t0 = time.perf_counter()
            out, offsets, sent = _dispatch_call(
                a_prep, survivors, words, fetches, n_use, w_true, groups,
                tile)
            ready = torch.cuda.Event()
            ready.record(stream)
            host = result[off : off + nbytes]
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
            pending.append((part, deltas, offsets, host, ready, done, key,
                            t0))
            off += nbytes
            # the work list and masks cross PCIe in the launch itself
            pipe.h2d_bytes += sent
            pipe.d2h_bytes += nbytes
            h2d += sent
            d2h += nbytes
        drain()
    return h2d, d2h


def _pack_calls_sharded(cache, requests, row_of, groups: int):
    """PACK for a lane-sharded volume: plan against the stripe width
    (requests split at stripe boundaries, _plan's stripe path), route each
    sub-request to the lane owning its stripe (stripe c lives on lane
    c % n, at lane-local stripe c // n) with its lane-local offset, and
    pack each lane's sub-requests into ragged calls.  -> (subs, {lane:
    [(part, words, fetches, deltas)]}), part entries (sub index, the
    lane-local sub-request)."""
    n, stripe = cache.n_devices, cache.stripe
    subs = _plan(requests, stripe)
    by_lane: dict[int, list] = {}
    for i, s in enumerate(subs):
        c = s[1] // stripe
        local = (c // n) * stripe + s[1] % stripe
        by_lane.setdefault(c % n, []).append(
            (i, (s[0], local, s[2], s[3], s[4])))
    calls = {}
    for lane, items in sorted(by_lane.items()):
        idx = [i for i, _ in items]
        calls[lane] = [
            ([(idx[j], sub) for j, sub in part], words, fetches, deltas)
            for part, words, fetches, deltas in _ragged_calls(
                [sub for _, sub in items], requests, row_of, groups)
        ]
    return subs, calls


def _reconstruct_sharded(cache, vid, requests, layout, data_shards,
                         total_shards) -> list[bytes]:
    """reconstruct_intervals for a lane-sharded volume (the port of the
    reference's `_sharded_gather_reconstruct`): every lane with work runs
    one ragged launch of the fused kernel over its own stripes, with
    lane-local offsets, on its own device and stream; each lane's result
    comes down in one D2H, and no survivor byte crosses lanes.  In a pod
    each process runs its own lanes and one all_gather shares the
    reconstructed rows."""
    groups = cache.groups if layout == "blockdiag" else 1
    tile = groups * FUSED_ALIGN
    with obs_trace.span("batch_pack", requests=len(requests), layout=layout):
        rmat, use, row_of, got = _survivors(cache, vid, requests,
                                            data_shards, total_shards)
        if not isinstance(got[0][0], list):
            raise CacheMiss(f"vid {vid}: not lane-sharded (placement changed)")
        subs, calls = _pack_calls_sharded(cache, requests, row_of, groups)
    w_true = rmat.shape[0]
    wrapper = fused_reconstruct_blockdiag if groups > 1 else fused_reconstruct
    dev_span = obs_trace.span(
        "device_execute", requests=len(requests), layout=layout,
        kernel="sharded_" + ("blockdiag" if groups > 1 else "flat"),
    )
    sub_out: list[bytes | None] = [None] * len(subs)
    pipe = cache.pipeline
    n_calls = h2d = d2h = 0
    with devledger.device("mesh"), pipe.slot() as pslot, dev_span:
        pending = []
        for lane in (d for d in calls if d in cache._local_dev_indices):
            dev = cache.lane_devices[lane]
            survivors = tuple(buf[lane] for buf, _ in got)
            a_prep = _prepared_for(cache, rmat, layout, dev)
            _, stream = pslot.on(lane)
            ctx = (contextlib.nullcontext() if stream is None else
                   torch.cuda.stream(stream))
            with ctx:
                if stream is not None:
                    # the survivors were written on the put's stream, and
                    # an eviction must not free them under this stream
                    for _, evs in got:
                        if evs[lane] is not None:
                            stream.wait_event(evs[lane])
                    for s in survivors:
                        s.record_stream(stream)
                for part, words, fetches, deltas in calls[lane]:
                    key = _call_key(wrapper.__name__, groups, w_true,
                                    sum(fetches), len(part))
                    t0 = time.perf_counter()
                    out, offsets, sent = _dispatch_call(
                        a_prep, survivors, words, fetches, len(use), w_true,
                        groups, tile)
                    n_calls += 1
                    if stream is None:
                        _note_call_latency(key, time.perf_counter() - t0)
                        with obs_trace.span("d2h_copy",
                                            bytes=int(out.numel())):
                            _trim(out.numpy(), part, deltas, offsets, sub_out)
                        continue
                    ready = torch.cuda.Event()
                    ready.record(stream)
                    host = torch.empty(out.numel(), dtype=torch.uint8,
                                       pin_memory=True)
                    host.copy_(out, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(stream)
                    pending.append((part, deltas, offsets, host, ready, done,
                                    key, t0))
                    h2d += sent
                    d2h += int(out.numel())
        # every lane's launch and D2H are enqueued before the first wait
        for part, deltas, offsets, host, ready, done, key, t0 in pending:
            ready.synchronize()
            _note_call_latency(key, time.perf_counter() - t0)
            with obs_trace.span("d2h_copy", bytes=int(host.numel())):
                done.synchronize()
                _trim(host.numpy(), part, deltas, offsets, sub_out)
        with _launch_lock:
            pipe.h2d_bytes += h2d
            pipe.d2h_bytes += d2h
        dev_span.annotate(
            device_calls=n_calls, compile_misses=0, h2d_bytes=h2d,
            d2h_bytes=d2h, slot_wait_us=int(pslot.wait_s * 1e6),
        )
        devledger.record(dispatches=n_calls, nbytes=h2d + d2h)
    if cache.multiprocess:
        sub_out = _share_rows(sub_out)
    outputs: list[list[bytes]] = [[] for _ in requests]
    for (idx, *_), piece in zip(subs, sub_out):
        outputs[idx].append(piece)  # subs are in offset order per request
    return [b"".join(parts) for parts in outputs]


def _share_rows(sub_out: list) -> list:
    """The pod's one collective of a sharded read: every process
    all-gathers the reconstructed rows its lanes produced, so each holds
    the whole batch's answers."""
    mine = {i: b for i, b in enumerate(sub_out) if b is not None}
    everyone: list = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(everyone, mine)
    out = list(sub_out)
    for rows in everyone:
        for i, b in rows.items():
            out[i] = b
    if any(b is None for b in out):
        raise RuntimeError("a sharded read's rows are missing after the gather")
    return out


# --- the hot-call view ----------------------------------------------------------
#
# The reference keys /debug/device/hot by compiled shape.  Nothing compiles
# per shape here (the kernels take runtime shapes and a ragged work list),
# so the view keys by call class: the kernel, its system (groups, wanted
# rows) and the call's output bytes and sub-requests rounded up to a
# power of two.  key -> [dispatches, latency EWMA s, last dispatch unix s]
_call_stats: dict[tuple, list] = {}
_call_lock = threading.Lock()
# EWMA weight: ~last 10 dispatches of the class (the reference's)
_CALL_EWMA_ALPHA = 0.2


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _call_key(kernel: str, groups: int, w_true: int, out_bytes: int,
              n_sub: int) -> tuple:
    return (kernel, groups, w_true, _pow2_ceil(out_bytes), _pow2_ceil(n_sub))


def _note_call_latency(key: tuple, seconds: float) -> None:
    """Record one device call's dispatch -> kernel-complete wall seconds
    (calls pipelined in one batch include their wait behind the earlier
    ones: an observed service latency, not a pure kernel time)."""
    now = time.time()
    with _call_lock:
        rec = _call_stats.get(key)
        if rec is None:
            _call_stats[key] = [1, seconds, now]
            return
        rec[0] += 1
        rec[1] += _CALL_EWMA_ALPHA * (seconds - rec[1])
        rec[2] = now


def hot_shapes(limit: int = 10) -> list[dict]:
    """The hottest call classes, most-dispatched first: dispatches,
    per-dispatch latency EWMA, last-seen age — the /debug/device/hot
    payload."""
    with _call_lock:
        items = sorted(
            _call_stats.items(), key=lambda kv: -kv[1][0]
        )[: max(0, limit)]
    now = time.time()
    return [
        {
            "kernel": kernel,
            "groups": groups,
            "w_true": w_true,
            "out_bytes_bucket": out_bucket,
            "count_bucket": n_bucket,
            "dispatches": count,
            "ewma_ms": round(ewma_s * 1e3, 3),
            "last_dispatch_age_s": round(max(0.0, now - last), 3),
        }
        for (kernel, groups, w_true, out_bucket, n_bucket), (
            count, ewma_s, last) in items
    ]


def aot_stats() -> dict:
    """The reference's AOT warm-grid census.  The kernels here take
    runtime shapes, so nothing is compiled ahead of time: empty."""
    return {}


def make_batched_call(
    cache: DeviceShardCache,
    vid: int,
    requests: list[tuple[int, int, int]],
    layout: str | None = None,
):
    """Zero-arg thunk running the ONE uniform device call a homogeneous
    batch of requests (one size bucket, count <= COUNT_BUCKETS[-1]) maps
    to, and returning the un-copied [N * fetch] device tensor (a benchmark
    times the serving call with it, without host copies)."""
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
        if survivors[0].device.type == "cuda":
            stream = torch.cuda.current_stream(survivors[0].device)
            for ev in events:
                stream.wait_event(ev)
        meta = torch.tensor(packed, dtype=torch.int32)
        if groups > 1:
            out = fused_reconstruct_blockdiag(
                a_prep, survivors, meta, tile=tile, fetch=fetch,
                k_true=len(use), w_true=w_true, groups=groups)
        else:
            out = fused_reconstruct(a_prep, survivors, meta, tile=tile,
                                    fetch=fetch, k_true=len(use),
                                    w_true=w_true)
        return out.reshape(-1)

    return thunk


# --- parity scrub -------------------------------------------------------------
#
# The port of the JAX package's scrub half: scrub_volume and
# scrub_all_resident check every parity byte of fully resident volumes
# against their resident data shards and count the mismatching bytes per
# parity shard.  One launch of csrc/scrub.cu (`scrub` below) reads the 14
# resident shards once and computes each byte's syndrome on the tensor
# cores; only the int32 [V, p, n_seg] mismatch partials come down.  What
# differs from the JAX package: no stacked operand or recomputed parity is
# materialised, so nothing bounds a fused call but the 32 volumes one
# launch's parameters hold (the JAX package's 256 MiB stack cap and its
# power-of-two volume padding are gone), and the device section runs in a
# pipeline slot of the cache, like a serving batch, so its busy seconds
# conserve into DevicePipeline.total_busy_s.

# per-segment mismatch sums stay < 2^28 < int31, so a wholesale-corrupt
# multi-GB shard cannot wrap the int32 partials; the host adds the
# [p, n_seg] partials with 64-bit integers.  A power of two >= 2^12.
_SCRUB_SEG = 1 << 28
# most volumes one scrub launch takes (csrc/scrub.cu's parameter block)
_SCRUB_STACK_CAP = 32
# csrc/scrub.cu's walk (checked against the library when it loads): shard
# bytes a tile covers (tiles are aligned to it), columns of a warp's pass
# (the unit whose block-diagonal group is picked once), and the least
# seg_log2 (a tile lies in one counting segment)
SCRUB_TILE = 2048
SCRUB_PASS_COLS = 64
SCRUB_MIN_SEG_LOG2 = 12
# K slots of the syndrome: k data then p parity shards, k + p <= 16
SCRUB_SLOTS = 16


def _scrub_segments(n_lanes: int, seg_log2: int) -> int:
    return (n_lanes + (1 << seg_log2) - 1) >> seg_log2


def _scrub_torch(a, vols, *, k, n_lanes, groups, seg_log2) -> torch.Tensor:
    """Plain version of csrc/scrub.cu, computed as the JAX package's
    _scrub_call / _scrub_call_blockdiag / _scrub_all_call do: per volume,
    the segment-stacked operand (row jg*k + i is data shard i's bytes
    [jg*seg, (jg+1)*seg), seg = n_lanes / groups), one apply of the
    (block-diagonal) parity system (rs_cuda._apply_torch), output row
    jg*p + j compared with parity shard j's segment jg, and the
    mismatches summed per counting segment (jg*seg + c) >> seg_log2,
    column by column in windows of _PLAIN_COLS so that it runs over a
    whole volume on the card.  -> [V, p, n_seg] int32."""
    p = len(vols[0]) - k
    dev = vols[0][0].device
    seg = n_lanes // groups
    n_seg = _scrub_segments(n_lanes, seg_log2)
    out = torch.zeros((len(vols), p, n_seg), dtype=torch.int64, device=dev)
    for v, shards in enumerate(vols):
        for lo in range(0, seg, _PLAIN_COLS):
            hi = min(seg, lo + _PLAIN_COLS)
            x = torch.stack([shards[i][jg * seg + lo : jg * seg + hi]
                             for jg in range(groups) for i in range(k)])
            y = rs_cuda._apply_torch(a, x, groups * p)
            for jg in range(groups):
                q = torch.arange(jg * seg + lo, jg * seg + hi, device=dev)
                for j in range(p):
                    diff = y[jg * p + j] != shards[k + j][jg * seg + lo :
                                                         jg * seg + hi]
                    out[v, j] += torch.bincount(q[diff] >> seg_log2,
                                                minlength=n_seg)
    return out.to(torch.int32)


def _scrub_masks(a: torch.Tensor, k: int, p: int, groups: int) -> np.ndarray:
    """The scrub kernels' mask table: _bit_masks(a, k, p, groups, p) with
    the syndrome bytes added.  Row (jg*p + j)*8 + i of the [groups*p*8,
    16] u8 table is K slot s's mask for output bit i of parity row j in
    group jg: byte s < k the data shard's mask of the prepared matrix,
    byte k + j the stored parity bit (1 << i), every other byte 0; so
    parity(popcount(slots & row)) is (recomputed bit i) XOR (stored bit
    i), and a byte verifies iff all 8 are 0."""
    if k + p > SCRUB_SLOTS:
        raise ValueError(f"{k}+{p} shards exceed the syndrome's "
                         f"{SCRUB_SLOTS} slots")
    table = _bit_masks(a, k, p, groups, p).reshape(groups, p, 8, 16).copy()
    bits = np.arange(8)
    for j in range(p):
        table[:, j, bits, k + j] = 1 << bits
    return table.reshape(-1, 16)


def _scrub_fragments(masks: np.ndarray, p: int, groups: int) -> np.ndarray:
    """numpy mirror of csrc/scrub.cu's scrub_fragments: the mask table in
    the tensor-core kernel's B-fragment order, [groups, n_blk, 4, 32]
    uint32 (n_blk = ceil(p / 4) N-blocks of 4 rows, 4 n-tiles, 32 lanes):
    lane (g, t)'s word for n-tile q of N-block nb holds at byte r slot
    t + 4r of row 4*nb + g//2, bit 2q + g%2 (zero past row p)."""
    n_blk = -(-p // 4)
    rows = np.zeros((groups, 4 * n_blk, 8, 16), dtype=np.uint32)
    rows[:, :p] = masks.reshape(groups, p, 8, 16)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    row = (4 * np.arange(n_blk)[:, None, None] + (g >> 1))  # [n_blk, 1, 32]
    bit = (2 * np.arange(4)[None, :, None] + (g & 1))       # [1, 4, 32]
    out = np.zeros((groups, n_blk, 4, 32), dtype=np.uint32)
    for r in range(4):
        out |= rows[:, row, bit, t + 4 * r] << np.uint32(8 * r)
    return out


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def _scrub_bad(frags: np.ndarray, shards, *, k: int, lo: int, hi: int,
               seg: int, groups: int) -> np.ndarray:
    """The tensor-core kernel's verdict on columns [lo, hi), modelled
    through its fragments: each column's A word for lane t holds slot
    t + 4r at byte r (a 4x4 byte transpose of the loaded rows), each
    count is popcount(A & B) summed over the 4 lanes t of a column of B,
    and a (column, row) mismatches iff one of its 8 counts is odd.  The
    group is picked per SCRUB_PASS_COLS-column pass.  -> [p, hi - lo]
    bool."""
    p = len(shards) - k
    n_blk = frags.shape[1]
    x = np.zeros((SCRUB_SLOTS, hi - lo), dtype=np.uint32)
    for s, shard in enumerate(shards):
        x[s] = shard[lo:hi]
    a = np.zeros((4, hi - lo), dtype=np.uint32)
    for r in range(4):
        a |= x[4 * r : 4 * r + 4] << np.uint32(8 * r)  # lane t: slot t + 4r
    q0 = np.arange(lo, hi) // SCRUB_PASS_COLS * SCRUB_PASS_COLS
    jg = (q0[:, None] >= np.arange(1, groups) * seg).sum(axis=1)
    # counts [cols, nb, q, g]: B column g of n-tile q, summed over lanes t
    b = frags[jg].reshape(hi - lo, n_blk, 4, 8, 4)
    anded = np.ascontiguousarray(a.T[:, None, None, None, :] & b)
    counts = _POPCOUNT8[anded.view(np.uint8)].sum(axis=-1, dtype=np.int64)
    # column g is row 4*nb + g//2, bit 2q + g%2
    odd = (counts & 1).reshape(hi - lo, n_blk, 4, 4, 2)
    return odd.any(axis=(2, 4)).reshape(hi - lo, 4 * n_blk)[:, :p].T


def _scrub_model(masks: np.ndarray, vols, *, k: int, n_lanes: int,
                 groups: int, seg_log2: int,
                 blocks: int = 264) -> tuple[np.ndarray, list]:
    """numpy model of a launch of csrc/scrub.cu's tensor-core kernel:
    `blocks` persistent blocks (264 on the H100, two an SM) walk the
    (volume, SCRUB_TILE-byte tile) pairs, volume-major, each taking every
    blocks-th pair; each tile's mismatches come from the syndrome model
    (_scrub_bad, through the B fragments of `masks`); a block adds its
    counts per row when its next tile lies in another (volume, counting
    segment), and at its end.  -> (partials [V, p, n_seg] int64, the adds
    in block order: (block, v, j, segment, count), zero counts skipped as
    the kernel skips them)."""
    p = len(vols[0]) - k
    seg = n_lanes // groups
    n_seg = _scrub_segments(n_lanes, seg_log2)
    frags = _scrub_fragments(masks, p, groups)
    tiles = -(-n_lanes // SCRUB_TILE)
    # per_tile[v][j, tile]: the tile's mismatching bytes of row j
    per_tile = []
    for shards in vols:
        counts = np.zeros((p, tiles * SCRUB_TILE), dtype=np.int64)
        for lo in range(0, n_lanes, 1 << 15):
            hi = min(n_lanes, lo + (1 << 15))
            counts[:, lo:hi] = _scrub_bad(frags, shards, k=k, lo=lo, hi=hi,
                                          seg=seg, groups=groups)
        per_tile.append(counts.reshape(p, tiles, SCRUB_TILE).sum(axis=2))
    out = np.zeros((len(vols), p, n_seg), dtype=np.int64)
    adds: list[tuple[int, int, int, int, int]] = []
    total = len(vols) * tiles
    for blk in range(min(blocks, total)):
        cnt = np.zeros(p, dtype=np.int64)
        cur = None
        for f in range(blk, total, blocks):
            v, tile = divmod(f, tiles)
            key = (v, (tile * SCRUB_TILE) >> seg_log2)
            if cur is not None and key != cur:
                _scrub_model_add(out, adds, blk, cur, cnt)
            cur = key
            cnt += per_tile[v][:, tile]
        _scrub_model_add(out, adds, blk, cur, cnt)
    return out, adds


def _scrub_model_add(out, adds, blk, key, cnt) -> None:
    """A block's flush in the model: one add per row with a non-zero
    count, then the counts restart."""
    v, sid = key
    for j, c in enumerate(cnt.tolist()):
        if c:
            out[v, j, sid] += c
            adds.append((blk, v, j, sid, c))
    cnt[:] = 0


def _check_scrub(a, vols, k, n_lanes, groups, seg_log2) -> None:
    """Host checks of a scrub call, shared by both routes; raises on any
    violation before any device work."""
    if not vols or len(vols) > _SCRUB_STACK_CAP:
        raise ValueError(f"a scrub takes 1..{_SCRUB_STACK_CAP} volumes, "
                         f"got {len(vols)}")
    n = len(vols[0])
    if n <= k or any(len(vol) != n for vol in vols):
        raise ValueError(f"every volume needs the same {k} data shards and "
                         "at least one parity shard")
    dev = a.device
    for vol in vols:
        for s in vol:
            if s.dtype != torch.uint8 or s.dim() != 1 or not s.is_contiguous():
                raise TypeError("shards must be contiguous 1-D uint8 tensors")
            if s.device != dev:
                raise ValueError(f"matrix on {dev} but a shard on {s.device}")
            if s.numel() < n_lanes:
                raise ValueError(f"n_lanes {n_lanes} runs past a "
                                 f"{s.numel()}-byte shard")
    if a.dtype != torch.int8 or a.dim() != 2 or a.shape[0] % 8 or a.shape[1] % 8:
        raise TypeError(f"matrix must be bit-major int8, got {a.dtype} "
                        f"{tuple(a.shape)}")
    p = n - k
    if groups * k > a.shape[1] // 8 or groups * p > a.shape[0] // 8:
        raise ValueError(f"{groups} groups of {p}x{k} exceed the matrix "
                         f"{tuple(a.shape)}")
    if n_lanes <= 0 or n_lanes % (groups * LANE):
        raise ValueError(f"n_lanes {n_lanes} is not a positive multiple of "
                         f"{groups}*{LANE}")
    if seg_log2 < SCRUB_MIN_SEG_LOG2:
        raise ValueError(f"seg_log2 {seg_log2} < {SCRUB_MIN_SEG_LOG2}")


@functools.cache
def _scrub_lib():
    """The kernel library, csrc/scrub.cu's constants checked against this
    module's."""
    lib = _build.kernels()
    tile, cols = ctypes.c_long(), ctypes.c_int()
    vols, seg_min = ctypes.c_int(), ctypes.c_int()
    lib.scrub_limits(ctypes.byref(tile), ctypes.byref(cols),
                     ctypes.byref(vols), ctypes.byref(seg_min))
    got = (tile.value, cols.value, vols.value, seg_min.value)
    want = (SCRUB_TILE, SCRUB_PASS_COLS, _SCRUB_STACK_CAP, SCRUB_MIN_SEG_LOG2)
    if got != want:
        raise RuntimeError(f"csrc/scrub.cu has (tile, pass columns, volumes, "
                           f"seg_log2) {got}; rs_resident expects {want}")
    return lib


def _scrub_launch(entry: str, a, vols, n_lanes: int, k: int, groups: int,
                  seg_log2: int) -> torch.Tensor:
    """One launch of csrc/scrub.cu's C entry `entry` on the current stream
    over checked CUDA shards; raises if it does not launch.  -> the int32
    [V, p, n_seg] partials on the card."""
    if any(s.data_ptr() % 16 for vol in vols for s in vol):
        raise ValueError("shard buffers must be 16-byte aligned")
    lib = _scrub_lib()
    p = len(vols[0]) - k
    masks = _scrub_masks(a, k, p, groups)
    dev = vols[0][0].device
    out = torch.empty((len(vols), p, _scrub_segments(n_lanes, seg_log2)),
                      dtype=torch.int32, device=dev)
    ptrs = [s.data_ptr() for vol in vols for s in vol]
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            masks.ctypes.data, k, p, groups, (ctypes.c_void_p * len(ptrs))(*ptrs),
            len(vols), n_lanes, seg_log2, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed ({rc}): "
                           f"{lib.scrub_error_string(rc).decode()}")
    return out


def scrub(a, vols, *, n_lanes: int, k: int = DATA_SHARDS, groups: int = 1,
          seg_log2: int | None = None) -> torch.Tensor:
    """Parity scrub of up to 32 volumes in one call (the port of the JAX
    `_scrub_call`, `_scrub_call_blockdiag` and `_scrub_all_call`): `vols`
    holds each volume's k data shards then p parity shards, 1-D uint8
    tensors of at least n_lanes bytes; `a` the prepared parity system,
    flat (groups 1) or the g-group block-diagonal one.  -> int32 [V, p,
    n_seg] on the shards' device: the mismatching bytes of parity row j
    over the first n_lanes bytes per 2^seg_log2-byte counting segment
    (seg_log2 defaults to _SCRUB_SEG's).  CPU shards take the plain
    version; CUDA shards launch csrc/scrub.cu's tensor-core kernel on the
    current stream or raise.  `.launches` counts launches."""
    if seg_log2 is None:
        seg_log2 = _SCRUB_SEG.bit_length() - 1
    _check_scrub(a, vols, k, n_lanes, groups, seg_log2)
    dev = vols[0][0].device
    if dev.type == "cpu":
        return _scrub_torch(a, vols, k=k, n_lanes=n_lanes, groups=groups,
                            seg_log2=seg_log2)
    if dev.type != "cuda":
        raise ValueError(f"no scrub kernel for {dev}")
    out = _scrub_launch("scrub_launch", a, vols, n_lanes, k, groups, seg_log2)
    with _launch_lock:
        scrub.launches += 1
    return out


scrub.launches = 0
# bytes the scrub calls copied to the host (only their partials)
scrub.d2h_bytes = 0


def scrub_cuda_cores(a, vols, *, n_lanes: int, k: int = DATA_SHARDS,
                     groups: int = 1,
                     seg_log2: int | None = None) -> torch.Tensor:
    """`scrub` on csrc/scrub.cu's earlier CUDA-core kernel
    (scrub_cuda_cores_launch): the same arguments and partials.  Kept to be
    timed beside the tensor-core kernel; nothing on the main path calls
    it.  CPU shards take the plain version; CUDA shards launch or raise.
    `.launches` counts launches."""
    if seg_log2 is None:
        seg_log2 = _SCRUB_SEG.bit_length() - 1
    _check_scrub(a, vols, k, n_lanes, groups, seg_log2)
    if vols[0][0].device.type != "cuda":
        return scrub(a, vols, n_lanes=n_lanes, k=k, groups=groups,
                     seg_log2=seg_log2)
    out = _scrub_launch("scrub_cuda_cores_launch", a, vols, n_lanes, k,
                        groups, seg_log2)
    with _launch_lock:
        scrub_cuda_cores.launches += 1
    return out


scrub_cuda_cores.launches = 0


def _scrub_matrix(data_shards: int, total_shards: int, groups: int,
                  device: str) -> torch.Tensor:
    """The prepared RS parity rows (gf256.build_matrix(k, n)[k:]): the flat
    system, or the g-group block-diagonal one the reads use."""
    parity_m = gf256.build_matrix(data_shards, total_shards)[data_shards:]
    if groups > 1:
        return _prepared_blockdiag(parity_m.tobytes(), *parity_m.shape,
                                   groups, device)
    return rs_cuda._prepared(parity_m.tobytes(), *parity_m.shape, device)


def _scrub_run(cache, a, got, n_lanes: int, groups: int, k: int,
               lane: int = 0) -> np.ndarray:
    """One scrub call in a pipeline slot of the cache on `lane`, tagged
    "scrub" in the device ledger.  `got` is each volume's [(buffer, put
    event)] on that lane.  On the card it runs on the slot's stream of the
    lane after the puts' events, with every buffer kept from reuse until
    the stream is done with it (an eviction mid-scrub frees nothing the
    kernel reads).  -> host int64 [V, p, n_seg] partials."""
    vols = [tuple(buf for buf, _ in vol) for vol in got]
    with devledger.workload("scrub"), cache.pipeline.slot() as pslot:
        _, stream = pslot.on(lane)
        if stream is None:
            host = scrub(a, vols, n_lanes=n_lanes, k=k, groups=groups).numpy()
        else:
            dev = cache.lane_devices[lane]
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                for vol in got:
                    for buf, ev in vol:
                        if ev is not None:
                            stream.wait_event(ev)
                        buf.record_stream(stream)
                out = scrub(a, vols, n_lanes=n_lanes, k=k, groups=groups)
                host = out.cpu().numpy()  # the only D2H
            with _launch_lock:
                scrub.d2h_bytes += host.nbytes
        # busy seconds are the slot's (recorded on exit)
        devledger.record(dispatches=1, nbytes=host.nbytes)
    return host.astype(np.int64)


def _scrub_span(size: int, quant: int) -> int:
    """The verified span: the true shard size rounded up to `quant`
    (LANE, or groups*LANE block-diagonal); the cache's zero padding covers
    the rest, and parity of zeros is zero."""
    return -(-size // quant) * quant


def _scrub_placed(cache, place, got, n_lanes: int, groups: int,
                  data_shards: int, total_shards: int) -> list[list[int]]:
    """Scrub volumes of one placement -> each volume's per-parity-shard
    mismatch counts.  A whole pin is one launch on its lane.  A
    lane-sharded volume is scrubbed where it lies (`n_lanes` is then each
    lane's span): every lane checks its own stripes of every shard with
    one launch (parity is byte-wise, so the stripe order does not
    matter), and the lanes' counts add up; in a pod the processes' counts
    meet in one all_gather."""
    if place != "mesh":
        lane = int(place)
        a = _scrub_matrix(data_shards, total_shards, groups,
                          str(cache.lane_devices[lane]))
        partials = _scrub_run(cache, a, got, n_lanes, groups, data_shards,
                              lane)
        return [[int(r.sum()) for r in vol] for vol in partials]
    p = total_shards - data_shards
    counts = np.zeros((len(got), p), dtype=np.int64)
    for lane in cache._local_dev_indices:
        a = _scrub_matrix(data_shards, total_shards, groups,
                          str(cache.lane_devices[lane]))
        lane_got = [[(buf[lane], None if ev is None else ev[lane])
                     for buf, ev in vol] for vol in got]
        counts += _scrub_run(cache, a, lane_got, n_lanes, groups,
                             data_shards, lane).sum(axis=-1)
    if cache.multiprocess:
        everyone: list = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(everyone, counts)
        counts = sum(everyone)
    return [[int(c) for c in vol] for vol in counts]


def scrub_volume(
    cache: DeviceShardCache,
    vid: int,
    data_shards: int = DATA_SHARDS,
    total_shards: int = TOTAL_SHARDS,
    layout: str | None = None,
) -> tuple[list[int], int]:
    """Parity scrub of a fully resident volume: -> (per-parity-shard
    mismatch byte counts, bytes verified per shard).  Raises CacheMiss
    unless ALL shards are resident and of one size, or when one is evicted
    between the listing and the call.  The verified span rounds the true
    shard size up to LANE (block-diagonal: to groups*LANE, so every segment
    slice stays lane-aligned).  `layout` (None = the cache's) picks the
    flat or block-diagonal system; one launch of csrc/scrub.cu either way."""
    if layout is None:
        layout = cache.layout
    if layout not in LAYOUTS:
        raise ValueError(f"unknown resident layout {layout!r}")
    resident = cache.shard_ids(vid)
    if len(resident) < total_shards:
        raise CacheMiss(
            f"vid {vid}: {len(resident)}/{total_shards} shards resident"
        )
    sizes = {cache.shard_size(vid, s) for s in range(total_shards)}
    if len(sizes) != 1:
        raise CacheMiss(f"vid {vid}: resident shard sizes differ: {sizes}")
    true_size = sizes.pop()
    got = [cache._get_ready(vid, s) for s in range(total_shards)]
    if any(buf is None for buf, _ in got):
        raise CacheMiss(f"vid {vid}: shard evicted mid-scrub")
    groups = cache.groups if layout == "blockdiag" else 1
    place = cache.placement(vid)
    n_lanes = _scrub_span(true_size, groups * LANE)
    if place == "mesh":
        # the stripes are permuted: a true-size span would cover an
        # arbitrary stripe subset, so the whole padded buffer is checked
        # (the zero padding verifies trivially)
        n_lanes = cache._padded_len(true_size)
    counts = _scrub_placed(
        cache, 0 if place is None else place, [got],
        n_lanes // cache.n_devices if place == "mesh" else n_lanes,
        groups, data_shards, total_shards)
    stats_metrics.VOLUME_SERVER_EC_SCRUB_DISPATCH.labels(
        mode="per_volume"
    ).inc()
    return counts[0], n_lanes


def scrub_all_resident(
    cache: DeviceShardCache,
    data_shards: int = DATA_SHARDS,
    total_shards: int = TOTAL_SHARDS,
    layout: str | None = None,
    vids: list[int] | None = None,
) -> tuple[dict[int, tuple[list[int], int]], dict]:
    """Parity-scrub EVERY fully resident volume (or the `vids` subset) in
    as few launches as possible: volumes with equal verified spans (and
    placement) stack into one launch of csrc/scrub.cu, up to
    _SCRUB_STACK_CAP a launch.  -> ({vid: (per-parity-shard mismatch byte
    counts, bytes verified per shard)}, {"device_calls", "volumes"}).
    Volumes that do not qualify (not fully resident, mixed sizes, evicted
    mid-pass) are absent from the result: the caller's per-volume path
    owns them."""
    if layout is None:
        layout = cache.layout
    if layout not in LAYOUTS:
        raise ValueError(f"unknown resident layout {layout!r}")
    groups = cache.groups if layout == "blockdiag" else 1
    if vids is None:
        vids = sorted(cache.resident_by_vid())
    # ((n_lanes, placement), [(vid, [(buffer, event)])]): only fully
    # resident, uniform-size volumes qualify (scrub_volume's rule)
    stacks: dict[tuple[int, int], list[tuple[int, list]]] = {}
    for vid in vids:
        if cache.resident_count(vid) < total_shards:
            continue
        sizes = {cache.shard_size(vid, s) for s in range(total_shards)}
        if len(sizes) != 1 or None in sizes:
            continue
        got = [cache._get_ready(vid, s) for s in range(total_shards)]
        if any(buf is None for buf, _ in got):
            continue
        size = sizes.pop()
        place = cache.placement(vid)
        place = 0 if place is None else place
        # a lane-sharded volume is checked whole (see scrub_volume)
        n_lanes = (cache._padded_len(size) if place == "mesh"
                   else _scrub_span(size, groups * LANE))
        stacks.setdefault((n_lanes, place), []).append((vid, got))
    results: dict[int, tuple[list[int], int]] = {}
    device_calls = 0
    for (n_lanes, place), members in sorted(
            stacks.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        span = n_lanes // cache.n_devices if place == "mesh" else n_lanes
        for start in range(0, len(members), _SCRUB_STACK_CAP):
            chunk = members[start : start + _SCRUB_STACK_CAP]
            counts = _scrub_placed(cache, place, [got for _, got in chunk],
                                   span, groups, data_shards, total_shards)
            device_calls += 1
            stats_metrics.VOLUME_SERVER_EC_SCRUB_DISPATCH.labels(
                mode="megakernel"
            ).inc()
            for (vid, _), vol_counts in zip(chunk, counts):
                results[vid] = (vol_counts, n_lanes)
    return results, {"device_calls": device_calls, "volumes": len(results)}
