"""EcVolume: serving needles out of mounted `.ecNN` shards.

Port of seaweedfs_tpu/storage/ec/volume.py (reference:
weed/storage/erasure_coding/ec_volume.go, ec_shard.go, ec_volume_delete.go
and the read path weed/storage/store_ec.go:136-393).  A needle read
resolves the sorted `.ecx` index (on-disk binary search), maps the
(offset, size) run to shard intervals, then serves each interval from a
local shard, its remote holder, or — the degraded path — by reading the
same interval from >=10 surviving shards and reconstructing the missing bytes with
one GF(256) multiply (the reference's per-needle ReconstructData,
store_ec.go:339-393), on the card by default.  With a DeviceShardCache
(ops/rs_resident.py) holding >=10 survivors, the missing-shard intervals of
a read, or of a whole burst (read_needles_batch), are reconstructed from the
resident bytes in one device call instead.

With the residency ladder's host-RAM tier attached (`host_cache`, a
serving/tiering.HostShardCache), every host interval read — a local
shard's, and each survivor of a degraded gather — is served from the
staged bytes first (a zero-copy memoryview, no pread), and a promotion's
pin reads the staged bytes instead of the shard files.

Every read is traced as the reference's is (obs/trace.py): the `.ecx`
locate and each local pread are `shard_read` spans (`source="host_tier"`
when the host tier served it), the host degraded read a `shard_read`
gather then a `host_reconstruct`, and the resident call carries its own
spans (ops/rs_resident.py).

Shards that live on other servers are read through a caller-supplied
`remote_read` hook (the volume server's VolumeEcShardRead client,
server/volume.py): a missing interval goes to its holder first, and the
degraded gather fetches its remote survivors concurrently through the
hedged gather (utils/faultpolicy.py).  A burst of a resident volume
(read_needles_batch with >=10 survivors pinned) reconstructs on the card
without the remote hop.  The reconstruct memo is ROADMAP A4c.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Optional

import numpy as np

from ...obs import trace as obs_trace
from ...ops import rs, rs_resident
from .. import needle as needle_mod
from .. import types as t
from ..needle import Needle
from ..volume import CookieMismatch
from ..volume_info import load_volume_info, save_volume_info
from .encoder import ec_base_name
from .layout import (
    DATA_SHARDS,
    TOTAL_SHARDS,
    Interval,
    ShardBits,
    locate_data,
    to_ext,
)


class NeedleNotFound(KeyError):
    pass


class InsufficientShards(RuntimeError):
    pass


def search_sorted_index(fd: int, index_size: int, needle_id: int) -> tuple[int, int, int]:
    """Binary-search a sorted-entry index file -> (entry_offset,
    needle_offset, size); raises NeedleNotFound (SearchNeedleFromSortedIndex
    ec_volume.go:230-255)."""
    entry = t.NEEDLE_MAP_ENTRY_SIZE
    lo, hi = 0, index_size // entry
    while lo < hi:
        mid = (lo + hi) // 2
        buf = os.pread(fd, entry, mid * entry)
        key = int.from_bytes(buf[:8], "big")
        if key == needle_id:
            off = t.offset_from_bytes(buf[8 : 8 + t.OFFSET_SIZE])
            size = int.from_bytes(
                buf[8 + t.OFFSET_SIZE : entry], "big", signed=True
            )
            return mid * entry, off, size
        if key < needle_id:
            lo = mid + 1
        else:
            hi = mid
    raise NeedleNotFound(f"needle {needle_id:x} not in sorted index")


def mark_entry_deleted(fd: int, entry_offset: int) -> None:
    """Tombstone an index entry in place: size=-1 written over the size
    field (MarkNeedleDeleted ec_volume_delete.go:13-25)."""
    os.pwrite(
        fd,
        t.TOMBSTONE_FILE_SIZE.to_bytes(4, "big", signed=True),
        entry_offset + 8 + t.OFFSET_SIZE,
    )


def iter_ecj(path: str):
    """Yield journaled needle ids from a .ecj (8B big-endian each)."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        buf = f.read()
    for i in range(0, len(buf) - len(buf) % 8, 8):
        yield int.from_bytes(buf[i : i + 8], "big")


# shard_id, shard file offset, size -> bytes (or None if unavailable);
# the remote-read hook corresponding to VolumeEcShardRead
# (store_ec.go:299-337)
RemoteReadFn = Callable[[int, int, int], Optional[bytes]]


# shared fetch pool for the degraded-read survivor gather: a per-read pool
# would spawn ~10 threads per reconstruct, and thread churn is tail latency
_GATHER_POOL = None
_GATHER_POOL_LOCK = threading.Lock()


def _gather_pool():
    global _GATHER_POOL
    with _GATHER_POOL_LOCK:
        if _GATHER_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _GATHER_POOL = ThreadPoolExecutor(
                max_workers=32, thread_name_prefix="ec-gather"
            )
        return _GATHER_POOL


class EcVolumeShard:
    """One mounted .ecNN file (ec_shard.go:17-97)."""

    def __init__(self, dirname: str, vid: int, shard_id: int, collection: str = ""):
        self.dir = dirname
        self.id = vid
        self.shard_id = shard_id
        self.collection = collection
        self.path = ec_base_name(dirname, vid, collection) + to_ext(shard_id)
        self._f = open(self.path, "rb")
        self.size = os.path.getsize(self.path)

    def read_at(self, offset: int, size: int) -> bytes:
        return os.pread(self._f.fileno(), size, offset)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def destroy(self) -> None:
        self.close()
        if os.path.exists(self.path):
            os.remove(self.path)


class EcVolume:
    """Mounted EC volume: `.ecx` + `.ecj` sidecars + any local shards."""

    def __init__(self, dirname: str, vid: int, collection: str = ""):
        self.dir = dirname
        self.id = vid
        self.collection = collection
        self.base_name = ec_base_name(dirname, vid, collection)
        self.ecx_path = self.base_name + ".ecx"
        self.ecj_path = self.base_name + ".ecj"
        self._ecx = open(self.ecx_path, "r+b")
        self.ecx_size = os.path.getsize(self.ecx_path)
        self._ecj = open(self.ecj_path, "ab")
        self._ecj_lock = threading.Lock()
        self.shards: dict[int, EcVolumeShard] = {}
        # optional device shard cache (ops/rs_resident.py): when set and
        # >=10 survivors of this volume are resident, degraded reads
        # reconstruct on the card without shipping survivor bytes
        self.device_cache = None
        # optional host-RAM warm tier (serving/tiering.HostShardCache):
        # when set and this volume's shard bytes are staged, interval
        # reads serve zero-copy memoryview slices of the staged arrays
        # instead of disk preads — the middle rung of the residency ladder
        self.host_cache = None
        # missing-shard intervals a CacheMiss sent to the host path
        self.device_misses = 0
        info = load_volume_info(self.base_name + ".vif")
        if info:
            self.version = int(info.get("version", needle_mod.CURRENT_VERSION))
        else:
            # no .vif: derive the true version from the .ec00 superblock
            # (block 0 of the stripe is the head of the original .dat) the
            # way ec_decoder.go:120-138 does, then persist it
            try:
                from .decoder import read_ec_volume_version

                self.version = read_ec_volume_version(self.base_name)
            except OSError:
                self.version = needle_mod.CURRENT_VERSION
            save_volume_info(self.base_name + ".vif", {"version": self.version})

    # -- shard management ----------------------------------------------------

    def add_shard(self, shard_id: int) -> bool:
        if shard_id in self.shards:
            return False
        self.shards[shard_id] = EcVolumeShard(
            self.dir, self.id, shard_id, self.collection
        )
        return True

    def _holds_pin(self) -> bool:
        """True when this location's shard files back the cache's resident
        bytes of this vid (the cache is keyed by (vid, shard) only)."""
        return (
            self.device_cache is not None
            and self.device_cache.pin_source(self.id) == self.dir
        )

    def delete_shard(self, shard_id: int) -> EcVolumeShard | None:
        # only the pinning location's unmount evicts resident bytes
        if self._holds_pin():
            self.device_cache.evict(self.id, shard_id)
        return self.shards.pop(shard_id, None)

    def load_shards_to_device(self, cache=None, should_stop=None) -> int:
        """Pin every locally mounted shard of this volume into the device
        cache, in shard-id order.  Returns shards pinned.  `should_stop`
        (callable -> bool) aborts between shards.  A vid another location
        already pinned stays file-backed here (returns 0)."""
        if cache is not None:
            self.device_cache = cache
        if self.device_cache is None:
            raise ValueError("no device cache configured")
        if self.device_cache.claim_pin_source(self.id, self.dir) != self.dir:
            return 0
        n = 0
        for sid, shard in sorted(self.shards.items()):
            if should_stop is not None and should_stop():
                break
            if self.device_cache.get(self.id, sid) is None:
                # promotion from the host tier never re-reads disk: the
                # staged bytes ARE the shard file's bytes
                staged = (
                    self.host_cache.shard_array(self.id, sid)
                    if self.host_cache is not None
                    else None
                )
                self.device_cache.put(
                    self.id, sid,
                    staged if staged is not None
                    else np.fromfile(shard.path, dtype=np.uint8),
                )
                n += 1
        return n

    def stage_host_shards(self) -> dict[int, np.ndarray]:
        """Read every locally mounted shard's bytes once (demotion-time
        staging for the host-RAM warm tier).  Raises OSError when a shard
        file is unreadable — the caller keeps the volume on its current
        tier rather than staging a partial set silently."""
        return {
            sid: np.fromfile(shard.path, dtype=np.uint8)
            for sid, shard in list(self.shards.items())
        }

    def is_device_resident(self) -> bool:
        """True when enough of THIS location's shards are pinned to
        reconstruct any missing interval on the device."""
        return (
            self._holds_pin()
            and self.device_cache.resident_count(self.id) >= DATA_SHARDS
        )

    def shard_bits(self) -> ShardBits:
        b = ShardBits(0)
        for sid in self.shards:
            b = b.add(sid)
        return b

    @property
    def shard_size(self) -> int:
        for s in self.shards.values():
            return s.size
        return 0

    def dat_size(self) -> int:
        """Original volume size implied by the shard size, the same
        DataShards*ecdFileSize the reference uses for interval math
        (ec_volume.go:218-223)."""
        return DATA_SHARDS * self.shard_size

    # -- .ecx lookup ---------------------------------------------------------

    def _search_ecx(self, needle_id: int) -> tuple[int, int, int]:
        """-> (entry_offset_in_ecx, needle_offset, size)."""
        return search_sorted_index(self._ecx.fileno(), self.ecx_size, needle_id)

    def find_needle(self, needle_id: int) -> tuple[int, int]:
        """-> (volume offset, size); raises NeedleNotFound (incl. deleted)."""
        _, off, size = self._search_ecx(needle_id)
        if not t.size_is_valid(size):
            raise NeedleNotFound(f"needle {needle_id:x} deleted")
        return off, size

    def locate_needle(self, needle_id: int) -> tuple[int, int, list[Interval]]:
        """(offset, size, shard intervals covering the whole record)
        (LocateEcShardNeedle ec_volume.go:206-223)."""
        off, size = self.find_needle(needle_id)
        total = needle_mod.actual_size(size, self.version)
        intervals = locate_data(self.dat_size(), off, total)
        return off, size, intervals

    # -- interval reads (store_ec.go:176-393) --------------------------------

    def _host_tier_read(self, shard_id: int, off: int, size: int):
        """Zero-copy slice of the host-RAM tier's staged shard bytes, or
        None when the shard is not staged or the slice is short (a shard's
        tail: the caller reads the file, as after a short pread) — the one
        host-tier probe every interval-read path shares."""
        hc = self.host_cache
        if hc is None:
            return None
        view = hc.read(self.id, shard_id, off, size)
        return view if view is not None and len(view) == size else None

    def read_interval(
        self, interval: Interval, remote_read: RemoteReadFn | None = None,
        backend: str = "cuda", use_device: bool = True,
    ) -> bytes:
        shard_id, off = interval.to_shard_and_offset()
        return self._read_shard_interval(
            shard_id, off, interval.size, remote_read, backend, use_device
        )

    def _read_shard_interval(
        self, shard_id: int, off: int, size: int,
        remote_read: RemoteReadFn | None, backend: str,
        use_device: bool = True,
    ) -> bytes:
        """One interval: the host tier, the local shard, the shard's holder
        (`remote_read`), else a degraded reconstruction."""
        staged = self._host_tier_read(shard_id, off, size)
        if staged is not None:
            with obs_trace.span(
                "shard_read", shard=shard_id, bytes=size, source="host_tier",
            ):
                return staged
        shard = self.shards.get(shard_id)
        if shard is not None:
            with obs_trace.span("shard_read", shard=shard_id, bytes=size):
                return shard.read_at(off, size)
        if remote_read is not None:
            with obs_trace.span(
                "remote_shard_read", shard=shard_id, bytes=size
            ):
                data = remote_read(shard_id, off, size)
            if data is not None:
                return data
        return self._reconstruct_interval(
            shard_id, off, size, remote_read, backend, use_device
        )

    def _reconstruct_interval(
        self, missing_shard: int, off: int, size: int,
        remote_read: RemoteReadFn | None, backend: str,
        use_device: bool = True,
    ) -> bytes:
        """Degraded read: gather this interval from >=k other shards and
        recompute the missing rows (recoverOneRemoteEcShardInterval
        store_ec.go:339-393) — one multiply on the selected backend.  Local
        survivors are read first; the rest come from their holders through
        `remote_read`, concurrently, by the hedged gather.  With the
        survivors resident in `device_cache` the gather happens on the
        device instead; `use_device=False` forces the host path."""
        if use_device and self.device_cache is not None:
            try:
                return rs_resident.reconstruct_intervals(
                    self.device_cache, self.id, [(missing_shard, off, size)]
                )[0]
            except rs_resident.CacheMiss:
                self.device_misses += 1
        got: dict[int, np.ndarray] = {}
        n_remote = 0
        with obs_trace.span("shard_read", op="gather_survivors") as gather:
            remote_candidates: list[int] = []
            for sid in range(TOTAL_SHARDS):
                if sid == missing_shard:
                    continue
                # host tier first: a warm volume's survivor gather must
                # not touch disk (the whole point of the middle rung)
                buf = self._host_tier_read(sid, off, size)
                if buf is None:
                    shard = self.shards.get(sid)
                    if shard is None:
                        if remote_read is not None:
                            remote_candidates.append(sid)
                        continue
                    buf = shard.read_at(off, size)
                if len(buf) == size:
                    got[sid] = np.frombuffer(buf, dtype=np.uint8)
                if len(got) >= DATA_SHARDS:
                    break
            # the remote survivors fetch concurrently through the hedged
            # gather: the `need` cheapest peers first, a hedge to a spare
            # holder past a peer's latency quantile, failed fetches
            # replaced from the spares; each fetch runs under a copy of
            # this worker's contextvars (trace id and deadline ride along)
            if len(got) < DATA_SHARDS and remote_candidates:
                from ...utils import faultpolicy

                res = faultpolicy.hedged_gather(
                    DATA_SHARDS - len(got),
                    remote_candidates,
                    lambda sid: remote_read(sid, off, size),
                    pool=_gather_pool(),
                    validate=lambda b: b is not None and len(b) == size,
                    peer_of=getattr(remote_read, "peer_of", None),
                    pod_of=getattr(remote_read, "pod_of", None),
                    what=f"ec {self.id} survivor gather",
                )
                n_remote = res.sent
                for sid, buf in res.got.items():
                    got[sid] = np.frombuffer(buf, dtype=np.uint8)
                gather.annotate(
                    hedges=res.hedges_sent, hedge_wins=res.hedge_wins,
                )
            gather.annotate(survivors=len(got), remote=n_remote,
                            bytes=size * len(got))
        if len(got) < DATA_SHARDS:
            raise InsufficientShards(
                f"ec volume {self.id}: {len(got)} shards reachable, "
                f"{DATA_SHARDS} needed to recover shard {missing_shard}"
            )
        with obs_trace.span("host_reconstruct", backend=backend, bytes=size):
            codec = rs.RSCodec(backend=backend)
            out = codec.reconstruct(got, wanted=[missing_shard])
            return out[missing_shard].tobytes()

    def read_needle_bytes(
        self, needle_id: int, remote_read: RemoteReadFn | None = None,
        backend: str = "cuda", use_device: bool = True,
    ) -> bytes:
        # the .ecx binary search is a real disk read serving the request
        with obs_trace.span("shard_read", op="locate"):
            _, _, intervals = self.locate_needle(needle_id)
        parts = [self.read_interval(iv, remote_read, backend, use_device)
                 for iv in intervals]
        return parts[0] if len(parts) == 1 else b"".join(parts)

    def read_needles_batch(
        self, needle_ids: list[int], remote_read: RemoteReadFn | None = None,
        backend: str = "cuda", zero_copy: bool = False,
    ) -> list[Needle | Exception]:
        """Serve a burst of needle reads with every missing-shard interval
        reconstructed in one reconstruct_intervals call (one ragged device
        launch and D2H for the burst) — with >=10 survivors resident the
        missing shard is recomputed on the card, never fetched from its
        holder.  Local intervals are pread as usual.  Without a device
        cache, or when it lacks survivors (CacheMiss), each missing
        interval takes the per-interval path: its holder through
        `remote_read`, else the host degraded read.

        Returns one entry per requested id, in order; a failed needle
        (deleted, not found, corrupt) yields its exception in that slot.
        `zero_copy` keeps each needle's `data` a memoryview over its one
        source buffer: a pread, or the bytes reconstruct_intervals copied
        out of the pipeline slot's pinned buffer — never the pinned buffer
        itself, which the slot's next batch overwrites."""
        plans: list[tuple[int, list] | Exception] = []
        requests: list[tuple[int, int, int]] = []
        # locate = one .ecx binary search (disk preads) per needle: the
        # batch's index-lookup cost, visible as its own trace stage
        with obs_trace.span(
            "shard_read", op="locate", needles=len(needle_ids)
        ):
            for nid in needle_ids:
                try:
                    _, _, intervals = self.locate_needle(nid)
                except (NeedleNotFound, OSError) as e:
                    plans.append(e)
                    continue
                parts: list = []
                for iv in intervals:
                    sid, off = iv.to_shard_and_offset()
                    if sid in self.shards:
                        parts.append(("local", sid, off, iv.size))
                    else:
                        parts.append(("recon", len(requests)))
                        requests.append((sid, off, iv.size))
                plans.append((nid, parts))

        recon: list[bytes] | None = None
        if requests and self.device_cache is not None:
            try:
                recon = rs_resident.reconstruct_intervals(
                    self.device_cache, self.id, requests
                )
            except rs_resident.CacheMiss:
                self.device_misses += len(requests)

        results: list[Needle | Exception] = []
        for plan in plans:
            if isinstance(plan, Exception):
                results.append(plan)
                continue
            nid, parts = plan
            try:
                pieces: list = []
                for p in parts:
                    if p[0] == "local":
                        _, sid, off, size = p
                        staged = self._host_tier_read(sid, off, size)
                        if staged is not None:
                            with obs_trace.span(
                                "shard_read", shard=sid, bytes=size,
                                source="host_tier",
                            ):
                                pieces.append(staged)
                            continue
                        with obs_trace.span(
                            "shard_read", shard=sid, bytes=size
                        ):
                            pieces.append(self.shards[sid].read_at(off, size))
                    elif recon is not None:
                        pieces.append(recon[p[1]])
                    else:
                        sid, off, size = requests[p[1]]
                        pieces.append(self._read_shard_interval(
                            sid, off, size, remote_read, backend,
                            use_device=False,
                        ))
                raw = pieces[0] if len(pieces) == 1 else b"".join(pieces)
                n = Needle.from_bytes(raw, self.version, copy=not zero_copy)
                if n.id != nid:
                    raise NeedleNotFound(
                        f"ec batch read got needle {n.id:x}, expected {nid:x}"
                    )
                results.append(n)
            except Exception as e:  # isolate per-needle failures
                results.append(e)
        return results

    def read_needle(
        self, needle_id: int, cookie: int | None = None,
        remote_read: RemoteReadFn | None = None, backend: str = "cuda",
        use_device: bool = True, zero_copy: bool = False,
    ) -> Needle:
        """Full needle with CRC verification (ReadEcShardNeedle
        store_ec.go:136-174); `zero_copy` as in read_needles_batch."""
        raw = self.read_needle_bytes(needle_id, remote_read, backend,
                                     use_device)
        n = Needle.from_bytes(raw, self.version, copy=not zero_copy)
        if n.id != needle_id:
            raise NeedleNotFound(
                f"ec read got needle {n.id:x}, expected {needle_id:x}"
            )
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatch(f"cookie mismatch for needle {needle_id:x}")
        return n

    # -- delete (ec_volume_delete.go) ----------------------------------------

    def delete_needle(self, needle_id: int) -> None:
        """Tombstone the .ecx entry in place + journal the id in .ecj
        (DeleteNeedleFromEcx ec_volume_delete.go:27-49)."""
        try:
            entry_off, _, _ = self._search_ecx(needle_id)
        except NeedleNotFound:
            return
        mark_entry_deleted(self._ecx.fileno(), entry_off)
        with self._ecj_lock:
            self._ecj.write(needle_id.to_bytes(8, "big"))
            self._ecj.flush()

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Unmount: closes the files and, when this location holds the
        pin, releases the volume's resident bytes."""
        if self._holds_pin():
            self.device_cache.evict(self.id)
        for s in self.shards.values():
            s.close()
        if not self._ecx.closed:
            self._ecx.close()
        if not self._ecj.closed:
            self._ecj.close()

    def destroy(self) -> None:
        """Remove sidecars + local shards (ec_volume.go Destroy)."""
        self.close()
        for p in [self.ecx_path, self.ecj_path, self.base_name + ".vif"]:
            if os.path.exists(p):
                os.remove(p)
        for s in self.shards.values():
            s.destroy()


def rebuild_ecx_file(base_name: str) -> None:
    """Replay .ecj tombstones into a (rebuilt) .ecx, then drop the journal
    (RebuildEcxFile ec_volume_delete.go:51-98)."""
    ecj_path = base_name + ".ecj"
    if not os.path.exists(ecj_path):
        return
    with open(base_name + ".ecx", "r+b") as ecx:
        size = os.fstat(ecx.fileno()).st_size
        for nid in iter_ecj(ecj_path):
            try:
                entry_off, _, _ = search_sorted_index(ecx.fileno(), size, nid)
            except NeedleNotFound:
                continue
            mark_entry_deleted(ecx.fileno(), entry_off)
    os.remove(ecj_path)
