"""Store: the volume server's registry of volumes and EC shards.

Port of seaweedfs_tpu/storage/store.py (reference: weed/storage/store.go,
store_ec.go, store_ec_delete.go) for one node.  One Store per volume-server
process; it owns a set of DiskLocations and routes needle reads and writes
to the right Volume or EcVolume.  EC reads of a volume whose survivors are
pinned in the DeviceShardCache reconstruct on the card
(EcVolume.read_needles_batch -> rs_resident.reconstruct_intervals).

The Store is synchronous (file I/O + device kernels); the asyncio server
layer calls it via ``asyncio.to_thread``.

The parity scrub (scrub_ec_volume, scrub_ec, scrub_all_resident) runs on
the card when every shard of a volume is resident (one launch of
csrc/scrub.cu a volume, or one for up to 32 volumes of one span) and
streams the shard files through verify_ec_files otherwise.

The heartbeat reads the store as the reference's does: collect_heartbeat
for a full pulse (VolumeMessage / EcShardMessage records), and drain_deltas
for the mounts, unmounts, deletes and EC shard changes queued since the
last pulse (NewVolumesChan / NewEcShardsChan, store.go:66-70).  EC reads
take a `remote_read` hook (server/volume.py's peer shard reader) for
shards that live on other servers.

The residency ladder (serving/tiering.py) attaches its host-RAM tier
through set_ec_host_cache, so every mounted EcVolume reads staged bytes
before its shard files; ec_volume_tier names a volume's rung.  The
streaming ingest plane (ingest/, attached as `ingest` by the volume
server) lets ec_generate seal a volume from its streamed parity.

Not here, each named in ROADMAP A4c: the `.dat` tier moves, and vacuum
(with it the ingest pipeline's vacuum invalidation).
"""
from __future__ import annotations

import glob
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field

from . import needle as needle_mod
from . import types as t
from .disk_location import DiskLocation
from .ec import (
    DATA_SHARDS,
    EcVolume,
    ShardBits,
    ec_base_name,
    rebuild_ec_files,
    rebuild_ecx_file,
    to_ext,
    write_ec_files,
    write_sorted_file_from_idx,
)
from .needle import Needle
from .volume import CookieMismatch, NotFoundError, Volume, VolumeInfo


@dataclass
class VolumeMessage:
    """Heartbeat record for one normal volume
    (master_pb.VolumeInformationMessage, master.proto:77-95)."""

    id: int
    size: int
    collection: str
    file_count: int
    delete_count: int
    deleted_byte_count: int
    read_only: bool
    replica_placement: int
    version: int
    ttl: int
    disk_type: str
    modified_at_second: int = 0


@dataclass
class EcShardMessage:
    """Heartbeat record for one EC volume's local shards
    (master_pb.VolumeEcShardInformationMessage, master.proto:97-102)."""

    id: int
    collection: str
    ec_index_bits: int
    disk_type: str


@dataclass
class HeartbeatState:
    """Everything the master needs from one pulse (master_pb.Heartbeat,
    master.proto:45-75)."""

    volumes: list[VolumeMessage] = field(default_factory=list)
    ec_shards: list[EcShardMessage] = field(default_factory=list)
    max_volume_counts: dict[str, int] = field(default_factory=dict)
    has_no_volumes: bool = False
    has_no_ec_shards: bool = False


class Store:
    def __init__(
        self,
        locations: list[DiskLocation],
        ip: str = "localhost",
        port: int = 8080,
        public_url: str = "",
        ec_backend: str = "cuda",
        ec_device_cache=None,  # ops.rs_resident.DeviceShardCache | None
    ):
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.locations = locations
        self.ec_backend = ec_backend
        self.ec_device_cache = ec_device_cache
        # host-RAM warm tier (serving/tiering.HostShardCache | None):
        # attached by the tiering controller; every mounted EcVolume
        # carries the reference so interval reads probe it without the
        # controller on the read path
        self.ec_host_cache = None
        # streaming write plane (ingest.IngestPlane | None), attached by
        # the volume server: ec_generate consults it for a streamed seal,
        # delete/unmount drop its per-volume pipelines
        self.ingest = None
        self.volume_size_limit = 30 * 1024 * 1024 * 1024  # set by master pulse
        self._lock = threading.RLock()
        # device-cache pin threads: cancellable + joined on close
        self._closing = threading.Event()
        self._pin_threads: list[threading.Thread] = []
        # delta queues drained by the heartbeat loop (store.go:66-70)
        self.new_volumes: queue.SimpleQueue[VolumeMessage] = queue.SimpleQueue()
        self.deleted_volumes: queue.SimpleQueue[VolumeMessage] = queue.SimpleQueue()
        self.new_ec_shards: queue.SimpleQueue[EcShardMessage] = queue.SimpleQueue()
        self.deleted_ec_shards: queue.SimpleQueue[EcShardMessage] = queue.SimpleQueue()
        for loc in self.locations:
            loc.load_existing_volumes()
        if self.ec_device_cache is not None:
            for loc in self.locations:
                for ev in loc.ec_volumes.values():
                    self._pin_ec_shards_async(ev)

    # -- lookup --------------------------------------------------------------

    def find_volume(self, vid: int) -> Volume | None:
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                return v
        return None

    def find_ec_volume(self, vid: int) -> EcVolume | None:
        for loc in self.locations:
            ev = loc.ec_volumes.get(vid)
            if ev is not None:
                return ev
        return None

    def set_ec_host_cache(self, host_cache) -> None:
        """Attach (or detach, None) the host-RAM warm tier to every
        mounted EC volume — and to future mounts via `ec_host_cache`."""
        self.ec_host_cache = host_cache
        with self._lock:
            for loc in self.locations:
                for ev in loc.ec_volumes.values():
                    ev.host_cache = host_cache

    def ec_volume_tier(self, vid: int) -> str:
        """Residency tier of `vid` right now: "hbm" (device-resident,
        the dispatcher's batched route), "host" (shard bytes held in host
        RAM — the native path serves without disk preads), or "disk"."""
        if self.ec_volume_is_resident(vid):
            return "hbm"
        hc = self.ec_host_cache
        if hc is not None and hc.resident_count(vid) >= DATA_SHARDS:
            return "host"
        return "disk"

    def ec_volume_is_resident(self, vid: int) -> bool:
        """Routing predicate for the serving dispatcher: True when the
        vid's shard set is pinned deep enough that a coalesced batch
        becomes one resident reconstruct call.  False while the pin
        thread is still uploading (reads fall to the host path instead of
        queuing behind a batch that can't use the card)."""
        if self.ec_device_cache is None:
            return False
        return (
            self.find_ec_volume(vid) is not None
            and self.ec_device_cache.resident_count(vid) >= DATA_SHARDS
        )

    def location_of_volume(self, vid: int) -> DiskLocation | None:
        for loc in self.locations:
            if vid in loc.volumes:
                return loc
        return None

    def volume_infos(self) -> list[VolumeInfo]:
        return [
            v.info() for loc in self.locations for v in loc.volumes.values()
        ]

    # -- volume lifecycle (store.go:200-320) ---------------------------------

    def add_volume(
        self,
        vid: int,
        collection: str = "",
        replica_placement: str | t.ReplicaPlacement = "000",
        ttl: str | t.TTL = "",
        version: int = needle_mod.CURRENT_VERSION,
        disk_type: str = "",
    ) -> Volume:
        with self._lock:
            if self.find_volume(vid) is not None:
                raise ValueError(f"volume {vid} already exists")
            loc = self._pick_location(disk_type)
            if loc is None:
                raise RuntimeError("no disk location has free slots")
            if isinstance(replica_placement, str):
                replica_placement = t.ReplicaPlacement.parse(replica_placement)
            if isinstance(ttl, str):
                ttl = t.TTL.parse(ttl)
            v = Volume(
                loc.directory, vid, collection, replica_placement, ttl, version
            )
            loc.volumes[vid] = v
            self.new_volumes.put(self._volume_message(v, loc.disk_type))
            return v

    def _pick_location(self, disk_type: str = "") -> DiskLocation | None:
        best = None
        for loc in self.locations:
            if disk_type and loc.disk_type != disk_type:
                continue
            if loc.free_slots() <= 0:
                continue
            if best is None or loc.free_slots() > best.free_slots():
                best = loc
        return best

    def delete_volume(self, vid: int) -> None:
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    msg = self._volume_message(v, loc.disk_type)
                    if self.ingest is not None:
                        self.ingest.drop(vid)
                    v.destroy()
                    self.deleted_volumes.put(msg)
                    return
        raise NotFoundError(f"volume {vid} not found")

    def unmount_volume(self, vid: int) -> None:
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    msg = self._volume_message(v, loc.disk_type)
                    if self.ingest is not None:
                        self.ingest.drop(vid)
                    v.close()
                    self.deleted_volumes.put(msg)
                    return
        raise NotFoundError(f"volume {vid} not found")

    def mount_volume(self, vid: int) -> None:
        with self._lock:
            for loc in self.locations:
                if vid in loc.volumes:
                    return
                for dat in glob.glob(os.path.join(loc.directory, f"*{vid}.dat")):
                    stem = os.path.basename(dat)[: -len(".dat")]
                    collection, _, vid_s = stem.rpartition("_")
                    if vid_s != str(vid):
                        continue
                    v = Volume(loc.directory, vid, collection)
                    loc.volumes[vid] = v
                    self.new_volumes.put(self._volume_message(v, loc.disk_type))
                    return
        raise NotFoundError(f"volume {vid} not found on disk")

    def mark_volume_readonly(self, vid: int, read_only: bool = True) -> None:
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        v.read_only = read_only
        if not read_only:
            v.full = False  # admin override re-opens a size-locked volume
        # push the flip at once (both directions) so the master's writable
        # pool tracks it without waiting for a full re-sync
        self._push_volume_delta(v)

    # -- needle ops ----------------------------------------------------------

    def write_needle(self, vid: int, n: Needle) -> int:
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        # soft limit, as the reference: the limit-crossing write itself
        # still lands, THEN the volume stops accepting appends
        v.append_needle(n)
        if not v.full and v.content_size > self.volume_size_limit:
            v.full = True
            self._push_volume_delta(v)
        return n.size

    def _push_volume_delta(self, v: Volume) -> None:
        loc = self.location_of_volume(v.id)
        self.new_volumes.put(
            self._volume_message(v, loc.disk_type if loc else "")
        )

    def read_needle(
        self,
        vid: int,
        needle_id: int,
        cookie: int | None = None,
        read_deleted: bool = False,
        zero_copy: bool = False,
    ) -> Needle:
        v = self.find_volume(vid)
        if v is not None:
            return v.read(
                needle_id, cookie, read_deleted=read_deleted,
                zero_copy=zero_copy,
            )
        ev = self.find_ec_volume(vid)
        if ev is not None:
            return self.read_ec_needle(vid, needle_id, cookie, zero_copy=zero_copy)
        raise NotFoundError(f"volume {vid} not found")

    def delete_needle(self, vid: int, needle_id: int, cookie: int | None = None) -> int:
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        return v.delete(needle_id, cookie)

    # -- EC shard lifecycle (store_ec.go) ------------------------------------

    def ec_generate(self, vid: int) -> None:
        """Stripe a local volume into .ec00-.ec13 + .ecx + .vif
        (VolumeEcShardsGenerate volume_grpc_erasure_coding.go:38-81), the
        GF(256) math on the configured backend (the card by default).
        Streamed seal first: when the ingest plane already encoded the
        volume's interior stripe rows as the writes landed, the seal only
        re-reads the .dat for the data shards and encodes the zero-padded
        tail row; an invalidated or absent pipeline falls through to the
        offline bulk encode (the same bytes either way).  Quiesce the
        volume's writers first: the seal takes the pipeline's feed lock.
        The reference also invalidates a pipeline when vacuum rewrites the
        .dat (Store.vacuum_volume); the port has no vacuum yet (ROADMAP
        A4b), so nothing here rewrites a streaming volume's offsets."""
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        v.sync()
        base = Volume.base_name(v.dir, vid, v.collection)
        streamed = False
        if self.ingest is not None:
            streamed = self.ingest.seal(vid, base, backend=self.ec_backend)
        if not streamed:
            write_ec_files(base, backend=self.ec_backend)
        write_sorted_file_from_idx(base)

    def ec_rebuild(
        self, vid: int, collection: str = "", fsync: bool = False
    ) -> list[int]:
        """Rebuild whatever shards are missing from the local >=10
        (VolumeEcShardsRebuild volume_grpc_erasure_coding.go:84-123).
        Returns rebuilt shard ids."""
        base = self._ec_base(vid, collection)
        if base is None:
            raise NotFoundError(f"ec volume {vid} not found")
        rebuilt = rebuild_ec_files(base, backend=self.ec_backend, fsync=fsync)
        rebuild_ecx_file(base)
        return rebuilt

    def _ec_base(self, vid: int, collection: str = "") -> str | None:
        """Directory-resolved EC base name: prefer a mounted EcVolume's dir,
        else any location holding shard/sidecar files."""
        ev = self.find_ec_volume(vid)
        if ev is not None:
            return ev.base_name
        for loc in self.locations:
            base = ec_base_name(loc.directory, vid, collection)
            if os.path.exists(base + ".ecx") or os.path.exists(base + to_ext(0)):
                return base
        return None

    def mount_ec_shards(self, vid: int, shard_ids: list[int], collection: str = "") -> None:
        """(VolumeEcShardsMount volume_grpc_erasure_coding.go:267-287)"""
        with self._lock:
            ev = self.find_ec_volume(vid)
            if ev is None:
                loc = self._location_with_ec_files(vid, collection)
                if loc is None:
                    raise NotFoundError(f"ec volume {vid} has no local files")
                ev = EcVolume(loc.directory, vid, collection)
                ev.host_cache = self.ec_host_cache
                loc.ec_volumes[vid] = ev
            for sid in shard_ids:
                ev.add_shard(sid)
            self.new_ec_shards.put(self._ec_message(ev))
        if self.ec_device_cache is not None:
            self._pin_ec_shards_async(ev)

    def _pin_ec_shards_async(self, ev: EcVolume) -> None:
        """Pin a volume's local shards in device memory off the caller's
        thread, so the upload never blocks the store lock, a mount or
        server startup.  Until the thread finishes, ec_volume_is_resident
        is False and reads take the native route.  Nothing compiles: the
        CUDA kernels take runtime shapes, so there is no warm step."""
        cache = self.ec_device_cache
        if self._closing.is_set():
            return

        def pin():
            try:
                ev.load_shards_to_device(
                    cache, should_stop=self._closing.is_set
                )
            except Exception:
                logging.getLogger(__name__).exception(
                    "ec device-cache pinning failed for volume %d", ev.id
                )
                # a claim never backed by a resident shard would block
                # another location's healthy copy until restart
                cache.release_pin_source(ev.id, ev.dir)

        # prune finished threads so mount/unmount churn doesn't pile up
        self._pin_threads = [t for t in self._pin_threads if t.is_alive()]
        th = threading.Thread(target=pin, name=f"ec-pin-{ev.id}", daemon=True)
        self._pin_threads.append(th)
        th.start()

    def _location_with_ec_files(self, vid: int, collection: str) -> DiskLocation | None:
        for loc in self.locations:
            if os.path.exists(ec_base_name(loc.directory, vid, collection) + ".ecx"):
                return loc
        return None

    def unmount_ec_shards(self, vid: int, shard_ids: list[int]) -> None:
        with self._lock:
            ev = self.find_ec_volume(vid)
            if ev is None:
                return
            bits = ShardBits(0)
            for sid in shard_ids:
                s = ev.delete_shard(sid)
                if s is not None:
                    s.close()
                    bits = bits.add(sid)
            self.deleted_ec_shards.put(
                EcShardMessage(vid, ev.collection, int(bits),
                               self._disk_type_of(ev))
            )
            if not ev.shards:
                for loc in self.locations:
                    if loc.ec_volumes.get(vid) is ev:
                        del loc.ec_volumes[vid]
                ev.close()
                # whole-vid release: the claim must not outlive the
                # unmounted volume and block a later pinner
                cache = self.ec_device_cache
                if cache is not None and cache.pin_source(vid) == ev.dir:
                    cache.evict(vid)
                # the warm tier's claim must not outlive the volume either
                # (outstanding zero-copy views keep their own arrays alive)
                if self.ec_host_cache is not None:
                    self.ec_host_cache.evict(vid)

    def delete_ec_shards(self, vid: int, shard_ids: list[int], collection: str = "") -> None:
        """Unmount + remove the shard files; drop sidecars when the last
        shard goes (VolumeEcShardsDelete volume_grpc_erasure_coding.go:181-236)."""
        with self._lock:
            ev = self.find_ec_volume(vid)
            if ev is not None:
                collection = ev.collection
            self.unmount_ec_shards(vid, shard_ids)
            base = self._ec_base(vid, collection)
            if base is None:
                return
            for sid in shard_ids:
                p = base + to_ext(sid)
                if os.path.exists(p):
                    os.remove(p)
            if not any(os.path.exists(base + to_ext(i)) for i in range(14)):
                for ext in (".ecx", ".ecj", ".vif"):
                    if os.path.exists(base + ext):
                        os.remove(base + ext)

    def destroy_ec_volume(self, vid: int) -> None:
        with self._lock:
            for loc in self.locations:
                ev = loc.ec_volumes.pop(vid, None)
                if ev is not None:
                    self.deleted_ec_shards.put(self._ec_message(ev))
                    ev.destroy()
                    if self.ec_host_cache is not None:
                        self.ec_host_cache.evict(vid)

    # -- parity scrub (store.go's VolumeEcShardsVerify backend) ---------------

    def scrub_ec_volume(self, vid: int) -> dict:
        """Parity scrub of a mounted EC volume: recompute parity and count
        mismatching bytes per parity shard, on the card when every shard
        is resident (only the mismatch partials come down), else by
        streaming the shard files through the codec.  -> {parity_mismatch_
        bytes, backend, seconds, bytes_verified}."""
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise NotFoundError(f"ec volume {vid} not found")
        return self.scrub_ec(ev)

    def scrub_all_resident(self) -> dict[int, dict]:
        """Parity-scrub every fully device-resident EC volume in one pass
        over the cache (rs_resident.scrub_all_resident: one launch per
        span class and 32 volumes).  -> {vid: result dict in the scrub_ec
        shape, plus "dir" (the pinned location, the only location whose
        files the resident verdict speaks for) and "device_calls" /
        "volumes_in_pass" of the shared pass}.  Volumes not covered (not
        fully resident, mixed sizes, unpinned location) are absent: the
        caller's per-volume path owns them."""
        cache = self.ec_device_cache
        if cache is None:
            return {}
        from ..ops import rs_resident

        eligible: dict[int, EcVolume] = {}
        with self._lock:
            for loc in self.locations:
                for vid, ev in loc.ec_volumes.items():
                    # scrub_ec's attribution rule: the resident verdict
                    # speaks only for the pinned location's files
                    if ev.is_device_resident():
                        eligible[vid] = ev
        if not eligible:
            return {}
        t0 = time.time()
        results, pass_stats = rs_resident.scrub_all_resident(
            cache, vids=sorted(eligible)
        )
        wall = time.time() - t0
        # the shared pass's wall apportioned by span: per-volume seconds
        # sum back to the pass wall
        total_span = sum(span for _m, span in results.values()) or 1
        return {
            vid: {
                "parity_mismatch_bytes": mism,
                "backend": "device_megakernel",
                "seconds": wall * span / total_span,
                "bytes_verified": span,
                "dir": eligible[vid].dir,
                "device_calls": pass_stats["device_calls"],
                "volumes_in_pass": pass_stats["volumes"],
            }
            for vid, (mism, span) in results.items()
        }

    def scrub_ec(self, ev: EcVolume) -> dict:
        """Scrub one specific EcVolume object (a vid can be mounted in
        several disk locations; resolving by vid would always scrub the
        first location's copy).  The resident path speaks only for the
        location whose shard files were pinned (EcVolume.
        is_device_resident); another location's copy scrubs its own files."""
        t0 = time.time()
        if self.ec_device_cache is not None and ev.is_device_resident():
            from ..ops import rs_resident

            try:
                mism, span = rs_resident.scrub_volume(
                    self.ec_device_cache, ev.id
                )
                return {
                    "parity_mismatch_bytes": mism,
                    "backend": "device_resident",
                    "seconds": time.time() - t0,
                    "bytes_verified": span,
                }
            except rs_resident.CacheMiss:
                pass
        from ..ops import rs
        from .ec.encoder import verify_ec_files

        mism, span = verify_ec_files(ev.base_name, backend=self.ec_backend)
        return {
            "parity_mismatch_bytes": mism,
            "backend": rs.resolve_backend(self.ec_backend),
            "seconds": time.time() - t0,
            "bytes_verified": span,
        }

    # -- EC reads ------------------------------------------------------------

    def read_ec_needle(
        self,
        vid: int,
        needle_id: int,
        cookie: int | None = None,
        remote_read=None,
        use_device: bool = True,
        zero_copy: bool = False,
    ) -> Needle:
        """(ReadEcShardNeedle store_ec.go:136-174): local shards, then the
        shard's holder through `remote_read`, then a degraded
        reconstruction from the survivors, local and remote.
        `use_device=False` forces the host reconstruct even when the
        volume is resident (the dispatcher's shed path)."""
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise NotFoundError(f"ec volume {vid} not found")
        return ev.read_needle(
            needle_id, cookie, remote_read, backend=self.ec_backend,
            use_device=use_device, zero_copy=zero_copy,
        )

    def read_ec_needles_batch(
        self,
        vid: int,
        requests: list[tuple[int, int | None]],  # (needle_id, cookie)
        remote_read=None,
        zero_copy: bool = False,
    ) -> list[Needle | Exception]:
        """Serve a burst of EC needle reads in one coalesced call: every
        degraded-read reconstruction in the batch becomes one ragged
        resident launch (EcVolume.read_needles_batch).  One result slot per
        request; a bad needle yields its exception without failing the
        rest."""
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise NotFoundError(f"ec volume {vid} not found")
        results = ev.read_needles_batch(
            [nid for nid, _ in requests], remote_read,
            backend=self.ec_backend, zero_copy=zero_copy,
        )
        out: list[Needle | Exception] = []
        for (nid, cookie), r in zip(requests, results):
            if (
                isinstance(r, Needle)
                and cookie is not None
                and r.cookie != cookie
            ):
                out.append(CookieMismatch(f"cookie mismatch for {nid:x}"))
            else:
                out.append(r)
        return out

    def read_ec_shard_interval(self, vid: int, shard_id: int, offset: int, size: int) -> bytes:
        """Serve a raw shard range to a peer (VolumeEcShardRead
        volume_grpc_erasure_coding.go:309-375)."""
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise NotFoundError(f"ec volume {vid} not found")
        shard = ev.shards.get(shard_id)
        if shard is None:
            raise NotFoundError(f"ec volume {vid} shard {shard_id} not local")
        return shard.read_at(offset, size)

    def delete_ec_needle(self, vid: int, needle_id: int) -> None:
        """Local tombstone (VolumeEcBlobDelete)."""
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise NotFoundError(f"ec volume {vid} not found")
        ev.delete_needle(needle_id)

    # -- heartbeat assembly (CollectHeartbeat store.go:254-320,
    #    CollectErasureCodingHeartbeat store_ec.go:25-52) --------------------

    def _volume_message(self, v: Volume, disk_type: str) -> VolumeMessage:
        info = v.info()
        return VolumeMessage(
            id=v.id,
            size=info.size,
            collection=v.collection,
            file_count=info.file_count,
            delete_count=info.delete_count,
            deleted_byte_count=info.deleted_bytes,
            read_only=v.read_only or v.full,
            replica_placement=v.super_block.replica_placement.to_byte(),
            version=v.version,
            ttl=int.from_bytes(v.super_block.ttl.to_bytes(), "big"),
            disk_type=disk_type,
            modified_at_second=getattr(v, "last_modified_at", 0),
        )

    def _disk_type_of(self, ev: EcVolume) -> str:
        for loc in self.locations:
            if loc.ec_volumes.get(ev.id) is ev:
                return loc.disk_type
        return "hdd"

    def _ec_message(self, ev: EcVolume) -> EcShardMessage:
        return EcShardMessage(
            id=ev.id,
            collection=ev.collection,
            ec_index_bits=int(ev.shard_bits()),
            disk_type=self._disk_type_of(ev),
        )

    def collect_heartbeat(self) -> HeartbeatState:
        hs = HeartbeatState()
        for loc in self.locations:
            hs.max_volume_counts[loc.disk_type] = (
                hs.max_volume_counts.get(loc.disk_type, 0) + loc.max_volume_count
            )
            for v in loc.volumes.values():
                hs.volumes.append(self._volume_message(v, loc.disk_type))
            for ev in loc.ec_volumes.values():
                hs.ec_shards.append(self._ec_message(ev))
        hs.has_no_volumes = not hs.volumes
        hs.has_no_ec_shards = not hs.ec_shards
        return hs

    def drain_deltas(self):
        """-> (new_vols, deleted_vols, new_ec, deleted_ec) accumulated since
        the last pulse."""

        def drain(q):
            out = []
            while True:
                try:
                    out.append(q.get_nowait())
                except queue.Empty:
                    return out

        return (
            drain(self.new_volumes),
            drain(self.deleted_volumes),
            drain(self.new_ec_shards),
            drain(self.deleted_ec_shards),
        )

    def close(self) -> None:
        # stop + join the pin threads FIRST: a daemon thread torn down
        # mid-upload at interpreter exit can take the process with it
        self._closing.set()
        for th in self._pin_threads:
            th.join(timeout=60)
        self._pin_threads.clear()
        for loc in self.locations:
            loc.close()
