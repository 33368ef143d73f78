"""Heat-tiered residency: HBM -> host RAM -> disk, driven by observed
popularity.

Port of seaweedfs_tpu/serving/tiering.py.  Residency was a mount-time
pin and a blind LRU budget eviction; this module closes the loop the way
SeaweedFS's own hot/warm storage backends tier `.dat` files, but for the
device shard cache (ops/rs_resident.DeviceShardCache):

  * `HeatTracker` — decayed per-volume counters, fed from the serving
    dispatcher's admission path (`EcReadDispatcher.read` calls
    `note_read` for every EC read it routes) and from the ingest plane's
    post-append hook (write heat: a freshly written volume enters the
    ladder warm).  Interactive-tier reads weigh 1.0, bulk reads
    `-ec.tier.bulkWeight`: a bulk scan must not evict the front door's
    hot set.
  * `HostShardCache` — the warm tier: shard bytes held in host RAM (numpy
    arrays staged once from the shard files), served through the host
    read and reconstruct path via zero-copy memoryview slices — a warm
    read touches no disk.
  * `TieringController` — the ladder: hot volumes promote into HBM (a pin
    through `EcVolume.load_shards_to_device`, host-RAM bytes first; the
    promoted volume's reads then take the ragged resident launch of
    csrc/fused_reconstruct.cu), warm volumes demote into the host cache,
    cold volumes fall back to disk.  Demotion under HBM pressure is
    heat-chosen (coldest victim) instead of the blind LRU budget
    eviction, and hysteresis — a promotion/demotion threshold separated by
    `-ec.tier.promoteRatio` plus a `-ec.tier.minResidencySeconds` floor —
    keeps a flash crowd from thrashing the ladder.

Fit and pressure are judged per device of the cache's serving mesh
(`device_stats`, `pressure_devices`, `plan_pin`, `device_bytes_by_vid`):
a swap demotes only volumes holding bytes where the candidate lands, and
in a pod lane-sharded volumes leave only through the cache's eviction
partition.

What the reference does and this port does not: the promotion's AOT
pre-warm (`rs_resident.warm(...)`): nothing here compiles per shape (the
CUDA kernels take runtime shapes), so a promoted volume's first reads
never wait on a compile.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import TYPE_CHECKING, Callable

import numpy as np

from ..obs import incident as obs_incident
from ..stats import metrics as stats_metrics
from .qos import BULK

if TYPE_CHECKING:
    from .config import ServingConfig

log = logging.getLogger("serving.tiering")

TIER_HBM = "hbm"
TIER_HOST = "host"
TIER_DISK = "disk"
TIERS = (TIER_HBM, TIER_HOST, TIER_DISK)

# ladder moves per rebalance cycle: bounds promotion/demotion churn (and
# the pin/stage IO it costs) no matter how violently the heat ranking
# reshuffles between cycles
MAX_MOVES_PER_CYCLE = 2
# a volume whose promotion pin FAILED is not retried for this long: the
# failure already cost (at worst) one healthy demotion, and retrying
# every cycle would turn one unreadable shard file into a permanent
# demote-thrash loop
PROMOTE_FAILURE_BACKOFF_S = 60.0
# most residents one swap may demote to fit a single big candidate:
# bounds the per-cycle pin/stage IO a giant volume can trigger (a
# candidate needing more victims than this is skipped, not served)
MAX_SWAP_VICTIMS = 4


class HeatTracker:
    """Exponentially-decayed per-volume read counters.

    `note(vid, tier)` adds one (QoS-weighted) observation; `value(vid)`
    reads the decayed count.  Decay uses a half-life rather than a
    fixed window so a volume's heat is continuous — no cliff at a
    window edge — and idle volumes converge to zero, which is what lets
    the controller treat "heat 0" as never-promote."""

    def __init__(
        self,
        half_life_s: float = 60.0,
        bulk_weight: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.half_life_s = max(half_life_s, 1e-3)
        self.bulk_weight = bulk_weight
        self._clock = clock
        self._lock = threading.Lock()
        self._heat: dict[int, float] = {}
        self._stamp: dict[int, float] = {}

    def _decayed(self, vid: int, now: float) -> float:
        h = self._heat.get(vid, 0.0)
        if h <= 0.0:
            return 0.0
        dt = now - self._stamp.get(vid, now)
        if dt <= 0.0:
            return h
        return h * 0.5 ** (dt / self.half_life_s)

    # entries whose decayed heat fell below this are dropped at prune
    # time — after ~10 half-lives a single read's trace is gone
    PRUNE_FLOOR = 1e-3
    # tracked-vid cap: note() prunes past this so a client probing
    # random fids (the dispatcher feeds every requested vid, existent
    # or not) cannot grow the dicts without bound
    MAX_TRACKED = 8192

    def note(self, vid: int, tier: str = "", n: int = 1) -> None:
        """Record `n` reads of `vid`; bulk-tier reads are down-weighted
        (-ec.tier.bulkWeight) so background scans cannot out-heat the
        interactive front door."""
        w = (self.bulk_weight if tier == BULK else 1.0) * n
        now = self._clock()
        with self._lock:
            self._heat[vid] = self._decayed(vid, now) + w
            self._stamp[vid] = now
            if len(self._heat) > self.MAX_TRACKED:
                self._prune_locked(now)

    def _prune_locked(self, now: float) -> None:
        """Drop cooled-off entries; if probing traffic keeps more than
        MAX_TRACKED vids warm, keep the hottest half (caller holds the
        lock)."""
        for vid in [
            v
            for v in self._heat
            if self._decayed(v, now) < self.PRUNE_FLOOR
        ]:
            del self._heat[vid]
            del self._stamp[vid]
        if len(self._heat) > self.MAX_TRACKED:
            keep = sorted(
                self._heat, key=lambda v: -self._decayed(v, now)
            )[: self.MAX_TRACKED // 2]
            keep_set = set(keep)
            for vid in list(self._heat):
                if vid not in keep_set:
                    del self._heat[vid]
                    del self._stamp[vid]

    def prune(self, now: float | None = None) -> None:
        """Periodic cleanup hook (the controller calls it per
        rebalance): keeps the tracked-vid set bounded even when note()
        never crosses the cap."""
        now = self._clock() if now is None else now
        with self._lock:
            self._prune_locked(now)

    def value(self, vid: int, now: float | None = None) -> float:
        now = self._clock() if now is None else now
        with self._lock:
            return self._decayed(vid, now)

    def snapshot(self, now: float | None = None) -> dict[int, float]:
        now = self._clock() if now is None else now
        with self._lock:
            return {vid: self._decayed(vid, now) for vid in self._heat}

    def forget(self, vid: int) -> None:
        with self._lock:
            self._heat.pop(vid, None)
            self._stamp.pop(vid, None)


class HostShardCache:
    """Warm tier: EC shard bytes pinned in host RAM, whole volumes at a
    time (partial shard sets cannot reconstruct, so per-shard residency
    would only fake coverage).  Reads hand out zero-copy memoryview
    slices of the staged arrays — the arrays are never mutated in place
    (eviction just drops the reference; an outstanding view keeps its
    buffer alive via the ordinary refcount), so a demotion racing a read
    never changes the bytes the read holds."""

    def __init__(self, budget_bytes: int) -> None:
        self.budget = budget_bytes
        self._lock = threading.Lock()
        self._shards: dict[int, dict[int, np.ndarray]] = {}
        self.bytes_used = 0
        # cumulative stage/evict counters for telemetry
        self.stages = 0
        self.evictions = 0

    def put_volume(self, vid: int, shards: dict[int, np.ndarray]) -> bool:
        """Stage a whole volume's shard bytes; all-or-nothing against
        the budget (False = did not fit — the CONTROLLER picks victims
        by heat; this cache never blindly evicts)."""
        size = sum(int(a.nbytes) for a in shards.values())
        if not shards:
            return False
        with self._lock:
            old = self._shards.get(vid)
            old_size = (
                sum(int(a.nbytes) for a in old.values()) if old else 0
            )
            if self.bytes_used - old_size + size > self.budget:
                return False
            if old is not None:
                self.bytes_used -= old_size
            self._shards[vid] = dict(shards)
            self.bytes_used += size
            self.stages += 1
            stats_metrics.VOLUME_SERVER_EC_TIER_HOST_BYTES.set(
                self.bytes_used
            )
        return True

    def shard_array(self, vid: int, shard_id: int) -> np.ndarray | None:
        with self._lock:
            vol = self._shards.get(vid)
            return None if vol is None else vol.get(shard_id)

    def read(self, vid: int, shard_id: int, off: int, size: int):
        """-> zero-copy memoryview of the staged bytes, or None when the
        shard is not host-resident.  Short slices at the shard tail
        mirror a disk pread's short read (callers already handle it);
        only FULL serves count in the host-reads series — a short slice
        the caller throws away and re-reads from disk must not read as
        'the warm tier served it'."""
        arr = self.shard_array(vid, shard_id)
        if arr is None:
            return None
        view = memoryview(arr.data)[off : off + size]
        if len(view) == size:
            stats_metrics.VOLUME_SERVER_EC_TIER_HOST_READS.inc()
        return view

    def resident_count(self, vid: int) -> int:
        with self._lock:
            vol = self._shards.get(vid)
            return 0 if vol is None else len(vol)

    def volume_bytes(self, vid: int) -> int:
        with self._lock:
            vol = self._shards.get(vid)
            if vol is None:
                return 0
            return sum(int(a.nbytes) for a in vol.values())

    def vids(self) -> list[int]:
        with self._lock:
            return sorted(self._shards)

    def evict(self, vid: int) -> int:
        """Drop a volume's staged bytes; returns bytes freed.  Any
        outstanding memoryview keeps its own array alive — eviction
        only ends the cache's claim on the budget."""
        with self._lock:
            vol = self._shards.pop(vid, None)
            if vol is None:
                return 0
            freed = sum(int(a.nbytes) for a in vol.values())
            self.bytes_used -= freed
            self.evictions += 1
            stats_metrics.VOLUME_SERVER_EC_TIER_HOST_BYTES.set(
                self.bytes_used
            )
        return freed


class TieringController:
    """The residency ladder over one Store's EC volumes.

    `rebalance()` is the single decision point, run by the volume
    server's tier loop (-ec.tier.intervalSeconds) or driven manually by
    tests.  Each cycle:

      1. PRESSURE — while the HBM cache is over budget, demote the
         coldest resident volume (heat-chosen, not LRU) to the host
         tier (or disk when no host budget); over-budget demotion
         ignores the min-residency floor — staying over budget would
         re-trigger the BLIND per-shard LRU eviction this controller
         replaces.
      2. PROMOTE — hottest non-resident volumes move into free HBM
         budget; when the budget is full, a candidate must out-heat the
         coldest eligible resident by `promote_ratio` AND the victim
         must be past `min_residency_s` (hysteresis: the demotion
         threshold sits promote_ratio below the promotion threshold, so
         a flash crowd flapping between two volumes cannot thrash).
         While any QoS breaker is open (overload), swaps are frozen —
         promotion churn must not add pin traffic to a device already
         shedding — but free-budget promotions still run.
      3. HOST FILL — the hottest non-HBM volumes fill the host-RAM
         budget in heat order; host entries that fell cold (or got
         promoted) are dropped.

    Promotion pins shards (host-cache bytes first, disk otherwise)."""

    def __init__(
        self,
        store,
        cfg: "ServingConfig",
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.store = store
        self.cfg = cfg
        self._clock = clock
        self.heat = HeatTracker(
            cfg.tier_half_life_seconds, cfg.tier_bulk_weight, clock
        )
        self.host_cache: HostShardCache | None = None
        if cfg.tier_host_cache_mb > 0:
            self.host_cache = HostShardCache(cfg.tier_host_cache_mb << 20)
        # attach the host tier to every mounted (and future) EC volume
        # so its reads serve from RAM without the controller on the path
        store.set_ec_host_cache(self.host_cache)
        self.qos = None  # serving/qos.QosController | None
        self._lock = threading.Lock()  # rebalance is single-flight
        self._resident_since: dict[int, float] = {}
        # vid -> monotonic time of the last FAILED promotion pin
        # (unreadable shard file, claim lost): backed off so one broken
        # hot volume cannot demote a healthy resident every cycle
        self._promote_failed_at: dict[int, float] = {}
        # cumulative ladder counters (heartbeat telemetry + /metrics)
        self.promotions = {TIER_HBM: 0, TIER_HOST: 0}
        self.demotions = {TIER_HBM: 0, TIER_HOST: 0}
        # last rebalance's tier census (telemetry reads this instead of
        # re-scanning the store per heartbeat pulse)
        self.last_sizes = {TIER_HBM: 0, TIER_HOST: 0, TIER_DISK: 0}

    # ------------------------------------------------------------- signals

    def note_read(self, vid: int, tier: str = "") -> None:
        """The dispatcher's per-read heat feed (every EC read, batched
        or native, before routing)."""
        self.heat.note(vid, tier)

    def attach_qos(self, qos) -> None:
        """Wire the QoS controller so overload (any open breaker)
        freezes ladder swaps for the cycle."""
        self.qos = qos

    def _qos_storm(self) -> bool:
        q = self.qos
        if q is None:
            return False
        try:
            return any(
                q.breaker_state(t) != 0 for t in q.policies
            )
        except Exception:  # noqa: BLE001 — a QoS probe failure must
            # never stall the ladder; treat as calm
            return False

    # ------------------------------------------------------------ census

    def _volumes(self) -> tuple[dict[int, object], dict[int, tuple[int, int]]]:
        """(vid -> EcVolume, vid -> (local shard count, shard size)) for
        every locally mounted EC volume (first location wins, matching
        Store.find_ec_volume's resolution).  BOTH snapshots are taken
        under the store lock: mount/unmount RPCs mutate the ec_volumes
        dicts AND each volume's shards dict under it, so the sizing
        arithmetic below must never iterate them live from the tier
        thread (the same convention Store.set_ec_host_cache follows)."""
        out: dict[int, object] = {}
        meta: dict[int, tuple[int, int]] = {}
        with self.store._lock:
            for loc in self.store.locations:
                for vid, ev in loc.ec_volumes.items():
                    if vid in out:
                        continue
                    out[vid] = ev
                    shards = list(ev.shards.values())
                    meta[vid] = (
                        len(shards),
                        shards[0].size if shards else 0,
                    )
        return out, meta

    @staticmethod
    def _pin_need(cache, vid: int, meta: tuple[int, int]) -> dict[int, int]:
        """device -> padded bytes a full pin of `vid` would add, by the
        cache's placement rule (lane-sharded volumes split evenly, small
        ones land whole on the least-loaded device, unless `vid` still
        holds a claim, which the pin follows): the budget-fit arithmetic
        promotions and swaps share.  Empty = nothing to pin (unknown
        sizing)."""
        n, shard_size = meta
        if not n or not shard_size:
            return {}
        return cache.plan_pin(n, shard_size, vid=vid)

    @staticmethod
    def _fits(cache, need: dict[int, int], freed: dict[int, int]) -> bool:
        """Would `need` fit every device it lands on once `freed` bytes a
        device are released?  Judged against the per-device budget: an
        aggregate answer would still overflow the one device a whole pin
        lands on and hand eviction back to the blind per-shard LRU in
        DeviceShardCache.put."""
        if not need:
            return False
        budget = cache.device_budget
        stats = cache.device_stats()
        return all(
            stats[d]["used_bytes"] - freed.get(d, 0) + add <= budget
            for d, add in need.items()
        )

    def tier_of(self, vid: int) -> str:
        """Delegates to Store.ec_volume_tier — ONE home for the
        hbm/host/disk classification (the controller's host cache IS
        store.ec_host_cache, attached in __init__), so the read-routing
        view and the ladder's view can never drift."""
        return self.store.ec_volume_tier(vid)

    # ------------------------------------------------------------- moves

    def _promote_hbm(self, ev, now: float) -> bool:
        """Pin `ev` into the device cache (host-cache bytes first, disk
        otherwise).  Nothing to warm: the kernels take runtime shapes."""
        cache = self.store.ec_device_cache
        try:
            n = ev.load_shards_to_device(cache)
        except Exception:  # noqa: BLE001 — an unreadable shard file
            # must not kill the tier loop; the volume stays where it was
            log.exception("tier promotion failed for volume %d", ev.id)
            cache.release_pin_source(ev.id, ev.dir)
            self._promote_failed_at[ev.id] = now
            return False
        if not n and not cache.resident_count(ev.id):
            self._promote_failed_at[ev.id] = now
            return False
        self._promote_failed_at.pop(ev.id, None)
        self._resident_since[ev.id] = now
        self.promotions[TIER_HBM] += 1
        stats_metrics.VOLUME_SERVER_EC_TIER_PROMOTIONS.labels(
            tier=TIER_HBM
        ).inc()
        obs_incident.record(
            "tier_promote", vid=ev.id, tier=TIER_HBM, shards=n
        )
        return True

    def _demote_hbm(self, ev, stage: bool = True) -> None:
        """Release a volume's device residency through the claim/evict
        release path (in-flight reads stay byte-exact or fail a clean
        CacheMiss).  Shard bytes are staged host-side FIRST so a warm
        demotion never opens a window where the volume serves from
        neither RAM tier; `stage=False` skips that for heat-0 victims —
        a cold demotion must not pay a whole-volume disk read for bytes
        the same cycle's host fill would immediately evict."""
        cache = self.store.ec_device_cache
        if stage and self.host_cache is not None:
            self._stage_host(ev)
        cache.evict(ev.id)
        self._resident_since.pop(ev.id, None)
        self.demotions[TIER_HBM] += 1
        stats_metrics.VOLUME_SERVER_EC_TIER_DEMOTIONS.labels(
            tier=TIER_HBM
        ).inc()
        obs_incident.record(
            "tier_demote", vid=ev.id, tier=TIER_HBM, staged_host=stage
        )

    def _stage_host(self, ev) -> bool:
        hc = self.host_cache
        if hc is None:
            return False
        from ..storage.ec.layout import DATA_SHARDS

        if hc.resident_count(ev.id) >= DATA_SHARDS:
            return True  # already staged
        # budget pre-check BEFORE the whole-volume disk read: a full
        # host tier (the steady state) must not cost a multi-MB/GB
        # stage that put_volume then rejects and throws away
        snap = list(ev.shards.values())
        est = len(snap) * (snap[0].size if snap else 0)
        if not est or (
            hc.bytes_used - hc.volume_bytes(ev.id) + est > hc.budget
        ):
            return False
        try:
            shards = ev.stage_host_shards()
        except OSError:
            log.exception("host-tier staging failed for volume %d", ev.id)
            return False
        if len(shards) < DATA_SHARDS:
            return False
        if hc.put_volume(ev.id, shards):
            self.promotions[TIER_HOST] += 1
            stats_metrics.VOLUME_SERVER_EC_TIER_PROMOTIONS.labels(
                tier=TIER_HOST
            ).inc()
            obs_incident.record(
                "tier_promote", vid=ev.id, tier=TIER_HOST
            )
            return True
        return False

    def _evict_host(self, vid: int) -> None:
        if self.host_cache is not None and self.host_cache.evict(vid):
            self.demotions[TIER_HOST] += 1
            stats_metrics.VOLUME_SERVER_EC_TIER_DEMOTIONS.labels(
                tier=TIER_HOST
            ).inc()
            obs_incident.record("tier_demote", vid=vid, tier=TIER_HOST)

    # ---------------------------------------------------------- rebalance

    def rebalance(self, now: float | None = None) -> list[tuple[str, int]]:
        """One ladder cycle; returns the moves made as (kind, vid)
        tuples — kinds: promote_hbm, demote_hbm, stage_host,
        evict_host."""
        cache = self.store.ec_device_cache
        if cache is None or not self.cfg.tier:
            return []
        self.heat.prune(now)  # bound the tracked-vid set (probe traffic)
        with self._lock:
            return self._rebalance_locked(
                cache, self._clock() if now is None else now
            )

    def _rebalance_locked(self, cache, now: float) -> list[tuple[str, int]]:
        from ..storage.ec.layout import DATA_SHARDS

        cfg = self.cfg
        vols, meta = self._volumes()
        heat = self.heat.snapshot(now)
        moves: list[tuple[str, int]] = []

        def resident(vid: int) -> bool:
            return cache.resident_count(vid) >= DATA_SHARDS

        # volumes resident before this controller existed (mount-time
        # pin threads) enter the hysteresis clock on first sight
        for vid in vols:
            if resident(vid):
                self._resident_since.setdefault(vid, now)
            else:
                self._resident_since.pop(vid, None)

        def age_ok(vid: int) -> bool:
            return (
                now - self._resident_since.get(vid, now)
                >= cfg.tier_min_residency_seconds
            )

        # in a pod, lane-sharded volumes are coupled across processes
        # (every member holds one lane of each): a local, heat-driven
        # demotion would strand the other members' lanes.  They leave
        # only through the cache's put-order eviction partition; the
        # ladder keeps whole pins, and every volume in one process.
        multiproc = bool(getattr(cache, "multiprocess", False))

        def demotable(vid: int) -> bool:
            return not (multiproc and cache.vid_sharded(vid))

        # 1. PRESSURE: any device over ITS budget -> demote the coldest
        # residents holding bytes on the fullest over-budget device
        # (demoting a volume parked on an idle device frees nothing
        # where the pressure is).  Ignores the min-residency floor:
        # staying over budget would hand control back to the blind
        # per-shard LRU eviction in DeviceShardCache.put.
        def hbm_residents() -> list[int]:
            return [vid for vid in vols if resident(vid)]

        while True:
            pressure = cache.pressure_devices()
            if not pressure:
                break
            dev = pressure[0]  # fullest first
            # one locked footprint snapshot a demotion round
            foot = cache.device_bytes_by_vid()

            def on_dev(v: int) -> bool:
                return bool(foot.get(v, {}).get(dev))

            pool = [v for v in hbm_residents() if on_dev(v) and demotable(v)]
            if not pool:
                # partial shard sets (mount pins racing the LRU, or a
                # budget shrink mid-pin) hold device bytes without ever
                # serving a reconstruct: under pressure they are pure
                # waste — evict them too, or the orphaned bytes block
                # every future promotion forever
                pool = [v for v in vols if cache.resident_count(v) > 0
                        and on_dev(v) and demotable(v)]
            if not pool:
                break
            vid = min(pool, key=lambda v: (heat.get(v, 0.0), v))
            # heat-0 victims skip host staging: nobody reads them, and
            # the stage would be a wasted whole-volume disk read this
            # same cycle's host fill evicts again
            self._demote_hbm(vols[vid], stage=heat.get(vid, 0.0) > 0.0)
            moves.append(("demote_hbm", vid))
            if len(moves) >= 2 * MAX_MOVES_PER_CYCLE:
                break  # pathological budget shrink: finish next cycle

        # 2. PROMOTE hottest non-resident volumes
        storm = self._qos_storm()
        candidates = sorted(
            (vid for vid in vols if not resident(vid)),
            key=lambda v: (-heat.get(v, 0.0), v),
        )
        for vid in candidates:
            if len(moves) >= MAX_MOVES_PER_CYCLE:
                break
            h = heat.get(vid, 0.0)
            if h <= 0.0:
                break  # never promote a volume nobody reads
            if (
                now - self._promote_failed_at.get(vid, float("-inf"))
                < PROMOTE_FAILURE_BACKOFF_S
            ):
                continue  # recent pin failure: don't burn a victim on it
            need = self._pin_need(cache, vid, meta[vid])
            if not need:
                continue
            if self._fits(cache, need, {}):
                if self._promote_hbm(vols[vid], now):
                    moves.append(("promote_hbm", vid))
                continue
            if storm:
                # overload: no swap churn while breakers are open — but
                # a COLDER candidate that fits the free budget may
                # still promote, so keep scanning instead of breaking
                continue
            # collect enough eligible victims (coldest first, each one
            # beaten by promote_ratio — hysteresis: the demotion
            # threshold sits promote_ratio below the promotion
            # threshold, so equally hot volumes never flap) to actually
            # FIT the candidate before demoting anything: a one-victim
            # swap that still overflowed would hand eviction back to
            # the blind per-shard LRU in DeviceShardCache.put.  Only
            # volumes holding bytes on a device the candidate still lacks
            # room on count: demoting one parked elsewhere frees nothing
            # where the pin lands.
            budget = cache.device_budget

            def still_tight(freed: dict[int, int]) -> set[int]:
                stats = cache.device_stats()
                return {d for d, add in need.items()
                        if stats[d]["used_bytes"] - freed.get(d, 0) + add
                        > budget}

            victims: list[int] = []
            freed: dict[int, int] = {}
            # one locked footprint snapshot for the whole victim scan
            foot = cache.device_bytes_by_vid()
            for v in sorted(
                (v for v in hbm_residents() if age_ok(v) and demotable(v)),
                key=lambda v: (heat.get(v, 0.0), v),
            ):
                if h < cfg.tier_promote_ratio * max(
                    heat.get(v, 0.0), 1e-9
                ) or len(victims) >= MAX_SWAP_VICTIMS:
                    break  # remaining victims are hotter still / capped
                # freed = the bytes the victim actually holds a device (a
                # partially resident victim frees less than a full pin)
                held = foot.get(v, {})
                if not still_tight(freed) & held.keys():
                    continue  # holds nothing where room is still needed
                victims.append(v)
                for d, b in held.items():
                    freed[d] = freed.get(d, 0) + b
                if self._fits(cache, need, freed):
                    break
            if not victims or not self._fits(cache, need, freed):
                # cannot fit THIS candidate without demoting something
                # too hot — but a colder, smaller candidate further down
                # may still fit the free budget, so keep scanning (the
                # same reasoning as the storm branch above)
                continue
            for v in victims:
                self._demote_hbm(vols[v], stage=heat.get(v, 0.0) > 0.0)
                moves.append(("demote_hbm", v))
            if self._promote_hbm(vols[vid], now):
                moves.append(("promote_hbm", vid))

        # 3. HOST FILL: warmest non-HBM volumes hold the host budget.
        # Still-warm HBM volumes KEEP their host copy (a later pressure
        # demotion then costs no re-stage), accounted against the
        # budget first; everything else not in the desired warm set is
        # evicted so cold entries never squat on the RAM a warmer
        # volume needs.
        hc = self.host_cache
        if hc is not None:
            keep: set[int] = {
                vid
                for vid in hc.vids()
                if vid in vols
                and resident(vid)
                and heat.get(vid, 0.0) > 0.0
            }
            acc = sum(hc.volume_bytes(vid) for vid in keep)
            desired: set[int] = set()
            for vid in sorted(
                (v for v in vols if not resident(v)),
                key=lambda v: (-heat.get(v, 0.0), v),
            ):
                if heat.get(vid, 0.0) <= 0.0:
                    break
                n_shards, shard_size = meta[vid]
                size = hc.volume_bytes(vid) or n_shards * shard_size
                if not size or acc + size > hc.budget:
                    continue
                desired.add(vid)
                acc += size
            for vid in hc.vids():
                if vid not in desired and vid not in keep:
                    self._evict_host(vid)
                    moves.append(("evict_host", vid))
            for vid in desired:
                if hc.resident_count(vid) < DATA_SHARDS:
                    if self._stage_host(vols[vid]):
                        moves.append(("stage_host", vid))

        # census for telemetry + gauges (cheap: reuses this cycle's scan)
        sizes = {TIER_HBM: 0, TIER_HOST: 0, TIER_DISK: 0}
        for vid in vols:
            sizes[self.tier_of(vid)] += 1
        self.last_sizes = sizes
        for tier in TIERS:
            stats_metrics.VOLUME_SERVER_EC_TIER_VOLUMES.labels(
                tier=tier
            ).set(sizes[tier])
        return moves

    # ------------------------------------------------------------- status

    def status(self) -> dict:
        """The volume.tier.status / telemetry view: per-tier census,
        cumulative ladder counters, host-tier occupancy, and the decayed
        heat ranking."""
        hc = self.host_cache
        return {
            "tiers": dict(self.last_sizes),
            "promotions": dict(self.promotions),
            "demotions": dict(self.demotions),
            "host_bytes": hc.bytes_used if hc is not None else 0,
            "host_budget_bytes": hc.budget if hc is not None else 0,
            "heat": {
                vid: round(h, 3)
                for vid, h in sorted(
                    self.heat.snapshot().items(), key=lambda kv: -kv[1]
                )
            },
        }
