"""The port's heat-tiered residency (seaweedfs_tpu_torch/serving/tiering.py)
held against the JAX package's, on the CPU.

Mirrors tests/test_heat_tiering.py case for case where a case needs no
master.  The ladder cases drive BOTH packages side by side: the same EC
volume files (copied into one directory per package), the same heat, the
same clock and the same budget moves, and at every rebalance the port's
decisions (the moves `rebalance()` returns) and tiers must equal the
reference's.  The port's cache is its DeviceShardCache(device="cpu"), the
reference's its CPU cache with no AOT grid (warm_sizes=()).  Promotion
asserts the pin: the port has no AOT warm to arm (the CUDA kernels take
runtime shapes).  The heartbeat telemetry case waits for the master
(ROADMAP A4b/A7c).
"""
import os
import random
import shutil
import threading

import numpy as np
import pytest

from seaweedfs_tpu import stats as jax_stats
from seaweedfs_tpu.ops import rs_resident as jax_rs_resident
from seaweedfs_tpu.serving import ServingConfig as JaxServingConfig
from seaweedfs_tpu.serving import tiering as jax_tiering
from seaweedfs_tpu.storage import disk_location as jax_dl
from seaweedfs_tpu.storage import ec as jax_ec
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.storage.ec.volume import EcVolumeShard as JaxEcVolumeShard
from seaweedfs_tpu.storage.volume import Volume as JaxVolume
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ops import rs_resident
from seaweedfs_tpu_torch.serving import EcReadDispatcher, ServingConfig
from seaweedfs_tpu_torch.serving import tiering
from seaweedfs_tpu_torch.serving.tiering import (
    TIER_DISK,
    TIER_HBM,
    TIER_HOST,
    HostShardCache,
)
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.ec.volume import EcVolumeShard
from seaweedfs_tpu_torch.storage.store import Store

TIERING = {"jax": jax_tiering, "torch": tiering}
REGISTRY = {"jax": jax_stats.REGISTRY, "torch": stats.REGISTRY}


class FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _make_ec_volume(dirname, vid, count=8, seed=7, sizes=(500, 4096, 20_000)):
    """Write a small volume, EC-encode it, drop the .dat/.idx (the
    standard post-encode state), return {nid: (cookie, data)}."""
    rng = random.Random(seed + vid)
    v = JaxVolume(str(dirname), vid)
    blobs = {}
    for i in range(1, count + 1):
        data = rng.randbytes(rng.choice(list(sizes)))
        cookie = rng.getrandbits(32)
        v.write(i, cookie, data)
        blobs[i] = (cookie, data)
    v.sync()
    base = JaxVolume.base_name(v.dir, vid, v.collection)
    jax_ec.write_ec_files(base, backend="cpu")
    jax_ec.write_sorted_file_from_idx(base)
    v.close()
    for ext in (".dat", ".idx"):
        if os.path.exists(base + ext):
            os.remove(base + ext)
    return blobs


def _side(pkg, dirname, vids, budget):
    """A Store of `pkg` over `dirname` with `vids` mounted, and its CPU
    device cache attached AFTER mount so no pin thread races the test."""
    if pkg == "jax":
        store = jax_store.Store([jax_dl.DiskLocation(str(dirname))],
                                ec_backend="numpy")
        cache = jax_rs_resident.DeviceShardCache(budget_bytes=budget,
                                                 shard_quantum=1 << 20)
        cache.warm_sizes = ()  # no AOT grid compiles
    else:
        store = Store([DiskLocation(str(dirname))], ec_backend="numpy")
        cache = rs_resident.DeviceShardCache(budget_bytes=budget,
                                             shard_quantum=1 << 20, device="cpu")
    for vid in vids:
        store.mount_ec_shards(vid, list(range(14)))
    store.ec_device_cache = cache
    for loc in store.locations:
        for ev in loc.ec_volumes.values():
            ev.device_cache = cache
    return store, cache


def _cfg(pkg, **kw):
    defaults = dict(
        tier_host_cache_mb=64,
        tier_half_life_seconds=10.0,
        tier_promote_ratio=1.5,
        tier_min_residency_seconds=5.0,
        tier_interval_seconds=0.0,
    )
    defaults.update(kw)
    cls = JaxServingConfig if pkg == "jax" else ServingConfig
    return cls(**defaults).validated()


def _vol_bytes(store, cache, vid):
    ev = store.find_ec_volume(vid)
    return len(ev.shards) * cache._padded_len(ev.shard_size)


class Ladder:
    """The same ladder in both packages, driven in lockstep: every call
    is made on both, and every answer must agree."""

    def __init__(self, tmp_path, vids, budget=8 << 30, cfg=None, volumes=None):
        src = tmp_path / "src"
        src.mkdir()
        self.blobs = {}
        for vid in vids:
            kw = (volumes or {}).get(vid, {})
            self.blobs[vid] = _make_ec_volume(src, vid, **kw)
        self.clock = FakeClock()
        self.sides = {}
        for pkg in ("jax", "torch"):
            shutil.copytree(src, tmp_path / pkg)
            store, cache = _side(pkg, tmp_path / pkg, vids, budget)
            ctl = TIERING[pkg].TieringController(
                store, _cfg(pkg, **(cfg or {})), clock=self.clock)
            self.sides[pkg] = (store, cache, ctl)

    def each(self, fn):
        """fn(store, cache, ctl) on both sides -> the port's answer, after
        checking the reference gave the same."""
        got = {pkg: fn(*side) for pkg, side in self.sides.items()}
        assert got["torch"] == got["jax"], got
        return got["torch"]

    def note(self, vid, n=1, tier=""):
        for _store, _cache, ctl in self.sides.values():
            for _ in range(n):
                ctl.note_read(vid, tier)

    def rebalance(self):
        return self.each(lambda s, c, ctl: ctl.rebalance())

    def tier(self, vid):
        return self.each(lambda s, c, ctl: ctl.tier_of(vid))

    def budget_to(self, *vids):
        for store, cache, _ in self.sides.values():
            cache.budget = sum(_vol_bytes(store, cache, v) for v in vids)

    @property
    def port(self):
        return self.sides["torch"]


def _host_reads(pkg):
    return REGISTRY[pkg].get_sample_value(
        "SeaweedFS_volumeServer_ec_tier_host_reads_total") or 0


# --------------------------------------------------------------- heat


@pytest.mark.parametrize("pkg", list(TIERING))
def test_heat_decays_with_half_life(pkg):
    clock = FakeClock()
    h = TIERING[pkg].HeatTracker(half_life_s=10.0, clock=clock)
    for _ in range(8):
        h.note(5)
    assert h.value(5) == pytest.approx(8.0)
    clock.advance(10.0)
    assert h.value(5) == pytest.approx(4.0)
    clock.advance(20.0)
    assert h.value(5) == pytest.approx(1.0)
    h.forget(5)
    assert h.value(5) == 0.0


@pytest.mark.parametrize("pkg", list(TIERING))
def test_heat_weighs_bulk_reads_down(pkg):
    clock = FakeClock()
    h = TIERING[pkg].HeatTracker(half_life_s=60.0, bulk_weight=0.25, clock=clock)
    for _ in range(4):
        h.note(1, tier="bulk")
    h.note(2, tier="interactive")
    # 4 bulk reads == 1 interactive read
    assert h.value(1) == pytest.approx(h.value(2))


@pytest.mark.parametrize("pkg", list(TIERING))
def test_heat_tracker_prunes_probe_traffic(pkg):
    """A client scanning random fids feeds note() a new vid per probe: the
    tracked set stays bounded and cooled entries drop at prune time."""
    cls = TIERING[pkg].HeatTracker
    clock = FakeClock()
    h = cls(half_life_s=1.0, clock=clock)
    for vid in range(3 * cls.MAX_TRACKED):
        h.note(vid)
    assert len(h._heat) <= cls.MAX_TRACKED
    clock.advance(60.0)  # 60 half-lives: everything below the floor
    h.prune()
    assert len(h._heat) == 0


@pytest.mark.parametrize("pkg", list(TIERING))
def test_concurrent_note_read_is_thread_safe(pkg):
    h = TIERING[pkg].HeatTracker(half_life_s=1e9)  # no decay in the window
    threads = [threading.Thread(target=lambda: [h.note(1) for _ in range(500)])
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert not any(th.is_alive() for th in threads)
    assert h.value(1) == pytest.approx(2000.0)


# ---------------------------------------------------------- host cache


@pytest.mark.parametrize("pkg", list(TIERING))
def test_host_cache_budget_is_all_or_nothing(pkg):
    hc = TIERING[pkg].HostShardCache(budget_bytes=100)
    small = {0: np.zeros(30, np.uint8), 1: np.zeros(30, np.uint8)}
    big = {0: np.zeros(80, np.uint8), 1: np.zeros(80, np.uint8)}
    assert hc.put_volume(1, small)
    assert hc.bytes_used == 60
    assert not hc.put_volume(2, big)  # would overflow: rejected whole
    assert hc.bytes_used == 60 and hc.resident_count(2) == 0
    assert hc.evict(1) == 60
    assert hc.bytes_used == 0
    assert hc.put_volume(2, big) is False  # 160 > 100 even when empty
    assert hc.put_volume(2, {0: np.zeros(80, np.uint8)})
    assert hc.volume_bytes(2) == 80


@pytest.mark.parametrize("pkg", list(TIERING))
def test_host_cache_reads_are_zero_copy_views(pkg):
    hc = TIERING[pkg].HostShardCache(budget_bytes=1 << 20)
    arr = np.arange(256, dtype=np.uint8)
    assert hc.put_volume(3, {0: arr})
    view = hc.read(3, 0, 10, 20)
    assert isinstance(view, memoryview)
    assert bytes(view) == bytes(range(10, 30))
    hc.evict(3)  # drops the cache's claim, not the view's buffer
    assert bytes(view) == bytes(range(10, 30))
    assert hc.read(3, 0, 0, 4) is None


@pytest.mark.parametrize("pkg", list(TIERING))
def test_host_read_counter_only_counts_full_serves(pkg):
    hc = TIERING[pkg].HostShardCache(budget_bytes=1 << 20)
    assert hc.put_volume(4, {0: np.zeros(100, np.uint8)})
    before = _host_reads(pkg)
    full = hc.read(4, 0, 0, 50)
    assert len(full) == 50 and _host_reads(pkg) == before + 1
    # a tail short-read the caller discards and re-serves from disk does
    # not claim a host-tier serve
    short = hc.read(4, 0, 90, 50)
    assert len(short) == 10 and _host_reads(pkg) == before + 1


def _no_disk(self, off, size):
    raise AssertionError("host-tier read touched disk")


def test_host_tier_serves_without_disk_reads(tmp_path, monkeypatch):
    """A warm volume's needle reads come entirely out of the staged RAM
    bytes: with every shard pread failing, both packages' reads return
    the written blobs."""
    ladder = Ladder(tmp_path, [21])
    for pkg, (store, _cache, _ctl) in ladder.sides.items():
        ev = store.find_ec_volume(21)
        hc = TIERING[pkg].HostShardCache(budget_bytes=1 << 30)
        assert hc.put_volume(21, ev.stage_host_shards())
        store.set_ec_host_cache(hc)
        assert ev.host_cache is hc
    monkeypatch.setattr(JaxEcVolumeShard, "read_at", _no_disk)
    monkeypatch.setattr(EcVolumeShard, "read_at", _no_disk)
    for pkg, (store, _cache, _ctl) in ladder.sides.items():
        before = _host_reads(pkg)
        for nid, (cookie, data) in ladder.blobs[21].items():
            assert bytes(store.read_ec_needle(21, nid, cookie).data) == data
        assert _host_reads(pkg) > before
        assert store.ec_volume_tier(21) == TIER_HOST


def test_host_tier_degraded_gather_without_disk(tmp_path, monkeypatch):
    """The degraded path too: with a shard unmounted AND disk reads
    forbidden, the survivor gather reconstructs from the staged bytes."""
    ladder = Ladder(tmp_path, [22])
    for pkg, (store, _cache, _ctl) in ladder.sides.items():
        ev = store.find_ec_volume(22)
        hc = TIERING[pkg].HostShardCache(budget_bytes=1 << 30)
        assert hc.put_volume(22, ev.stage_host_shards())
        store.set_ec_host_cache(hc)
        ev.shards.pop(3).close()  # degrade: shard 3 no longer mounted
    monkeypatch.setattr(JaxEcVolumeShard, "read_at", _no_disk)
    monkeypatch.setattr(EcVolumeShard, "read_at", _no_disk)
    for store, _cache, _ctl in ladder.sides.values():
        for nid, (cookie, data) in ladder.blobs[22].items():
            n = store.read_ec_needle(22, nid, cookie, use_device=False)
            assert bytes(n.data) == data


def test_port_degraded_gather_reads_survivors_from_the_host_tier(tmp_path,
                                                                 monkeypatch):
    """The port's survivor gather itself probes the host tier: with the
    staged copy of the missing shard dropped, the reconstruct still reads
    no disk."""
    ladder = Ladder(tmp_path, [23])
    store = ladder.port[0]
    ev = store.find_ec_volume(23)
    staged = ev.stage_host_shards()
    del staged[0]
    hc = HostShardCache(budget_bytes=1 << 30)
    assert hc.put_volume(23, staged)
    store.set_ec_host_cache(hc)
    ev.shards.pop(0).close()
    monkeypatch.setattr(EcVolumeShard, "read_at", _no_disk)
    for nid, (cookie, data) in ladder.blobs[23].items():
        assert bytes(store.read_ec_needle(23, nid, cookie, use_device=False).data) == data
    assert store.ec_volume_tier(23) == TIER_HOST


# -------------------------------------------------------------- ladder


def test_rebalance_promotes_hot_volume_and_pins_it(tmp_path):
    ladder = Ladder(tmp_path, [1, 2, 3])
    ladder.note(2, 5)
    moves = ladder.rebalance()
    assert ("promote_hbm", 2) in moves
    assert ladder.tier(2) == TIER_HBM
    store, cache, ctl = ladder.port
    # the promotion is the pin: all 14 shards resident, the volume served
    # by the resident launch; nothing to warm
    assert cache.resident_count(2) == 14 and store.ec_volume_is_resident(2)
    assert store.find_ec_volume(2).is_device_resident()
    assert ladder.each(lambda s, c, ctl: ctl.promotions[TIER_HBM]) == 1
    # cold volumes (zero heat) are never promoted
    assert ladder.tier(1) == TIER_DISK and ladder.tier(3) == TIER_DISK


def test_rebalance_hysteresis_blocks_flap_then_allows_swap(tmp_path):
    ladder = Ladder(tmp_path, [1, 2])
    ladder.budget_to(1)  # fits exactly ONE volume: the second must swap
    ladder.note(1, 4)
    ladder.rebalance()
    assert ladder.tier(1) == TIER_HBM
    # volume 2 hotter, but NOT promote_ratio (1.5x) hotter: no swap
    ladder.note(2, 5)
    ladder.clock.advance(6.0)  # past min_residency
    ladder.rebalance()
    assert ladder.tier(1) == TIER_HBM and ladder.tier(2) != TIER_HBM
    ladder.note(2, 20)  # now decisively hotter
    moves = ladder.rebalance()
    assert ("demote_hbm", 1) in moves and ("promote_hbm", 2) in moves
    assert ladder.tier(2) == TIER_HBM
    # the demoted-but-mounted volume landed on the host tier, not disk
    assert ladder.tier(1) == TIER_HOST
    assert ladder.each(lambda s, c, ctl: ctl.demotions[TIER_HBM]) == 1


def test_rebalance_min_residency_blocks_immediate_swap(tmp_path):
    ladder = Ladder(tmp_path, [1, 2])
    ladder.budget_to(1)
    ladder.note(1, 4)
    ladder.rebalance()
    ladder.note(2, 40)  # way past the ratio threshold
    ladder.rebalance()  # but volume 1 is only just resident
    assert ladder.tier(1) == TIER_HBM, "min-residency floor ignored"
    ladder.clock.advance(6.0)
    ladder.rebalance()
    assert ladder.tier(2) == TIER_HBM


def test_pressure_demotion_is_heat_chosen_and_ignores_min_residency(tmp_path):
    ladder = Ladder(tmp_path, [1, 2, 3])
    for vid in (1, 2, 3):
        ladder.note(vid, 2 + 3 * vid)  # heat: 3 > 2 > 1
    ladder.rebalance()
    ladder.rebalance()  # two moves a cycle: the second finishes the set
    assert all(ladder.tier(v) == TIER_HBM for v in (1, 2, 3))
    # the budget collapses to one volume: the two COLDEST demote
    ladder.budget_to(3)
    moves = ladder.rebalance()
    assert {vid for kind, vid in moves if kind == "demote_hbm"} == {1, 2}
    assert ladder.tier(3) == TIER_HBM
    assert ladder.tier(1) == TIER_HOST and ladder.tier(2) == TIER_HOST


def test_pressure_evicts_partial_orphan_shard_sets(tmp_path):
    """Partial shard sets (a mount pin racing the LRU, a budget shrink
    mid-pin) hold device bytes without serving: under pressure they are
    evicted too, coldest first."""
    ladder = Ladder(tmp_path, [1, 2])
    for store, cache, _ in ladder.sides.values():
        for vid in (1, 2):
            ev = store.find_ec_volume(vid)
            for sid in range(4):
                cache.put(vid, sid, np.fromfile(ev.shards[sid].path, dtype=np.uint8))
        assert cache.bytes_used > 0
        cache.budget = cache.bytes_used // 4
    ladder.note(2, 3)  # volume 2 is the warmer orphan
    moves = ladder.rebalance()
    demoted = [vid for kind, vid in moves if kind == "demote_hbm"]
    assert demoted and demoted[0] == 1, "coldest orphan must go first"
    assert ladder.each(lambda s, c, ctl: c.bytes_used <= c.budget)


def test_qos_storm_freezes_swaps_but_not_free_promotions(tmp_path):
    ladder = Ladder(tmp_path, [1, 2])
    ladder.budget_to(1)

    class StormyQos:
        policies = {"interactive": None, "bulk": None}

        def breaker_state(self, tier):
            return 2  # OPEN

    ladder.note(1, 4)
    ladder.rebalance()  # free-budget promotion: allowed even in a storm
    ladder.clock.advance(10.0)
    ladder.note(2, 40)
    for _, _, ctl in ladder.sides.values():
        ctl.attach_qos(StormyQos())
    ladder.rebalance()
    # the swap would happen (ratio + age hold) but the open breaker froze it
    assert ladder.tier(1) == TIER_HBM and ladder.tier(2) != TIER_HBM
    for _, _, ctl in ladder.sides.values():
        ctl.attach_qos(None)
    ladder.rebalance()
    assert ladder.tier(2) == TIER_HBM


def test_promotion_from_host_tier_skips_disk(tmp_path, monkeypatch):
    """RAM -> HBM: a volume demoted to the host tier re-promotes from the
    staged bytes, never re-reading its shard files."""
    ladder = Ladder(tmp_path, [1, 2])
    ladder.budget_to(1)
    ladder.note(1, 8)
    ladder.rebalance()
    ladder.clock.advance(6.0)
    ladder.note(2, 40)
    ladder.rebalance()  # 1 -> host, 2 -> hbm
    assert ladder.tier(1) == TIER_HOST
    ladder.clock.advance(6.0)
    for _, _, ctl in ladder.sides.values():
        ctl.heat.forget(2)
    ladder.note(1, 60)
    np_fromfile = np.fromfile

    def no_fromfile_for_v1(path, *a, **kw):
        # volume 2's demotion MAY stage its own bytes from disk; the
        # PROMOTED volume must come out of the host tier
        if os.path.basename(str(path)).startswith("1.ec"):
            raise AssertionError("host->HBM promotion re-read disk")
        return np_fromfile(path, *a, **kw)

    monkeypatch.setattr(np, "fromfile", no_fromfile_for_v1)
    moves = ladder.rebalance()
    assert ("promote_hbm", 1) in moves
    assert ladder.tier(1) == TIER_HBM


def test_failed_promotion_backs_off_and_spares_residents(tmp_path):
    """One unreadable hot volume must not demote a healthy resident every
    cycle: the first failed swap is the last until the backoff lapses."""
    ladder = Ladder(tmp_path, [1, 2])
    ladder.budget_to(1)
    ladder.note(1, 4)
    ladder.rebalance()
    assert ladder.tier(1) == TIER_HBM
    for store, _, _ in ladder.sides.values():
        ev2 = store.find_ec_volume(2)
        for shard in list(ev2.shards.values()):
            shard.close()
            os.remove(shard.path)
    ladder.clock.advance(6.0)
    ladder.note(2, 40)
    ladder.rebalance()
    assert ladder.tier(2) != TIER_HBM
    first = ladder.each(lambda s, c, ctl: ctl.demotions[TIER_HBM])
    assert first <= 1
    ladder.note(1, 50)
    for _ in range(3):
        ladder.clock.advance(6.0)
        ladder.rebalance()
    assert ladder.tier(1) == TIER_HBM
    assert ladder.each(lambda s, c, ctl: ctl.demotions[TIER_HBM]) == first


def test_swap_collects_enough_victims_to_fit(tmp_path):
    """A candidate bigger than one victim demotes as many colder
    residents as it needs BEFORE pinning — never overflowing the budget
    into the blind per-shard LRU."""
    ladder = Ladder(tmp_path, [1, 2, 4], volumes={
        1: dict(count=4), 2: dict(count=4), 4: dict(count=60, sizes=(200_000,))})
    ladder.budget_to(1, 2)
    for store, cache, _ in ladder.sides.values():
        need = _vol_bytes(store, cache, 4)
        assert _vol_bytes(store, cache, 1) < need <= cache.budget
    ladder.note(1, 3)
    ladder.note(2, 3)
    ladder.rebalance()
    assert ladder.tier(1) == TIER_HBM and ladder.tier(2) == TIER_HBM
    ladder.clock.advance(6.0)
    ladder.note(4, 40)
    moves = ladder.rebalance()
    assert ("promote_hbm", 4) in moves
    assert {vid for kind, vid in moves if kind == "demote_hbm"} == {1, 2}
    assert ladder.tier(4) == TIER_HBM
    assert ladder.each(lambda s, c, ctl: (c.bytes_used <= c.budget, c.evictions)) == (True, 0)


# ------------------------------------------- budget/claim symmetry


def test_demote_promote_cycle_keeps_budget_accounting_symmetric(tmp_path):
    """Claims and padded-byte accounting of a demoted-then-repromoted
    volume never double-count: three full cycles land on identical
    bytes_used and shard counts, one fresh claim a cycle."""
    ladder = Ladder(tmp_path, [9])
    store, cache, _ = ladder.port
    ev = store.find_ec_volume(9)
    ev.load_shards_to_device(cache)
    shards0, bytes0 = cache.stats()
    claims0 = cache.pin_claims
    assert shards0 == 14 and bytes0 > 0
    for cycle in range(1, 4):
        cache.evict(9)  # the demotion release path
        assert cache.stats() == (0, 0)
        assert cache.pin_source(9) is None, "claim outlived the demotion"
        assert ev.load_shards_to_device(cache) == 14
        assert cache.stats() == (shards0, bytes0), f"cycle {cycle} drifted"
        assert cache.pin_claims == claims0 + cycle
        assert cache.resident_count(9) == 14


def test_repin_over_existing_shards_does_not_double_count(tmp_path):
    ladder = Ladder(tmp_path, [9])
    store, cache, _ = ladder.port
    ev = store.find_ec_volume(9)
    ev.load_shards_to_device(cache)
    _, bytes0 = cache.stats()
    assert ev.load_shards_to_device(cache) == 0  # already resident: no-op
    cache.put(9, 0, np.fromfile(ev.shards[0].path, dtype=np.uint8))
    assert cache.stats()[1] == bytes0  # a double put replaces, never adds


def test_cache_accounting_matches_reference(tmp_path):
    """The ladder's view of the cache (bytes held against the device
    budget, the bytes a pin would add per device, pressure) reads the
    same in both packages."""
    ladder = Ladder(tmp_path, [1, 2])
    ladder.note(1, 3)
    ladder.rebalance()
    ladder.each(lambda s, c, ctl: (c.bytes_used, c.device_budget, c.stats(),
                                   [c.resident_count(v) for v in (1, 2)]))
    jstore, jcache, _ = ladder.sides["jax"]
    store, cache, _ = ladder.port
    jev, ev = jstore.find_ec_volume(2), store.find_ec_volume(2)
    plan = jcache.plan_pin(len(jev.shards), jev.shard_size, vid=2)
    assert cache.plan_pin(len(ev.shards), ev.shard_size, vid=2) == plan
    assert list(plan) == [0]
    for _store, c, _ctl in ladder.sides.values():
        c.budget = c.bytes_used // 2
    assert ladder.each(lambda s, c, ctl: c.bytes_used > c.device_budget)
    assert jcache.pressure_devices() == cache.pressure_devices() == [0]


# ----------------------------------------------------------- telemetry


def test_controller_status_and_census(tmp_path):
    ladder = Ladder(tmp_path, [1, 2])
    ladder.note(1, 3)
    ladder.rebalance()
    st = ladder.each(lambda s, c, ctl: ctl.status())
    assert st["tiers"][TIER_HBM] == 1
    assert st["promotions"][TIER_HBM] == 1
    assert st["host_budget_bytes"] == 64 << 20
    assert list(st["heat"]) == [1]  # hottest first
    # the census gauges, as the last rebalance left them
    tiers = ("hbm", "host", "disk")
    assert [stats.metrics.VOLUME_SERVER_EC_TIER_VOLUMES.labels(tier=t).value
            for t in tiers] == [1, 0, 1]
    assert [jax_stats.REGISTRY.get_sample_value(
        "SeaweedFS_volumeServer_ec_tier_volumes", {"tier": t})
        for t in tiers] == [1, 0, 1]


def test_unmount_releases_host_tier(tmp_path):
    ladder = Ladder(tmp_path, [1])
    for pkg, (store, _cache, _ctl) in ladder.sides.items():
        ev = store.find_ec_volume(1)
        hc = TIERING[pkg].HostShardCache(budget_bytes=1 << 30)
        store.set_ec_host_cache(hc)
        assert hc.put_volume(1, ev.stage_host_shards())
        assert hc.bytes_used > 0
        store.unmount_ec_shards(1, list(range(14)))
        assert hc.bytes_used == 0 and hc.resident_count(1) == 0


def test_dispatcher_feeds_read_heat(tmp_path):
    """Every routed EC read notes (vid, tier) on the attached ladder, the
    native route's too, before routing."""
    import asyncio

    ladder = Ladder(tmp_path, [5])
    store, _cache, ctl = ladder.port
    d = EcReadDispatcher(store, lambda vid: None, ServingConfig(max_inflight=1))
    d.tiering = ctl
    cookie, data = ladder.blobs[5][1]

    async def go():
        n = await d.read(5, 1, cookie, tier="interactive")
        assert bytes(n.data) == data
        await d.read(5, 2, ladder.blobs[5][2][0], tier="bulk")

    asyncio.run(go())
    d.shutdown()
    assert ctl.heat.value(5) == pytest.approx(1.25)
    moves = ctl.rebalance()
    assert moves == [("promote_hbm", 5)]
    assert store.ec_volume_tier(5) == TIER_HBM


# ------------------------------------------------------------- config


TIER_BAD = [dict(tier_promote_ratio=0.5), dict(tier_half_life_seconds=0),
            dict(tier_bulk_weight=1.5), dict(tier_interval_seconds=-1),
            dict(tier_host_cache_mb=-1), dict(tier_min_residency_seconds=-1)]


@pytest.mark.parametrize("bad", TIER_BAD, ids=[next(iter(b)) for b in TIER_BAD])
def test_tier_config_validation(bad):
    """Each bad tier value is refused by both packages with the same
    message; the tier defaults are the reference's."""
    import re

    assert ServingConfig().validated().tier is True
    with pytest.raises(ValueError) as ref:
        JaxServingConfig(**bad).validated()
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        ServingConfig(**bad).validated()
    fields = [f for f in vars(ServingConfig()) if f.startswith("tier")]
    assert len(fields) == 7
    assert {f: getattr(ServingConfig(), f) for f in fields} == {
        f: getattr(JaxServingConfig(), f) for f in fields}
