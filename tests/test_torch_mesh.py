"""The port's mesh layout held against the JAX package's.

parallel/mesh.py's constructors; the lane-sharded DeviceShardCache (the
placement rule, owner-major stripes, per-lane budgets and eviction,
`device_stats`, `pressure_devices`, `device_bytes_by_vid`, `plan_pin`);
its sharded reads in both layouts and its scrub; and the ladder's
per-device `rebalance`.  The JAX cache runs on the first n of the 8 forced
host devices (tests/conftest.py); the port's on a mesh of n CPU lanes
built with `make_mesh(n, 1, devices=["cpu"] * n)`, at n = 2, 4 and 8.
Every read body is byte-equal to the reference's and to the numpy oracle;
there is no tolerance.  Mirrors tests/test_mesh_serving.py.
"""
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import rs as jax_rs
from seaweedfs_tpu.ops import rs_resident as jax_rr
from seaweedfs_tpu.parallel import mesh as jax_mesh
from seaweedfs_tpu.serving import ServingConfig as JaxServingConfig
from seaweedfs_tpu.serving.tiering import TieringController as JaxTiering
from seaweedfs_tpu_torch.ops import rs_resident as rr
from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
from seaweedfs_tpu_torch.serving import ServingConfig
from seaweedfs_tpu_torch.serving.tiering import TieringController

WIDTHS = (2, 4, 8)
MIB = 1 << 20


def _encode(seed, size):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(10, size), dtype=np.uint8)
    return jax_rs.RSCodec(backend="numpy").encode_all(data)


@pytest.fixture(scope="module")
def encoded():
    """A 256 KB-shard volume."""
    return _encode(77, 256 * 1024)


@pytest.fixture(scope="module")
def encoded_big():
    """A 4 MB-shard volume: its padded buffers span many stripes at
    every width."""
    return _encode(78, 4 * MIB)


def _caches(n, **kw):
    """(the JAX cache on n host devices, the port's on n CPU lanes)."""
    kw.setdefault("shard_quantum", MIB)
    kw.setdefault("mesh_min_shard_bytes", 0)
    j = jax_rr.DeviceShardCache(mesh_devices=n, **kw)
    j.warm_sizes = ()  # no AOT grid compile
    p = rr.DeviceShardCache(
        device="cpu", mesh=mesh_mod.make_mesh(n, 1, devices=["cpu"] * n),
        **kw)
    return j, p


def _view(c, vids):
    """Everything the accounting shows, for equality."""
    return {
        "placement": {v: c.placement(v) for v in vids},
        "sharded": {v: c.vid_sharded(v) for v in vids},
        "stripe": c.stripe, "quantum": c.quantum, "n": c.n_devices,
        "dev_bytes": list(c._dev_bytes), "device_stats": c.device_stats(),
        "pressure": c.pressure_devices(), "by_vid": c.device_bytes_by_vid(),
        "resident": c.resident_by_vid(), "stats": c.stats(),
        "evictions": c.evictions, "budget": c.device_budget,
        "foot": {k: c._foot[k] for k in sorted(c._foot)},
    }


# ------------------------------------------------------------ constructors


def test_mesh_constructors_match_the_reference():
    assert (mesh_mod.SHARD_AXIS, mesh_mod.BATCH_AXIS) == (
        jax_mesh.SHARD_AXIS, jax_mesh.BATCH_AXIS)
    m = mesh_mod.make_mesh(2, 2, devices=["cpu"] * 4)
    j = jax_mesh.make_mesh(2, 2)
    assert m.axis_names == j.axis_names
    assert m.shape == dict(j.shape)
    assert m.lane(1, 0) == 2 and m.size == 4
    assert mesh_mod.make_mesh(2, devices=["cpu"] * 5).shape == {
        "shard": 2, "batch": 2}
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(3, 2, devices=["cpu"] * 4)
    # the width-1 degrade: one CPU device here, and an explicit one lane
    assert mesh_mod.serving_mesh(0, "cpu") is None
    assert mesh_mod.global_serving_mesh(0, "cpu") is None
    assert jax_mesh.serving_mesh(1) is None
    assert mesh_mod._serving_mesh_or_none(["cpu"]) is None
    two = mesh_mod._serving_mesh_or_none(["cpu", "cpu"])
    assert two.axis_names == (mesh_mod.SHARD_AXIS,) and two.size == 2
    assert mesh_mod.serving_mesh(0, "cpu") is mesh_mod.serving_mesh(0, "cpu")
    assert mesh_mod.mesh_hosts(None) == () == jax_mesh.mesh_hosts(None)
    assert mesh_mod.mesh_hosts(two) == (0,)
    pod = mesh_mod.Mesh([mesh_mod.PodDevice(1, "cpu"),
                         mesh_mod.PodDevice(0, "cpu")], ("shard",))
    assert pod.processes == [1, 0] and mesh_mod.mesh_hosts(pod) == (0, 1)
    assert pod.local_lanes(0) == [1]
    assert mesh_mod.device_host(mesh_mod.PodDevice(3, "cpu")) == 3
    assert mesh_mod.process_index() == 0
    assert mesh_mod.global_devices("cpu") == [
        mesh_mod.PodDevice(0, torch.device("cpu"))]
    assert mesh_mod.initialize_distributed("h:1", 0, 1) is False
    assert mesh_mod.backend_for("cuda") == "nccl"
    assert mesh_mod.backend_for("torch") == "gloo"
    with pytest.raises(ValueError):
        mesh_mod.backend_for("numpy")
    # a cache whose mesh resolves to one device is the one-device layout
    c = rr.DeviceShardCache(device="cpu", mesh_devices=0)
    assert c.mesh is None and c.n_devices == 1 and c.stripe == 0


def test_serving_config_validates_mesh_knobs_as_the_reference():
    for kw in ({}, {"mesh_devices": -1}, {"mesh_min_shard_mb": -1},
               {"mesh_process_count": 0}, {"mesh_process_count": 2},
               {"mesh_process_id": 1},
               {"mesh_process_count": 2, "mesh_coordinator": "h:1",
                "mesh_process_id": 2},
               {"mesh_process_count": 2, "mesh_coordinator": "h:99999"},
               {"mesh_process_count": 2, "mesh_coordinator": "h:1",
                "mesh_process_id": 1}):
        outcome = []
        for cls in (JaxServingConfig, ServingConfig):
            try:
                cfg = cls(**kw).validated()
                outcome.append((cfg.mesh, cfg.multiprocess))
            except ValueError:
                outcome.append("ValueError")
        assert outcome[0] == outcome[1], kw


# ---------------------------------------------------- placement/accounting


@pytest.mark.parametrize("n", WIDTHS)
def test_placement_and_accounting_equal(n, encoded, encoded_big):
    caches = _caches(n, mesh_min_shard_bytes=MIB)
    small_pad = caches[0]._padded_len(encoded.shape[1])
    for c in caches:
        for vid, enc in ((1, encoded), (2, encoded_big), (3, encoded)):
            for sid in range(4):
                c.put(vid, sid, enc[sid])
    views = [_view(c, (1, 2, 3)) for c in caches]
    assert views[0] == views[1]
    assert views[1]["placement"][2] == "mesh"
    assert isinstance(views[1]["placement"][1], int)
    plans = [
        [c.plan_pin(10, encoded.shape[1]), c.plan_pin(10, 4 * MIB),
         c.plan_pin(2, encoded.shape[1], vid=3), c.plan_pin(1, 1, vid=2)]
        for c in caches
    ]
    assert plans[0] == plans[1]
    # squeeze the per-lane budget: the same victims, lane by lane
    for c in caches:
        c.budget = n * (3 * small_pad)
        for vid in (4, 5, 6):
            for sid in range(3):
                c.put(vid, sid, encoded[sid])
    views = [_view(c, range(1, 7)) for c in caches]
    assert views[0] == views[1]
    assert views[1]["evictions"] > 0
    for c in caches:
        c.budget = sum(c._dev_bytes) // 2
    assert caches[0].pressure_devices() == caches[1].pressure_devices() != []
    for c in caches:
        c.evict(2)
        c.evict(1, 0)
    assert _view(caches[0], range(1, 7)) == _view(caches[1], range(1, 7))
    for c in caches:
        c.clear()
    assert _view(caches[0], range(1, 7)) == _view(caches[1], range(1, 7))


def test_eviction_targets_the_over_budget_lane(encoded):
    caches = _caches(2, mesh_min_shard_bytes=1 << 30)
    pad = caches[0]._padded_len(encoded.shape[1])
    for c in caches:
        c.budget = 2 * (4 * pad)
        for vid in (1, 2, 3, 4, 5):
            for sid in (0, 1):
                c.put(vid, sid, encoded[sid])
    assert _view(caches[0], range(1, 6)) == _view(caches[1], range(1, 6))
    assert caches[1].evictions == 2
    assert all(b <= caches[1].device_budget for b in caches[1]._dev_bytes)


def test_put_drops_stale_placement_when_claim_vanishes_mid_put(encoded):
    """evict() racing put()'s staging window must not let the buffer land
    under its vanished claim, in either package."""
    outcomes = []
    for c in _caches(8, mesh_min_shard_bytes=1 << 30):
        c.put(71, 0, encoded[0])
        orig = c._device_of
        fired = {}

        def hooked(place, c=c, orig=orig, fired=fired):
            if not fired:
                fired["x"] = True
                c.evict(71)
            return orig(place)

        c._device_of = hooked
        try:
            c.put(71, 1, encoded[1])
        finally:
            c._device_of = orig
        got = [c.resident_count(71), c.placement(71),
               c.device_bytes_by_vid().get(71, {})]
        c.put(71, 2, encoded[2])
        outcomes.append(got + [c.resident_count(71), c.placement(71)])
    assert outcomes[0] == outcomes[1] == [0, None, {}, 1, 0]


# --------------------------------------------------------- sharded reads


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
@pytest.mark.parametrize("n", WIDTHS)
def test_sharded_reads_equal(n, layout, encoded_big):
    caches = _caches(n, layout=layout)
    down = (3, 11)
    for c in caches:
        for sid in range(14):
            if sid not in down:
                c.put(21, sid, encoded_big[sid])
    assert caches[1].placement(21) == "mesh"
    stripe = caches[1].stripe
    l_loc = caches[1]._foot[(21, 0)][1] // n
    big = encoded_big.shape[1]
    rng = np.random.default_rng(4 + n)
    reqs = [(3, int(rng.integers(0, big - 70000)), int(size))
            for size in rng.choice([100, 4096, 33000, 70000], size=24)]
    # stripe and chunk straddles, tails, the other wanted shard
    reqs += [(3, stripe - 17, 4096), (3, 3 * stripe - 60000, 65536),
             (3, l_loc - 5, 10), (11, big - 1500, 1500), (11, 0, 1),
             (3, 999, 3 * MIB + 777)]
    got_j = jax_rr.reconstruct_intervals(caches[0], 21, reqs)
    got_p = rr.reconstruct_intervals(caches[1], 21, reqs)
    for (sid, off, size), pj, pp in zip(reqs, got_j, got_p):
        want = encoded_big[sid][off : off + size].tobytes()
        assert pp == pj == want, (n, layout, sid, off, size)


@pytest.mark.parametrize("n", WIDTHS)
def test_whole_pin_on_a_lane_reads_equal(n, encoded):
    caches = _caches(n, mesh_min_shard_bytes=1 << 30)
    for c in caches:
        c.put(90, 0, encoded[0])
        for sid in range(14):
            if sid != 2:
                c.put(91, sid, encoded[sid])
    assert caches[0].placement(91) == caches[1].placement(91) != 0
    reqs = [(2, 4000, 9000), (2, 0, 1), (2, 250_000, 12_144)]
    got = [m.reconstruct_intervals(c, 91, reqs)
           for m, c in zip((jax_rr, rr), caches)]
    assert got[0] == got[1] == [encoded[2][o : o + s].tobytes()
                                for _, o, s in reqs]


@pytest.mark.parametrize("n", WIDTHS)
def test_scrub_by_placement_equal(n, encoded):
    """Whole pins on different lanes and a lane-sharded volume scrub in
    separate stacks with the same counts and spans; a flipped parity byte
    counts once in a lane-sharded volume."""
    small = _encode(91, 64 * 1024)
    bad = encoded.copy()
    bad[12, 70_001] ^= 0x5A
    caches = _caches(n, mesh_min_shard_bytes=128 * 1024)
    for c in caches:
        for vid, enc in ((201, small), (202, small), (203, encoded),
                         (204, bad)):
            for sid in range(14):
                c.put(vid, sid, enc[sid])
    assert caches[1].placement(201) != caches[1].placement(202)
    assert caches[1].placement(204) == "mesh"
    got = [m.scrub_all_resident(c) for m, c in zip((jax_rr, rr), caches)]
    assert got[0] == got[1]
    assert got[1][1]["device_calls"] == 3
    assert got[1][0][204][0] == [0, 0, 1, 0]
    for vid in (202, 204):
        assert rr.scrub_volume(caches[1], vid) == jax_rr.scrub_volume(
            caches[0], vid)


# ------------------------------------------------- the ladder, per device


class _FakeShard:
    def __init__(self, size):
        self.size = size


class _FakeVol:
    def __init__(self, vid, data):
        self.id = vid
        self.dir = f"/fake/{vid}"
        self._data = data
        self.shards = {sid: _FakeShard(len(b)) for sid, b in data.items()}

    def load_shards_to_device(self, cache):
        n = 0
        for sid, b in self._data.items():
            if cache.get(self.id, sid) is None:
                cache.put(self.id, sid, b)
                n += 1
        return n

    def stage_host_shards(self):
        return {sid: np.frombuffer(b, dtype=np.uint8)
                for sid, b in self._data.items()}


class _FakeLoc:
    def __init__(self, vols):
        self.ec_volumes = {v.id: v for v in vols}


class _FakeStore:
    def __init__(self, vols, cache):
        self._lock = threading.Lock()
        self.locations = [_FakeLoc(vols)]
        self.ec_device_cache = cache
        self.ec_host_cache = None

    def set_ec_host_cache(self, hc):
        self.ec_host_cache = hc

    def ec_volume_tier(self, vid):
        return "hbm" if self.ec_device_cache.resident_count(vid) >= 10 else (
            "disk")


def _ladders(specs, seed):
    """Both packages' ladders over a 2-lane cache of whole pins and fake
    volumes of `specs` [(vid, shard bytes)]."""
    rng = np.random.default_rng(seed)
    data = {vid: {sid: rng.integers(0, 256, size=size, dtype=np.uint8)
                  .tobytes() for sid in range(10)} for vid, size in specs}
    out = []
    for c, cls, cfg in zip(_caches(2, mesh_min_shard_bytes=1 << 30),
                           (JaxTiering, TieringController),
                           (JaxServingConfig, ServingConfig)):
        vols = {vid: _FakeVol(vid, d) for vid, d in data.items()}
        ctl = cls(_FakeStore(list(vols.values()), c), cfg(
            tier_min_residency_seconds=0.0, tier_promote_ratio=1.0,
            tier_interval_seconds=0.0).validated())
        out.append((c, vols, ctl))
    return out


def _state(c, vids):
    return ({v: c.resident_count(v) for v in vids},
            {v: c.placement(v) for v in vids}, c.device_stats())


def test_pressure_demotes_from_the_full_lane_equal():
    sides = _ladders([(101, 2 * MIB), (102, 64 * 1024)], 9)
    moves = []
    for c, vols, ctl in sides:
        vols[101].load_shards_to_device(c)
        vols[102].load_shards_to_device(c)
        c.budget = 2 * 35 * MIB
        ctl.heat.note(101)
        moves.append(ctl.rebalance(now=1000.0))
    assert moves[0] == moves[1] and ("demote_hbm", 101) in moves[1]
    assert _state(sides[0][0], (101, 102)) == _state(sides[1][0], (101, 102))
    assert sides[1][0].resident_count(102) == 10


def test_promotion_fit_uses_per_lane_headroom_equal():
    sides = _ladders([(111, 64 * 1024), (112, 64 * 1024)], 10)
    moves, needs = [], []
    for c, vols, ctl in sides:
        vols[111].load_shards_to_device(c)
        c.budget = 2 * 32 * MIB
        ctl.heat.note(112, n=5)
        needs.append(ctl._pin_need(c, 112, (10, 64 * 1024)))
        moves.append(ctl.rebalance(now=1000.0))
    assert needs[0] == needs[1] and len(needs[1]) == 1
    assert moves[0] == moves[1] and ("promote_hbm", 112) in moves[1]
    assert _state(sides[0][0], (111, 112)) == _state(sides[1][0], (111, 112))


def test_swap_victims_come_only_from_the_needed_lane_equal():
    sides = _ladders([(121, 64 * 1024), (122, 64 * 1024), (123, 64 * 1024)],
                     11)
    moves = []
    for c, vols, ctl in sides:
        vols[121].load_shards_to_device(c)
        vols[122].load_shards_to_device(c)
        c.budget = 2 * 32 * MIB
        ctl.heat.note(121)
        ctl.heat.note(123, n=5)
        moves.append(ctl.rebalance(now=1000.0))
    assert moves[0] == moves[1]
    assert ("demote_hbm", 121) in moves[1] and ("promote_hbm", 123) in moves[1]
    assert sides[1][0].resident_count(122) == 10
    assert _state(sides[0][0], (121, 122, 123)) == _state(
        sides[1][0], (121, 122, 123))
