"""The port's parity scrub (ops/rs_resident.py scrub half, Store.scrub_*,
the volume server's idle scrub loop) held against the JAX package.

The same seeded numpy shards go through the JAX package's scrub_volume /
scrub_all_resident (on the CPU with its default off the TPU, kernel
"xla") and the port's on a CPU DeviceShardCache, whose scrub runs the
kernel's plain version (the kernel, csrc/scrub.cu, is held against the
plain version and the numpy model of its walk on the card in
test_torch_cuda.py).  A mismatch count is an integer, so every
comparison is exact.  Mirrors tests/test_scrub.py and the scrub half of
tests/test_aot_scrub_r11.py.
"""
import asyncio
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import rs_resident as jax_rr
from seaweedfs_tpu.storage import disk_location as jax_dl
from seaweedfs_tpu.storage import ec as jax_ec
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ops import gf256, rs_cpu, rs_resident
from seaweedfs_tpu_torch.server import volume as server_volume
from seaweedfs_tpu_torch.server.http import Client
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.store import Store

from test_torch_store import EC_VID, build_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIB = 1 << 20
PARITY = gf256.build_matrix(10, 14)[10:]


def volume(size: int, seed: int, flips=()) -> np.ndarray:
    """[14, size] RS(10,4) shards from a seed; `flips` (shard, byte) XOR
    0x5A into them."""
    data = np.random.default_rng(seed).integers(0, 256, (10, size),
                                                dtype=np.uint8)
    shards = np.concatenate([data, rs_cpu.apply_matrix_numpy(PARITY, data)])
    for sid, byte in flips:
        shards[sid, byte] ^= 0x5A
    return shards


def caches(layout: str):
    """(JAX cache, port CPU cache), both with 1 MiB padding quanta."""
    return (jax_rr.DeviceShardCache(shard_quantum=MIB, layout=layout),
            rs_resident.DeviceShardCache(shard_quantum=MIB, layout=layout,
                                         device="cpu"))


def fill(pair, vid: int, shards, sids=range(14)) -> None:
    for cache in pair:
        for sid in sids:
            cache.put(vid, sid, shards[sid])


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the class is what is compared
        return type(e).__name__


# the cases: (shard size, flips, the port's expected counts)
CASES = {
    "clean": (100_000, (), [0, 0, 0, 0]),
    "parity_byte": (100_000, ((12, 777),), [0, 0, 1, 0]),
    # the RS parity matrix has no zero entry: a data byte reaches every row
    "data_byte": (100_000, ((3, 4242),), [1, 1, 1, 1]),
    "many": (100_000, ((10, 0), (10, 99_999), (11, 5), (13, 65_536),
                       (0, 12), (9, 70_000), (12, 12)), [4, 3, 2, 3]),
    # not a multiple of the kernel's 2 KiB tile, of LANE or of 4*LANE
    "ragged_size": (70_001, ((13, 70_000), (2, 69_999)), [1, 1, 1, 2]),
}


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scrub_volume_equals_jax(layout, case):
    size, flips, want = CASES[case]
    pair = caches(layout)
    fill(pair, 7, volume(size, seed=len(case), flips=flips))
    ref = jax_rr.scrub_volume(pair[0], 7, kernel="xla")
    got = rs_resident.scrub_volume(pair[1], 7)
    assert got == ref
    assert got[0] == want
    quant = 128 * (4 if layout == "blockdiag" else 1)
    assert got[1] == -(-size // quant) * quant


def test_scrub_volume_refuses_partial_and_mixed_volumes():
    shards = volume(50_000, seed=1)
    pair = caches("flat")
    fill(pair, 1, shards, sids=range(13))
    assert _outcome(lambda: jax_rr.scrub_volume(pair[0], 1, kernel="xla")) \
        == _outcome(lambda: rs_resident.scrub_volume(pair[1], 1)) \
        == "CacheMiss"
    fill(pair, 2, shards, sids=range(13))
    for cache in pair:
        cache.put(2, 13, shards[13][:40_000])  # one shard of another size
    assert _outcome(lambda: jax_rr.scrub_volume(pair[0], 2, kernel="xla")) \
        == _outcome(lambda: rs_resident.scrub_volume(pair[1], 2)) \
        == "CacheMiss"
    with pytest.raises(rs_resident.CacheMiss, match="sizes differ"):
        rs_resident.scrub_volume(pair[1], 2)


def _dispatches(mode):
    return stats.VOLUME_SERVER_EC_SCRUB_DISPATCH.labels(mode=mode).value


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
def test_scrub_all_resident_equals_jax(layout):
    """Mixed sizes and partly resident volumes: the same verdicts and spans
    as the JAX pass; the port launches once per span class (here 3: its
    rule, up to 32 volumes a launch, no power-of-two padding)."""
    pair = caches(layout)
    fill(pair, 1, volume(60_000, seed=1))
    fill(pair, 2, volume(60_000, seed=2, flips=((11, 54_321),)))
    fill(pair, 3, volume(60_000, seed=3, flips=((4, 9),)))
    fill(pair, 4, volume(30_003, seed=4, flips=((13, 30_002),)))
    fill(pair, 5, volume(60_000, seed=5), sids=[s for s in range(14) if s != 5])
    fill(pair, 6, volume(8_192, seed=6))
    ref, ref_stats = jax_rr.scrub_all_resident(pair[0], kernel="xla")
    before = _dispatches("megakernel")
    got, got_stats = rs_resident.scrub_all_resident(pair[1])
    assert got == ref
    assert set(got) == {1, 2, 3, 4, 6}
    assert got[2][0] == [0, 1, 0, 0] and got[3][0] == [1, 1, 1, 1]
    assert got[4][0] == [0, 0, 0, 1]
    assert got_stats == {"device_calls": 3, "volumes": 5}
    assert ref_stats["volumes"] == 5
    assert _dispatches("megakernel") == before + 3
    for vid in got:
        assert got[vid] == rs_resident.scrub_volume(pair[1], vid)
    assert rs_resident.scrub_all_resident(pair[1], vids=[2, 5]) == (
        {2: got[2]}, {"device_calls": 1, "volumes": 1})


def test_scrub_all_resident_launches_once_per_32_volumes():
    cache = caches("flat")[1]
    for vid in range(33):
        shards = volume(4096, seed=vid, flips=((10, vid),) if vid == 32 else ())
        for sid in range(14):
            cache.put(vid, sid, shards[sid])
    got, st = rs_resident.scrub_all_resident(cache)
    assert st == {"device_calls": 2, "volumes": 33}
    assert got[32] == ([1, 0, 0, 0], 4096)
    assert all(got[v] == ([0, 0, 0, 0], 4096) for v in range(32))


def _segment_oracle(shards, n_lanes, seg_log2):
    """numpy per-segment mismatch counts over the first n_lanes bytes of
    the zero-padded shards: [p, n_seg]."""
    padded = np.zeros((14, n_lanes), dtype=np.uint8)
    padded[:, : shards.shape[1]] = shards
    par = rs_cpu.apply_matrix_numpy(PARITY, padded[:10])
    bad = par != padded[10:]
    n_seg = rs_resident._scrub_segments(n_lanes, seg_log2)
    seg = np.arange(n_lanes) >> seg_log2
    return np.stack([np.bincount(seg[row], minlength=n_seg) for row in bad])


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
@pytest.mark.parametrize("seg_log2", [12, 13, 15])
def test_scrub_segments_on_the_port(monkeypatch, layout, seg_log2):
    """Several counting segments (the port's segment constant set small):
    the partials equal a numpy oracle and the model of the kernel's walk,
    whose blocks' tiles lie in several segments, and whose block-diagonal
    groups begin mid-tile."""
    size = 5 * 65536 + 300
    flips = ((12, 0), (12, 4095), (12, 4096), (10, size - 1), (7, 8191),
             (13, 3 * 65536 + 17), (11, 2 * 4096 + 1), (12, 40_000))
    shards = volume(size, seed=seg_log2, flips=flips)
    monkeypatch.setattr(rs_resident, "_SCRUB_SEG", 1 << seg_log2)
    cache = caches(layout)[1]
    for sid in range(14):
        cache.put(1, sid, shards[sid])
    groups = 4 if layout == "blockdiag" else 1
    counts, n_lanes = rs_resident.scrub_volume(cache, 1)
    oracle = _segment_oracle(shards, n_lanes, seg_log2)
    assert counts == oracle.sum(axis=1).tolist()
    a = rs_resident._scrub_matrix(10, 14, groups, "cpu")
    vol = tuple(cache.get(1, s) for s in range(14))
    plain = rs_resident.scrub(a, [vol], n_lanes=n_lanes, groups=groups,
                              seg_log2=seg_log2)
    assert np.array_equal(plain[0].numpy(), oracle)
    masks = rs_resident._scrub_masks(a, 10, 4, groups)
    host = [tuple(s.numpy() for s in vol)]
    model, _ = rs_resident._scrub_model(masks, host, k=10, n_lanes=n_lanes,
                                        groups=groups, seg_log2=seg_log2)
    assert np.array_equal(model[0], oracle)
    # three blocks walk the tiles: one add per (row, segment) a block's
    # tiles enter with a non-zero count, and a block whose tiles lie in
    # several segments adds to each of them
    few, adds = rs_resident._scrub_model(masks, host, k=10, n_lanes=n_lanes,
                                         groups=groups, seg_log2=seg_log2,
                                         blocks=3)
    assert np.array_equal(few, model)
    assert all(c > 0 for *_, c in adds)
    assert len({a[:4] for a in adds}) == len(adds)
    per_block: dict = {}
    for blk, _, _, sid, _ in adds:
        per_block.setdefault(blk, set()).add(sid)
    assert max(len(s) for s in per_block.values()) > 1


def test_model_equals_plain_across_groups_and_volumes():
    """The model of the kernel's walk against the plain version on three
    volumes, the block-diagonal group boundaries off every 2 KiB tile."""
    vols = [volume(size, seed=size, flips=((10 + size % 4, size // 3),
                                           (size % 10, size - 1)))
            for size in (3 * 65536 + 4096 + 640, 20_480, 9_000)]
    n_lanes = rs_resident._scrub_span(max(v.shape[1] for v in vols), 512)
    for groups in (1, 4):
        a = rs_resident._scrub_matrix(10, 14, groups, "cpu")
        tens = [tuple(torch.from_numpy(np.pad(s, (0, n_lanes - v.shape[1])))
                      for s in v) for v in vols]
        plain = rs_resident.scrub(a, tens, n_lanes=n_lanes, groups=groups,
                                  seg_log2=12)
        model, _ = rs_resident._scrub_model(
            rs_resident._scrub_masks(a, 10, 4, groups),
            [tuple(t.numpy() for t in v) for v in tens], k=10,
            n_lanes=n_lanes, groups=groups, seg_log2=12)
        assert np.array_equal(plain.numpy(), model)
        # a boundary falls mid-tile
        assert (n_lanes // groups) % rs_resident.SCRUB_TILE


# codes the syndrome covers, k + p <= 16 slots: (k, p) -> the groups of
# the block-diagonal layout (groups * p <= 16 rows in the mask table)
CODES = {(10, 4): 4, (6, 3): 4, (12, 4): 4, (8, 8): 2}
CODE_SIZE = 70_001  # not a multiple of LANE or of the 2 KiB tile


def _code_volumes(k, p, n_vols, seed, corruption):
    """n_vols [k + p, CODE_SIZE] volumes of the RS(k, k+p) code; "sparse"
    flips a few bytes of data and parity, "dense" replaces every parity
    byte with a random one (almost every byte mismatches)."""
    parity_m = gf256.build_matrix(k, k + p)[k:]
    out = []
    for v in range(n_vols):
        rng = np.random.default_rng(seed + v)
        data = rng.integers(0, 256, (k, CODE_SIZE), dtype=np.uint8)
        par = rs_cpu.apply_matrix_numpy(parity_m, data)
        if corruption == "dense":
            par = rng.integers(0, 256, par.shape, dtype=np.uint8)
        shards = np.concatenate([data, par])
        if corruption == "sparse":
            for sid, byte in ((k, 0), (k + p - 1, CODE_SIZE - 1),
                              (0, 4095 + v), (k - 1, 40_000), (k, 32_768)):
                shards[sid, byte] ^= 0x5A
        out.append(shards)
    return out


def _padded(vols, n_lanes):
    return [tuple(np.pad(s, (0, n_lanes - s.size)) for s in v) for v in vols]


@pytest.mark.parametrize("corruption", ["sparse", "dense"])
@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
@pytest.mark.parametrize("code", sorted(CODES), ids=lambda c: f"{c[0]}+{c[1]}")
def test_syndrome_equals_plain_and_jax(code, layout, corruption):
    """The syndrome form (_scrub_masks, the B fragments and the model of
    the kernel's walk) against the plain version and the JAX package's
    _scrub_call / _scrub_call_blockdiag (one volume) and _scrub_all_call
    (two volumes lane-stacked) on the same volumes, for codes other than
    RS(10,4) and parity that is wrong almost everywhere."""
    import jax.numpy as jnp

    k, p = code
    groups = CODES[code] if layout == "blockdiag" else 1
    n_lanes = rs_resident._scrub_span(CODE_SIZE, groups * 128)
    vols = _padded(_code_volumes(k, p, 2, seed=k * p, corruption=corruption),
                   n_lanes)
    a = rs_resident._scrub_matrix(k, k + p, groups, "cpu")
    plain = rs_resident.scrub(
        a, [tuple(torch.from_numpy(s) for s in v) for v in vols],
        n_lanes=n_lanes, k=k, groups=groups).numpy()
    masks = rs_resident._scrub_masks(a, k, p, groups)
    model, _ = rs_resident._scrub_model(masks, vols, k=k, n_lanes=n_lanes,
                                        groups=groups, seg_log2=28)
    assert np.array_equal(model, plain)

    parity_m = gf256.build_matrix(k, k + p)[k:]
    a_blk = jax_rr._prepared_blockdiag_matrix(parity_m.tobytes(), p, k,
                                              groups)
    dev = [tuple(jnp.asarray(s) for s in v) for v in vols]
    if groups == 1:
        one = jax_rr._scrub_call(
            jax_rr._prepared_matrix(parity_m.tobytes(), p, k), dev[0][:k],
            dev[0][k:], n_lanes=n_lanes, kernel="xla", interpret=True)
    else:
        one = jax_rr._scrub_call_blockdiag(
            a_blk, dev[0][:k], dev[0][k:], n_lanes=n_lanes, groups=groups,
            kernel="xla", interpret=True)
    both = jax_rr._scrub_all_call(
        a_blk, tuple(s for v in dev for s in v), n_lanes=n_lanes,
        groups=groups, vols=2, k=k, p=p, kernel="xla", interpret=True)
    assert np.array_equal(np.asarray(one), plain[0])
    assert np.array_equal(np.asarray(both), plain)
    if corruption == "dense":
        assert (plain.sum(axis=-1) > 0.99 * CODE_SIZE).all()
    else:
        assert plain.sum() > 0


@pytest.mark.parametrize("seg_log2", [12, 13, 15])
@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
@pytest.mark.parametrize("code", sorted(CODES), ids=lambda c: f"{c[0]}+{c[1]}")
def test_syndrome_segments_equal_plain(code, layout, seg_log2):
    """Per counting segment, the model of the tensor-core kernel equals
    the plain version for every code, both layouts and small segments."""
    k, p = code
    groups = CODES[code] if layout == "blockdiag" else 1
    n_lanes = rs_resident._scrub_span(CODE_SIZE, groups * 128)
    vols = _padded(_code_volumes(k, p, 1, seed=seg_log2, corruption="sparse"),
                   n_lanes)
    a = rs_resident._scrub_matrix(k, k + p, groups, "cpu")
    plain = rs_resident.scrub(
        a, [tuple(torch.from_numpy(s) for s in v) for v in vols],
        n_lanes=n_lanes, k=k, groups=groups, seg_log2=seg_log2).numpy()
    model, _ = rs_resident._scrub_model(
        rs_resident._scrub_masks(a, k, p, groups), vols, k=k,
        n_lanes=n_lanes, groups=groups, seg_log2=seg_log2)
    assert np.array_equal(model, plain)
    assert (plain > 0).sum() > 1


def test_scrub_masks_hold_the_syndrome_bytes():
    """_scrub_masks is _bit_masks plus byte k + j = 1 << i in row (j, i);
    the fragments carry slot t + 4r at byte r of lane (g, t)'s word."""
    k, p, groups = 6, 3, 4
    a = rs_resident._scrub_matrix(k, k + p, groups, "cpu")
    bits = rs_resident._bit_masks(a, k, p, groups, p).reshape(groups, p, 8, 16)
    masks = rs_resident._scrub_masks(a, k, p, groups).reshape(groups, p, 8, 16)
    assert np.array_equal(masks[..., :k], bits[..., :k])
    for j in range(p):
        for i in range(8):
            want = np.zeros(16 - k, dtype=np.uint8)
            want[j] = 1 << i
            assert (masks[:, j, i, k:] == want).all()
    frags = rs_resident._scrub_fragments(masks.reshape(-1, 16), p, groups)
    assert frags.shape == (groups, 1, 4, 32)
    lane = 4 * 5 + 2  # g 5, t 2: row 2, bit 2q + 1
    for q in range(4):
        row = masks[3, 2, 2 * q + 1]
        assert frags[3, 0, q, lane] == int.from_bytes(
            bytes(row[[2, 6, 10, 14]]), "little")
    with pytest.raises(ValueError, match="slots"):
        rs_resident._scrub_masks(rs_resident._scrub_matrix(14, 17, 1, "cpu"),
                                 14, 3, 1)


def test_scrub_refuses_bad_calls_on_the_cpu():
    vol = tuple(torch.zeros(8192, dtype=torch.uint8) for _ in range(14))
    a = rs_resident._scrub_matrix(10, 14, 1, "cpu")
    with pytest.raises(ValueError, match="multiple"):
        rs_resident.scrub(a, [vol], n_lanes=8192 - 64)
    with pytest.raises(ValueError, match="seg_log2"):
        rs_resident.scrub(a, [vol], n_lanes=8192, seg_log2=11)
    with pytest.raises(ValueError, match="runs past"):
        rs_resident.scrub(a, [vol], n_lanes=16384)
    with pytest.raises(ValueError, match="volumes"):
        rs_resident.scrub(a, [vol] * 33, n_lanes=8192)
    with pytest.raises(ValueError, match="data shards"):
        rs_resident.scrub(a, [vol, vol[:13]], n_lanes=8192)
    with pytest.raises(TypeError):
        rs_resident.scrub(a, [tuple(s.to(torch.int16) for s in vol)],
                          n_lanes=8192)
    assert rs_resident.scrub(a, [vol], n_lanes=8192).sum() == 0


# --- Store ------------------------------------------------------------------


def _pinned_stores(tmp_path, dirs=("a",)):
    """(JAX Store, port Store), each over copies of one full EC volume in
    `dirs` locations, the first location's shards pinned in a cache."""
    src = tmp_path / "src"
    build_dir(str(src), down=())
    out = []
    for pkg, (store_cls, loc_cls, cache) in {
        "jax": (jax_store.Store, jax_dl.DiskLocation,
                jax_rr.DeviceShardCache(shard_quantum=MIB)),
        "torch": (Store, DiskLocation,
                  rs_resident.DeviceShardCache(shard_quantum=MIB,
                                               device="cpu")),
    }.items():
        locs = []
        for d in dirs:
            shutil.copytree(src, tmp_path / pkg / d)
            locs.append(loc_cls(str(tmp_path / pkg / d)))
        store = store_cls(locs, ec_backend="numpy")
        store.ec_device_cache = cache
        ev = store.locations[0].ec_volumes[EC_VID]
        ev.device_cache = cache
        ev.load_shards_to_device(cache)
        out.append(store)
    return out


def _same(r_ref, r_port, *keys):
    return all(r_ref[k] == r_port[k] for k in keys)


def test_store_scrub_equals_jax(tmp_path):
    ref, port = _pinned_stores(tmp_path)
    try:
        keys = ("parity_mismatch_bytes", "backend", "bytes_verified")
        r = [s.scrub_ec_volume(EC_VID) for s in (ref, port)]
        assert _same(*r, *keys) and r[1]["backend"] == "device_resident"
        r = [s.scrub_all_resident() for s in (ref, port)]
        assert set(r[0]) == set(r[1]) == {EC_VID}
        a, b = r[0][EC_VID], r[1][EC_VID]
        assert _same(a, b, *keys, "volumes_in_pass")
        assert b["backend"] == "device_megakernel" and b["device_calls"] == 1
        assert os.path.relpath(b["dir"], tmp_path / "torch") == \
            os.path.relpath(a["dir"], tmp_path / "jax") == "a"
        # corrupt the resident parity of shard 12 in both caches
        for s in (ref, port):
            ev = s.locations[0].ec_volumes[EC_VID]
            bad = np.fromfile(ev.base_name + ec.to_ext(12), dtype=np.uint8)
            bad[100] ^= 1
            s.ec_device_cache.put(EC_VID, 12, bad)
        r = [s.scrub_ec_volume(EC_VID) for s in (ref, port)]
        assert _same(*r, *keys) and r[1]["parity_mismatch_bytes"] == [0, 0, 1, 0]
        # not resident: both stream the files (which are clean)
        for s in (ref, port):
            s.ec_device_cache.clear()
        r = [s.scrub_ec_volume(EC_VID) for s in (ref, port)]
        assert _same(*r, *keys)
        assert r[1]["backend"] == "numpy"
        assert r[1]["parity_mismatch_bytes"] == [0, 0, 0, 0]
        assert [s.scrub_all_resident() for s in (ref, port)] == [{}, {}]
    finally:
        ref.close()
        port.close()


def test_store_scrub_dir_rule_for_two_locations(tmp_path):
    """A vid mounted in two locations: the resident verdict speaks only for
    the pinned location; the other location's copy scrubs its own files,
    where a corrupt parity byte shows (in both packages)."""
    ref, port = _pinned_stores(tmp_path, dirs=("a", "b"))
    try:
        for s in (ref, port):
            ev_b = s.locations[1].ec_volumes[EC_VID]
            with open(ev_b.base_name + ec.to_ext(13), "r+b") as f:
                f.seek(10)
                b = f.read(1)
                f.seek(10)
                f.write(bytes([b[0] ^ 0xFF]))
        keys = ("parity_mismatch_bytes", "backend", "bytes_verified")
        for i, want in ((0, ("device_resident", [0, 0, 0, 0])),
                        (1, ("numpy", [0, 0, 0, 1]))):
            r = [s.scrub_ec(s.locations[i].ec_volumes[EC_VID])
                 for s in (ref, port)]
            assert _same(*r, *keys)
            assert (r[1]["backend"], r[1]["parity_mismatch_bytes"]) == want
        r = port.scrub_all_resident()
        assert r[EC_VID]["dir"] == port.locations[0].directory
    finally:
        ref.close()
        port.close()


def test_store_fallback_is_verify_ec_files(tmp_path):
    """Without a cache scrub_ec is verify_ec_files on the volume's files."""
    src = tmp_path / "src"
    build_dir(str(src), down=())
    port = Store([DiskLocation(str(src))], ec_backend="torch")
    try:
        ev = port.find_ec_volume(EC_VID)
        r = port.scrub_ec_volume(EC_VID)
        assert r["backend"] == "torch"
        assert (r["parity_mismatch_bytes"], r["bytes_verified"]) == tuple(
            ec.verify_ec_files(ev.base_name, backend="torch"))
        assert (r["parity_mismatch_bytes"], r["bytes_verified"]) == tuple(
            jax_ec.verify_ec_files(ev.base_name, backend="numpy"))
        assert port.scrub_all_resident() == {}
    finally:
        port.close()


# --- the volume server's idle scrub loop ------------------------------------


def _volume_dirs(tmp_path, corrupt_vid):
    """Two full EC volumes (vids 2 and 3); `corrupt_vid`'s parity shard 10
    has one byte flipped on disk."""
    d = tmp_path / "d"
    build_dir(str(d), down=())
    base = os.path.join(str(d), str(EC_VID))
    for ext in [ec.to_ext(s) for s in range(14)] + [".ecx", ".ecj", ".vif"]:
        if os.path.exists(base + ext):
            shutil.copy(base + ext, os.path.join(str(d), "3") + ext)
    with open(os.path.join(str(d), str(corrupt_vid)) + ec.to_ext(10), "r+b") as f:
        f.seek(64)
        b = f.read(1)
        f.seek(64)
        f.write(bytes([b[0] ^ 0x80]))
    return str(d)


# the server as an operator starts it, with the CPU cache's padding quantum
# cut to 1 MiB (the default 64 MiB pads 28 shards to 1.8 GB)
_SERVE = """
import functools, runpy, sys
from seaweedfs_tpu_torch.ops import rs_resident
rs_resident.DeviceShardCache = functools.partial(
    rs_resident.DeviceShardCache, shard_quantum=1 << 20)
sys.argv = ["seaweedfs_tpu_torch"] + sys.argv[1:]
runpy.run_module("seaweedfs_tpu_torch", run_name="__main__")
"""


def _scrape(port):
    async def go():
        c = Client("127.0.0.1", port)
        try:
            return (await c.request("GET", "/metrics"))[2].decode()
        finally:
            await c.close()

    out = {}
    for line in asyncio.run(go()).splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


@pytest.mark.parametrize("megakernel", [True, False])
def test_idle_scrub_loop_in_the_server_process(tmp_path, megakernel):
    """python3 -m seaweedfs_tpu_torch volume -ec.backend torch
    -ec.scrub.intervalSeconds 1 over two resident volumes, one with a
    corrupt parity shard: the corrupt gauge reads 1 over /metrics, the
    pass over the cache counts one megakernel dispatch a cycle (one span
    class), and with -ec.scrub.megakernel.disable only per_volume counts."""
    d = _volume_dirs(tmp_path, corrupt_vid=3)
    sock = __import__("socket").socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    cmd = [sys.executable, "-c", _SERVE, "volume", "-dir", d, "-port",
           str(port), "-mserver", "", "-ec.backend", "torch",
           "-ec.deviceCacheMB", "256", "-ec.scrub.intervalSeconds", "1"]
    if not megakernel:
        cmd.append("-ec.scrub.megakernel.disable")
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        t_end = time.monotonic() + 60
        m = {}
        while time.monotonic() < t_end:
            time.sleep(0.3)
            try:
                m = _scrape(port)
            except OSError:
                continue
            if m.get("SeaweedFS_volumeServer_ec_scrub_corrupt_volumes") == 1:
                break
        assert m.get("SeaweedFS_volumeServer_ec_scrub_corrupt_volumes") == 1, m
        mk = 'SeaweedFS_volumeServer_ec_scrub_device_dispatch_total{mode="megakernel"}'
        pv = 'SeaweedFS_volumeServer_ec_scrub_device_dispatch_total{mode="per_volume"}'
        if megakernel:
            assert m[mk] >= 1 and m[pv] == 0
        else:
            assert m[mk] == 0 and m[pv] >= 2
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=30)
    assert "FAILED parity scrub" in err


def test_idle_scrub_loop_on_files_detects_and_clears(tmp_path):
    """Without a cache the loop streams the files: a parity byte corrupted
    while the server runs raises the gauge, and restoring it clears it
    (tests/test_scrub.py::test_auto_scrub_loop_detects_corruption)."""
    d = _volume_dirs(tmp_path, corrupt_vid=3)
    path = os.path.join(d, "3") + ec.to_ext(10)
    with open(path, "r+b") as f:  # start clean
        f.seek(64)
        bad = f.read(1)
    good = bytes([bad[0] ^ 0x80])
    _patch(path, good)
    gauge = stats.VOLUME_SERVER_SCRUB_CORRUPT_GAUGE

    async def until(value, timeout=20):
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end and gauge.value != value:
            await asyncio.sleep(0.1)
        return gauge.value

    async def go():
        vs = server_volume.VolumeServer([], [d], port=0, ec_backend="torch",
                                        ec_scrub_interval_seconds=1)
        await vs.start()
        try:
            assert await until(0) == 0
            await asyncio.to_thread(_patch, path, bad)
            assert await until(1) == 1
            await asyncio.to_thread(_patch, path, good)
            assert await until(0) == 0
        finally:
            await vs.stop()

    asyncio.run(go())


def _patch(path, byte):
    with open(path, "r+b") as f:
        f.seek(64)
        f.write(byte)


def test_server_scrub_flags_parse(tmp_path):
    import argparse

    from seaweedfs_tpu_torch.command import volume as cmd_volume
    from seaweedfs_tpu_torch.obs import devledger

    parser = argparse.ArgumentParser()
    cmd_volume.add_args(parser)
    args = parser.parse_args([
        "-dir", str(tmp_path), "-ec.backend", "torch",
        "-ec.scrub.intervalSeconds", "7", "-ec.scrub.megakernel.disable",
        "-obs.ledger.disable"])
    try:
        vs = cmd_volume.build_server(args)
        assert vs.ec_scrub_interval_seconds == 7
        assert vs.ec_scrub_megakernel is False
        assert devledger.LEDGER.enabled is False
        vs.store.close()
    finally:
        devledger.configure(enabled=True)
    args = parser.parse_args(["-dir", str(tmp_path), "-ec.backend", "torch"])
    assert args.ec_scrub_interval_seconds == 0
    assert not args.ec_scrub_megakernel_disable and not args.obs_ledger_disable
