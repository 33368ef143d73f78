"""The port's resident degraded-read path held against the JAX package.

Inputs come from a numpy seed; GF(256) is exact arithmetic, so every
comparison is byte equality (tolerance 0).  The JAX side runs as
tests/test_rs_resident.py and tests/test_blockdiag_serving.py run it on the
CPU: Pallas kernels in interpret mode, shard_quantum 1 MiB, a few hundred KB
of shard.  The port side runs on CPU tensors, which take the kernels' plain
versions; the kernels themselves are held against those versions on the
card in test_torch_cuda.py.
"""
import os
import random
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as jax_gf256
from seaweedfs_tpu.ops import rs_resident as jr
from seaweedfs_tpu.ops import rs_tpu
from seaweedfs_tpu.storage import ec as jax_ec
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.ops import rs_resident as tr
from seaweedfs_tpu_torch.storage import ec

from test_blockdiag_serving import fill_cache as jax_fill_cache
from test_rs_resident import coded  # noqa: F401 (fixture)
from test_torch_ec import _needles, _pair

MIB = 1 << 20


def _port_cache(shards, missing=(), vid=7, layout="flat", quantum=MIB):
    cache = tr.DeviceShardCache(shard_quantum=quantum, layout=layout,
                                device="cpu")
    for sid in range(shards.shape[0]):
        if sid not in missing:
            cache.put(vid, sid, shards[sid])
    return cache


# --- copied constants and helpers --------------------------------------------


def test_constants_equal():
    for name in ("DATA_SHARDS", "TOTAL_SHARDS", "LANE", "FUSED_ALIGN",
                 "SIZE_BUCKETS", "COUNT_BUCKETS", "MAX_TILE", "CHUNK",
                 "SHARD_QUANTUM", "META_ROW_BITS", "_META_ROW_MASK",
                 "_MAX_CALL_OUT", "_MAX_PENDING_OUT", "FUSED_GROUP",
                 "FUSED_TILE", "LAYOUTS"):
        assert getattr(tr, name) == getattr(jr, name), name
    assert issubclass(tr.ColdShape, tr.CacheMiss)
    assert issubclass(tr.CacheMiss, LookupError)


def test_bucket_helpers_equal():
    for values in (tr.SIZE_BUCKETS, tr.COUNT_BUCKETS):
        for need in range(0, values[-1] + 1, max(1, values[-1] // 997)):
            assert tr._bucket(values, need) == jr._bucket(values, need)
        with pytest.raises(ValueError):
            tr._bucket(values, values[-1] + 1)
    for b in tr.SIZE_BUCKETS + (1, 4096, 3 << 20):
        assert tr._max_count(b) == jr._max_count(b)
    for span in list(range(1, 70_000, 97)) + [tr.MAX_TILE, tr.MAX_TILE + 896]:
        f = tr._fetch_cover(span)
        assert f == jr._fetch_cover(span)
        assert tr._fused_tile_for(f) == jr._fused_tile_for(f)
        for groups in (1, 2, 4, 8):
            assert tr._blockdiag_fetch_tile(f, groups) == \
                jr._blockdiag_fetch_tile(f, groups)


def _sweep_requests(rng, n, wanted):
    return [
        (int(rng.choice(wanted)), int(rng.integers(0, 1 << 26)),
         int(rng.integers(1, tr.MAX_TILE + 12346)))
        for _ in range(n)
    ]


@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_plan_and_vectors_equal(w):
    rng = np.random.default_rng(w)
    wanted = [0, 11, 5, 13][:w]
    reqs = _sweep_requests(rng, 300, wanted) + [(wanted[0], 5, 1),
                                                (wanted[-1], 1023, 12345)]
    subs = tr._plan(reqs)
    assert subs == jr._plan(reqs)
    for l_loc in (1 << 20, 3 << 20):
        assert tr._plan(reqs[:50], l_loc) == jr._plan(reqs[:50], l_loc)
    row_of = {sid: i for i, sid in enumerate(sorted(wanted))}
    for bucket in tr.SIZE_BUCKETS:
        part = [(i, s) for i, s in enumerate(subs) if s[4] == bucket]
        for lo in range(0, len(part), 16):
            chunk = part[lo : lo + 16]
            assert tr._fused_vectors(chunk, reqs, row_of) == \
                jr._fused_vectors(chunk, reqs, row_of)


# --- the kernels' plain versions against the JAX kernels -----------------------

L_SURV = 1 << 20


@pytest.fixture(scope="module")
def survivors():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, L_SURV, dtype=np.uint8) for _ in range(10)]


def _system(w):
    wanted = [0, 11, 5, 13][:w]
    present = [i for i in range(14) if i not in wanted]
    return jax_gf256.reconstruction_matrix(10, 14, present, wanted)[0]


def _meta(rng, n, fetch, w):
    last = (L_SURV - fetch) // tr.FUSED_ALIGN
    units = rng.integers(0, last + 1, n)
    units[-1] = last  # the last legal window
    rows = rng.integers(0, w, n)
    return ((units << tr.META_ROW_BITS) | rows).astype(np.int32)


@pytest.mark.parametrize("n,fetch,w", [
    (1, 2048, 1), (5, 3072, 2), (8, 8192, 3), (13, 3072, 4), (13, 8192, 1),
])
def test_fused_reconstruct_equals_jax(survivors, n, fetch, w):
    rng = np.random.default_rng(n * fetch + w)
    meta = _meta(rng, n, fetch, w)
    a_jax = rs_tpu.prepare_matrix(_system(w))
    tile = jr._fused_tile_for(fetch)
    want = np.asarray(jr._fused_reconstruct(
        a_jax, tuple(jnp.asarray(s) for s in survivors), jnp.asarray(meta),
        tile=tile, fetch=fetch, k_true=10, interpret=True,
    )).reshape(n, fetch)
    got = tr.fused_reconstruct(
        rs_cuda.from_jax_prepared(np.asarray(a_jax), "cpu"),
        tuple(torch.from_numpy(s) for s in survivors),
        torch.from_numpy(meta), tile=tile, fetch=fetch, k_true=10, w_true=w,
    )
    assert got.shape == (n, fetch)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,fetch,w", [
    (1, 4096, 1), (5, 8192, 2), (8, 4096, 3), (13, 8192, 4),
])
def test_fused_reconstruct_blockdiag_equals_jax(survivors, n, fetch, w):
    rng = np.random.default_rng(n * fetch + w + 1)
    meta = _meta(rng, n, fetch, w)
    fetch, tile = jr._blockdiag_fetch_tile(fetch, 4)
    a_jax = rs_tpu.prepare_matrix_blockdiag(_system(w), 4)
    want = np.asarray(jr._fused_reconstruct_blockdiag(
        a_jax, tuple(jnp.asarray(s) for s in survivors), jnp.asarray(meta),
        tile=tile, fetch=fetch, k_true=10, w_true=w, groups=4, interpret=True,
    )).reshape(n, fetch)
    got = tr.fused_reconstruct_blockdiag(
        rs_cuda.from_jax_prepared(np.asarray(a_jax), "cpu"),
        tuple(torch.from_numpy(s) for s in survivors),
        torch.from_numpy(meta), tile=tile, fetch=fetch, k_true=10,
        w_true=w, groups=4,
    )
    assert np.array_equal(got.numpy(), want)


def test_wrappers_refuse_bad_calls(survivors):
    surv = tuple(torch.from_numpy(s) for s in survivors)
    a = rs_cuda.prepare_matrix(_system(2), "cpu")
    meta = torch.tensor([(3 << 5) | 1], dtype=torch.int32)
    kw = dict(tile=2048, fetch=2048, k_true=10, w_true=2)
    last = torch.tensor([((L_SURV - 2048) // 1024 + 1) << 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="runs past"):
        tr.fused_reconstruct(a, surv, last, **kw)
    with pytest.raises(ValueError, match="row"):
        tr.fused_reconstruct(a, surv, torch.tensor([2], dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="survivors"):
        tr.fused_reconstruct(a, surv[:9], meta, **kw)
    with pytest.raises(TypeError):
        tr.fused_reconstruct(a, surv, meta.to(torch.int64), **kw)
    with pytest.raises(ValueError, match="fetch"):
        tr.fused_reconstruct(a, surv, meta, tile=2048, fetch=3000, k_true=10)
    a_blk = rs_cuda.prepare_matrix_blockdiag(_system(2), 4, "cpu")
    with pytest.raises(ValueError, match="tile"):
        tr.fused_reconstruct_blockdiag(a_blk, surv, meta, tile=2048,
                                       fetch=4096, k_true=10, w_true=2,
                                       groups=4)


# --- reconstruct_intervals ----------------------------------------------------


def _mixed_requests(length):
    rng = random.Random(3)
    return [
        (3, 5, 100),              # unaligned head
        (11, 131, 40000),         # parity shard, bucket-spanning
        (3, 0, 1),
        (11, 131000, 70000),
        (3, length - 1000, 1000),  # the tail of the shard
    ] + [
        (rng.choice([3, 11]), rng.randrange(0, length - 4096), 4096)
        for _ in range(64)        # a 64-request batch of one bucket
    ]


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
def test_reconstruct_intervals_equals_jax_and_oracle(coded, layout):  # noqa: F811
    reqs = _mixed_requests(coded.shape[1])
    jcache = jax_fill_cache(coded, missing=(3, 11), layout=layout)
    want = jr.reconstruct_intervals(jcache, 7, reqs, kernel="pallas",
                                    interpret=True)
    cache = _port_cache(coded, missing=(3, 11), layout=layout)
    got = tr.reconstruct_intervals(cache, 7, reqs)
    for (sid, off, size), g, w in zip(reqs, got, want):
        assert g == w == coded[sid][off : off + size].tobytes(), (sid, off, size)
    # the other layout over the same resident bytes gives the same bytes
    other = "flat" if layout == "blockdiag" else "blockdiag"
    assert tr.reconstruct_intervals(cache, 7, reqs[:5], layout=other) == got[:5]


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
def test_reconstruct_intervals_chunk_split(layout):
    big = tr.MAX_TILE + 12345
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, size=(10, big + 4096), dtype=np.uint8)
    from seaweedfs_tpu_torch.ops.rs import RSCodec

    shards = RSCodec(backend="numpy").encode_all(data)
    jcache = jr.DeviceShardCache(shard_quantum=1 << 22, layout=layout)
    for sid in range(1, 14):
        jcache.put(9, sid, shards[sid])
    cache = _port_cache(shards, missing=(0,), vid=9, layout=layout,
                        quantum=1 << 22)
    (want,) = jr.reconstruct_intervals(jcache, 9, [(0, 17, big)],
                                       kernel="pallas", interpret=True)
    (got,) = tr.reconstruct_intervals(cache, 9, [(0, 17, big)])
    assert got == want == shards[0][17 : 17 + big].tobytes()


def test_cache_miss_and_empty(coded):  # noqa: F811
    cache = _port_cache(coded, missing=range(5, 14))
    with pytest.raises(tr.CacheMiss):
        tr.reconstruct_intervals(cache, 7, [(3, 0, 100)])
    assert tr.reconstruct_intervals(_port_cache(coded), 7, []) == []
    with pytest.raises(ValueError):
        tr.reconstruct_intervals(_port_cache(coded), 7, [(3, 0, 1)],
                                 layout="diag")


@pytest.mark.parametrize("evicted", [7, 8])
def test_eviction_during_a_call_keeps_its_bytes(coded, monkeypatch, evicted):  # noqa: F811
    """Evicting the batch's own volume, or another one, after the call
    resolved its survivors serves the right bytes all the same (the call
    holds its survivors); the cache forgets only the evicted volume."""
    cache = _port_cache(coded, missing=(3,), layout="blockdiag")
    for sid in range(coded.shape[0]):
        cache.put(8, sid, coded[sid])
    real = tr._dispatch_call

    def evicting(*a, **kw):
        cache.evict(evicted)
        return real(*a, **kw)

    monkeypatch.setattr(tr, "_dispatch_call", evicting)
    reqs = _mixed_requests(coded.shape[1])[:8]
    got = tr.reconstruct_intervals(cache, 7, reqs)
    for (sid, off, size), g in zip(reqs, got):
        assert g == coded[sid][off : off + size].tobytes(), (sid, off, size)
    assert cache.shard_ids(evicted) == []
    assert cache.resident_count(15 - evicted) > 0


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
def test_make_batched_call(coded, layout):  # noqa: F811
    cache = _port_cache(coded, missing=(3,), layout=layout)
    reqs = [(3, 4096 * i, 4096) for i in range(8)]
    out = tr.make_batched_call(cache, 7, reqs)().numpy().reshape(8, -1)
    assert out.shape[1] >= 4096
    for i in range(8):
        assert (out[i, :4096] == coded[3][4096 * i : 4096 * i + 4096]).all()
    with pytest.raises(ValueError):
        tr.make_batched_call(cache, 7, [(3, 0, 100), (3, 0, 100_000)])


# --- DeviceShardCache ---------------------------------------------------------


def test_cache_lru_and_accounting_equal_jax(coded):  # noqa: F811
    one = tr.DeviceShardCache(shard_quantum=MIB, device="cpu")._padded_len(
        coded.shape[1])
    assert one == jr.DeviceShardCache(shard_quantum=MIB)._padded_len(
        coded.shape[1])
    caches = (jr.DeviceShardCache(budget_bytes=3 * one, shard_quantum=MIB),
              tr.DeviceShardCache(budget_bytes=3 * one, shard_quantum=MIB,
                                  device="cpu"))
    script = [("put", 7, 0), ("put", 7, 1), ("put", 7, 2), ("put", 7, 3),
              ("get", 7, 1), ("put", 7, 9), ("put", 8, 0), ("evict", 7, 9),
              ("put", 7, 4), ("get", 8, 0), ("put", 7, 5), ("evict", 8, None),
              ("put", 7, 1)]
    for op, vid, sid in script:
        seen = []
        for c in caches:
            if op == "put":
                c.put(vid, sid, coded[sid])
            elif op == "get":
                c.get(vid, sid)
            else:
                c.evict(vid, sid)
            seen.append((c.shard_ids(7), c.shard_ids(8), c.bytes_used,
                         c.evictions, c.resident_by_vid(), c.stats(),
                         c.resident_count(7), c.placement(7), c.placement(8)))
        assert seen[0] == seen[1], (op, vid, sid)
    port = caches[1]
    got = port.get(7, 4)
    assert got.numel() == one and port.shard_size(7, 4) == coded.shape[1]
    assert np.array_equal(got[: coded.shape[1]].numpy(), coded[4])
    assert not got[coded.shape[1]:].any()  # the padded tail is zero
    assert port.device_budget == 3 * one
    port.clear()
    assert port.bytes_used == 0 and port.shard_ids(7) == []


def test_pin_source_claim_and_release(coded):  # noqa: F811
    for c in (jr.DeviceShardCache(shard_quantum=MIB),
              tr.DeviceShardCache(shard_quantum=MIB, device="cpu")):
        assert c.claim_pin_source(7, "/a") == "/a"
        assert c.claim_pin_source(7, "/b") == "/a"
        c.release_pin_source(7, "/b")
        assert c.pin_source(7) == "/a"
        c.release_pin_source(7, "/a")  # nothing resident: released
        assert c.pin_source(7) is None
        c.claim_pin_source(7, "/b")
        c.put(7, 0, coded[0])
        c.release_pin_source(7, "/b")  # partially pinned: kept
        assert c.pin_source(7) == "/b" and c.pin_claims == 2
        c.evict(7)
        assert c.pin_source(7) is None


def test_cache_refuses_unported_layouts():
    """The mesh layout is ported (tests/test_torch_mesh.py): on the one
    CPU device a mesh resolves one lane wide and degrades to the
    one-device layout, as the reference's does.  Layouts and group counts
    the port has no system for still raise."""
    for kw in ({"mesh_devices": 0}, {"global_mesh": True},
               {"mesh_devices": 0, "global_mesh": True}):
        c = tr.DeviceShardCache(device="cpu", **kw)
        assert c.mesh is None and c.n_devices == 1 and c.stripe == 0
    with pytest.raises(ValueError):
        tr.DeviceShardCache(device="cpu", layout="diag")
    with pytest.raises(ValueError):
        tr.DeviceShardCache(device="cpu", groups=3)


# --- DevicePipeline -------------------------------------------------------------


def _section(pipe, hold, started, release):
    with pipe.slot() as s:
        assert s.arena is None and s.stream is None  # CPU: no staging lane
        started.append(time.perf_counter())
        release.wait(hold)


def _spawn(pipe, n, started, release):
    threads = [threading.Thread(target=_section,
                                args=(pipe, 5.0, started, release))
               for _ in range(n)]
    for t in threads:
        t.start()
    return threads


def _wait_for(cond, timeout=2.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.005)


def test_pipeline_single_slot_serializes():
    pipe = tr.DevicePipeline(slots=1)
    started, release = [], threading.Event()
    threads = _spawn(pipe, 2, started, release)
    _wait_for(lambda: started)
    time.sleep(0.1)
    assert len(started) == 1  # the second section waits for the slot
    pipe.set_slots(2)  # widening admits the queued section
    _wait_for(lambda: len(started) == 2)
    assert len(started) == 2
    release.set()
    for t in threads:
        t.join()


def test_pipeline_two_slots_overlap():
    pipe = tr.DevicePipeline(slots=2)
    started, release = [], threading.Event()
    threads = _spawn(pipe, 2, started, release)
    _wait_for(lambda: len(started) == 2)
    assert len(started) == 2  # both sections live at once
    time.sleep(0.05)
    release.set()
    for t in threads:
        t.join()
    assert pipe.last_overlap > 1.0
    assert pipe.total_busy_s > 0


# --- EcVolume --------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """~1.5 MB volume at the default blocks, encoded by both packages:
    shard 0 holds the first MB of needles."""
    needles = _needles(2, 24, [100, 5000, 70000, 120000])
    return _pair(tmp_path_factory.mktemp("resident"), needles), needles


def _mount(mod, base, down=(0, 11)):
    ev = mod.EcVolume(os.path.dirname(base), 1)
    for sid in range(14):
        if sid not in down:
            ev.add_shard(sid)
    return ev


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
def test_ec_volume_resident_reads_equal_jax(served, monkeypatch, layout):
    (jbase, tbase), needles = served
    jev, tev = _mount(jax_ec, jbase), _mount(ec, tbase)
    host = _mount(ec, tbase)
    jcache = jr.DeviceShardCache(shard_quantum=MIB, layout=layout)
    cache = tr.DeviceShardCache(shard_quantum=MIB, layout=layout, device="cpu")
    try:
        assert jev.load_shards_to_device(jcache) == 12
        assert tev.load_shards_to_device(cache) == 12
        assert tev.is_device_resident() and jev.is_device_resident()
        calls = []
        real = tr.reconstruct_intervals

        def counting(*a, **kw):
            calls.append(len(a[2]))
            return real(*a, **kw)

        monkeypatch.setattr(tr, "reconstruct_intervals", counting)
        nids = [nid for nid, _, _ in needles]
        got = tev.read_needles_batch(nids, backend="torch")
        want = jev.read_needles_batch(nids)
        assert len(calls) == 1 and calls[0] >= 5  # one coalesced call
        for (nid, cookie, data), g, w in zip(needles, got, want):
            assert g.data == w.data == data and g.cookie == cookie
            assert tev.read_needle_bytes(nid, backend="torch") == \
                jev.read_needle_bytes(nid) == \
                host.read_needle_bytes(nid, backend="torch")
        assert len(calls) > 1  # the single reads took the device branch
        n = tev.read_needle(nids[0], cookie=needles[0][1], backend="torch")
        assert n.data == needles[0][2]
        missing = tev.read_needles_batch([nids[1], 0xDEADBEEF], backend="torch")
        assert missing[0].data == needles[1][2]
        assert isinstance(missing[1], ec.NeedleNotFound)
    finally:
        for ev in (jev, tev, host):
            ev.close()
    assert cache.shard_ids(1) == []  # close released the pinned volume


def test_ec_volume_eviction_falls_back_to_host(served, monkeypatch):
    (_, tbase), needles = served
    tev = _mount(ec, tbase)
    cache = tr.DeviceShardCache(shard_quantum=MIB, device="cpu")
    try:
        tev.load_shards_to_device(cache)
        for sid in (5, 6, 7):  # 9 survivors left: every device call misses
            cache.evict(1, sid)
        assert not tev.is_device_resident()
        host_calls = []
        real = ec.volume.rs.RSCodec.reconstruct

        def counting(self, *a, **kw):
            host_calls.append(1)
            return real(self, *a, **kw)

        monkeypatch.setattr(ec.volume.rs.RSCodec, "reconstruct", counting)
        nids = [nid for nid, _, _ in needles]
        got = tev.read_needles_batch(nids, backend="torch")
        for (nid, _, data), g in zip(needles, got):
            assert g.data == data
        assert host_calls  # the burst fell back to the host path
        assert tev.device_misses > 0
    finally:
        tev.close()


def test_ec_volume_unmount_midbatch_clean_exceptions(served, monkeypatch):
    """Mirror of the JAX TestEvictionRaces: the cache evicted and every
    shard unmounted under an in-flight burst gives each needle a clean
    exception (CacheMiss, then the host path's missing shards), never
    stale bytes."""
    (_, tbase), needles = served
    tev = _mount(ec, tbase)
    cache = tr.DeviceShardCache(shard_quantum=MIB, layout="blockdiag",
                                device="cpu")
    try:
        tev.load_shards_to_device(cache)
        real = tr.reconstruct_intervals

        def racing(*a, **kw):
            cache.evict(1)
            for sid in list(tev.shards):
                tev.delete_shard(sid).close()
            return real(*a, **kw)

        monkeypatch.setattr(tr, "reconstruct_intervals", racing)
        results = tev.read_needles_batch([nid for nid, _, _ in needles],
                                         backend="torch")
        assert len(results) == len(needles)
        for r in results:
            assert isinstance(r, Exception), f"stale bytes served: {r!r}"
        assert tev.device_misses > 0
    finally:
        tev.close()


def test_ec_volume_delete_shard_evicts(served):
    (_, tbase), _ = served
    tev = _mount(ec, tbase, down=())
    other = ec.EcVolume(os.path.dirname(tbase), 1)
    other.add_shard(5)
    other.dir = tbase + "-elsewhere"  # a second location of the same vid
    cache = tr.DeviceShardCache(shard_quantum=MIB, device="cpu")
    try:
        assert tev.load_shards_to_device(cache) == 14
        other.device_cache = cache
        assert other.load_shards_to_device() == 0  # the first pinner wins
        other.delete_shard(5)  # not the pinning location: nothing evicted
        assert 5 in cache.shard_ids(1)
        tev.delete_shard(5)
        assert 5 not in cache.shard_ids(1)
        assert len(cache.shard_ids(1)) == 13
    finally:
        other.close()
        tev.close()
    assert cache.shard_ids(1) == [] and cache.pin_source(1) is None
