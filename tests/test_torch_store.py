"""The port's Store (and DiskLocation, the Volume and EcVolume extensions
it calls) held against the JAX package's Store on copies of one directory.

Data comes from a numpy seed; the comparisons are byte equality and the
exception class by name.  The reference side uses its host backends
(`numpy`, no device cache); the port reads through a DeviceShardCache on
the CPU, whose reconstruct runs the kernels' plain versions (the kernels
themselves are held against those on the card in test_torch_cuda.py).
Mirrors tests/test_store.py.
"""
import hashlib
import os
import shutil
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.storage import disk_location as jax_dl
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu_torch.ops import rs_resident
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation, parse_base_name
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import Volume

MIB = 1 << 20
DOWN = (0, 11)
EC_VID, VID = 2, 1


def needles(seed: int, count: int, sizes) -> list[tuple[int, int, bytes]]:
    rng = np.random.default_rng(seed)
    return [(i, int(rng.integers(0, 1 << 32)), rng.bytes(int(rng.choice(sizes))))
            for i in range(1, count + 1)]


def write_volume(dirname: str, vid: int, items) -> str:
    v = Volume(dirname, vid)
    for nid, cookie, data in items:
        v.append_needle(Needle(
            id=nid, cookie=cookie, data=data, name=b"f%d" % nid,
            mime=b"application/x-test", last_modified=1_700_000_000,
            append_at_ns=1_700_000_000_000 + nid,
        ))
    v.sync()
    v.close()
    return os.path.join(dirname, str(vid))


def build_dir(dirname: str, seed: int = 5, down=DOWN):
    """A directory holding a normal volume (VID) and a degraded EC volume
    (EC_VID: sidecars and the shards but `down`, no .dat).  The EC volume
    is about 2.5 MB at the default blocks, so shard 0 holds its first MiB
    and every needle there is a degraded read.  -> (normal, ec) needles."""
    os.makedirs(dirname, exist_ok=True)
    plain = needles(seed, 12, [10, 3000, 40000])
    coded = needles(seed + 1, 40, [100, 5000, 70000, 120000])
    write_volume(dirname, VID, plain)
    base = write_volume(dirname, EC_VID, coded)
    ec.write_ec_files(base, backend="numpy")
    ec.write_sorted_file_from_idx(base)
    for ext in (".dat", ".idx", ".note"):
        if os.path.exists(base + ext):
            os.remove(base + ext)
    for sid in down:
        os.remove(base + ec.to_ext(sid))
    return plain, coded


def cpu_cache(layout="flat"):
    return rs_resident.DeviceShardCache(shard_quantum=MIB, layout=layout,
                                        device="cpu")


def wait_resident(store, vid, timeout=30.0) -> bool:
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if store.ec_volume_is_resident(vid) and \
                store.ec_device_cache.resident_count(vid) == 14 - len(DOWN):
            return True
        time.sleep(0.01)
    return False


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    d = tmp_path_factory.mktemp("store_src")
    plain, coded = build_dir(str(d))
    return str(d), plain, coded


@pytest.fixture
def stores(source, tmp_path):
    """(reference Store, port Store with a resident CPU cache) over
    copies of the source directory."""
    src, plain, coded = source
    shutil.copytree(src, tmp_path / "jax")
    shutil.copytree(src, tmp_path / "torch")
    ref = jax_store.Store([jax_dl.DiskLocation(str(tmp_path / "jax"))],
                          ec_backend="numpy")
    port = Store([DiskLocation(str(tmp_path / "torch"))], ec_backend="torch",
                 ec_device_cache=cpu_cache())
    try:
        assert wait_resident(port, EC_VID)
        yield ref, port, plain, coded
    finally:
        ref.close()
        port.close()


def _outcome(fn):
    try:
        n = fn()
    except Exception as e:  # noqa: BLE001 — the class is what is compared
        return type(e).__name__
    return (n.id, n.cookie, bytes(n.data), n.name, n.mime, n.last_modified)


def test_parse_base_name_equal():
    for stem in ("7", "col_7", "a_b_7", "junk", "_3", "x_"):
        assert parse_base_name(stem) == jax_dl.parse_base_name(stem)


def test_discovery_and_infos_equal(stores):
    ref, port, _, _ = stores
    assert sorted(port.locations[0].volumes) == sorted(ref.locations[0].volumes) == [VID]
    assert sorted(port.locations[0].ec_volumes) == [EC_VID]
    assert sorted(port.find_ec_volume(EC_VID).shards) == \
        sorted(ref.find_ec_volume(EC_VID).shards)
    assert [vars(i) for i in port.volume_infos()] == \
        [vars(i) for i in ref.volume_infos()]


@pytest.mark.parametrize("zero_copy", [False, True])
def test_normal_reads_equal(stores, zero_copy):
    ref, port, plain, _ = stores
    for nid, cookie, data in plain:
        got = _outcome(lambda: port.read_needle(VID, nid, cookie,
                                                zero_copy=zero_copy))
        assert got == _outcome(lambda: ref.read_needle(VID, nid, cookie))
        assert got[2] == data
    for nid, cookie in ((plain[0][0], plain[0][1] ^ 1), (999, None)):
        assert _outcome(lambda: port.read_needle(VID, nid, cookie)) == \
            _outcome(lambda: ref.read_needle(VID, nid, cookie))
    ref.delete_needle(VID, plain[1][0])
    port.delete_needle(VID, plain[1][0])
    for read_deleted in (False, True):
        assert _outcome(lambda: port.read_needle(
            VID, plain[1][0], read_deleted=read_deleted)) == _outcome(
            lambda: ref.read_needle(VID, plain[1][0], read_deleted=read_deleted))
    assert port.find_volume(VID).deleted_needle_size(plain[1][0]) == \
        ref.find_volume(VID).deleted_needle_size(plain[1][0])
    assert vars(port.find_volume(VID).info()) == vars(ref.find_volume(VID).info())


def test_ec_reads_equal(stores, monkeypatch):
    ref, port, _, coded = stores
    calls = []
    real = rs_resident.reconstruct_intervals

    def counting(*a, **kw):
        calls.append(len(a[2]))
        return real(*a, **kw)

    monkeypatch.setattr(rs_resident, "reconstruct_intervals", counting)
    for nid, cookie, data in coded:
        for use_device in (True, False):
            got = _outcome(lambda: port.read_ec_needle(
                EC_VID, nid, cookie, use_device=use_device))
            assert got == _outcome(lambda: ref.read_ec_needle(
                EC_VID, nid, cookie, use_device=False))
            assert got[2] == data
    assert calls  # the device branch served the degraded reads
    assert port.find_ec_volume(EC_VID).device_misses == 0


@pytest.mark.parametrize("zero_copy", [False, True])
def test_ec_batch_equal_with_errors(stores, monkeypatch, zero_copy):
    ref, port, _, coded = stores
    port.delete_ec_needle(EC_VID, coded[3][0])
    ref.delete_ec_needle(EC_VID, coded[3][0])
    reqs = [(nid, cookie) for nid, cookie, _ in coded]
    reqs[5] = (reqs[5][0], reqs[5][1] ^ 0xFF)  # wrong cookie
    reqs.append((0xDEADBEEF, None))  # missing
    calls = []
    real = rs_resident.reconstruct_intervals

    def counting(*a, **kw):
        calls.append(len(a[2]))
        return real(*a, **kw)

    monkeypatch.setattr(rs_resident, "reconstruct_intervals", counting)
    got = port.read_ec_needles_batch(EC_VID, reqs, zero_copy=zero_copy)
    want = ref.read_ec_needles_batch(EC_VID, reqs)
    assert len(calls) == 1 and calls[0] >= 5  # one coalesced call
    for g, w in zip(got, want):
        if isinstance(w, Exception):
            assert type(g).__name__ == type(w).__name__
        else:
            assert isinstance(g.data, memoryview) == zero_copy
            assert (g.id, g.cookie, bytes(g.data)) == (w.id, w.cookie, w.data)
    names = [type(g).__name__ for g in got]
    assert names[3] == "NeedleNotFound" and names[5] == "CookieMismatch"
    assert names[-1] == "NeedleNotFound"
    for nid, cookie in ((coded[3][0], None), (0xDEADBEEF, None),
                        (coded[5][0], coded[5][1] ^ 1)):
        assert _outcome(lambda: port.read_ec_needle(EC_VID, nid, cookie)) == \
            _outcome(lambda: ref.read_ec_needle(EC_VID, nid, cookie))
    assert _outcome(lambda: port.read_ec_needle(99, 1)) == \
        _outcome(lambda: ref.read_ec_needle(99, 1))
    assert port.read_ec_shard_interval(EC_VID, 1, 100, 5000) == \
        ref.read_ec_shard_interval(EC_VID, 1, 100, 5000)


def test_two_lanes_never_share_a_body(stores):
    """Two threads batch-read disjoint needle sets at once with zero-copy
    views: no body aliases a buffer the other lane's batch overwrites."""
    _, port, _, coded = stores
    port.ec_device_cache.pipeline.set_slots(2)
    halves = (coded[0::2], coded[1::2])
    results: list = [[], []]
    errors: list = []

    def lane(i):
        try:
            for _ in range(8):
                got = port.read_ec_needles_batch(
                    EC_VID, [(n, c) for n, c, _ in halves[i]], zero_copy=True)
                results[i].append(got)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=lane, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not errors and not any(th.is_alive() for th in threads)
    for i in (0, 1):
        assert len(results[i]) == 8
        for got in results[i]:
            assert [bytes(n.data) for n in got] == [d for _, _, d in halves[i]]


def test_pin_thread_flips_residency(source, tmp_path, monkeypatch):
    src, _, coded = source
    shutil.copytree(src, tmp_path / "d")
    gate = threading.Event()
    real_put = rs_resident.DeviceShardCache.put

    def gated_put(self, *a, **kw):
        gate.wait(10)
        return real_put(self, *a, **kw)

    monkeypatch.setattr(rs_resident.DeviceShardCache, "put", gated_put)
    store = Store([DiskLocation(str(tmp_path / "d"))], ec_backend="torch",
                  ec_device_cache=cpu_cache())
    try:
        # pin still running: reads route to the host and still serve
        assert not store.ec_volume_is_resident(EC_VID)
        n = store.read_ec_needle(EC_VID, coded[0][0], coded[0][1])
        assert n.data == coded[0][2]
        gate.set()
        assert wait_resident(store, EC_VID)
        assert not store.ec_volume_is_resident(VID)  # a normal volume
    finally:
        gate.set()
        store.close()
    assert Store([DiskLocation(str(tmp_path / "e"))], ec_backend="torch") \
        .ec_volume_is_resident(EC_VID) is False  # no cache, never resident


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_ec_generate_and_rebuild_equal(tmp_path):
    items = needles(9, 30, [100, 5000, 70000])
    out = {}
    for name, store_mod, dl_mod, backend in (
        ("jax", jax_store, jax_dl, "numpy"),
        ("torch", None, None, "torch"),
    ):
        d = tmp_path / name
        d.mkdir()
        write_volume(str(d), 3, items)
        if store_mod is None:
            store = Store([DiskLocation(str(d))], ec_backend=backend)
        else:
            store = store_mod.Store([dl_mod.DiskLocation(str(d))],
                                    ec_backend=backend)
        try:
            store.ec_generate(3)
            base = str(d / "3")
            gen = {ext: _sha(base + ext) for ext in
                   [ec.to_ext(s) for s in range(14)] + [".ecx"]}
            store.mount_ec_shards(3, list(range(14)))
            store.delete_ec_needle(3, items[0][0])
            store.unmount_ec_shards(3, [0, 5, 10, 13])
            for sid in (0, 5, 10, 13):
                os.remove(base + ec.to_ext(sid))
            rebuilt = sorted(store.ec_rebuild(3))
            out[name] = (gen, rebuilt, {s: _sha(base + ec.to_ext(s))
                                        for s in rebuilt}, _sha(base + ".ecx"))
            assert not os.path.exists(base + ".ecj")
            store.mount_ec_shards(3, [0, 5, 10, 13])
            assert type(_raise(lambda: store.read_ec_needle(3, items[0][0]))) \
                .__name__ == "NeedleNotFound"
            assert store.read_ec_needle(3, items[1][0]).data == items[1][2]
            store.delete_ec_shards(3, list(range(14)))
            assert not os.path.exists(base + ".ecx")
            assert store.find_ec_volume(3) is None
        finally:
            store.close()
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == [0, 5, 10, 13]


def _raise(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — returned for the caller
        return e
    return None


def test_volume_lifecycle_matches(tmp_path):
    """add / write / readonly / unmount / mount / delete on both."""
    for name, store in (
        ("jax", jax_store.Store([jax_dl.DiskLocation(str(tmp_path / "j"),
                                                     max_volume_count=2)],
                                ec_backend="numpy")),
        ("torch", Store([DiskLocation(str(tmp_path / "t"),
                                      max_volume_count=2)],
                        ec_backend="torch")),
    ):
        try:
            store.add_volume(4, collection="pics")
            assert type(_raise(lambda: store.add_volume(4))).__name__ == "ValueError"
            store.add_volume(5)
            assert type(_raise(lambda: store.add_volume(6))).__name__ == "RuntimeError"
            n = Needle(id=7, cookie=9, data=b"x" * 100)
            store.write_needle(4, n)
            store.mark_volume_readonly(4)
            assert type(_raise(lambda: store.write_needle(4, n))).__name__ == \
                "VolumeReadOnly"
            store.mark_volume_readonly(4, False)
            store.unmount_volume(4)
            assert store.find_volume(4) is None
            store.mount_volume(4)
            assert store.read_needle(4, 7, 9).data == b"x" * 100
            assert store.find_volume(4).collection == "pics"
            store.delete_volume(4)
            assert not any(f.startswith("pics_4.") for f in os.listdir(
                store.locations[0].directory))
            for fn in (lambda: store.delete_volume(4),
                       lambda: store.read_needle(4, 7),
                       lambda: store.mount_volume(44)):
                assert type(_raise(fn)).__name__ == "NotFoundError", name
        finally:
            store.close()
