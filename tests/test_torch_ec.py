"""The PyTorch port's EC main path held against the JAX package, file by
file.

One set of needles, made from a numpy seed with fixed timestamps, is
written through both packages' Volume; both encode, rebuild, verify,
serve degraded reads and decode, and every output must be byte-identical
(sha256), tolerance 0.  The JAX side runs as its own tests run it on the
CPU (codec "xla" for the bulk pipelines, "pallas" in interpret mode for
degraded reads); the port side runs backend "torch", its plain version.
Small large/small blocks make both row phases of the layout occur.
"""
import hashlib
import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.storage import ec as jax_ec
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.volume import Volume as JaxVolume
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

LARGE, SMALL = 8192, 1024
SIDECARS = [ec.to_ext(i) for i in range(14)] + [".ecx", ".vif"]


def _needles(seed, count, sizes):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(1, count + 1):
        size = int(rng.choice(sizes))
        out.append((i, int(rng.integers(0, 1 << 32)), rng.bytes(size)))
    return out


def _write(volume_cls, needle_cls, dirname, needles):
    v = volume_cls(dirname, 1)
    for nid, cookie, data in needles:
        v.append_needle(needle_cls(
            id=nid, cookie=cookie, data=data, name=b"f%d" % nid,
            last_modified=1_700_000_000, append_at_ns=1_700_000_000_000 + nid,
        ))
    v.sync()
    v.close()
    return os.path.join(dirname, "1")


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _pair(tmp, needles, **blocks):
    """Write and encode the same needles through both packages."""
    jdir, tdir = tmp / "jax", tmp / "torch"
    jdir.mkdir()
    tdir.mkdir()
    jbase = _write(JaxVolume, JaxNeedle, str(jdir), needles)
    tbase = _write(Volume, Needle, str(tdir), needles)
    jax_ec.write_ec_files(jbase, backend="xla", **blocks)
    jax_ec.write_sorted_file_from_idx(jbase)
    ec.write_ec_files(tbase, backend="torch", **blocks)
    ec.write_sorted_file_from_idx(tbase)
    return jbase, tbase


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """~300 KB volume: three 10 x 8 KB large rows, then 1 KB small rows."""
    needles = _needles(1, 40, [10, 333, 1024, 4096, 9000, 20000])
    return _pair(tmp_path_factory.mktemp("enc"), needles,
                 large_block=LARGE, small_block=SMALL)


@pytest.fixture
def encoded_copy(encoded, tmp_path):
    jbase, tbase = encoded
    shutil.copytree(os.path.dirname(jbase), tmp_path / "jax")
    shutil.copytree(os.path.dirname(tbase), tmp_path / "torch")
    return str(tmp_path / "jax" / "1"), str(tmp_path / "torch" / "1")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """~1.5 MB volume at the default 1 GB / 1 MB blocks (the layout
    EcVolume serves): shard 0 holds the first MB of needles."""
    needles = _needles(2, 24, [100, 5000, 70000, 120000])
    return _pair(tmp_path_factory.mktemp("srv"), needles), needles


def test_volume_files_identical(encoded):
    jbase, tbase = encoded
    for ext in (".dat", ".idx"):
        assert _sha(jbase + ext) == _sha(tbase + ext), ext


def test_encode_identical(encoded):
    jbase, tbase = encoded
    assert os.path.getsize(tbase + ".dat") > 3 * 10 * LARGE  # both phases
    for ext in SIDECARS:
        assert _sha(jbase + ext) == _sha(tbase + ext), ext


@pytest.mark.parametrize(
    "missing", [(3,), (0, 13), (1, 5, 12), (0, 5, 10, 13), (9, 10, 11, 12)]
)
def test_rebuild_identical(encoded_copy, missing):
    jbase, tbase = encoded_copy
    want = {i: _sha(tbase + ec.to_ext(i)) for i in missing}
    for base in (jbase, tbase):
        for i in missing:
            os.remove(base + ec.to_ext(i))
    assert jax_ec.rebuild_ec_files(jbase, backend="xla") == list(missing)
    assert ec.rebuild_ec_files(tbase, backend="torch") == list(missing)
    for i in missing:
        assert _sha(tbase + ec.to_ext(i)) == want[i]
        assert _sha(jbase + ec.to_ext(i)) == want[i]


@pytest.mark.parametrize("corrupt", [False, True])
def test_verify_counts_equal(encoded_copy, corrupt):
    jbase, tbase = encoded_copy
    if corrupt:
        for base in (jbase, tbase):
            with open(base + ec.to_ext(12), "r+b") as f:
                f.seek(777)
                b = f.read(1)
                f.seek(777)
                f.write(bytes([b[0] ^ 0x5A]))
    want = jax_ec.verify_ec_files(jbase, backend="xla")
    got = ec.verify_ec_files(tbase, backend="torch")
    assert got == want
    assert got[0] == ([0, 0, 1, 0] if corrupt else [0, 0, 0, 0])


@pytest.mark.parametrize("overlap", [False, True])
def test_bulk_stats_contract(encoded_copy, overlap):
    _, tbase = encoded_copy
    stats = {}
    ec.write_ec_files(tbase, backend="torch", large_block=LARGE,
                      small_block=SMALL, stats=stats, overlap=overlap)
    assert stats["overlap"] is overlap
    assert stats["batches"] > 0 and stats["device_busy_s"] > 0
    legs = stats["read_s"] + stats["submit_s"] + stats["wait_s"] + stats["write_s"]
    if not overlap:
        assert legs <= stats["wall_s"]


def test_degraded_read_equal(served):
    """Shards 0 and 11 down: every needle read through the port's
    EcVolume equals the JAX EcVolume's (Pallas, interpret mode)."""
    (jbase, tbase), needles = served
    evs = []
    for mod, base in ((jax_ec, jbase), (ec, tbase)):
        ev = mod.EcVolume(os.path.dirname(base), 1)
        for sid in range(14):
            if sid not in (0, 11):
                ev.add_shard(sid)
        evs.append(ev)
    jev, tev = evs
    degraded = 0
    try:
        for nid, cookie, data in needles:
            _, _, ivs = tev.locate_needle(nid)
            degraded += any(iv.to_shard_and_offset()[0] == 0 for iv in ivs)
            raw = tev.read_needle_bytes(nid, backend="torch")
            assert raw == jev.read_needle_bytes(nid, backend="pallas")
            n = tev.read_needle(nid, cookie=cookie, backend="torch")
            assert n.data == data
        assert degraded >= 5
    finally:
        for ev in evs:
            ev.close()


def test_decode_identical(encoded_copy):
    jbase, tbase = encoded_copy
    want = _sha(tbase + ".dat")
    for mod, base in ((jax_ec, jbase), (ec, tbase)):
        os.remove(base + ".dat")
        size = mod.write_dat_file(base, large_block=LARGE, small_block=SMALL)
        assert size == os.path.getsize(base + ".dat")
        assert _sha(base + ".dat") == want
    assert ec.find_dat_file_size(tbase) == jax_ec.find_dat_file_size(jbase)


def test_rebuild_ecx_replays_journal(served, tmp_path):
    (jbase, tbase), needles = served
    bases = []
    for name, base in (("jax", jbase), ("torch", tbase)):
        d = tmp_path / name
        d.mkdir()
        for ext in (".ecx", ".vif", ec.to_ext(0)):
            shutil.copy(base + ext, d / ("1" + ext))
        bases.append(str(d / "1"))
    for mod, base in zip((jax_ec, ec), bases):
        ev = mod.EcVolume(os.path.dirname(base), 1)
        for nid in (2, 7, 11):
            ev.delete_needle(nid)
        ev.close()
        shutil.copy(
            (jbase if mod is jax_ec else tbase) + ".ecx", base + ".ecx"
        )  # a rebuilt .ecx knows nothing of the deletes
        mod.rebuild_ecx_file(base)
        assert not os.path.exists(base + ".ecj")
    assert _sha(bases[0] + ".ecx") == _sha(bases[1] + ".ecx")
    ev = ec.EcVolume(os.path.dirname(bases[1]), 1)
    try:
        with pytest.raises(ec.NeedleNotFound):
            ev.find_needle(7)
    finally:
        ev.close()
