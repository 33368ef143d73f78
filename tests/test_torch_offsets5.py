"""The port's 5-byte needle-map offsets (`-offset.bytes 5`) held against
the JAX package's, on the CPU.

types.set_offset_size(5) is the runtime form of the reference's
5BytesOffset build tag (types/offset_5bytes.go): process-wide, so a
fixture switches both packages and restores 4.  The wire encodings, the
.idx walker past 32 GB, a sparse volume addressed past 32 GB, and EC
encode, the 17-byte .ecx (byte-equal to the reference's), a degraded
read and an .ecx delete in 5-byte mode.
"""
import os
import random

import pytest

from seaweedfs_tpu.storage import ec as jax_ec
from seaweedfs_tpu.storage import idx as jax_idx
from seaweedfs_tpu.storage import types as jax_t
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu_torch import command
from seaweedfs_tpu_torch.storage import ec, idx as idx_mod
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.volume import Volume

GB = 1024 * 1024 * 1024


@pytest.fixture
def five_bytes():
    for mod in (t, jax_t):
        mod.set_offset_size(5)
    yield
    for mod in (t, jax_t):
        mod.set_offset_size(4)


def test_default_mode_unchanged():
    assert (t.OFFSET_SIZE, t.NEEDLE_MAP_ENTRY_SIZE,
            t.MAX_POSSIBLE_VOLUME_SIZE) == (4, 16, 32 * GB)
    assert command.parser().parse_args(["volume"]).offset_bytes == 4


def test_offset_encoding_matches_the_reference(five_bytes):
    assert t.NEEDLE_MAP_ENTRY_SIZE == 17
    assert t.MAX_POSSIBLE_VOLUME_SIZE == 8 * 1024 * GB
    for off in (0, 8, 32 * GB, 33 * GB + 8, 8 * 1024 * GB - 8):
        b = t.offset_to_bytes(off)
        assert len(b) == 5 and b == jax_t.offset_to_bytes(off)
        assert t.offset_from_bytes(b) == off
    # the reference's byte order: low word big-endian, high byte appended
    assert t.offset_to_bytes((1 << 32) * t.NEEDLE_PADDING_SIZE) == bytes(
        [0, 0, 0, 0, 1])


def test_idx_pack_parse_above_32gb(five_bytes, tmp_path):
    path = str(tmp_path / "big.idx")
    entries = [(1, 0, 100), (2, 33 * GB, 4096), (3, 100 * GB + 8, 1 << 20),
               (4, 0, t.TOMBSTONE_FILE_SIZE)]
    with open(path, "wb") as f:
        for nid, off, size in entries:
            packed = idx_mod.pack_entry(nid, off, size)
            assert packed == jax_idx.pack_entry(nid, off, size)
            f.write(packed)
    assert idx_mod.entry_count(path) == 4
    assert list(idx_mod.walk(path)) == entries == list(jax_idx.walk(path))


def test_sparse_volume_past_32gb_roundtrip(five_bytes, tmp_path):
    """Needles written above the 4-byte cap on a sparse .dat read back in
    the port, after a reload, and in the reference over the same files."""
    v = Volume(str(tmp_path), 1)
    blob_a, blob_b = os.urandom(5000), os.urandom(7000)
    v.write(1, 0xAAAA, blob_a, name=b"low")
    v._dat.truncate(33 * GB)  # a sparse hole: no disk is used
    v.write(2, 0xBBBB, blob_b, name=b"high")
    assert v.nm.get(2)[0] >= 33 * GB
    assert bytes(v.read(1, 0xAAAA).data) == blob_a
    assert bytes(v.read(2, 0xBBBB).data) == blob_b
    v.close()
    v2 = Volume(str(tmp_path), 1)
    assert bytes(v2.read(2, 0xBBBB).data) == blob_b
    assert bytes(v2.read(1, 0xAAAA).data) == blob_a
    assert sorted(v2.nm.items()) == sorted(
        jax_volume.Volume(str(tmp_path), 1).nm.items())
    v2.close()


def _make_volume(vol_mod, d, count=24, seed=7):
    rng = random.Random(seed)
    os.makedirs(d)
    v = vol_mod.Volume(str(d), 1)
    blobs = {}
    for i in range(1, count + 1):
        data = rng.randbytes(rng.choice([10, 100, 1337, 4096, 70_000]))
        cookie = rng.getrandbits(32)
        v.write(i, cookie, data, name=f"f{i}".encode())
        blobs[i] = (cookie, data)
    v.sync()
    return v, blobs


def test_ec_roundtrip_in_5byte_mode(five_bytes, tmp_path):
    """The port encodes a volume in 5-byte mode: its .ecx has 17-byte
    entries and equals the reference's encode of the same .dat and .idx,
    as do its shards; a read with shards 0 and 11 down returns every
    needle, and a delete tombstones the entry at the 5-byte field offset,
    as the reference's does."""
    v, blobs = _make_volume(jax_volume, tmp_path / "ref")
    os.makedirs(tmp_path / "port")
    for ext in (".dat", ".idx"):
        with open(v.dat_path[:-4] + ext, "rb") as f, open(
                tmp_path / "port" / f"1{ext}", "wb") as g:
            g.write(f.read())
    jax_ec.write_ec_files(v.dat_path[:-4], backend="cpu")
    jax_ec.write_sorted_file_from_idx(v.dat_path[:-4])
    base = str(tmp_path / "port" / "1")
    ec.write_ec_files(base, backend="numpy")
    ec.write_sorted_file_from_idx(base)

    def files(b):
        return [open(b + ext, "rb").read()
                for ext in [".ecx"] + [ec.to_ext(i) for i in range(14)]]

    assert os.path.getsize(base + ".ecx") % 17 == 0
    assert files(base) == files(v.dat_path[:-4])
    evs = {"port": ec.EcVolume(str(tmp_path / "port"), 1),
           "ref": jax_ec.EcVolume(str(tmp_path / "ref"), 1)}
    for ev in evs.values():
        for i in range(14):
            if i not in (0, 11):
                ev.add_shard(i)
    for nid, (cookie, data) in blobs.items():
        n = evs["port"].read_needle(nid, cookie=cookie, backend="numpy")
        assert bytes(n.data) == data
    victim = next(iter(blobs))
    for ev in evs.values():
        ev.delete_needle(victim)
    with pytest.raises(Exception):
        evs["port"].read_needle(victim, backend="numpy")
    for ev in evs.values():
        ev.close()
    assert open(base + ".ecx", "rb").read() == open(
        v.dat_path[:-4] + ".ecx", "rb").read()
    v.close()
