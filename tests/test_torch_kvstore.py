"""The port's embedded KV store (csrc/host/kvstore.cpp, built by
ops/_build.host() with g++ at first use, bound by storage/kvstore.py)
held against the JAX package's (native/kvstore.cpp), on the CPU.

Each case of the reference's tests runs on both bindings with the same
operations; answers, counts and the log file's bytes are compared.  The
filer store's case waits for the port's filer (ROADMAP A10).
"""
import os
import struct

import numpy as np
import pytest

from seaweedfs_tpu.storage.kvstore import NativeKv as JaxKv
from seaweedfs_tpu.storage.kvstore import native_available
from seaweedfs_tpu_torch.storage.kvstore import NativeKv as PortKv

pytestmark = pytest.mark.skipif(
    not native_available(), reason="the reference's native library is not built"
)
KINDS = {"jax": JaxKv, "torch": PortKv}


def _rand(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


def _both(tmp_path, case) -> dict:
    """Run `case(Kv, path)` on both bindings: -> {kind: (its answer, the
    log file's bytes)}."""
    out = {}
    for kind, cls in KINDS.items():
        path = str(tmp_path / f"{kind}.kv")
        got = case(cls, path)
        with open(path, "rb") as f:
            out[kind] = (got, f.read())
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_kv_basic_ops(tmp_path):
    def case(Kv, p):
        kv = Kv(p)
        kv.put(b"alpha", b"1" * 10)
        kv.put(b"beta", b"2" * 5000)  # past the first get buffer
        kv.put(b"alpha", b"updated")
        got = [kv.get(b"alpha"), kv.get(b"beta"), kv.get(b"missing"), len(kv),
               kv.delete(b"beta"), kv.delete(b"beta"), kv.get(b"beta"),
               len(kv), dict(kv.items()), kv.keys()]
        kv.close()
        with pytest.raises(ValueError):
            kv.get(b"alpha")  # closed: an error, not a NULL handle
        return got

    got, _ = _both(tmp_path, case)
    assert got == [b"updated", b"2" * 5000, None, 2, True, False, None, 1,
                   {b"alpha": b"updated"}, [b"alpha"]]


def test_kv_reopen_replays_log(tmp_path):
    def case(Kv, p):
        kv = Kv(p)
        for i in range(200):
            kv.put(f"k{i}".encode(), _rand(i, 50 + i))
        kv.put(b"k7", b"second-version")
        kv.delete(b"k9")
        kv.close()
        kv2 = Kv(p)
        got = [len(kv2), kv2.get(b"k7"), kv2.get(b"k9"), kv2.get(b"k100")]
        kv2.close()
        return got

    got, _ = _both(tmp_path, case)
    assert got == [199, b"second-version", None, _rand(100, 150)]


def test_kv_torn_tail_recovery(tmp_path):
    def case(Kv, p):
        kv = Kv(p)
        kv.put(b"good", b"data")
        kv.close()
        with open(p, "ab") as f:
            f.write(b"\x30\x00\x00\x00\xff")  # half a record header
        kv2 = Kv(p)
        got = [kv2.get(b"good")]
        kv2.put(b"after", b"crash")  # lands on a clean boundary
        kv2.close()
        kv3 = Kv(p)
        got += [kv3.get(b"after"), len(kv3)]
        kv3.close()
        return got

    got, _ = _both(tmp_path, case)
    assert got == [b"data", b"crash", 2]


def test_kv_compaction_reclaims_and_preserves(tmp_path):
    def case(Kv, p):
        kv = Kv(p)
        for i in range(50):
            kv.put(b"hot", _rand(i, 1000))  # 49 superseded versions
        kv.put(b"cold", b"keep")
        kv.delete(b"hot")
        size_before = os.path.getsize(p)
        dead = kv.dead_bytes
        reclaimed = kv.compact()
        got = [dead > 0, reclaimed, os.path.getsize(p) < size_before,
               kv.get(b"cold"), kv.get(b"hot"), len(kv)]
        kv.put(b"post", b"compact")  # still writable after the swap
        kv.close()
        kv2 = Kv(p)
        got += [kv2.get(b"post"), kv2.get(b"cold")]
        kv2.close()
        return got

    got, _ = _both(tmp_path, case)
    assert got[0] is True and got[1] > 0 and got[2] is True
    assert got[3:] == [b"keep", None, 1, b"compact", b"keep"]


def test_kv_tombstone_churn_does_not_fill_table(tmp_path):
    """Delete-heavy churn leaves tombstone slots in the hash index; growth
    gates on occupancy, so neither a get nor the replay spins."""
    def case(Kv, p):
        kv = Kv(p)
        for i in range(3000):
            k = f"churn-{i}".encode()
            kv.put(k, b"v")
            kv.delete(k)
        got = [len(kv), kv.get(b"absent-after-churn")]
        kv.put(b"alive", b"yes")
        got.append(kv.get(b"alive"))
        kv.close()
        kv2 = Kv(p)
        got += [len(kv2), kv2.get(b"alive")]
        kv2.close()
        return got

    got, _ = _both(tmp_path, case)
    assert got == [0, None, b"yes", 1, b"yes"]


def test_kv_torn_value_not_zero_extended(tmp_path):
    """A record whose value was half written is dropped at replay, not
    zero-extended into a corrupt live value."""
    def case(Kv, p):
        kv = Kv(p)
        kv.put(b"ok", b"fine")
        kv.close()
        with open(p, "ab") as f:
            # the header claims a 100-byte value; 10 bytes follow
            f.write(struct.pack("<II", 4, 100) + b"torn" + b"x" * 10)
        kv2 = Kv(p)
        got = [kv2.get(b"torn"), kv2.get(b"ok"), len(kv2)]
        kv2.close()
        return got

    got, _ = _both(tmp_path, case)
    assert got == [None, b"fine", 1]


def test_kv_files_open_across_bindings(tmp_path):
    """A log the reference wrote opens in the port with every record, and
    the port's appends to it read back in the reference."""
    p = str(tmp_path / "x.kv")
    kv = JaxKv(p)
    for i in range(64):
        kv.put(i.to_bytes(8, "big"), _rand(i, 12))
    kv.delete((5).to_bytes(8, "big"))
    kv.close()
    kv = PortKv(p)
    assert len(kv) == 63 and kv.get((9).to_bytes(8, "big")) == _rand(9, 12)
    kv.put(b"port", b"wrote this")
    kv.close()
    kv = JaxKv(p)
    assert kv.get(b"port") == b"wrote this" and len(kv) == 64
    kv.close()
