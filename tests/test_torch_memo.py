"""The degraded read's reconstruct memo (storage/ec/volume.py), held against
the JAX package's.

Both packages encode the same needles (tests/test_torch_ec.py's fixture:
default 1 GB / 1 MB blocks, shard 0 holds the first MB).  Each side mounts
a few shards locally and reaches the rest through a counting `remote_read`
over the same shard files; shard 0 is missing everywhere, so every read of
a needle on it is a degraded read whose gather pulls survivors off "peers".
Held equal between the packages, with no tolerance: the bytes, the remote
pulls, the memo's keys after eviction, and the hit/miss counters.
"""
import os
import threading
import time

import pytest

from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu.storage import ec as ref_ec
from seaweedfs_tpu.storage.ec import volume as ref_ec_volume
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.ec import volume as port_ec_volume

from test_torch_ec import _needles, _pair

MISSING = 0
LOCAL = (1, 2, 3)
SIDES = {"ref": (ref_ec, ref_ec_volume, "numpy"),
         "port": (ec, port_ec_volume, "torch")}


class _Peers:
    """remote_read over the shard files of `base`: a shard with a holder
    answers its bytes (a pull), the missing shard has none (None, no
    pull), as the volume server's reader does with no holder listed."""

    def __init__(self, base):
        self.base = base
        self.pulls = 0
        self.lock = threading.Lock()

    def __call__(self, sid, off, size):
        if sid == MISSING:
            return None
        with open(self.base + ec.to_ext(sid), "rb") as f:
            f.seek(off)
            data = f.read(size)
        with self.lock:
            self.pulls += 1
        return data


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    needles = _needles(2, 24, [100, 5000, 70000, 120000])
    return _pair(tmp_path_factory.mktemp("memo"), needles), needles


def _open(kind, base, local=LOCAL):
    mod = SIDES[kind][0]
    ev = mod.EcVolume(os.path.dirname(base), 1)
    for sid in local:
        ev.add_shard(sid)
    return ev


def _degraded(base, needles):
    """-> (the needles with an interval on the missing shard, the sizes of
    those intervals)."""
    ev = _open("port", base)
    nids, sizes = [], []
    try:
        for nid, _, _ in needles:
            _, _, ivs = ev.locate_needle(nid)
            on = [iv.size for iv in ivs
                  if iv.to_shard_and_offset()[0] == MISSING]
            if on:
                nids.append(nid)
                sizes += on
    finally:
        ev.close()
    return nids, sizes


def _memo_counts(kind):
    if kind == "port":
        c = stats.VOLUME_SERVER_EC_DEGRADED_MEMO
        return {r: c.labels(result=r).value for r in ("hit", "miss")}
    c = ref_stats.VOLUME_SERVER_EC_DEGRADED_MEMO
    return {r: c.labels(result=r)._value.get() for r in ("hit", "miss")}


def _passes(kind, base, nids, passes=2, between=None):
    """Read every needle `passes` times: -> per pass (bodies, pulls,
    memo hit/miss deltas), and the memo's keys at the end."""
    backend = SIDES[kind][2]
    ev = _open(kind, base)
    peers = _Peers(base)
    out = []
    try:
        for i in range(passes):
            if i and between is not None:
                between()
            before, pulls0 = _memo_counts(kind), peers.pulls
            bodies = [bytes(ev.read_needle_bytes(nid, peers, backend=backend))
                      for nid in nids]
            after = _memo_counts(kind)
            out.append((bodies, peers.pulls - pulls0,
                        {k: after[k] - before[k] for k in after}))
        return out, list(ev._reconstruct_memo), ev._reconstruct_memo_bytes
    finally:
        ev.close()


def _bases(served):
    (jbase, tbase), needles = served
    return {"ref": jbase, "port": tbase}, needles


def test_a_repeat_within_the_ttl_pulls_nothing(served):
    bases, needles = _bases(served)
    nids, _ = _degraded(bases["port"], needles)
    assert len(nids) >= 5
    got = {k: _passes(k, b, nids) for k, b in bases.items()}
    assert got["port"] == got["ref"]
    (first, second), keys, nbytes = got["port"]
    assert first[0] == second[0]
    # the first pass pulled 7 survivors an interval (3 are local), the
    # second none: every interval a hit
    assert first[1] == 7 * len(keys) and second[1] == 0
    assert first[2] == {"hit": 0, "miss": len(keys)}
    assert second[2] == {"hit": len(keys), "miss": 0}
    assert nbytes == sum(k[2] for k in keys)
    whole = _open("port", bases["port"], range(1, 14))
    try:
        for nid, body in zip(nids, first[0]):
            assert body == bytes(whole.read_needle_bytes(nid, backend="torch"))
    finally:
        whole.close()


def test_past_the_ttl_it_pulls_again(served, monkeypatch):
    bases, needles = _bases(served)
    nids = _degraded(bases["port"], needles)[0][:3]
    for mod in (ref_ec_volume, port_ec_volume):
        monkeypatch.setattr(mod, "RECONSTRUCT_MEMO_TTL_S", 1.0)
    got = {k: _passes(k, b, nids, passes=3,
                      between=lambda: time.sleep(1.1))
           for k, b in bases.items()}
    assert [(p[1], p[2]) for p in got["port"][0]] == [
        (p[1], p[2]) for p in got["ref"][0]]
    pulls = [p[1] for p in got["port"][0]]
    assert pulls[0] > 0 and pulls[1] == pulls[0] and pulls[2] == pulls[0]
    assert all(p[2]["hit"] == 0 for p in got["port"][0])


def test_the_budget_evicts_the_same_keys(served, monkeypatch):
    bases, needles = _bases(served)
    nids, sizes = _degraded(bases["port"], needles)
    budget = sum(sorted(sizes)[-3:])  # a few intervals, not all
    assert budget < sum(sizes)
    for mod in (ref_ec_volume, port_ec_volume):
        monkeypatch.setattr(mod, "RECONSTRUCT_MEMO_BUDGET", budget)
    got = {k: _passes(k, b, nids) for k, b in bases.items()}
    assert got["port"] == got["ref"]
    _, keys, nbytes = got["port"]
    assert 0 < len(keys) < len(sizes) and nbytes <= budget


def test_a_local_gather_is_never_memoised(served):
    bases, needles = _bases(served)
    nids, _ = _degraded(bases["port"], needles)
    for kind, base in bases.items():
        backend = SIDES[kind][2]
        ev = _open(kind, base, local=range(1, 14))
        peers = _Peers(base)
        try:
            before = _memo_counts(kind)
            for _ in range(2):
                for nid in nids:
                    ev.read_needle_bytes(nid, peers, backend=backend)
            after = _memo_counts(kind)
            assert peers.pulls == 0
            assert ev._reconstruct_memo == {}, kind
            assert after["hit"] == before["hit"], kind
        finally:
            ev.close()


def test_a_resident_read_is_never_memoised(served):
    from seaweedfs_tpu_torch.ops import rs_resident

    bases, needles = _bases(served)
    base = bases["port"]
    nids, _ = _degraded(base, needles)
    cache = rs_resident.DeviceShardCache(budget_bytes=1 << 30, device="cpu",
                                         shard_quantum=1 << 20)
    ev = _open("port", base, local=range(1, 14))
    peers = _Peers(base)
    try:
        assert ev.load_shards_to_device(cache) == 13
        assert ev.is_device_resident()
        before = _memo_counts("port")
        bodies = [[bytes(ev.read_needle_bytes(nid, peers, backend="torch"))
                   for nid in nids] for _ in range(2)]
        after = _memo_counts("port")
        assert bodies[0] == bodies[1]
        assert ev._reconstruct_memo == {} and peers.pulls == 0
        assert after["hit"] == before["hit"]
        assert after["miss"] - before["miss"] == 2 * len(nids)
    finally:
        ev.close()


def test_hits_and_misses_show_on_metrics(served):
    bases, needles = _bases(served)
    nids = _degraded(bases["port"], needles)[0][:2]
    _passes("port", bases["port"], nids)
    text = stats.generate_latest(stats.REGISTRY).decode()
    lines = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
             for ln in text.splitlines()
             if ln.startswith("SeaweedFS_volumeServer_ec_degraded_memo_total")}
    counts = _memo_counts("port")
    assert lines == {
        'SeaweedFS_volumeServer_ec_degraded_memo_total{result="hit"}':
            counts["hit"],
        'SeaweedFS_volumeServer_ec_degraded_memo_total{result="miss"}':
            counts["miss"],
    }
    assert counts["hit"] > 0 and counts["miss"] > 0
