"""The port's master topology against the JAX package's: the same heartbeats
(full and delta) fed to both `Topology` classes give equal layouts,
lookups, EC shard locations, write picks and growth plans.

Mirrors tests/test_topology.py: each scenario there runs here on both
packages with the same seeded inputs, and a seeded random heartbeat stream
(nodes joining, full syncs, volume and EC-shard deltas, node deaths) is
replayed into both and compared after every step."""
import random

import numpy as np
import pytest

from seaweedfs_tpu.storage import store as ref_store
from seaweedfs_tpu.storage import types as ref_t
from seaweedfs_tpu import topology as ref_topo
from seaweedfs_tpu_torch.storage import store as port_store
from seaweedfs_tpu_torch.storage import types as port_t
from seaweedfs_tpu_torch import topology as port_topo

PKGS = {
    "ref": (ref_topo, ref_store, ref_t),
    "port": (port_topo, port_store, port_t),
}


def _vol(st, vid, size=1000, collection="", rp="000", read_only=False,
         disk="hdd", files=1):
    return st.VolumeMessage(
        id=vid, size=size, collection=collection, file_count=files,
        delete_count=0, deleted_byte_count=0, read_only=read_only,
        replica_placement=int(rp), version=3, ttl=0, disk_type=disk,
    )


def _hb(st, volumes=(), ec=(), max_counts=None):
    return st.HeartbeatState(
        volumes=list(volumes), ec_shards=list(ec),
        max_volume_counts=max_counts or {"hdd": 10},
    )


def _locs(nodes):
    return [n.url for n in nodes]


def _view(topo):
    """Everything a client or the shell can observe of a topology."""
    ec = {
        vid: (locs.collection, [_locs(l) for l in locs.locations])
        for vid, locs in sorted(topo.ec_shard_map.items())
    }
    layouts = sorted(
        (name, str(vl.rp), str(vl.ttl), vl.disk_type, sorted(vl.writables),
         sorted((vid, sorted(_locs(ll.nodes) if hasattr(ll, "nodes") else
                             _locs(ll)))
                for vid, ll in vl.vid2location.items()))
        for name, vl in topo.layouts()
    )
    lookups = {
        vid: _locs(topo.lookup_volume("", vid))
        for vid in range(1, topo.max_volume_id + 3)
    }
    return topo.to_info(), ec, layouts, lookups, topo.max_volume_id


# ------------------------------------------------- tests/test_topology.py


def _scenario_full_and_incremental(topo_mod, st, t):
    out = []
    topo = topo_mod.Topology()
    n = topo.get_or_create_node("dc1", "r1", "10.0.0.1", 8080)
    out.append(topo.sync_node(n, _hb(st, [_vol(st, 1), _vol(st, 2)])))
    out.append(_view(topo))
    out.append(topo.sync_node(n, _hb(st, [_vol(st, 2)])))
    topo.incremental_sync_node(n, [_vol(st, 5)], [])
    out.append(_view(topo))
    topo.incremental_sync_node(n, [], [_vol(st, 5)])
    out.append(_view(topo))
    return out


def _scenario_node_death(topo_mod, st, t):
    topo = topo_mod.Topology()
    n1 = topo.get_or_create_node("dc1", "r1", "10.0.0.1", 8080)
    n2 = topo.get_or_create_node("dc1", "r1", "10.0.0.2", 8080)
    topo.sync_node(n1, _hb(st, [_vol(st, 1)]))
    topo.sync_node(n2, _hb(st, [_vol(st, 1)]))
    dead = topo.unregister_node(n1)
    return dead, _view(topo), topo.find_node("10.0.0.1:8080") is None


def _scenario_ec_registration(topo_mod, st, t):
    topo = topo_mod.Topology()
    n1 = topo.get_or_create_node("dc1", "r1", "10.0.0.1", 8080)
    n2 = topo.get_or_create_node("dc1", "r2", "10.0.0.2", 8080)
    bits1 = sum(1 << i for i in range(7))
    bits2 = sum(1 << i for i in range(7, 14))
    out = [topo.sync_node(n1, _hb(st, ec=[st.EcShardMessage(9, "", bits1, "hdd")])),
           topo.sync_node(n2, _hb(st, ec=[st.EcShardMessage(9, "", bits2, "hdd")])),
           _view(topo)]
    topo.incremental_sync_node(
        n1, [], [], [], [st.EcShardMessage(9, "", bits1, "hdd")])
    out.append(_view(topo))
    return out


def _scenario_pick_for_write(topo_mod, st, t):
    out = []
    topo = topo_mod.Topology(
        volume_size_limit=10_000, sequencer=topo_mod.MemorySequencer(start=100))
    n = topo.get_or_create_node("dc1", "r1", "10.0.0.1", 8080)
    topo.sync_node(n, _hb(st, [
        _vol(st, 1), _vol(st, 2), _vol(st, 3), _vol(st, 4, read_only=True),
        _vol(st, 5, size=20_000), _vol(st, 6, rp="001"),
    ]))
    for count in (1, 3, 1, 2, 1, 1, 5, 1):
        fid, c, nodes = topo.pick_for_write(count, topo_mod.VolumeGrowOption())
        vid, nid, _ = t.parse_fid(fid)  # the cookie is random by design
        out.append((vid, nid, c, _locs(nodes)))
    opt = topo_mod.VolumeGrowOption(
        replica_placement=t.ReplicaPlacement.parse("001"))
    with pytest.raises(LookupError):
        topo.pick_for_write(1, opt)
    return out


def _fabric(topo_mod, st):
    topo = topo_mod.Topology()
    for dc, racks in {
        "dc1": {"r1": [("s1", 1, 4), ("s2", 1, 4)], "r2": [("s3", 1, 4)]},
        "dc2": {"r1": [("s4", 1, 4)]},
        "dc3": {"r1": [("s5", 1, 4)]},
    }.items():
        for rack, nodes in racks.items():
            for ip, port, maxc in nodes:
                n = topo.get_or_create_node(dc, rack, ip, port)
                topo.sync_node(n, _hb(st, max_counts={"hdd": maxc}))
    return topo


def _scenario_growth(topo_mod, st, t):
    out = []
    for rp in ("000", "001", "010", "100", "200", "011", "110", "111"):
        topo = _fabric(topo_mod, st)
        g = topo_mod.VolumeGrowth(rng=random.Random(42))
        opt = topo_mod.VolumeGrowOption(
            replica_placement=t.ReplicaPlacement.parse(rp))
        try:
            out.append((rp, _locs(g.find_empty_slots(topo.data_centers, opt))))
        except topo_mod.NoFreeSpace as e:
            out.append((rp, "NoFreeSpace", str(e)))
        out.append(topo_mod.target_count_per_request(opt.replica_placement))
    topo = _fabric(topo_mod, st)
    topo.growth = topo_mod.VolumeGrowth(rng=random.Random(7))
    allocated = []
    opt = topo_mod.VolumeGrowOption(
        replica_placement=t.ReplicaPlacement.parse("001"))
    vids = topo.grow_volumes(
        opt, 3, lambda n, vid, o: allocated.append((n.url, vid)))
    out.append((vids, allocated))
    return out


SCENARIOS = {
    "full_and_incremental_sync": _scenario_full_and_incremental,
    "node_death_unregisters_everything": _scenario_node_death,
    "ec_shard_registration": _scenario_ec_registration,
    "pick_for_write": _scenario_pick_for_write,
    "volume_growth": _scenario_growth,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(name):
    got = {}
    for pkg, (topo_mod, st, t) in PKGS.items():
        random.seed(1234)  # the layouts' write cursors start from here
        got[pkg] = SCENARIOS[name](topo_mod, st, t)
    assert got["port"] == got["ref"]


# ------------------------------------------------- random heartbeat streams


def _random_stream(seed: int):
    """A seeded list of heartbeat events in package-neutral form."""
    rng = np.random.default_rng(seed)
    nodes = [(f"dc{rng.integers(1, 3)}", f"r{rng.integers(1, 3)}",
              f"10.0.{seed}.{i}", 8080 + i, int(rng.integers(2, 12)))
             for i in range(int(rng.integers(3, 7)))]
    rps = ["000", "001", "010", "100"]
    cols = ["", "pics", "ec9"]
    events = []
    next_vid = 1
    held: dict[int, set] = {i: set() for i in range(len(nodes))}
    for step in range(40):
        i = int(rng.integers(len(nodes)))
        kind = rng.choice(["full", "delta", "ec_full", "ec_delta", "death"],
                          p=[0.3, 0.3, 0.15, 0.2, 0.05])
        if kind == "full":
            vols = []
            for _ in range(int(rng.integers(0, 5))):
                vid = int(rng.integers(1, next_vid + 3))
                next_vid = max(next_vid, vid + 1)
                vols.append(dict(vid=vid, size=int(rng.integers(0, 5000)),
                                 collection=str(rng.choice(cols)),
                                 rp=str(rng.choice(rps)),
                                 read_only=bool(rng.random() < 0.2)))
            events.append(("full", i, vols, nodes[i][4]))
        elif kind == "delta":
            vid = int(rng.integers(1, next_vid + 2))
            next_vid = max(next_vid, vid + 1)
            v = dict(vid=vid, size=int(rng.integers(0, 5000)),
                     collection=str(rng.choice(cols)), rp=str(rng.choice(rps)),
                     read_only=False)
            events.append(("delta", i, v, bool(rng.random() < 0.35)))
        elif kind == "ec_full":
            ec = []
            for _ in range(int(rng.integers(0, 3))):
                ec.append((int(rng.integers(100, 104)), str(rng.choice(cols)),
                           int(rng.integers(1, 1 << 14))))
            events.append(("ec_full", i, ec, nodes[i][4]))
        elif kind == "ec_delta":
            events.append(("ec_delta", i, int(rng.integers(100, 104)),
                           int(rng.integers(1, 1 << 14)),
                           bool(rng.random() < 0.4)))
        else:
            events.append(("death", i))
    return nodes, events


def _replay(topo_mod, st, nodes, events):
    topo = topo_mod.Topology(volume_size_limit=4000)
    live: dict[int, object] = {}
    views = []

    def node(i):
        if i not in live:
            dc, rack, ip, port, _ = nodes[i]
            live[i] = topo.get_or_create_node(dc, rack, ip, port, "", port + 1)
        return live[i]

    for ev in events:
        kind, i = ev[0], ev[1]
        if kind == "full":
            r = topo.sync_node(node(i), _hb(
                st, [_vol(st, v["vid"], v["size"], v["collection"], v["rp"],
                          v["read_only"]) for v in ev[2]],
                max_counts={"hdd": ev[3]}))
        elif kind == "delta":
            v = _vol(st, ev[2]["vid"], ev[2]["size"], ev[2]["collection"],
                     ev[2]["rp"])
            r = topo.incremental_sync_node(
                node(i), [] if ev[3] else [v], [v] if ev[3] else [])
        elif kind == "ec_full":
            r = topo.sync_node(node(i), _hb(
                st, ec=[st.EcShardMessage(vid, col, bits, "hdd")
                        for vid, col, bits in ev[2]],
                max_counts={"hdd": ev[3]}))
        elif kind == "ec_delta":
            m = st.EcShardMessage(ev[2], "", ev[3], "hdd")
            r = topo.incremental_sync_node(
                node(i), [], [], [] if ev[4] else [m], [m] if ev[4] else [])
        else:
            r = topo.unregister_node(live.pop(i)) if i in live else None
        views.append((r, _view(topo)))
    return views


@pytest.mark.parametrize("seed", range(6))
def test_random_heartbeat_stream_matches_the_reference(seed):
    nodes, events = _random_stream(seed)
    got = {}
    for pkg, (topo_mod, st, _) in PKGS.items():
        random.seed(seed)
        got[pkg] = _replay(topo_mod, st, nodes, events)
    assert len(got["port"]) == len(events)
    for step, (p, r) in enumerate(zip(got["port"], got["ref"])):
        assert p == r, f"seed {seed}: diverged at event {step}: {events[step]}"
