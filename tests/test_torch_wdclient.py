"""The client plane of the port: wdclient/ (VidMap, MasterClient) and
master.follower (server/master_follower.py), against the JAX package's.

- VidMap: the same seeded operations on both packages' maps give the same
  lookups (same-data-center first; the order within a tier is shuffled
  in both, so each tier is compared as a set).
- MasterClient: on three masters of each package, a client whose list
  starts with followers follows the leader hint, then applies the
  KeepConnected deltas of a growth and a volume delete; its map is
  compared with the other package's client after each step.
- master.follower: its /dir/lookup and LookupVolume equal the leader's,
  before and after the leader's kill; /cluster/status names the leader
  it follows; Assign and Statistics reach the leader.
"""
import asyncio
import json
import random

from seaweedfs_tpu.pb import Stub as RefStub
from seaweedfs_tpu.pb import channel as ref_channel
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vpb
from seaweedfs_tpu.wdclient import Location as RefLocation
from seaweedfs_tpu.wdclient import MasterClient as RefMasterClient
from seaweedfs_tpu.wdclient import VidMap as RefVidMap
from seaweedfs_tpu_torch.pb import Stub, channel, master_pb2, volume_server_pb2
from seaweedfs_tpu_torch.server.http import fetch
from seaweedfs_tpu_torch.server.master_follower import MasterFollowerServer
from seaweedfs_tpu_torch.wdclient import Location, MasterClient, VidMap

SEED = 1808
WAIT_S = 30.0


def _ha():
    from test_torch_master_ha import Group, get_json, wait_for

    return Group, get_json, wait_for


# ------------------------------------------------------------------- VidMap


def _tiers(vm, vid):
    """lookup(vid) as (same-DC urls, other urls), each a set."""
    locs = vm.lookup(vid)
    mine = {l.url for l in locs if l.data_center == vm.data_center}
    rest = [l.url for l in locs if l.data_center != vm.data_center]
    # same-DC locations come first
    assert [l.url for l in locs][:len(mine)] == [
        l.url for l in locs if l.data_center == vm.data_center]
    return sorted(mine), sorted(rest)


def test_vid_map_lookups_match_the_reference():
    rng = random.Random(SEED)
    urls = [f"10.0.0.{i}:8080" for i in range(8)]
    dcs = ["dc1", "dc2"]
    maps = {"port": VidMap("dc1"), "ref": RefVidMap("dc1")}
    locs = {"port": Location, "ref": RefLocation}
    seen = {"port": [], "ref": []}
    for step in range(400):
        op = rng.random()
        vid = rng.randrange(1, 20)
        url = rng.choice(urls)
        dc = dcs[urls.index(url) % 2]
        ec = rng.random() < 0.3
        for kind, vm in maps.items():
            if op < 0.6:
                vm.add_location(vid, locs[kind](url, url, 0, dc), is_ec=ec)
            elif op < 0.9:
                vm.delete_location(vid, url)
            else:
                vm.delete_server(url)
        if step % 20 == 19:
            for kind, vm in maps.items():
                seen[kind].append((
                    len(vm),
                    [_tiers(vm, v) for v in range(1, 20)],
                    sorted(vm.lookup_file_id("3,01637037d6")),
                ))
    assert seen["port"] == seen["ref"]
    assert any(n for n, _, _ in seen["ref"])
    loc = Location("10.0.0.1:8080", grpc_port=0)
    assert loc.grpc_address == RefLocation("10.0.0.1:8080").grpc_address


# ------------------------------------------------------------- MasterClient


async def _client_scenario(kind, tmp_path):
    Group, get_json, wait_for = _ha()
    g = Group(kind, tmp_path)
    await g.start()
    mc = None
    try:
        await g.leader()
        vs = await g.add_volume_server(f"{kind}-v")
        leader = await g.leader(lambda m: g.registered(m) == {vs.url},
                                "the volume server at the leader")
        followers = [m for m in g.masters if m is not leader]
        cls = MasterClient if kind == "port" else RefMasterClient
        mc = cls([f.advertise_url for f in followers] + [leader.advertise_url],
                 client_type="filer", client_address="127.0.0.1:18889")
        await mc.start()
        await wait_for(lambda: mc.current_master == leader.advertise_url,
                       "the client to follow the leader hint")
        await wait_for(lambda: mc._connected.is_set(),
                       "the client subscribed at the leader")
        await wait_for(lambda: ("filer", "127.0.0.1:18889")
                       in leader.cluster_nodes, "the client registered")
        names = {vs.url: "vs0"}

        def snapshot():
            return {vid: sorted(names[l.url] for l in mc.vid_map.lookup(vid))
                    for vid in range(1, 12) if mc.vid_map.lookup(vid)}

        seen = {"empty": snapshot()}
        status, _, grown = await get_json(leader.url, "/vol/grow?count=2")
        assert status == 200, grown
        await wait_for(lambda: all(mc.vid_map.lookup(v)
                                   for v in grown["vids"]),
                       "the growth's delta")
        seen["grown"] = (grown["vids"], snapshot())
        stub_cls, chan, vpb = ((Stub, channel, volume_server_pb2)
                               if kind == "port"
                               else (RefStub, ref_channel, ref_vpb))
        stub = stub_cls(chan(vs.grpc_url), vpb, "VolumeServer")
        gone = grown["vids"][0]
        await stub.VolumeDelete(vpb.VolumeDeleteRequest(volume_id=gone))
        await wait_for(lambda: not mc.vid_map.lookup(gone),
                       "the delete's delta")
        seen["deleted"] = snapshot()
        seen["lookup_or_fetch"] = sorted(
            names[l.url] for l in await mc.lookup_or_fetch(grown["vids"][1]))
        seen["fetch_missing"] = await mc.lookup_or_fetch(999)
        return seen
    finally:
        if mc is not None:
            await mc.stop()
        await g.stop()


def test_master_client_follows_the_hint_and_applies_deltas(tmp_path):
    ref = asyncio.run(_client_scenario("ref", tmp_path))
    port = asyncio.run(_client_scenario("port", tmp_path))
    assert ref["grown"][1] == {v: ["vs0"] for v in ref["grown"][0]}
    assert ref["grown"][0][0] not in ref["deleted"]
    assert port == ref


# ----------------------------------------------------------- master.follower


async def _lookups(url, grpc_port, vids):
    """/dir/lookup and LookupVolume of each vid at one master or follower:
    -> {vid: (status, locations, rpc locations)}."""
    stub = Stub(channel(f"127.0.0.1:{grpc_port}"), master_pb2, "Seaweed")
    resp = await stub.LookupVolume(master_pb2.LookupVolumeRequest(
        volume_or_file_ids=[str(v) for v in vids]))
    rpc = {int(e.volume_or_file_id): sorted(
        (l.url, l.public_url) for l in e.locations)
        for e in resp.volume_id_locations}
    out = {}
    for v in vids:
        status, _, body = await fetch(url, "GET", f"/dir/lookup?volumeId={v}",
                                      timeout=WAIT_S)
        doc = json.loads(body)
        out[v] = (status, doc.get("volumeOrFileId"),
                  sorted((l["url"], l["publicUrl"])
                         for l in doc.get("locations", [])), rpc[v])
    return out


def test_master_follower_answers_as_the_leader_across_a_failover(tmp_path):
    Group, get_json, wait_for = _ha()

    async def go():
        g = Group("port", tmp_path)
        await g.start()
        f = None
        try:
            await g.leader()
            vs = await g.add_volume_server("v")
            leader = await g.leader(lambda m: g.registered(m) == {vs.url},
                                    "the volume server at the leader")
            status, _, grown = await get_json(leader.url, "/vol/grow?count=3")
            assert status == 200, grown
            vids = grown["vids"]
            f = MasterFollowerServer(list(g.urls), port=0, grpc_port=0)
            await f.start()
            await wait_for(lambda: all(f.master_client.vid_map.lookup(v)
                                       for v in vids),
                           "the follower's map")
            want = await _lookups(leader.url, leader.grpc_port, vids)
            assert all(w[0] == 200 and w[2] == [(vs.url, vs.url)]
                       for w in want.values()), want
            assert await _lookups(f.url, f.grpc_port, vids) == want
            status, _, st = await get_json(f.url, "/cluster/status")
            assert st == {"IsLeader": False,
                          "Leader": leader.advertise_url,
                          "Peers": list(g.urls)}
            fstub = Stub(channel(f"127.0.0.1:{f.grpc_port}"), master_pb2,
                         "Seaweed")
            a = await fstub.Assign(master_pb2.AssignRequest(count=1))
            assert a.fid and a.location.url == vs.url, a
            stats = await fstub.Statistics(master_pb2.StatisticsRequest())
            assert stats.total_size > 0

            await g.kill(leader)
            leader2 = await g.leader(lambda m: g.registered(m) == {vs.url},
                                     "the volume server at the new leader")

            async def switched():
                st = await get_json(f.url, "/cluster/status")
                return st[2]["Leader"] == leader2.advertise_url

            loop = asyncio.get_running_loop()
            deadline = loop.time() + WAIT_S
            while not await switched():
                assert loop.time() < deadline, "the follower's leader"
                await asyncio.sleep(0.1)
            await wait_for(lambda: all(f.master_client.vid_map.lookup(v)
                                       for v in vids),
                           "the follower's map from the new leader")
            want2 = await _lookups(leader2.url, leader2.grpc_port, vids)
            assert want2 == want
            assert await _lookups(f.url, f.grpc_port, vids) == want2
            status, _, miss = await get_json(f.url, "/dir/lookup?volumeId=999")
            assert status == 404
        finally:
            if f is not None:
                await f.stop()
            await g.stop()

    asyncio.run(go())
