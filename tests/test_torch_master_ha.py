"""Master HA in the port: three masters under raft (raft/node.py), the
follower paths (a 307 to the leader, proxied rpcs, the heartbeat's leader
hint), and the allocation ceilings the raft log replicates.

tests/test_master_ha.py's three scenarios on the port: failover with a
follower's 307 on /dir/assign and fid keys past the kill; the vid ceiling
across a growth and a failover; a restart from a snapshot.  Then an EC
volume on three port masters: encode, kill the leader, the new leader
lists 14 shards and queues no repair for a server not yet back, and its
repair plane heals a two-shard loss byte-equal to the reference's
`write_ec_files` of the same .dat.  Membership: `cluster.raft.add` of a
master started as a non-voter and `cluster.raft.remove` of a stopped one,
held against the reference's masters.  Three departures are pinned
against the reference's masters (ROADMAP §C): a master behind the
leader's compacted log catches up by InstallSnapshot (the reference's
master has no such rpc); a new leader queues no repair in its first
seconds (the reference's queues a rebuild of the shards on a server not
yet back); a leader deposed while alive hands its volume servers' and
clients' streams to the new leader (the reference's keeps them).

Every master gets explicit free RPC ports (the `host:port.grpc` form),
every wait polls with a budget of 30 s or more, no duration is asserted,
and every server is stopped in a `finally`.
"""
import asyncio
import hashlib
import io
import json
import logging
import os
import shutil
import socket

from seaweedfs_tpu.pb.rpc import close_all_channels as ref_close_all_channels
from seaweedfs_tpu.repair import RepairConfig as RefRepairConfig
from seaweedfs_tpu.server.master import MasterServer as RefMaster
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run
from seaweedfs_tpu.storage.ec.encoder import write_ec_files
from seaweedfs_tpu_torch.operation import upload_data
from seaweedfs_tpu_torch.pb import (
    Stub,
    channel,
    close_all_channels,
    volume_server_pb2,
)
from seaweedfs_tpu_torch.repair import RepairConfig
from seaweedfs_tpu_torch.server.http import fetch
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv
from seaweedfs_tpu_torch.shell import run_command as port_run

log = logging.getLogger("test_torch_master_ha")

WAIT_S = 30.0
ELECTION_TIMEOUT = (2.0, 4.0)
REPAIR_KW = dict(interval_seconds=0.25, backoff_base_seconds=0.2)

PKG = {
    "port": dict(master=MasterServer, volume=VolumeServer, env=CommandEnv,
                 run=port_run, repair=RepairConfig, backend="torch"),
    "ref": dict(master=RefMaster, volume=RefVolumeServer, env=RefEnv,
                run=ref_run, repair=RefRepairConfig, backend="numpy"),
}


def run(coro):
    return asyncio.run(coro)


def free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    return ports


async def wait_for(pred, what, timeout=WAIT_S):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


class Group:
    """n masters of one package under raft, each on explicit free ports
    with its own meta_dir, and the volume servers that follow them."""

    def __init__(self, kind, tmp_path, n=3, **master_kw):
        self.kind = kind
        self.pkg = PKG[kind]
        self.tmp_path = tmp_path
        ports = free_ports(2 * n)
        while any(g == p + 10000 for p, g in zip(ports[:n], ports[n:])):
            # a master whose RPC port is its HTTP port + 10000 advertises
            # the short form, which the -peers list does not spell
            ports = free_ports(2 * n)
        self.ports = list(zip(ports[:n], ports[n:]))
        self.urls = [f"127.0.0.1:{p}.{g}" for p, g in self.ports]
        self.master_kw = dict(pulse_seconds=1, volume_size_limit_mb=64,
                              **master_kw)
        self.masters: list = [None] * n
        self.volume_servers: list = []

    def make(self, i):
        p, g = self.ports[i]
        return self.pkg["master"](
            port=p, grpc_port=g, peers=list(self.urls),
            meta_dir=str(self.tmp_path / f"{self.kind}-m{i}"),
            **self.master_kw)

    async def start(self):
        self.masters = [self.make(i) for i in range(len(self.urls))]
        await asyncio.gather(*(m.start() for m in self.masters))
        for m in self.masters:
            self.steady(m)

    async def restart(self, i):
        self.masters[i] = self.make(i)
        await self.masters[i].start()
        return self.steady(self.masters[i])

    @staticmethod
    def steady(m):
        """Election timeouts of 2-4 s after the first election (both
        packages' default is 0.4-0.8 s): under a loaded test run a stalled
        event loop must not read as a dead leader (the reference's volume
        servers would stay on the deposed one)."""
        m.raft.election_timeout = ELECTION_TIMEOUT
        return m

    async def kill(self, m):
        """Stop one master (its listeners close: every stream to it
        breaks) and leave it out of `live`."""
        i = self.masters.index(m)
        self.masters[i] = None
        await m.stop()

    @property
    def live(self):
        return [m for m in self.masters if m is not None]

    async def leader(self, pred=lambda m: True, what="a single leader",
                     agreed=True):
        """The one leader, once `pred` holds for it (a leadership that
        moves meanwhile is followed) and, with `agreed`, every live master
        follows it in its term (a leader of an older term may still think
        it leads for a moment)."""
        def ok():
            leaders = [m for m in self.live if m.is_leader]
            if len(leaders) != 1 or not pred(leaders[0]):
                return False
            lead = leaders[0].raft
            return not agreed or all(
                m.raft.leader_id == lead.id and m.raft.term == lead.term
                for m in self.live)

        try:
            await wait_for(ok, f"{self.kind}: {what}")
        except AssertionError as e:
            views = [(m.url, m.is_leader, m.raft.term, m.raft.leader_id,
                      sorted(self.registered(m))) for m in self.live]
            raise AssertionError(f"{e}; masters {views}; servers' "
                                 f"masters {[vs.current_master for vs in self.volume_servers]}") from None
        return next(m for m in self.live if m.is_leader)

    async def add_volume_server(self, name):
        vs = self.pkg["volume"](
            masters=list(self.urls), directories=[str(self.tmp_path / name)],
            port=0, grpc_port=0, pulse_seconds=1, max_volume_counts=32,
            ec_backend=self.pkg["backend"])
        await vs.start()
        self.volume_servers.append(vs)
        return vs

    def registered(self, m):
        return {n.url for n in m.topo.data_nodes()}

    async def stop(self):
        for server in self.volume_servers + self.live:
            try:
                await server.stop()
            except Exception as e:  # noqa: BLE001 — teardown goes on
                log.debug("stopping %s: %s", server, e)
        # each package caches a channel per address, bound to this loop;
        # a later test's server may get the same port
        await ref_close_all_channels()
        await close_all_channels()


def fid_key(fid: str) -> int:
    return int(fid.split(",")[1][:-8], 16)


async def get_json(url, path):
    status, headers, body = await fetch(url, "GET", path, timeout=WAIT_S)
    return status, headers, (json.loads(body) if status == 200 else body)


# ------------------------------------------------------------------ scenarios


def test_failover_redirects_and_mints_past_the_kill(tmp_path):
    async def go():
        g = Group("port", tmp_path)
        await g.start()
        try:
            await g.leader()
            vs = await g.add_volume_server("v")
            leader = await g.leader(lambda m: g.registered(m) == {vs.url},
                                    "the volume server at the leader")
            followers = [m for m in g.live if m is not leader]
            # followers hold no topology of their own
            assert all(not f.topo.data_nodes() for f in followers)

            # an assign at a follower is a 307 to the leader's same path
            status, headers, _ = await fetch(
                followers[0].url, "GET", "/dir/assign?count=1")
            assert status == 307
            assert headers.get("Location") == (
                f"http://{leader.url}/dir/assign?count=1")
            status, _, a = await get_json(leader.url, "/dir/assign?count=1")
            assert status == 200 and "fid" in a, a
            data = b"ha payload " * 1000
            await upload_data(f"http://{a['url']}/{a['fid']}", data,
                              "f.bin", jwt=a.get("auth", ""))
            # the follower's rpcs proxy to the leader
            from seaweedfs_tpu_torch.pb import master_pb2

            stub = Stub(channel(f"127.0.0.1:{followers[0].grpc_port}"),
                        master_pb2, "Seaweed")
            vid1 = int(a["fid"].split(",")[0])
            resp = await stub.LookupVolume(master_pb2.LookupVolumeRequest(
                volume_or_file_ids=[str(vid1)]))
            assert [l.url for l in resp.volume_id_locations[0].locations] \
                == [vs.url]
            status, _, grown = await get_json(leader.url, "/vol/grow?count=1")
            assert status == 200, grown
            vids_before = set(grown["vids"]) | {vid1}

            # kill the leader: a new one takes over and the server re-homes
            await g.kill(leader)
            leader2 = await g.leader(lambda m: g.registered(m) == {vs.url},
                                     "the volume server at the new leader")
            status, _, look = await get_json(
                leader2.url, f"/dir/lookup?volumeId={vid1}")
            assert status == 200 and look["locations"][0]["url"] == vs.url
            status, _, body = await fetch(vs.url, "GET", f"/{a['fid']}")
            assert status == 200 and body == data

            # new assigns and growth never re-mint ids from before the kill
            status, _, a2 = await get_json(leader2.url,
                                           "/dir/assign?count=1")
            assert status == 200, a2
            assert fid_key(a2["fid"]) > fid_key(a["fid"])
            status, _, grown2 = await get_json(leader2.url,
                                               "/vol/grow?count=1")
            assert status == 200, grown2
            assert min(grown2["vids"]) > max(vids_before)
        finally:
            await g.stop()

    run(go())


def test_growth_replicates_vid_ceiling(tmp_path):
    async def go():
        g = Group("port", tmp_path)
        await g.start()
        try:
            await g.leader()
            vs = await g.add_volume_server("v")
            leader = await g.leader(lambda m: g.registered(m) == {vs.url},
                                    "the volume server at the leader")
            status, _, grown = await get_json(leader.url, "/vol/grow?count=2")
            assert status == 200 and grown["count"] == 2, grown
            max_vid = leader.topo.max_volume_id
            # every follower learned the ceiling through the raft log
            for m in g.live:
                await wait_for(lambda m=m: m.topo.max_volume_id >= max_vid,
                               "the vid ceiling replicated")
            for m in g.live:
                status, _, st = await get_json(m.url, "/cluster/status")
                assert st["MaxVolumeId"] == max_vid
        finally:
            await g.stop()

    run(go())


def test_master_snapshot_restart(tmp_path):
    """The state machine's snapshot (vid ceiling, sequence ceiling): after
    many commands a restart recovers from the snapshot and the tail, not
    a whole log replay."""

    async def go():
        port, gport = free_ports(2)
        url = f"127.0.0.1:{port}.{gport}"

        def make():
            return MasterServer(
                port=port, grpc_port=gport, peers=[url],
                meta_dir=str(tmp_path / "m"), pulse_seconds=1,
                volume_size_limit_mb=64, raft_snapshot_threshold=25,
            )

        m = make()
        await m.start()
        try:
            total = 120
            for i in range(total):
                await m.raft.propose({"op": "max_vid", "vid": i + 1})
            await m.raft.propose({"op": "seq", "ceiling": 77_000})
            assert m.topo.max_volume_id == total
            assert m.raft.snapshot_index > 0
            assert len(m.raft.log) - 1 <= 30
        finally:
            await m.stop()

        m2 = make()
        await m2.start()
        try:
            assert m2.topo.max_volume_id == total
            assert m2._seq_committed == 77_000
            assert m2.topo.sequencer.peek() >= 77_000
            assert m2.raft.snapshot_index > 0
            assert len(m2.raft.log) - 1 <= 35
            # and the restored ceiling keeps allocations monotonic
            await m2.raft.propose({"op": "max_vid", "vid": total + 1})
            assert m2.topo.max_volume_id == total + 1
        finally:
            await m2.stop()

    run(go())


def test_leader_settling_starts_at_each_election():
    """The settle window of ROADMAP §C is keyed on the raft node's own
    election stamp, so a re-election between two repair cycles settles
    again; a master without peers never settles."""
    from seaweedfs_tpu_torch.raft import RaftNode

    async def go():
        m = MasterServer(port=0, pulse_seconds=1)
        assert not m.leader_settling()
        m.raft = RaftNode("127.0.0.1:1.2", ["127.0.0.1:3.4", "127.0.0.1:5.6"],
                          apply_fn=m._apply_raft)
        assert not m.leader_settling()  # a follower
        m.raft.term = 1
        m.raft._become_leader()
        assert m.leader_settling()
        m.raft.leader_since -= 8.0  # 2 x pulse + 2 x 3 masters x pulse
        assert not m.leader_settling()
        m.raft._become_follower(2)
        assert not m.leader_settling()
        m.raft.term = 3
        m.raft._become_leader()
        assert m.leader_settling()
        m.raft = RaftNode("127.0.0.1:1.2", [], apply_fn=m._apply_raft)
        m.raft.term = 1
        m.raft._become_leader()
        assert not m.leader_settling()

    run(go())


async def _behind_a_compacted_log(kind, tmp_path):
    """Three masters with raft_snapshot_threshold=4: one follower stopped,
    six volumes grown (six max_vid proposals commit and the leader
    compacts), the follower restarted on its meta_dir.  -> whether it
    caught up within the watch, and what it and the leader answer."""
    g = Group(kind, tmp_path, raft_snapshot_threshold=4)
    await g.start()
    try:
        await g.leader()
        vs = await g.add_volume_server(f"{kind}-v")
        leader = await g.leader(lambda m: g.registered(m) == {vs.url},
                                "the volume server at the leader")
        i = next(i for i, m in enumerate(g.masters) if m is not leader)
        await g.kill(g.masters[i])
        for _ in range(6):
            status, _, grown = await get_json(leader.url, "/vol/grow?count=1")
            assert status == 200, grown
        compacted_at = leader.raft.snapshot_index
        assert compacted_at > 0
        back = await g.restart(i)
        loop = asyncio.get_running_loop()
        # the port's catches up well inside the budget; the reference's
        # is watched for 10 s
        deadline = loop.time() + (WAIT_S if kind == "port" else 10.0)
        while loop.time() < deadline and back.topo.max_volume_id < 6:
            await asyncio.sleep(0.1)
        # the reference's restarted master never follows: it campaigns
        now_leader = await g.leader(agreed=False)
        peer = next((p for p in now_leader.raft.peers
                     if now_leader.raft.same_node(p, g.urls[i])), None)
        _, _, st = await get_json(back.url, "/cluster/status")
        return {"max_vid": st["MaxVolumeId"],
                "terms": (now_leader.raft.term, back.raft.term),
                "restarted_snapshot_index": back.raft.snapshot_index,
                "match_index": (now_leader.raft.match_index.get(peer)
                                if peer else None),
                "compacted_at": compacted_at}
    finally:
        await g.stop()


def test_a_master_behind_a_compacted_log_catches_up(tmp_path):
    """A departure (ROADMAP §C): the reference's master registers the raft
    service with itself as the servicer and has no InstallSnapshot, so a
    master behind the leader's compacted log never catches up; the port's
    hands InstallSnapshot to its RaftNode."""
    port = run(_behind_a_compacted_log("port", tmp_path))
    assert port["max_vid"] == 6
    assert port["restarted_snapshot_index"] >= port["compacted_at"]
    assert port["match_index"] >= port["compacted_at"]
    ref = run(_behind_a_compacted_log("ref", tmp_path))
    assert ref["max_vid"] == 0
    assert ref["restarted_snapshot_index"] == 0
    assert not ref["match_index"] or ref["match_index"] < ref["compacted_at"]


async def _deposed(kind, tmp_path):
    """A leader deposed while it lives on: made a non-voter and stepped
    down a term, so another master wins.  -> where its volume server's
    heartbeats and a subscribed client's KeepConnected stream end up."""
    from seaweedfs_tpu.wdclient import MasterClient as RefMasterClient
    from seaweedfs_tpu_torch.wdclient import MasterClient

    g = Group(kind, tmp_path)
    await g.start()
    mc = None
    try:
        await g.leader()
        vs = await g.add_volume_server(f"{kind}-v")
        old = await g.leader(lambda m: g.registered(m) == {vs.url},
                             "the volume server at the leader")
        # a volume, so that the server's registration at the next leader
        # is a location change pushed to the client with that leader's name
        status, _, grown = await get_json(old.url, "/vol/grow?count=1")
        assert status == 200, grown
        mc = (MasterClient if kind == "port" else RefMasterClient)(
            [old.advertise_url] + [u for u in g.urls
                                   if u != old.advertise_url],
            client_type="filer", client_address="127.0.0.1:18890")
        await mc.start()
        await wait_for(lambda: mc._connected.is_set(), "the client")
        old.raft.voter = False
        old.raft._become_follower(old.raft.term + 1)
        # a voter again once it follows the new leader (else its own
        # timer, run down meanwhile, would start a campaign at once)
        new = await g.leader(lambda m: m is not old, "another leader")
        old.raft.voter = True

        def followed():
            return (g.registered(new) == {vs.url}
                    and mc.current_master == new.advertise_url)

        # the port's follow well inside the budget; the reference's are
        # watched for 5 s (a heartbeat a second)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + (WAIT_S if kind == "port" else 5.0)
        while loop.time() < deadline and not followed():
            await asyncio.sleep(0.1)
        return {"server_at_new": g.registered(new) == {vs.url},
                "server_at_old": g.registered(old) == {vs.url},
                "client_on_new": mc.current_master == new.advertise_url}
    finally:
        if mc is not None:
            await mc.stop()
        await g.stop()


def test_a_deposed_leader_hands_its_streams_to_the_new_one(tmp_path):
    """A departure (ROADMAP §C): the reference's master checks leadership
    only when a heartbeat or KeepConnected stream opens, so a leader
    deposed while alive keeps its volume servers and clients, and the new
    leader never hears of them; the port's ends both streams with the new
    leader's address (the Go master's check on every heartbeat)."""
    port = run(_deposed("port", tmp_path))
    assert port == {"server_at_new": True, "server_at_old": False,
                    "client_on_new": True}
    ref = run(_deposed("ref", tmp_path))
    assert ref == {"server_at_new": False, "server_at_old": True,
                   "client_on_new": False}


# ------------------------------------------------------------ membership


def _committed_conf(raft):
    """The members of the last raft_conf entry a node has committed."""
    conf = None
    for _, index, command in raft.log:
        if command and index <= raft.commit_index:
            cmd = json.loads(command)
            if cmd.get("op") == "raft_conf":
                conf = cmd["members"]
    return conf


async def _membership(kind, tmp_path):
    """Three masters of one package, and a fourth started as a non-voter
    with all four addresses in its peers (`raft_join`: a master started to
    be added).  `cluster.raft.add` of the fourth at a follower (proxied to
    the leader); then another follower stopped and `cluster.raft.remove`d,
    as an operator retires a dead master.  -> after each step, every live
    master's RaftListClusterServers, voter flag and committed raft_conf,
    and the shell's output, each address masked by its master's role."""
    from seaweedfs_tpu.pb import Stub as RefStub
    from seaweedfs_tpu.pb import channel as ref_channel
    from seaweedfs_tpu.pb import master_pb2 as ref_mpb
    from seaweedfs_tpu_torch.pb import master_pb2

    g = Group(kind, tmp_path, n=4)
    voters = g.urls[:3]

    def make(i):
        p, gp = g.ports[i]
        return g.pkg["master"](
            port=p, grpc_port=gp, peers=list(g.urls if i == 3 else voters),
            meta_dir=str(tmp_path / f"{kind}-m{i}"), raft_join=i == 3,
            **g.master_kw)

    g.make = make
    await g.start()
    try:
        joiner = g.masters[3]
        roles = {joiner.advertise_url: "joiner"}

        def mask(text):
            for url, role in roles.items():
                text = text.replace(url, role)
            return text

        async def agreed(members, what):
            """One leader among `members`, each of them a voter listing
            the others and following it in its term, with that list
            committed."""
            def ok():
                leaders = [m for m in members if m.is_leader]
                if len(leaders) != 1:
                    return False
                lead = leaders[0].raft
                return all(
                    m.raft.voter and m.raft.leader_id == lead.id
                    and m.raft.term == lead.term
                    and len(m.raft.peers) == len(members) - 1
                    and (len(members) == 3
                         or len(_committed_conf(m.raft) or ()) == len(members))
                    for m in members)

            await wait_for(ok, f"{kind}: {what}")
            return next(m for m in members if m.is_leader)

        async def views():
            out = []
            for m in g.live:
                if kind == "port":
                    stub = Stub(channel(m.grpc_url), master_pb2, "Seaweed")
                    req = master_pb2.RaftListClusterServersRequest()
                else:
                    stub = RefStub(ref_channel(m.grpc_url), ref_mpb,
                                   "Seaweed")
                    req = ref_mpb.RaftListClusterServersRequest()
                resp = await stub.RaftListClusterServers(req)
                conf = _committed_conf(m.raft)
                out.append({
                    "at": mask(m.advertise_url),
                    "servers": sorted((mask(s.id), s.is_leader)
                                      for s in resp.cluster_servers),
                    "term_is_the_leaders": resp.term == leader.raft.term,
                    "voter": m.raft.voter,
                    "conf": None if conf is None else sorted(
                        mask(c) for c in conf),
                })
            return sorted(out, key=lambda v: v["at"])

        leader = await agreed(g.masters[:3], "a leader of the three")
        members = [m for m in g.masters[:3] if m is not leader]
        roles[leader.advertise_url] = "leader"
        roles[members[0].advertise_url] = "member"
        roles[members[1].advertise_url] = "retired"
        result = {"before": await views()}

        env = g.pkg["env"]([members[0].advertise_url], out=io.StringIO())
        await g.pkg["run"](env, "lock")
        mark = len(env.out.getvalue())
        await g.pkg["run"](env, f"cluster.raft.add -id {joiner.raft.id}")
        await agreed(g.masters, "the joiner a voter of four")
        result["added"] = await views()

        await g.kill(members[1])
        await g.pkg["run"](env, f"cluster.raft.remove -id {members[1].advertise_url}")
        await agreed(g.live, "three voters without the retired master")
        result["removed"] = await views()
        await g.pkg["run"](env, "cluster.raft.ps")
        await g.pkg["run"](env, "unlock")
        result["shell"] = sorted(
            "term: <term>" if line.startswith("term: ") else mask(line)
            for line in env.out.getvalue()[mark:].splitlines())
        return result
    finally:
        await g.stop()


def test_raft_membership_matches_the_reference(tmp_path):
    """cluster.raft.add of a master started as a non-voter, then
    cluster.raft.remove of a stopped follower: RaftListClusterServers at
    every master, each master's voter flag and committed raft_conf, and
    the shell's output equal the reference's."""
    port = run(_membership("port", tmp_path))
    ref = run(_membership("ref", tmp_path))
    assert port == ref
    members = ["joiner", "leader", "member"]
    assert [v["servers"] for v in port["removed"]] == [
        sorted((r, r == "leader") for r in members)] * 3
    assert [v["conf"] for v in port["removed"]] == [members] * 3
    assert [v["at"] for v in port["removed"]] == members
    assert port["before"][0] == {
        "at": "joiner", "conf": None, "term_is_the_leaders": False,
        "voter": False,
        "servers": sorted((r, False) for r in
                          ["joiner", "leader", "member", "retired"])}
    assert "added raft server joiner" in port["shell"]
    assert "removed raft server retired" in port["shell"]


# ------------------------------------------------------------------ EC


def _ec_blobs():
    from test_torch_cluster import VID, _blobs

    return VID, _blobs()


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _shards_equal_write_ec_files(oracle: str, vid: int, dirs: list) -> bool:
    """Every shard once across `dirs`, each equal to the reference's
    `write_ec_files` of the .dat in `oracle`."""
    write_ec_files(os.path.join(oracle, str(vid)), backend="numpy")
    got: dict = {}
    for d in dirs:
        for sid in range(14):
            path = os.path.join(d, f"{vid}.ec{sid:02d}")
            if os.path.exists(path):
                got.setdefault(sid, []).append(_sha256(path))
    return got == {sid: [_sha256(os.path.join(oracle, f"{vid}.ec{sid:02d}"))]
                   for sid in range(14)}


async def _ec_failover(kind, tmp_path, lose_after=False):
    """Three masters and three volume servers of one package.  Volume 1
    is written on server 0 and `ec.encode`d through a follower (its rpcs
    proxy to the leader).  The server holding the fewest shards is kept
    dialing only the leader; the leader is killed; once the new leader
    lists the other two servers, the holdout stays away until the new
    leader queues a repair or 2 s pass, then comes back.  -> what the new
    leader queued meanwhile and, with `lose_after`, the heal of a
    two-shard loss on a holder (the plane's own doing)."""
    vid, blobs = _ec_blobs()
    pkg = PKG[kind]
    g = Group(kind, tmp_path, ec_repair=pkg["repair"](**REPAIR_KW))
    await g.start()
    out = {}
    try:
        await g.leader()
        vss = [await g.add_volume_server(f"{kind}-vs{i}") for i in range(3)]
        leader = await g.leader(lambda m: len(g.registered(m)) == 3,
                                "three servers at the leader")
        vs0 = vss[0]
        vstub = Stub(channel(vs0.grpc_url), volume_server_pb2,
                     "VolumeServer")
        if kind == "ref":
            from seaweedfs_tpu.pb import Stub as RefStub
            from seaweedfs_tpu.pb import channel as ref_channel
            from seaweedfs_tpu.pb import volume_server_pb2 as ref_vpb

            vstub = RefStub(ref_channel(vs0.grpc_url), ref_vpb,
                            "VolumeServer")
            vpb = ref_vpb
        else:
            vpb = volume_server_pb2
        await vstub.AllocateVolume(vpb.AllocateVolumeRequest(
            volume_id=vid, replication="000"))
        for fid, data, name in blobs:
            await upload_data(f"http://{vs0.url}/{fid}", data, name)
        await wait_for(lambda: leader.topo.lookup_volume("", vid),
                       "the volume at the leader")
        dat = os.path.join(str(tmp_path / f"{kind}-vs0"), f"{vid}.dat")
        oracle = str(tmp_path / f"{kind}-oracle")
        os.makedirs(oracle)
        follower = next(m for m in g.live if m is not leader)
        env = pkg["env"]([follower.advertise_url, *g.urls],
                         out=io.StringIO())
        # the status reads /cluster/health.json: a 307 from the follower
        for line in ("volume.repair.pause", "volume.repair.status -json",
                     "lock", f"ec.encode -volumeId {vid}", "unlock"):
            if line.startswith("ec.encode"):
                # the .dat as the encode reads it (marked read-only first)
                shutil.copy(dat, os.path.join(oracle, f"{vid}.dat"))
            mark = len(env.out.getvalue())
            await pkg["run"](env, line)
            if line.startswith("volume.repair.status"):
                status = json.loads(env.out.getvalue()[mark:])
                assert status["paused"] is True, status

        cur = {"leader": leader}

        def listed():
            locs = cur["leader"].topo.lookup_ec_shards(vid)
            return {} if locs is None else {
                sid: sorted(n.url for n in nodes)
                for sid, nodes in enumerate(locs.locations) if nodes}

        def where_stored():
            out = {}
            for vs in vss:
                ev = vs.store.find_ec_volume(vid)
                for sid in (ev.shards if ev is not None else ()):
                    out.setdefault(sid, []).append(vs.url)
            return out

        await wait_for(lambda: len(listed()) == 14 and listed()
                       == where_stored(), "14 spread shards at the leader")
        placement = listed()
        holdout = min(vss, key=lambda vs: len(vs.store.find_ec_volume(vid)
                                               .shards))
        out["holdout_shards"] = sorted(holdout.store.find_ec_volume(vid)
                                       .shards)
        holdout.masters = [leader.advertise_url]
        await g.kill(leader)
        others = {vs.url for vs in vss if vs is not holdout}
        leader2 = await g.leader(lambda m: g.registered(m) == others,
                                 "the other two servers at the new leader")
        cur["leader"] = leader2
        loop = asyncio.get_running_loop()
        until = loop.time() + 2.0
        while (loop.time() < until
               and not leader2.repair.totals["queued"]):
            await asyncio.sleep(0.05)
        out["queued_while_away"] = leader2.repair.totals["queued"]
        holdout.masters = list(g.urls)
        await wait_for(lambda: len(g.registered(leader2)) == 3,
                       "the holdout at the new leader")
        if not lose_after:
            return out
        await wait_for(lambda: listed() == placement,
                       "the new leader lists 14 shards where they are")
        out["queued_at_14"] = leader2.repair.totals["queued"]
        out["paused"] = leader2.repair.paused

        # the loss: two shards unmounted and deleted on one holder; the
        # new leader's plane heals them with no shell verb
        loser = max(vss, key=lambda vs: len(vs.store.find_ec_volume(vid)
                                            .shards))
        lost = sorted(loser.store.find_ec_volume(vid).shards)[:2]
        lstub = Stub(channel(loser.grpc_url), volume_server_pb2,
                     "VolumeServer")
        await lstub.VolumeEcShardsUnmount(
            volume_server_pb2.VolumeEcShardsUnmountRequest(
                volume_id=vid, shard_ids=lost))
        await lstub.VolumeEcShardsDelete(
            volume_server_pb2.VolumeEcShardsDeleteRequest(
                volume_id=vid, collection="", shard_ids=lost))
        sched = leader2.repair
        # the census of the holdout's absence may have closed an episode
        converged = sched.last_convergence_unix
        await wait_for(lambda: sched.totals["completed"] >= 1
                       and not sched._inflight
                       and len(listed()) == 14
                       and listed() == where_stored()
                       and sched.last_convergence_unix != converged,
                       "the new leader's repair", timeout=60.0)
        out["totals"] = dict(sched.totals)
        out["shards_equal_reference"] = await asyncio.to_thread(
            _shards_equal_write_ec_files, oracle, vid,
            [vs.store.locations[0].directory for vs in vss])
        return out
    finally:
        await g.stop()


def test_ec_volume_survives_a_leader_kill(tmp_path):
    """The port's three masters keep an EC volume through the leader's
    kill: the new leader lists all 14 shards, has queued no repair for
    the server that came back last, starts with its repair plane running
    (PauseRepair is one master's), and heals a two-shard loss to the
    reference's encode of the same .dat."""
    port = run(_ec_failover("port", tmp_path, lose_after=True))
    assert len(port["holdout_shards"]) == 4
    assert port["queued_while_away"] == 0
    assert port["queued_at_14"] == 0
    assert port["paused"] is False
    assert port["totals"]["completed"] == 1 and port["totals"]["failed"] == 0
    assert port["shards_equal_reference"]


def test_new_leader_waits_for_servers_to_return(tmp_path):
    """A departure (ROADMAP §C): with the holdout's 4 shards away, the
    reference's new leader sees 10 of 14 and queues a rebuild of shards
    that exist; the port's queues nothing in its first seconds as leader."""
    ref = run(_ec_failover("ref", tmp_path))
    port = run(_ec_failover("port", tmp_path / "p"))
    assert ref["holdout_shards"] == port["holdout_shards"]
    assert len(ref["holdout_shards"]) == 4
    assert ref["queued_while_away"] >= 1
    assert port["queued_while_away"] == 0
