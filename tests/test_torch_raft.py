"""The port's raft (seaweedfs_tpu_torch/raft/node.py) against the JAX
package's.

tests/test_raft.py's four cases run on the port's RaftNode over the port's
RPC plane (pb/rpc.py): election with replication and failover, a restart
from durable state, snapshot compaction with a replayed tail, and a lagging
follower caught up by InstallSnapshot.  Then the durable state crosses
packages: a -mdir written by the reference's RaftNode loads into the
port's with the same term, vote, peers, voter flag, log entries and
snapshot, and one written by the port's loads the same way into the
reference's.  Every wait polls with a budget of 30 s or more and no
duration is asserted.
"""
import asyncio
import json
import os
import shutil

import pytest

from seaweedfs_tpu.raft import RaftNode as RefRaftNode
from seaweedfs_tpu_torch.pb import RpcServer, raft_pb2
from seaweedfs_tpu_torch.raft import LEADER, NotLeader, RaftNode

WAIT_S = 30.0


def run(coro):
    return asyncio.run(coro)


async def wait_for(pred, what: str, timeout: float = WAIT_S) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.02)


class Harness:
    """n RaftNodes, each on an RpcServer of its own (tests/test_raft.py's
    Harness over the port's RPC plane)."""

    def __init__(self, tmp_path, n=3, snapshot_threshold=None):
        self.tmp_path = tmp_path
        self.n = n
        self.snapshot_threshold = snapshot_threshold
        self.nodes: dict[str, RaftNode] = {}
        self.servers: dict[str, RpcServer] = {}
        self.applied: dict[str, list] = {}
        self.restored: dict[str, dict] = {}
        self.base_counts: dict[str, int] = {}
        self.addrs: list[str] = []

    def _snapshot_of(self, addr):
        return {"count": self.base_counts.get(addr, 0) + len(self.applied[addr])}

    def _restore(self, addr, st):
        self.restored[addr] = st
        self.base_counts[addr] = st["count"]

    async def start(self):
        # bind every listener first, so the peer lists are complete
        for _ in range(self.n):
            server = RpcServer("127.0.0.1", 0)
            port = await server.start()
            addr = f"127.0.0.1:{port}"
            self.addrs.append(addr)
            self.servers[addr] = server
        for i, addr in enumerate(self.addrs):
            await self.spawn(i, addr)

    async def spawn(self, i, addr, **node_kwargs):
        if addr not in self.servers:
            server = RpcServer("127.0.0.1", int(addr.rsplit(":", 1)[1]))
            await server.start()
            self.servers[addr] = server
        self.applied.setdefault(addr, [])
        if self.snapshot_threshold is not None:
            node_kwargs.setdefault("snapshot_threshold", self.snapshot_threshold)
            node_kwargs.setdefault(
                "snapshot_fn", lambda a=addr: self._snapshot_of(a))
            node_kwargs.setdefault(
                "restore_fn", lambda st, a=addr: self._restore(a, st))
        node = RaftNode(
            addr, list(self.addrs),
            apply_fn=lambda cmd, a=addr, **kw: self.applied[a].append(cmd),
            data_dir=str(self.tmp_path / f"raft-{i}"),
            election_timeout=(0.15, 0.3),
            heartbeat_interval=0.04,
            **node_kwargs,
        )
        self.nodes[addr] = node
        self.servers[addr].add_servicer(raft_pb2, "SeaweedRaft", node)
        await node.start()
        return node

    async def kill(self, addr):
        await self.nodes.pop(addr).stop()
        await self.servers.pop(addr).stop(0.1)

    async def stop(self):
        for addr in list(self.nodes):
            await self.kill(addr)
        for addr in list(self.servers):
            await self.servers.pop(addr).stop(0.1)

    async def wait_leader(self) -> RaftNode:
        await wait_for(
            lambda: sum(n.state == LEADER for n in self.nodes.values()) == 1,
            "a single leader")
        return next(n for n in self.nodes.values() if n.state == LEADER)

    async def wait_applied(self, addr, want: list) -> None:
        await wait_for(lambda: self.applied[addr] == want,
                       f"{addr} to apply {want}")


def test_election_replication_failover(tmp_path):
    async def go():
        h = Harness(tmp_path)
        await h.start()
        try:
            leader = await h.wait_leader()
            for i in range(5):
                await leader.propose({"op": "set", "i": i})
            want = [{"op": "set", "i": i} for i in range(5)]
            for addr in h.nodes:
                await h.wait_applied(addr, want)

            # a follower refuses proposals and names the leader
            follower = next(n for n in h.nodes.values() if n.state != LEADER)
            with pytest.raises(NotLeader) as ei:
                await follower.propose({"op": "nope"})
            assert ei.value.leader == leader.id

            # kill the leader: a new one takes over and the log continues
            old = leader.id
            await h.kill(leader.id)
            leader2 = await h.wait_leader()
            assert leader2.id != old
            await leader2.propose({"op": "after-failover"})
            for addr in h.nodes:
                await h.wait_applied(addr, want + [{"op": "after-failover"}])
        finally:
            await h.stop()

    run(go())


def test_restart_recovers_durable_state(tmp_path):
    async def go():
        h = Harness(tmp_path)
        await h.start()
        try:
            leader = await h.wait_leader()
            for i in range(3):
                await leader.propose({"n": i})
            want = [{"n": i} for i in range(3)]
            for addr in h.nodes:
                await h.wait_applied(addr, want)
            # restart a follower from disk: it must re-apply the log
            follower = next(n for n in h.nodes.values() if n.state != LEADER)
            addr = follower.id
            await h.kill(addr)
            h.applied[addr] = []
            node = await h.spawn(h.addrs.index(addr), addr)
            await h.wait_applied(addr, want)
            assert node.term >= leader.term
        finally:
            await h.stop()

    run(go())


def test_snapshot_compacts_log_and_restart_replays_tail(tmp_path):
    """Past the threshold the log is replaced by a snapshot; a restart
    replays the snapshot and the tail, not the whole history."""

    async def go():
        h = Harness(tmp_path, n=1, snapshot_threshold=50)
        await h.start()
        try:
            (leader,) = h.nodes.values()
            total = 300
            for i in range(total):
                await leader.propose({"n": i})
            addr = leader.id
            assert len(leader.log) - 1 <= 60, len(leader.log)
            assert leader.snapshot_index > 0
            assert len(h.applied[addr]) == total

            # restart from disk: restore_fn gets the snapshot, and only
            # the tail beyond it re-applies
            await h.kill(addr)
            h.applied[addr] = []
            h.base_counts.pop(addr, None)
            node = await h.spawn(0, addr)
            await wait_for(
                lambda: addr in h.restored
                and h.restored[addr]["count"] + len(h.applied[addr]) == total,
                "the snapshot and the tail")
            assert len(h.applied[addr]) <= 60, len(h.applied[addr])
            assert node.snapshot_index > 0
        finally:
            await h.stop()

    run(go())


def test_lagging_follower_catches_up_via_installsnapshot(tmp_path):
    """A wiped follower whose needed entries were compacted away receives
    the leader's snapshot, then the tail."""

    async def go():
        h = Harness(tmp_path, n=3, snapshot_threshold=20)
        await h.start()
        try:
            leader = await h.wait_leader()
            victim = next(a for a in h.addrs if a != leader.id)
            vidx = h.addrs.index(victim)
            await h.kill(victim)

            total = 120
            for i in range(total):
                await leader.propose({"n": i})
            assert leader.snapshot_index > 0

            # wipe the victim's disk: it returns knowing nothing
            shutil.rmtree(str(tmp_path / f"raft-{vidx}"))
            h.applied[victim] = []
            h.base_counts.pop(victim, None)
            await h.spawn(vidx, victim)
            await wait_for(
                lambda: victim in h.restored and h.base_counts.get(victim, 0)
                + len(h.applied[victim]) == total,
                "the victim to hold every entry")
            # it keeps up with new entries after the snapshot; its
            # rejoining campaign may have moved the leadership
            leader = await h.wait_leader()
            await leader.propose({"n": total})
            await wait_for(
                lambda: h.applied[victim][-1:] == [{"n": total}],
                "the victim to apply the next entry")
        finally:
            await h.stop()

    run(go())


# --------------------------------------------------------- across packages

MEMBERS = ["127.0.0.1:19333.29333", "127.0.0.1:19334.29334"]


def _write_state(cls, data_dir: str, node_id: str) -> None:
    """A single node of `cls` (no peers: it elects itself without a
    call) proposes 12 commands under a snapshot threshold of 5, then joins
    a three-member configuration: -> a snapshot, a log tail, a term, a
    vote and peers on disk."""
    counter = {"n": 0}

    def apply_fn(cmd, **kw):
        counter["n"] += cmd["add"]

    async def go():
        node = cls(node_id, [], apply_fn=apply_fn, data_dir=data_dir,
                   snapshot_fn=lambda: {"n": counter["n"]},
                   restore_fn=lambda st: counter.update(n=st["n"]),
                   snapshot_threshold=5)
        await node.start()
        for i in range(12):
            await node.propose({"add": i + 1, "payload": f"entry-{i}"})
        node.apply_config([node_id, *MEMBERS])
        await node.stop()

    run(go())


def _loaded(cls, data_dir: str, node_id: str) -> dict:
    """What a fresh node of `cls` reads back from data_dir."""
    restored = []
    node = cls(node_id, [], apply_fn=lambda cmd, **kw: None,
               data_dir=data_dir, restore_fn=restored.append)
    return {
        "term": node.term,
        "voted_for": node.voted_for,
        "peers": node.peers,
        "voter": node.voter,
        "log": [(t, i, bytes(c)) for t, i, c in node.log],
        "snapshot_index": node.snapshot_index,
        "snapshot_term": node.snapshot_term,
        "snapshot_state": node._snapshot_state,
        "commit_index": node.commit_index,
        "last_applied": node.last_applied,
        "restored": restored,
    }


def _files(data_dir: str) -> dict:
    out = {}
    for name in ("raft_state.json", "raft_snapshot.json"):
        with open(os.path.join(data_dir, name)) as f:
            out[name] = json.load(f)
    with open(os.path.join(data_dir, "raft_log.jsonl")) as f:
        out["raft_log.jsonl"] = [json.loads(line) for line in f]
    return out


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_mdir_loads_into_either_package(tmp_path, writer):
    """A -mdir written by one package's RaftNode restores the same term,
    voted_for, peers, voter flag, log entries (term, index and command
    bytes) and snapshot state in both; and both packages write the same
    files from the same commands."""
    node_id = "127.0.0.1:19332.29332"
    dirs = {}
    for name, cls in (("reference", RefRaftNode), ("port", RaftNode)):
        dirs[name] = str(tmp_path / name)
        _write_state(cls, dirs[name], node_id)
    assert _files(dirs["reference"]) == _files(dirs["port"])

    ref = _loaded(RefRaftNode, dirs[writer], node_id)
    port = _loaded(RaftNode, dirs[writer], node_id)
    assert port == ref
    assert port["peers"] == MEMBERS and port["voter"] is True
    assert port["snapshot_index"] > 0 and len(port["log"]) > 1
    assert port["restored"] == [port["snapshot_state"]]
    # the log tail holds the commands past the snapshot, byte for byte
    tail = [json.loads(c) for _, _, c in port["log"][1:] if c]
    assert [c["add"] for c in tail] == list(
        range(13 - len(tail), 13))
