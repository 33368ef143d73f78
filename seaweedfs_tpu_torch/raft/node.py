"""Raft consensus for master HA: the port of seaweedfs_tpu/raft/node.py.

Reference: weed/server/raft_server.go + raft_hashicorp.go ride
hashicorp/raft; this is the Raft paper's core, as the JAX package has it:
randomized-timeout leader election, AppendEntries heartbeat + log
replication with the conflict-backoff rule, majority commit with the
current-term guard (§5.4.2), durable term/vote/log, one-at-a-time
membership change, and log-compacting snapshots (§7): past
`snapshot_threshold` applied entries the state machine's snapshot
replaces the log prefix, restarts replay O(snapshot)+tail instead of the
whole history, and lagging or joining peers catch up via InstallSnapshot.

The durable state is the reference's three files in `data_dir`, with its
JSON keys, so a master restarts from a directory either package wrote:
`raft_state.json` ({"term", "voted_for", "peers", "voter"}),
`raft_log.jsonl` (one {"t", "i", "c": base64} line per entry) and
`raft_snapshot.json` ({"index", "term", "members", "state"}).

All state transitions run on the asyncio loop (no thread races); the RPCs
ride the port's own RPC plane (pb/rpc.py, messages from pb/raft.proto),
where a failed call is an `RpcError`.
"""
from __future__ import annotations

import asyncio
import base64
import json
import logging
import os
import random
import time

from ..pb import Stub, raft_pb2
from ..pb.rpc import RpcError, channel

log = logging.getLogger("raft")

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


class NotLeader(RuntimeError):
    def __init__(self, leader: str | None):
        super().__init__(f"not the leader (leader={leader})")
        self.leader = leader


class RaftNode:
    def __init__(
        self,
        node_id: str,  # this node's raft grpc address
        peers: list[str],  # other nodes' raft grpc addresses
        apply_fn,  # (command: dict) -> None, called in log order
        data_dir: str | None = None,
        election_timeout: tuple[float, float] = (0.4, 0.8),
        heartbeat_interval: float = 0.1,
        dial_fn=None,  # peer id -> grpc address (default: identity)
        voter: bool = True,  # False: joining server — replicate, never campaign
        snapshot_fn=None,  # () -> dict: state-machine snapshot at last_applied
        restore_fn=None,  # (dict) -> None: install a snapshot's state
        snapshot_threshold: int = 1000,  # log entries before compaction
    ):
        self.id = node_id
        self.voter = voter
        self.peers = [p for p in peers if p != node_id]
        self.dial_fn = dial_fn or (lambda a: a)
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.snapshot_threshold = snapshot_threshold
        self.data_dir = data_dir
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval

        self.state = FOLLOWER
        # time.monotonic() of this node's last election as leader
        self.leader_since: float | None = None
        self.term = 0
        self.voted_for: str | None = None
        # log[0] is a sentinel at the snapshot point (term 0, index 0
        # when no snapshot); entry index i lives at log[i - snapshot_index]
        self.log: list[tuple[int, int, bytes]] = [(0, 0, b"")]
        self.snapshot_index = 0
        self.snapshot_term = 0
        self._snapshot_state: dict | None = None  # last snapshot, for peers
        self.commit_index = 0
        self.last_applied = 0
        self.leader_id: str | None = None
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        self._commit_waiters: dict[int, asyncio.Future] = {}
        self._election_deadline = 0.0
        self._tasks: list[asyncio.Task] = []
        self._stopped = False
        self._stub_cache: dict[str, Stub] = {}
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._load()

    # ------------------------------------------------------------ persistence

    def _state_path(self) -> str:
        return os.path.join(self.data_dir, "raft_state.json")

    def _log_path(self) -> str:
        return os.path.join(self.data_dir, "raft_log.jsonl")

    def _snapshot_path(self) -> str:
        return os.path.join(self.data_dir, "raft_snapshot.json")

    def _load(self) -> None:
        # snapshot FIRST: raft_state.json may hold membership/voter that
        # changed after the snapshot was taken, so its values must win
        try:
            with open(self._snapshot_path()) as f:
                snap = json.load(f)
            self._install_local_snapshot(
                snap["index"], snap["term"], snap.get("members"),
                snap["state"],
            )
        except (OSError, ValueError, KeyError):
            pass
        try:
            with open(self._state_path()) as f:
                st = json.load(f)
            self.term = st["term"]
            self.voted_for = st["voted_for"]
            if "peers" in st:  # membership changes survive restart
                self.peers = [p for p in st["peers"] if p != self.id]
            self.voter = st.get("voter", self.voter)
        except (OSError, ValueError, KeyError):
            pass
        try:
            with open(self._log_path()) as f:
                for line in f:
                    e = json.loads(line)
                    if e["i"] <= self.snapshot_index:
                        continue  # compacted away
                    self.log.append(
                        (e["t"], e["i"], base64.b64decode(e["c"]))
                    )
        except (OSError, ValueError, KeyError):
            pass

    def _install_local_snapshot(
        self, index: int, term: int, members: list[str] | None, state: dict
    ) -> None:
        """Adopt a snapshot as the new log base (shared by restart load
        and leader-pushed InstallSnapshot)."""
        self.snapshot_index = index
        self.snapshot_term = term
        self._snapshot_state = state
        self.log = [(term, index, b"")]
        self.commit_index = max(self.commit_index, index)
        self.last_applied = max(self.last_applied, index)
        if members is not None:
            self.peers = [m for m in members if not self.same_node(m, self.id)]
            if any(self.same_node(m, self.id) for m in members):
                self.voter = True
            elif self.voter and self.state != LEADER:
                # removed while partitioned and the config entry was
                # compacted away: stop campaigning (mirrors apply_config,
                # or this node would term-bump the cluster forever)
                self.voter = False
        if self.restore_fn is not None:
            try:
                self.restore_fn(state)
            except Exception:  # noqa: BLE001
                log.exception("snapshot restore failed at index %d", index)

    def _persist_snapshot(self) -> None:
        if not self.data_dir:
            return
        tmp = self._snapshot_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "index": self.snapshot_index,
                    "term": self.snapshot_term,
                    "members": [self.id] + self.peers,
                    "state": self._snapshot_state,
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snapshot_path())

    def _persist_state(self) -> None:
        if not self.data_dir:
            return
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "term": self.term,
                    "voted_for": self.voted_for,
                    "peers": self.peers,
                    "voter": self.voter,
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path())

    def _persist_log_rewrite(self) -> None:
        if not self.data_dir:
            return
        tmp = self._log_path() + ".tmp"
        with open(tmp, "w") as f:
            for t_, i, c in self.log[1:]:
                f.write(json.dumps(
                    {"t": t_, "i": i, "c": base64.b64encode(c).decode()}
                ) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._log_path())

    def _persist_log_append(self, entries) -> None:
        if not self.data_dir:
            return
        with open(self._log_path(), "a") as f:
            for t_, i, c in entries:
                f.write(json.dumps(
                    {"t": t_, "i": i, "c": base64.b64encode(c).decode()}
                ) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # --------------------------------------------------------------- helpers

    @property
    def is_leader(self) -> bool:
        return self.state == LEADER

    @property
    def quorum(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    def last_log(self) -> tuple[int, int]:
        t_, i, _ = self.log[-1]
        return i, t_

    def _at(self, index: int) -> tuple[int, int, bytes]:
        """Log entry by ABSOLUTE index (the sentinel sits at
        snapshot_index)."""
        return self.log[index - self.snapshot_index]

    def _has(self, index: int) -> bool:
        return self.snapshot_index <= index <= self.last_log()[0]

    def _stub(self, peer: str) -> Stub:
        s = self._stub_cache.get(peer)
        if s is None:
            s = Stub(channel(self.dial_fn(peer)), raft_pb2, "SeaweedRaft")
            self._stub_cache[peer] = s
        return s

    def _reset_election_timer(self) -> None:
        lo, hi = self.election_timeout
        self._election_deadline = (
            asyncio.get_running_loop().time() + random.uniform(lo, hi)
        )

    def _become_follower(self, term: int, leader: str | None = None) -> None:
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._persist_state()
        self.state = FOLLOWER
        if leader:
            self.leader_id = leader
        self._reset_election_timer()

    # -------------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self._reset_election_timer()
        if not self.peers and self.voter:
            # single-master deployment: win the 1-node election immediately.
            # A non-voter (raft_join) must NOT take this path even with an
            # empty peer list — self-electing would split-brain against the
            # cluster it is about to join.
            self.term += 1
            self.voted_for = self.id
            self._persist_state()
            self._become_leader()
        self._tasks.append(asyncio.create_task(self._ticker()))

    async def stop(self) -> None:
        self._stopped = True
        for t_ in self._tasks:
            t_.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        for _, fut in self._commit_waiters.values():
            if not fut.done():
                fut.cancel()
        self._commit_waiters.clear()

    async def _ticker(self) -> None:
        while not self._stopped:
            await asyncio.sleep(self.heartbeat_interval / 2)
            now = asyncio.get_running_loop().time()
            if self.state == LEADER:
                await self._replicate_all()
            elif self.voter and now >= self._election_deadline:
                await self._run_election()

    # --------------------------------------------------------------- election

    async def _run_election(self) -> None:
        self.state = CANDIDATE
        self.term += 1
        self.voted_for = self.id
        self._persist_state()
        self._reset_election_timer()
        term = self.term
        li, lt = self.last_log()
        votes = 1
        log.info("%s: starting election for term %d", self.id, term)

        async def ask(peer: str) -> bool:
            try:
                resp = await asyncio.wait_for(
                    self._stub(peer).RequestVote(
                        raft_pb2.VoteRequest(
                            term=term, candidate_id=self.id,
                            last_log_index=li, last_log_term=lt,
                        )
                    ),
                    timeout=self.heartbeat_interval * 3,
                )
            except (RpcError, asyncio.TimeoutError):
                return False
            if resp.term > self.term:
                self._become_follower(resp.term)
                return False
            return resp.vote_granted

        results = await asyncio.gather(*(ask(p) for p in self.peers))
        if self.state != CANDIDATE or self.term != term:
            return  # a leader appeared or a newer term started meanwhile
        votes += sum(results)
        if votes >= self.quorum:
            self._become_leader()

    def _become_leader(self) -> None:
        self.state = LEADER
        self.leader_since = time.monotonic()
        self.leader_id = self.id
        li, _ = self.last_log()
        self.next_index = {p: li + 1 for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        # no-op entry in the new term: prior-term entries can only commit
        # indirectly (§5.4.2), and this drives the commit index forward so
        # the durable log replays on a restarted single node too
        entry = (self.term, li + 1, b"")
        self.log.append(entry)
        self._persist_log_append([entry])
        if not self.peers:
            self._advance_commit()
        log.info("%s: leader for term %d", self.id, self.term)

    # ----------------------------------------------------------- membership

    def same_node(self, a: str, b: str) -> bool:
        """Node identity comparison through the dial mapping: 'host:port'
        and 'host:port.grpc' flag/advertise forms of one server must not
        read as two members."""
        return a == b or self.dial_fn(a) == self.dial_fn(b)

    def apply_config(self, members: list[str]) -> None:
        """Membership change, called when a raft_conf log entry commits.
        The entry carries the COMPLETE member list so every replica —
        including a joining server that knew nobody — converges on the
        same configuration.  One add/remove at a time keeps old and new
        quorums overlapping (the hashicorp AddVoter/RemoveServer
        discipline the reference relies on)."""
        is_member = any(self.same_node(m, self.id) for m in members)
        new_peers = [m for m in members if not self.same_node(m, self.id)]
        if self.state == LEADER:
            li, _ = self.last_log()
            for p in new_peers:
                if p not in self.next_index:
                    self.next_index[p] = li + 1
                    self.match_index[p] = 0
            for p in list(self.next_index):
                if p not in new_peers:
                    self.next_index.pop(p, None)
                    self.match_index.pop(p, None)
        self.peers = new_peers
        if is_member:
            self.voter = True  # a joining server is promoted on commit
        elif self.voter and self.state != LEADER:
            self.voter = False  # removed: stop campaigning
        self._persist_state()

    # ------------------------------------------------------------ replication

    async def propose(self, command: dict, timeout: float = 5.0) -> None:
        """Append a command and wait until it is committed AND applied.
        Raises NotLeader on followers."""
        if self.state != LEADER:
            raise NotLeader(self.leader_id)
        li, _ = self.last_log()
        index = li + 1
        term = self.term
        entry = (term, index, json.dumps(command).encode())
        self.log.append(entry)
        self._persist_log_append([entry])
        fut = asyncio.get_running_loop().create_future()
        # the waiter records its term: if another leader overwrites this
        # index, committing a DIFFERENT entry there must fail the propose,
        # not confirm it
        self._commit_waiters[index] = (term, fut)
        if not self.peers:
            self._advance_commit()
        else:
            await self._replicate_all()
        try:
            await asyncio.wait_for(fut, timeout)
        finally:
            self._commit_waiters.pop(index, None)

    async def _replicate_all(self) -> None:
        if self.peers:
            await asyncio.gather(
                *(self._replicate(p) for p in self.peers),
                return_exceptions=True,
            )
        self._advance_commit()

    async def _replicate(self, peer: str) -> None:
        ni = self.next_index.get(peer, self.snapshot_index + 1)
        if ni <= self.snapshot_index:
            if self._snapshot_state is not None:
                # the entries this peer needs are compacted away: ship
                # the snapshot instead (raft §7 InstallSnapshot)
                await self._send_snapshot(peer)
                return
            ni = self.snapshot_index + 1
        prev = self._at(ni - 1)
        entries = [
            raft_pb2.LogEntry(term=t_, index=i, command=c)
            for t_, i, c in self.log[ni - self.snapshot_index:]
        ]
        try:
            resp = await asyncio.wait_for(
                self._stub(peer).AppendEntries(
                    raft_pb2.AppendRequest(
                        term=self.term, leader_id=self.id,
                        prev_log_index=prev[1], prev_log_term=prev[0],
                        entries=entries, leader_commit=self.commit_index,
                    )
                ),
                timeout=self.heartbeat_interval * 3,
            )
        except (RpcError, asyncio.TimeoutError):
            return
        if resp.term > self.term:
            self._become_follower(resp.term)
            return
        if self.state != LEADER:
            return
        if resp.success:
            self.match_index[peer] = resp.match_index
            self.next_index[peer] = resp.match_index + 1
        else:
            # conflict backoff; backing off TO the snapshot boundary
            # flips the next round to InstallSnapshot
            floor = self.snapshot_index if self._snapshot_state else 1
            self.next_index[peer] = max(floor, ni - 1)

    def _advance_commit(self) -> None:
        li, _ = self.last_log()
        for n in range(self.commit_index + 1, li + 1):
            if self._at(n)[0] != self.term:
                continue  # only current-term entries commit by counting (§5.4.2)
            replicated = 1 + sum(
                1 for p in self.peers if self.match_index.get(p, 0) >= n
            )
            if replicated >= self.quorum:
                self.commit_index = n
        self._apply_committed()

    def _apply_committed(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            t_, i, c = self._at(self.last_applied)
            if c:
                # own_live: this node proposed the entry in its current
                # leadership — state machines can skip self-adjustments
                # that only matter for followers/replay (e.g. sequence
                # ceilings that would jump the leader's own counter)
                own_live = self.state == LEADER and t_ == self.term
                try:
                    self.apply_fn(json.loads(c), term=t_, own_live=own_live)
                except Exception:  # noqa: BLE001 — state machine must not kill raft
                    log.exception("apply failed at index %d", i)
            waiter = self._commit_waiters.get(i)
            if waiter is not None:
                wterm, fut = waiter
                if not fut.done():
                    if wterm == t_:
                        fut.set_result(None)
                    else:
                        fut.set_exception(NotLeader(self.leader_id))
        self._maybe_snapshot()

    # ------------------------------------------------------------- snapshots

    def _maybe_snapshot(self) -> None:
        if (
            self.snapshot_fn is None
            or len(self.log) - 1 <= self.snapshot_threshold
            or self.last_applied <= self.snapshot_index
        ):
            return
        self.take_snapshot()

    def take_snapshot(self) -> None:
        """Compact the log at last_applied: the state machine's snapshot
        replaces every entry at or below it (§7; the reference's
        hashicorp snapshot store role)."""
        index = self.last_applied
        term = self._at(index)[0] if index > self.snapshot_index else self.snapshot_term
        try:
            state = self.snapshot_fn()
        except Exception:  # noqa: BLE001 — never kill raft for a snapshot
            log.exception("snapshot_fn failed; keeping full log")
            return
        tail = self.log[index - self.snapshot_index + 1:]
        self.log = [(term, index, b"")] + tail
        self.snapshot_index = index
        self.snapshot_term = term
        self._snapshot_state = state
        self._persist_snapshot()
        self._persist_log_rewrite()
        log.info(
            "%s: snapshot at index %d (log now %d entries)",
            self.id, index, len(self.log) - 1,
        )

    async def _send_snapshot(self, peer: str) -> None:
        try:
            resp = await asyncio.wait_for(
                self._stub(peer).InstallSnapshot(
                    raft_pb2.SnapshotRequest(
                        term=self.term,
                        leader_id=self.id,
                        last_included_index=self.snapshot_index,
                        last_included_term=self.snapshot_term,
                        members=[self.id] + self.peers,
                        state=json.dumps(self._snapshot_state).encode(),
                    )
                ),
                timeout=self.heartbeat_interval * 10,
            )
        except (RpcError, asyncio.TimeoutError):
            return
        if resp.term > self.term:
            self._become_follower(resp.term)
            return
        if self.state != LEADER:
            return
        self.match_index[peer] = self.snapshot_index
        self.next_index[peer] = self.snapshot_index + 1

    # ------------------------------------------------------------ rpc handlers

    async def RequestVote(self, request, context):
        if request.term > self.term:
            self._become_follower(request.term)
        granted = False
        if request.term == self.term and self.voted_for in (None, request.candidate_id):
            li, lt = self.last_log()
            up_to_date = (request.last_log_term, request.last_log_index) >= (lt, li)
            if up_to_date:
                granted = True
                self.voted_for = request.candidate_id
                self._persist_state()
                self._reset_election_timer()
        return raft_pb2.VoteResponse(term=self.term, vote_granted=granted)

    async def AppendEntries(self, request, context):
        if request.term < self.term:
            return raft_pb2.AppendResponse(term=self.term, success=False)
        self._become_follower(request.term, leader=request.leader_id)
        # log consistency check.  A prev BELOW our snapshot point is
        # consistent by construction: snapshots only cover committed
        # entries, which every legitimate leader's log matches.
        pli, plt = request.prev_log_index, request.prev_log_term
        if pli >= self.snapshot_index:
            if not self._has(pli) or self._at(pli)[0] != plt:
                return raft_pb2.AppendResponse(term=self.term, success=False)
        # append, truncating conflicts; plain appends persist by appending
        # (a full rewrite per batch would be O(n^2) across the log's life)
        truncated = False
        appended: list[tuple[int, int, bytes]] = []
        for e in request.entries:
            if e.index <= self.snapshot_index:
                continue  # already compacted into the snapshot
            if e.index <= self.last_log()[0]:
                if self._at(e.index)[0] != e.term:
                    del self.log[e.index - self.snapshot_index:]
                    truncated = True
                else:
                    continue
            entry = (e.term, e.index, bytes(e.command))
            self.log.append(entry)
            appended.append(entry)
        if truncated:
            self._persist_log_rewrite()
        elif appended:
            self._persist_log_append(appended)
        if request.leader_commit > self.commit_index:
            li, _ = self.last_log()
            self.commit_index = min(request.leader_commit, li)
            self._apply_committed()
        # match through what THIS request proved, never the follower's own
        # tail — stale extra entries here must not advance the leader
        return raft_pb2.AppendResponse(
            term=self.term,
            success=True,
            match_index=request.prev_log_index + len(request.entries),
        )

    async def InstallSnapshot(self, request, context):
        if request.term < self.term:
            return raft_pb2.SnapshotResponse(term=self.term)
        self._become_follower(request.term, leader=request.leader_id)
        if request.last_included_index <= self.snapshot_index:
            return raft_pb2.SnapshotResponse(term=self.term)  # stale
        self._install_local_snapshot(
            request.last_included_index,
            request.last_included_term,
            list(request.members) or None,
            json.loads(request.state),
        )
        # state BEFORE snapshot: _load gives raft_state.json's membership
        # precedence, so a crash between the two writes must never leave a
        # newer snapshot beside older state (pre-snapshot peers would be
        # resurrected with no config entry left in the log to fix them)
        self._persist_state()
        self._persist_snapshot()
        self._persist_log_rewrite()  # log restarts from the snapshot point
        log.info(
            "%s: installed snapshot at index %d from %s",
            self.id, self.snapshot_index, request.leader_id,
        )
        return raft_pb2.SnapshotResponse(term=self.term)
