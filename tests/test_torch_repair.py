"""The port's repair plane (repair/) held against the JAX package's.

- The planner: `plan()` on 200 seeded censuses (corrupt and stale shards,
  mesh pods, critical and unrecoverable volumes) gives the reference's
  jobs, in its order, and its unrecoverable list; and mirrors of the
  planner cases of tests/test_repair_plan.py.
- The scheduler, against a fake master and a pinned clock on both sides:
  breaker deferral, pause, exponential backoff and parking, time to
  healthy, the max_inflight bound and report_corrupt, each compared with
  the reference's `status()` after the same ticks.  (test_repair_plan.py's
  two fault-injector cases need the reference's loadgen package, which
  the port does not have: they are left out.)
- The master's -ec.repair.* flags build the reference's RepairConfig.
- End to end, each case on the port's LocalCluster and the reference's
  with the same seeded blobs (mirroring test_repair_e2e.py without its
  chaos harness): a killed server is healed to 14 shards; a corrupt
  parity shard is found by the master's scrub sweep (the port's servers
  scrub their resident shards with the scrub kernel's plain version),
  dropped before the rebuild and healed; a server whose heartbeats stop
  (`heartbeat_pause`) goes stale and its shards are re-established on
  fresh nodes.  Every shard file's sha256 must equal the other cluster's
  and its hash before the loss, every GET body the blob, and the repair
  blocks' counters must be equal.
- The shell: volume.repair.status [-json], pause and resume on both.
"""
import asyncio
import dataclasses
import json
import re
import time

import numpy as np
import pytest

from seaweedfs_tpu import repair as jax_repair
from seaweedfs_tpu.repair import planner as jax_planner
from seaweedfs_tpu_torch import repair
from seaweedfs_tpu_torch.repair import planner

URLS = ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3", "127.0.0.1:4",
        "127.0.0.1:5"]


def _holders(*sids, url="n1:8080"):
    return {sid: url for sid in sids}


def _plans(*args, **kw):
    """plan() in both packages on the same census -> (port, ref), each as
    plain data."""
    def flat(r):
        return ([dataclasses.asdict(j) for j in r.jobs],
                [dataclasses.asdict(j) for j in r.unrecoverable],
                list(r.healthy_vids))
    return flat(repair.plan(*args, **kw)), flat(jax_repair.plan(*args, **kw))


# ------------------------------------------------------------------ planner


def _census(rng):
    n_vids = int(rng.integers(1, 7))
    shard_map, corrupt, collections = {}, {}, {}
    for vid in rng.choice(50, n_vids, replace=False):
        vid = int(vid)
        n_held = int(rng.integers(6, 15))
        sids = sorted(int(s) for s in rng.choice(14, n_held, replace=False))
        shard_map[vid] = {s: URLS[int(rng.integers(len(URLS)))]
                          for s in sids}
        if rng.random() < 0.3:
            bad = rng.choice(sids, int(rng.integers(1, 3)), replace=False)
            corrupt[vid] = {int(s): shard_map[vid][int(s)] for s in bad}
        collections[vid] = str(rng.choice(["", "c1", "ec9"]))
    if rng.random() < 0.1:  # a verdict for a volume the census lost
        corrupt[99] = {3: URLS[0]}
    stale = {u for u in URLS if rng.random() < 0.2}
    pods = {u: str(rng.choice(["", "pod-a", "pod-b"])) for u in URLS
            if rng.random() < 0.5}
    return shard_map, collections, corrupt, stale, pods


def test_plan_matches_the_reference_on_seeded_censuses():
    rng = np.random.default_rng(12)
    kinds = {"critical": 0, "unrecoverable": 0, "corrupt": 0,
             "stale_node": 0, "pod_exposed": 0}
    for _ in range(200):
        shard_map, collections, corrupt, stale, pods = _census(rng)
        mine, theirs = _plans(shard_map, collections=collections,
                              corrupt=corrupt, stale_nodes=stale,
                              node_pods=pods)
        assert mine == theirs
        jobs, dead, _ = mine
        kinds["critical"] += sum(j["critical"] for j in jobs)
        kinds["unrecoverable"] += len(dead)
        kinds["corrupt"] += sum(j["reason"] == "corrupt" for j in jobs)
        kinds["stale_node"] += sum(j["reason"] == "stale_node" for j in jobs)
        kinds["pod_exposed"] += sum(j["pod_exposed"] for j in jobs)
    assert all(kinds.values()), kinds  # every branch was reached


def test_plan_healthy_volume_produces_no_job():
    result = repair.plan({1: _holders(*range(14))})
    assert result.jobs == [] and result.unrecoverable == []
    assert result.healthy_vids == [1]


def test_plan_critical_volume_jumps_the_queue():
    result = repair.plan({
        1: _holders(*range(12)),
        2: _holders(*range(10)),
        3: _holders(*range(13)),
    })
    assert [j.vid for j in result.jobs] == [2, 1, 3]
    assert result.jobs[0].critical
    assert result.jobs[0].missing == [10, 11, 12, 13]


def test_plan_most_missing_first_within_noncritical():
    result = repair.plan({1: _holders(*range(13)), 2: _holders(*range(11))})
    assert [j.vid for j in result.jobs] == [2, 1]


def test_plan_corrupt_shard_counts_as_lost():
    result = repair.plan({1: _holders(*range(14))},
                         corrupt={1: {11: "n1:8080"}})
    (job,) = result.jobs
    assert job.missing == [11]
    assert job.corrupt == {11: "n1:8080"}
    assert job.reason == "corrupt"
    assert job.healthy == 13


def test_plan_stale_node_shards_count_as_lost():
    shards = {sid: ("stale:1" if sid in (0, 1) else "live:1")
              for sid in range(14)}
    (job,) = repair.plan({1: shards}, stale_nodes={"stale:1"}).jobs
    assert job.missing == [0, 1]
    assert job.reason == "stale_node"


def test_plan_unrecoverable_not_queued():
    result = repair.plan({1: _holders(*range(9))})
    assert result.jobs == []
    (dead,) = result.unrecoverable
    assert dead.vid == 1 and dead.healthy == 9


def test_plan_corrupt_can_make_volume_unrecoverable():
    result = repair.plan({1: _holders(*range(10))},
                         corrupt={1: {3: "n1:8080"}})
    assert result.jobs == []
    assert [j.vid for j in result.unrecoverable] == [1]


def test_plan_rescue_saves_volume_below_fresh_quorum():
    shards = {sid: ("stale:1" if sid < 6 else "live:1") for sid in range(14)}
    result = repair.plan({1: shards}, stale_nodes={"stale:1"})
    (job,) = result.jobs
    assert result.unrecoverable == []
    assert job.healthy == 8 and len(job.rescue) == 6
    assert job.critical
    few = {sid: ("stale:1" if sid < 2 else "live:1") for sid in range(8)}
    result2 = repair.plan({2: few}, stale_nodes={"stale:1"})
    assert [j.vid for j in result2.unrecoverable] == [2]


def test_plan_pods_are_a_failure_domain():
    """Survivors collapsed into one mesh pod escalate to critical."""
    shards = {sid: URLS[sid % 2] for sid in range(12)}
    pods = {URLS[0]: "pod-a", URLS[1]: "pod-a"}
    mine, theirs = _plans({4: shards}, node_pods=pods)
    assert mine == theirs
    (job,) = repair.plan({4: shards}, node_pods=pods).jobs
    assert job.pod_exposed and job.critical and job.healthy == 12
    (job,) = repair.plan({4: shards}, node_pods={URLS[0]: "pod-a"}).jobs
    assert not job.pod_exposed and not job.critical


def test_planner_sort_is_deterministic():
    a = planner.RepairJob(vid=2, collection="", missing=[1], healthy=13)
    b = planner.RepairJob(vid=1, collection="", missing=[2], healthy=13)
    assert sorted([a, b], key=planner.RepairJob.sort_key)[0].vid == 1
    assert [dataclasses.asdict(j) for j in sorted(
        [a, b], key=planner.RepairJob.sort_key)] == [
        dataclasses.asdict(j) for j in sorted(
            [jax_planner.RepairJob(**dataclasses.asdict(x)) for x in (a, b)],
            key=jax_planner.RepairJob.sort_key)]


def test_config_validation():
    for bad in (dict(max_inflight=0), dict(backoff_max_seconds=0.1),
                dict(interval_seconds=-1), dict(fanout_concurrency=0),
                dict(backoff_base_seconds=0), dict(max_attempts=0),
                dict(scrub_interval_seconds=-1),
                dict(breaker_pause_seconds=-1)):
        with pytest.raises(ValueError) as mine:
            repair.RepairConfig(**bad).validated()
        with pytest.raises(ValueError) as theirs:
            jax_repair.RepairConfig(**bad).validated()
        assert str(mine.value) == str(theirs.value)
    assert repair.RepairConfig().validated().enabled
    assert dataclasses.asdict(repair.RepairConfig()) == \
        dataclasses.asdict(jax_repair.RepairConfig())


# ---------------------------------------------------------------- scheduler


class _FakeTelemetry:
    def __init__(self):
        self.stale = set()
        self.open_breakers = 0

    def stale_node_urls(self, now=None):
        return set(self.stale)

    def breakers_open(self, now=None):
        return self.open_breakers


class _FakeTopo:
    def __init__(self):
        self.info = {"data_centers": []}

    def to_info(self):
        return self.info

    def data_nodes(self):
        return []


class _FakeMaster:
    def __init__(self):
        self.telemetry = _FakeTelemetry()
        self.topo = _FakeTopo()
        self.is_leader = True
        self.settling = False

    def leader_settling(self):
        return self.settling


def _topo_info(vid_shards):
    """Topology.to_info()-shaped snapshot: one node per distinct url."""
    by_url: dict[str, dict[int, int]] = {}
    for vid, shards in vid_shards.items():
        for sid, url in shards.items():
            by_url.setdefault(url, {}).setdefault(vid, 0)
            by_url[url][vid] |= 1 << sid
    return {"data_centers": [{"id": "dc1", "racks": [{"id": "r1", "nodes": [
        {"id": url, "grpc_port": 18080, "volumes": [],
         "ec_shards": [{"id": vid, "collection": "", "ec_index_bits": bits}
                       for vid, bits in vids.items()],
         "max_volume_counts": {"hdd": 8}}
        for url, vids in sorted(by_url.items())]}]}]}


def _masked(status: dict) -> dict:
    status = json.loads(json.dumps(status))
    if status.get("last_convergence_unix_ms") is not None:
        status["last_convergence_unix_ms"] = "<ms>"
    return status


async def _settle():
    for _ in range(20):
        await asyncio.sleep(0)


def _both_schedulers(monkeypatch, info, cfg_kw, executor=None, clock=None):
    """The port's and the reference's RepairScheduler, each over its own
    fake master holding `info`, with `executor` in place of repair_volume
    (no job dials a server) and the shared pinned `clock`."""
    out = []
    for pkg, mod in ((repair, "seaweedfs_tpu_torch"),
                     (jax_repair, "seaweedfs_tpu")):
        master = _FakeMaster()
        master.topo.info = info
        sched = pkg.RepairScheduler(master, pkg.RepairConfig(**cfg_kw))
        if clock is not None:
            sched.clock = clock
        out.append((master, sched))
    if executor is not None:
        for mod in ("seaweedfs_tpu_torch", "seaweedfs_tpu"):
            monkeypatch.setattr(
                f"{mod}.repair.scheduler.executor.repair_volume", executor)
    return out


async def _never(env, nodes, job, **kw):
    await asyncio.Event().wait()


def test_scheduler_breaker_pause_defers_whole_cycle(monkeypatch):
    pairs = _both_schedulers(
        monkeypatch, _topo_info({1: _holders(*range(12))}),
        dict(interval_seconds=0, breaker_pause_seconds=5.0), _never)

    async def go():
        seen = []
        for master, sched in pairs:
            master.telemetry.open_breakers = 1
            await sched.tick(now=100.0)
            assert sched._inflight == {}
            assert sched.totals["backoff_breaker"] == 1
            master.telemetry.open_breakers = 0
            await sched.tick(now=104.0)
            assert sched._inflight == {}
            await sched.tick(now=105.5)
            assert sched.totals["queued"] == 1
            seen.append(_masked(sched.status()))
            await sched.stop()
        return seen

    mine, theirs = asyncio.run(go())
    assert mine == theirs


def test_scheduler_paused_does_nothing(monkeypatch):
    pairs = _both_schedulers(
        monkeypatch, _topo_info({1: _holders(*range(12))}),
        dict(interval_seconds=0), _never)

    async def go():
        seen = []
        for _, sched in pairs:
            sched.pause()
            await sched.tick(now=0.0)
            assert sched._inflight == {} and sched.totals["queued"] == 0
            seen.append(_masked(sched.status()))
            sched.resume()
            await sched.tick(now=1.0)
            assert sched.totals["queued"] == 1
            seen.append(_masked(sched.status()))
            await sched.stop()
        return seen

    seen = asyncio.run(go())
    assert seen[:2] == seen[2:]
    assert seen[0]["paused"] and not seen[1]["paused"]


def test_scheduler_backoff_is_exponential_and_parks(monkeypatch):
    async def boom(env, nodes, job, **kw):
        raise RuntimeError("injected repair failure")

    fake_now = [1000.0]
    cfg = dict(interval_seconds=0, backoff_base_seconds=1.0,
               backoff_max_seconds=8.0, max_attempts=3)
    pairs = _both_schedulers(monkeypatch,
                             _topo_info({7: _holders(*range(12))}), cfg,
                             boom, clock=lambda: fake_now[0])

    async def go():
        out = []
        for _, sched in pairs:
            fake_now[0] = 1000.0
            statuses, delays = [], []
            for attempt in range(1, cfg["max_attempts"] + 1):
                await sched.tick()
                await _settle()
                assert sched._inflight == {}
                attempts, next_ok = sched._backoff[7]
                assert attempts == attempt
                delays.append(round(next_ok - fake_now[0], 6))
                queued = sched.totals["queued"]
                await sched.tick()
                assert sched.totals["queued"] == queued
                statuses.append(_masked(sched.status()))
                fake_now[0] = next_ok + 0.01
            assert delays == [1.0, 2.0, 4.0]
            assert sched.totals["failed"] == 1 and 7 in sched._parked
            st = sched.status()
            assert st["failed"]["7"]
            assert st["totals"]["backoff_retry"] == cfg["max_attempts"] - 1
            await sched.tick()
            assert sched.totals["queued"] == cfg["max_attempts"]
            assert sched.status()["volumes"]["7"]["state"] == "failed"
            statuses.append(_masked(sched.status()))
            await sched.stop()
            out.append(statuses)
        return out

    mine, theirs = asyncio.run(go())
    assert mine == theirs
    assert [s["volumes"]["7"]["state"] for s in mine] == [
        "backoff", "backoff", "failed", "failed"]


def test_scheduler_records_time_to_healthy(monkeypatch):
    pairs = _both_schedulers(monkeypatch, {"data_centers": []},
                             dict(interval_seconds=0))

    async def go():
        out = []
        for master, sched in pairs:
            master.topo.info = _topo_info({9: _holders(*range(8))})
            await sched.tick(now=50.0)
            assert sched._unhealthy_since == 50.0
            first = _masked(sched.status())
            assert first["volumes"]["9"]["state"] == "unrecoverable"
            master.topo.info = _topo_info({9: _holders(*range(14))})
            await sched.tick(now=61.5)
            assert sched._unhealthy_since is None
            assert sched.last_time_to_healthy_s == pytest.approx(11.5)
            st = sched.status()
            assert st["last_convergence_unix_ms"] is not None
            assert st["volumes"]["9"]["state"] == "healthy"
            out.append((first, _masked(st)))
        return out

    mine, theirs = asyncio.run(go())
    assert mine == theirs


def test_a_loss_while_a_new_leader_settles_is_counted_from_its_start(
        monkeypatch):
    """While the master settles after its election the port's scheduler
    queues no job (ROADMAP §C), but its census, verdicts and
    time-to-healthy clock run from the first cycle that sees the loss."""
    fake_now = [50.0]
    (master, sched), _ = _both_schedulers(
        monkeypatch, _topo_info({9: _holders(*range(12))}),
        dict(interval_seconds=0), clock=lambda: fake_now[0])

    async def heal(env, nodes, job, **kw):
        master.topo.info = _topo_info({9: _holders(*range(14))})
        return {"rebuilt": list(job.missing), "rebuilder": "127.0.0.1:1"}

    monkeypatch.setattr(
        "seaweedfs_tpu_torch.repair.scheduler.executor.repair_volume", heal)

    async def go():
        master.settling = True
        await sched.tick()
        assert sched.totals["queued"] == 0 and sched._inflight == {}
        assert sched._unhealthy_since == 50.0
        verdict = sched.status()["volumes"]["9"]
        assert verdict["missing"] == [12, 13]
        assert verdict["healthy_shards"] == 12
        master.settling = False
        fake_now[0] = 58.0
        await sched.tick()
        await _settle()
        assert sched.totals["queued"] == 1
        assert sched.totals["completed"] == 1
        fake_now[0] = 61.5
        await sched.tick()
        assert sched._unhealthy_since is None
        assert sched.last_time_to_healthy_s == pytest.approx(11.5)
        assert sched.status()["volumes"]["9"]["state"] == "healthy"
        await sched.stop()

    asyncio.run(go())


def test_scheduler_max_inflight_bound(monkeypatch):
    gate = []

    async def stall(env, nodes, job, **kw):
        await gate[-1].wait()
        return {"rebuilder": "x", "rebuilt": [], "spread": {},
                "dropped_corrupt": []}

    pairs = _both_schedulers(
        monkeypatch,
        _topo_info({vid: _holders(*range(12)) for vid in (1, 2, 3, 4)}),
        dict(interval_seconds=0, max_inflight=2), stall)

    async def go():
        out = []
        for _, sched in pairs:
            gate.append(asyncio.Event())
            await sched.tick(now=0.0)
            assert len(sched._inflight) == 2
            during = _masked(sched.status())
            gate[-1].set()
            await _settle()
            assert sched._inflight == {}
            assert sched.totals["completed"] == 2
            out.append((during, _masked(sched.status())))
            await sched.stop()
        return out

    mine, theirs = asyncio.run(go())
    assert mine == theirs
    assert mine[0]["inflight"] == [1, 2]


def test_report_corrupt_feeds_next_plan(monkeypatch):
    pairs = _both_schedulers(monkeypatch,
                             _topo_info({5: _holders(*range(14))}),
                             dict(interval_seconds=0), _never)

    async def go():
        out = []
        for _, sched in pairs:
            sched.pause()
            sched.report_corrupt(5, {11: "n1:8080"})
            sched.resume()
            await sched.tick(now=0.0)
            v = sched.status()["volumes"]["5"]
            assert v["corrupt"] == [11] and v["reason"] == "corrupt"
            out.append(_masked(sched.status()))
            await sched.stop()
        return out

    mine, theirs = asyncio.run(go())
    assert mine == theirs


# -------------------------------------------------------------------- flags

_REPAIR_FLAGS = [
    "-ec.repair.intervalSeconds", "0.75", "-ec.repair.maxInflight", "3",
    "-ec.repair.fanout", "6", "-ec.repair.backoffBaseSeconds", "0.5",
    "-ec.repair.backoffMaxSeconds", "30", "-ec.repair.maxAttempts", "5",
    "-ec.repair.scrubIntervalSeconds", "45",
    "-ec.repair.breakerPauseSeconds", "1.5",
]


@pytest.mark.parametrize("disable", [False, True])
def test_master_repair_flags_build_the_reference_config(disable):
    import argparse

    from seaweedfs_tpu.command import master as jax_cmd_master
    from seaweedfs_tpu_torch.command import master as cmd_master

    argv = _REPAIR_FLAGS + (["-ec.repair.disable"] if disable else [])
    parsed = []
    for mod in (cmd_master, jax_cmd_master):
        p = argparse.ArgumentParser(prog="master")
        mod.add_args(p)
        parsed.append(p.parse_args(argv))
    mine, theirs = parsed
    names = sorted(k for k in vars(theirs) if k.startswith("ec_repair_"))
    assert len(names) == 9
    assert {k: getattr(mine, k) for k in names} == \
        {k: getattr(theirs, k) for k in names}
    cfg = cmd_master.repair_config(mine)
    # the reference's command/master.py run() spelling of the same config
    want = jax_repair.RepairConfig(
        enabled=not theirs.ec_repair_disable,
        interval_seconds=theirs.ec_repair_interval_seconds,
        max_inflight=theirs.ec_repair_max_inflight,
        fanout_concurrency=theirs.ec_repair_fanout,
        backoff_base_seconds=theirs.ec_repair_backoff_base_seconds,
        backoff_max_seconds=theirs.ec_repair_backoff_max_seconds,
        max_attempts=theirs.ec_repair_max_attempts,
        scrub_interval_seconds=theirs.ec_repair_scrub_interval_seconds,
        breaker_pause_seconds=theirs.ec_repair_breaker_pause_seconds,
    ).validated()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.enabled is not disable
    # and the master the command builds carries it
    ms = cmd_master.build_server(mine)
    assert dataclasses.asdict(ms.repair.cfg) == dataclasses.asdict(want)


# --------------------------------------------------------------- end to end

# deadlines wait on state, never on fixed sleeps; generous for a loaded
# box running six test workers
DEADLINE_S = 90.0
REPAIR_KW = dict(interval_seconds=0.25, backoff_base_seconds=0.2)


def _e2e_imports():
    from test_torch_cluster import VID, _blobs, _Side

    return VID, _blobs, _Side


def _side_class():
    VID, _, _Side = _e2e_imports()

    class Side(_Side):
        """test_torch_cluster's `_Side` with the repair plane on:
        `repair_kw` builds each package's own RepairConfig, and
        `volume_kwargs[kind]` are extra VolumeServer kwargs of that side
        (a device cache)."""

        def __init__(self, kind, base, n, repair_kw, volume_kwargs=None):
            super().__init__(kind, base, n)
            self.repair_kw = repair_kw
            self.volume_kwargs = (volume_kwargs or {}).get(kind)

        async def start(self):
            from seaweedfs_tpu.server import cluster as ref_cluster_mod
            from seaweedfs_tpu.server.volume import VolumeServer as RefVS
            from seaweedfs_tpu.shell import CommandEnv as RefEnv
            from seaweedfs_tpu_torch.server.cluster import LocalCluster
            from seaweedfs_tpu_torch.shell import CommandEnv

            if self.kind == "port":
                self.c = LocalCluster(
                    n_volume_servers=self.n, base_dir=self.base,
                    pulse_seconds=1, ec_backend="torch",
                    volume_kwargs=self.volume_kwargs,
                    master_kwargs={"ec_repair": repair.RepairConfig(
                        **self.repair_kw)})
                await self.c.start()
                self.env = CommandEnv([self.c.master.advertise_url],
                                      out=self.out)
                return
            c = ref_cluster_mod.LocalCluster(
                base_dir=self.base, n_volume_servers=self.n, pulse_seconds=1,
                volume_kwargs=self.volume_kwargs,
                master_kwargs={"ec_repair": jax_repair.RepairConfig(
                    **self.repair_kw)})
            await c.master.start()
            for spec in c._specs:
                vs = RefVS(masters=[c.master.advertise_url], port=0,
                           grpc_port=0, **spec)
                await vs.start()
                c.volume_servers.append(vs)
                await c.wait_for_nodes(len(c.volume_servers))
            self.c = c
            self.env = RefEnv([c.master.advertise_url], out=self.out)

        def held(self, exclude=()):
            locs = self.c.master.topo.lookup_ec_shards(VID)
            if locs is None:
                return set()
            return {sid for sid, nodes in enumerate(locs.locations)
                    if any(n.url not in exclude for n in nodes)}

        async def wait_for(self, pred, what):
            t_end = time.monotonic() + DEADLINE_S
            while time.monotonic() < t_end:
                if pred():
                    return
                await asyncio.sleep(0.1)
            raise AssertionError(
                f"{self.kind}: {what} within {DEADLINE_S} s; repair "
                f"{self.c.master.repair.status()}")

        async def healed(self, exclude=()):
            sched = self.c.master.repair
            await self.wait_for(lambda: len(self.held(exclude)) == 14,
                                "14 shards")
            await self.wait_for(
                lambda: sched.last_time_to_healthy_s is not None
                and not sched._inflight, "convergence")

        def shard_hashes(self, skip=()):
            """shard id -> the set of sha256s of its files on the servers
            not in `skip` (indices)."""
            out = {}
            for (i, name), digest in self.files().items():
                m = re.fullmatch(rf"{VID}\.ec(\d\d)", name)
                if m and i not in skip:
                    out.setdefault(int(m.group(1)), set()).add(digest)
            return out

        async def read_all(self, vs, blobs):
            """(status, body == blob) of a GET of every blob on `vs`."""
            from seaweedfs_tpu_torch.server.http import Client

            vs._ec_locations.clear()
            cl = Client(vs.ip, vs.port)
            out = []
            try:
                for fid, data, _ in blobs:
                    status, _, body = await cl.request("GET", f"/{fid}")
                    out.append((status, body == data))
            finally:
                await cl.close()
            return out

        def totals(self):
            st = self.c.master.repair.status()
            return st["totals"], {v: d["state"]
                                  for v, d in st["volumes"].items()}

    return Side


async def _encode_on_holder(side, spread):
    """ec.encode through the shell (spread over the servers), or the
    holder's own generate + mount of all 14 shards, with repair paused
    (a half-spread census is not a loss); then until the master lists 14."""
    VID, _, _ = _e2e_imports()
    await side.sh("volume.repair.pause")
    if spread:
        await side.sh("lock")
        await side.sh(f"ec.encode -volumeId {VID}")
        await side.sh("unlock")
    else:
        vs0 = side.c.volume_servers[0]
        await side.rpc(vs0, "VolumeMarkReadonly", volume_id=VID)
        await side.rpc(vs0, "VolumeEcShardsGenerate", volume_id=VID)
        await side.rpc(vs0, "VolumeEcShardsMount", volume_id=VID,
                       shard_ids=list(range(14)))
        await side.rpc(vs0, "VolumeUnmount", volume_id=VID)
    await side.settle()
    await side.wait_for(lambda: len(side.held()) == 14, "the encode")


async def _kill_case(side, blobs):
    seen = {}
    await side.start()
    try:
        await side.allocate_and_fill(blobs)
        await _encode_on_holder(side, spread=True)
        seen["before"] = side.shard_hashes()
        seen["placement"] = side.placement()
        holders = [vs for vs in side.c.volume_servers[1:]
                   if vs.store.find_ec_volume(1) is not None]
        victim = min(holders,
                     key=lambda vs: len(vs.store.find_ec_volume(1).shards))
        vi = side.index()[victim.url]
        seen["lost"] = (vi, sorted(victim.store.find_ec_volume(1).shards))
        await side.sh("volume.repair.resume")
        await victim.stop()
        await side.healed(exclude=(victim.url,))
        seen["after"] = side.shard_hashes(skip=(vi,))
        seen["files"] = {k: v for k, v in side.files().items() if k[0] != vi}
        seen["totals"] = side.totals()
        seen["reads"] = await side.read_all(side.c.volume_servers[0], blobs)
    finally:
        await side.stop()
    return seen


def _flip_byte(path: str, offset: int) -> None:
    """Bit-rot one byte of a shard file in place."""
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x5A]))


async def _corrupt_case(side, blobs):
    from seaweedfs_tpu_torch import stats

    seen = {}
    await side.start()
    try:
        await side.allocate_and_fill(blobs)
        await _encode_on_holder(side, spread=False)
        holder = side.c.volume_servers[0]
        if side.kind == "port":  # all 14 resident: the sweep runs B5
            await side.wait_for(
                lambda: holder.store.ec_device_cache.resident_count(1) == 14,
                "all 14 shards resident")
        seen["before"] = side.shard_hashes()
        path = holder.store._ec_base(1, "") + ".ec11"
        await asyncio.to_thread(_flip_byte, path, 12345)
        cache = holder.store.ec_device_cache
        if cache is not None:  # the resident copy carries the flip too
            cache.evict(1, 11)
            cache.put(1, 11, np.fromfile(path, dtype=np.uint8))
        dispatch = stats.VOLUME_SERVER_EC_SCRUB_DISPATCH.labels(
            mode="per_volume")
        scrubs = dispatch.value
        await side.sh("volume.repair.resume")
        sched = side.c.master.repair
        await side.wait_for(lambda: sched.totals["completed"] >= 1,
                            "a completed repair")
        await side.healed()
        await side.wait_for(
            lambda: sched.status()["volumes"].get("1", {}).get("state")
            in ("repaired", "healthy"), "the repaired state")
        seen["scrubbed_resident"] = dispatch.value > scrubs
        seen["after"] = side.shard_hashes()
        seen["files"] = side.files()
        seen["totals"] = side.totals()
        seen["reads"] = await side.read_all(holder, blobs)
    finally:
        await side.stop()
    return seen


async def _stale_case(side, blobs):
    seen = {}
    await side.start()
    try:
        await side.allocate_and_fill(blobs)
        await _encode_on_holder(side, spread=True)
        seen["before"] = side.shard_hashes()
        victim = side.c.volume_servers[1]
        seen["lost"] = sorted(victim.store.find_ec_volume(1).shards)
        await side.sh("volume.repair.resume")
        victim.heartbeat_pause = True
        tel = side.c.master.telemetry
        await side.wait_for(lambda: victim.url in tel.stale_node_urls(),
                            "the victim going stale")
        await side.healed(exclude=(victim.url,))
        victim.heartbeat_pause = False
        await side.settle()
        seen["after"] = side.shard_hashes()
        seen["files"] = side.files()
        seen["totals"] = side.totals()
        seen["reads"] = await side.read_all(side.c.volume_servers[0], blobs)
    finally:
        await side.stop()
    return seen


@pytest.fixture
def small_cache(monkeypatch):
    import functools

    from seaweedfs_tpu_torch.ops import rs_resident
    from seaweedfs_tpu_torch.server import volume as server_volume

    monkeypatch.setattr(
        server_volume.rs_resident, "DeviceShardCache",
        functools.partial(rs_resident.DeviceShardCache,
                          shard_quantum=1 << 20))


@pytest.mark.parametrize("case", ["kill", "corrupt", "stale"])
def test_autonomous_repair_matches_the_reference(case, tmp_path, small_cache):
    _, _blobs, _ = _e2e_imports()
    Side = _side_class()
    blobs = _blobs()
    n = {"kill": 4, "corrupt": 2, "stale": 3}[case]
    repair_kw = dict(REPAIR_KW)
    volume_kwargs = None
    if case == "corrupt":
        repair_kw["scrub_interval_seconds"] = 0.5
        volume_kwargs = {"port": {"ec_device_cache_mb": 256}}
    run = {"kill": _kill_case, "corrupt": _corrupt_case,
           "stale": _stale_case}[case]
    ref = asyncio.run(run(Side("ref", str(tmp_path / "ref"), n, repair_kw),
                          blobs))
    port = asyncio.run(run(Side("port", str(tmp_path / "port"), n,
                                repair_kw, volume_kwargs), blobs))

    # the case did what it says, on the reference side
    assert ref["reads"] == [(200, True)] * len(blobs)
    assert sorted(ref["before"]) == list(range(14))
    assert all(len(v) == 1 for v in ref["before"].values())
    for sid, digests in ref["after"].items():
        assert digests == ref["before"][sid], sid  # healed to the same bytes
    assert sorted(ref["after"]) == list(range(14))
    totals, states = ref["totals"]
    assert totals["completed"] >= 1 and totals["failed"] == 0
    assert states["1"] in ("repaired", "healthy")
    if case == "corrupt":
        # the port's sweep scrubbed the resident shards (B5's plain
        # version); the reference's servers hold no cache
        assert port.pop("scrubbed_resident")
        ref.pop("scrubbed_resident")
    for key in ref:
        assert port[key] == ref[key], key


# -------------------------------------------------------------------- shell


def _mask(text: str, urls: dict) -> list[str]:
    for url, name in urls.items():
        text = text.replace(url, name)
    text = re.sub(r"unix_ms=\d+", "unix_ms=<ms>", text)
    text = re.sub(r'"last_convergence_unix_ms": \d+', '"last_convergence_'
                  'unix_ms": <ms>', text)
    return text.splitlines()


def test_repair_shell_commands_match_the_reference(tmp_path):
    """volume.repair.pause / status / resume / status -json against a live
    master, in both packages."""
    Side = _side_class()
    script = ["volume.repair.pause", "volume.repair.status",
              "volume.repair.resume", "volume.repair.status -json",
              "volume.repair.status"]

    async def go(side):
        await side.start()
        try:
            outs, paused = [], []
            for line in script:
                side.out.seek(0)
                side.out.truncate(0)
                await side.sh(line)
                paused.append(side.c.master.repair.paused)
                urls = {side.c.master.url: "master"}
                outs.append(_mask(side.out.getvalue(), urls))
            return outs, paused
        finally:
            await side.stop()

    ref = asyncio.run(go(Side("ref", str(tmp_path / "ref"), 1,
                              dict(interval_seconds=0.25))))
    port = asyncio.run(go(Side("port", str(tmp_path / "port"), 1,
                               dict(interval_seconds=0.25))))
    assert port == ref
    outs, paused = port
    assert paused == [True, True, False, False, False]
    assert outs[0] == ["repair scheduler paused"]
    assert outs[1][0].startswith("repair PAUSED: queue=0")
    doc = json.loads("\n".join(outs[3]))
    assert doc["enabled"] and not doc["paused"]
    assert doc["totals"] == {"queued": 0, "completed": 0, "failed": 0,
                             "backoff_retry": 0, "backoff_breaker": 0}
    assert outs[4][0].startswith("repair running: queue=0")
