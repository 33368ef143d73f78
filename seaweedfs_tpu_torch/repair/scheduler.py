"""RepairScheduler: the master's autonomous EC repair loop.

The port of seaweedfs_tpu/repair/scheduler.py.  Cluster health
(stats/cluster.py), the parallel rebuild fan-out (shell/command_ec.py)
and the serving QoS breakers exist; this loop acts on them, so a lost
shard is rebuilt (K1 on the rebuilder's card) without an operator.
Each scheduling cycle:

  1. OBSERVE — the topology's EC census (which shards exist where),
     the telemetry plane's stale nodes (heartbeats missed: their
     shards are suspect), and accumulated corrupt-shard scrub verdicts
     (the optional master-driven scrub sweep below, or ec.scrub /
     tests via report_corrupt()).
  2. PLAN — repair/planner.py: volumes one shard from data loss jump
     the queue, then most-shards-missing first; unrecoverable volumes
     are surfaced, not retried into the ground.
  3. SUBORDINATE — while any fresh node reports an open INTERACTIVE
     QoS breaker, the whole cycle defers (counted as
     backoff_total{reason="breaker_open"}): repair is bulk traffic and
     must never compete with an overloaded front door.  Every repair
     RPC is additionally stamped bulk via RPC metadata
     (repair/executor.py).
  4. EXECUTE — at most -ec.repair.maxInflight jobs run concurrently,
     each the shell's gather/rebuild/spread fan-out; a failed job backs
     off exponentially and parks as failed after maxAttempts.

Convergence is measured: the first cycle that observes ANY missing or
corrupt shard starts the clock, and the first cycle after that where
the census is fully redundant again observes wall seconds into
`SeaweedFS_master_repair_time_to_healthy_seconds` — the recovery SLO.
"""
from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from .. import stats
from ..obs import incident as obs_incident
from ..pb import volume_server_pb2
from ..shell.command_env import TopoNode, topo_nodes_from_info
from ..storage.ec import DATA_SHARDS, TOTAL_SHARDS
from ..utils.tasks import spawn_logged
from . import executor, planner
from .config import RepairConfig

log = logging.getLogger("repair")


class RepairScheduler:
    """Master-side repair orchestration (one per MasterServer)."""

    def __init__(self, master, cfg: RepairConfig | None = None) -> None:
        self.master = master
        self.cfg = (cfg or RepairConfig()).validated()
        self.env = executor.RepairEnv()
        # ONE clock for every deadline (backoff, settle, breaker pause):
        # injectable so pinned-clock tests drive tick() without mixing
        # fake nows against real-monotonic stamps
        self.clock = time.monotonic
        self.paused = False
        self._inflight: dict[int, asyncio.Task] = {}
        # vid -> (attempts, monotonic time the next attempt may start)
        self._backoff: dict[int, tuple[int, float]] = {}
        self._parked: dict[int, str] = {}  # vid -> last error (failed)
        # scrub verdicts awaiting repair: vid -> {shard_id -> holder url}
        self._corrupt: dict[int, dict[int, str]] = {}
        # post-repair settle window: a completed job's mounts reach the
        # census via heartbeat deltas, so re-planning the vid before
        # ~2 pulses would launch a duplicate no-op job against the lag
        self._settle_until: dict[int, float] = {}
        # per-volume last-known state for volume.repair.status
        self._verdicts: dict[int, dict[str, Any]] = {}
        self._queue_depth = 0
        self._unhealthy_since: float | None = None
        self._breaker_deferred_until = 0.0
        self._last_scrub = 0.0
        self.last_convergence_unix: float | None = None
        self.last_time_to_healthy_s: float | None = None
        self.totals = {
            "queued": 0, "completed": 0, "failed": 0,
            "backoff_retry": 0, "backoff_breaker": 0,
        }
        self._task: asyncio.Task | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self.cfg.enabled and self.cfg.interval_seconds > 0:
            self._task = spawn_logged(
                self._run_forever(), log, "repair scheduler loop"
            )

    async def stop(self) -> None:
        tasks = list(self._inflight.values())
        if self._task is not None:
            tasks.append(self._task)
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        self._inflight.clear()
        stats.MASTER_REPAIR_INFLIGHT.set(0)

    async def _run_forever(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.interval_seconds)
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — one failed cycle must not
                # end the repair plane; the next cycle re-observes
                log.exception("repair cycle failed")

    # ------------------------------------------------------------- controls

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    def report_corrupt(
        self, vid: int, shard_holders: dict[int, str]
    ) -> None:
        """Feed a corrupt-shard verdict (shard_id -> holder url) into
        the next planning cycle — the scrub sweep's path, and the hook
        tests / `ec.scrub` integrations use directly."""
        self._corrupt.setdefault(vid, {}).update(shard_holders)

    # ------------------------------------------------------------ the cycle

    def _breakers_open(self) -> int:
        return self.master.telemetry.breakers_open()

    async def tick(self, now: float | None = None) -> None:
        """One scheduling cycle (driven by the loop, or directly by
        tests/bench — pin `self.clock` to drive deadlines too)."""
        now = self.clock() if now is None else now
        if self.paused or not self.master.is_leader:
            return
        if now < self._breaker_deferred_until:
            return
        open_breakers = self._breakers_open()
        if open_breakers > 0:
            # repair yields to the front door: defer the WHOLE cycle
            self._breaker_deferred_until = (
                now + self.cfg.breaker_pause_seconds
            )
            self.totals["backoff_breaker"] += 1
            stats.MASTER_REPAIR_BACKOFF.labels(reason="breaker_open").inc()
            obs_incident.record(
                "repair_deferred", reason="breaker_open",
                open_breakers=open_breakers,
            )
            log.info(
                "repair deferred: %d node(s) report an open interactive "
                "QoS breaker", open_breakers,
            )
            return
        nodes = topo_nodes_from_info(self.master.topo.to_info())
        stale = self.master.telemetry.stale_node_urls()
        shard_map, collections = executor.shard_map_from_nodes(
            nodes, prefer_not=stale
        )
        result = planner.plan(
            shard_map,
            collections=collections,
            corrupt={k: dict(v) for k, v in self._corrupt.items()},
            stale_nodes=stale,
            # mesh pods as failure domains: survivors collapsed
            # into one pod escalate to critical in the planner
            node_pods={
                n.url: n.mesh_pod
                for n in self.master.topo.data_nodes()
                if n.mesh_pod
            },
        )
        self._note_plan(result, now)
        if (
            self.cfg.scrub_interval_seconds > 0
            and now - self._last_scrub >= self.cfg.scrub_interval_seconds
        ):
            self._last_scrub = now
            await self._scrub_pass(nodes, shard_map)
        for job in result.jobs:
            if len(self._inflight) >= self.cfg.max_inflight:
                break
            if job.vid in self._inflight or job.vid in self._parked:
                continue
            if now < self._settle_until.get(job.vid, 0.0):
                continue  # census lag, not a fresh degradation
            attempts, next_ok = self._backoff.get(job.vid, (0, 0.0))
            if now < next_ok:
                continue
            self.totals["queued"] += 1
            stats.MASTER_REPAIR_QUEUED.inc()
            obs_incident.record(
                "repair_queued", vid=job.vid, missing=list(job.missing),
                corrupt=sorted(job.corrupt), critical=job.critical,
                reason=job.reason,
            )
            self._inflight[job.vid] = spawn_logged(
                self._run_job(job, nodes, stale),
                log,
                f"repair job for volume {job.vid}",
            )
            stats.MASTER_REPAIR_INFLIGHT.set(len(self._inflight))

    def _note_plan(self, result: planner.PlanResult, now: float) -> None:
        """Record the plan into the status plane and drive the
        time-to-healthy clock."""
        self._queue_depth = len(result.jobs)
        unhealthy = bool(result.jobs or result.unrecoverable)
        if unhealthy and self._unhealthy_since is None:
            self._unhealthy_since = now
        for job in result.jobs + result.unrecoverable:
            # repairability is the PLANNER's verdict (rescue sources
            # count), not a local healthy-count recomputation: a volume
            # under fresh quorum that stale copies can still save is
            # queued work, and the operator must not read it as lost
            unrecoverable = any(
                j.vid == job.vid for j in result.unrecoverable
            )
            attempts, next_ok = self._backoff.get(job.vid, (0, 0.0))
            v = self._verdicts.setdefault(job.vid, {})
            v.update(
                state=(
                    "unrecoverable" if unrecoverable
                    # parked/backoff survive re-planning: the status
                    # plane must keep saying WHY the volume is not
                    # being repaired, not flip back to 'queued'
                    else "failed" if job.vid in self._parked
                    else "repairing" if job.vid in self._inflight
                    else "backoff" if now < next_ok
                    else "queued"
                ),
                missing=list(job.missing),
                corrupt=sorted(job.corrupt),
                healthy_shards=job.healthy,
                critical=job.critical,
                reason=job.reason,
                attempts=attempts,
            )
        for vid in result.healthy_vids:
            if vid in self._verdicts:
                self._verdicts[vid].update(
                    state="healthy", missing=[], corrupt=[],
                    healthy_shards=TOTAL_SHARDS, critical=False,
                )
            self._corrupt.pop(vid, None)
            self._backoff.pop(vid, None)
            self._parked.pop(vid, None)
        if not unhealthy and not self._inflight:
            if self._unhealthy_since is not None:
                dt = now - self._unhealthy_since
                self._unhealthy_since = None
                self.last_time_to_healthy_s = round(dt, 3)
                self.last_convergence_unix = time.time()
                stats.MASTER_REPAIR_TIME_TO_HEALTHY.observe(dt)
                log.info(
                    "cluster re-converged to full redundancy in %.2fs", dt
                )

    async def _run_job(
        self, job: planner.RepairJob, nodes, stale: set[str]
    ) -> None:
        try:
            result = await executor.repair_volume(
                self.env, nodes, job,
                concurrency=self.cfg.fanout_concurrency,
                stale_nodes=stale,
            )
            self.totals["completed"] += 1
            stats.MASTER_REPAIR_COMPLETED.inc()
            self._backoff.pop(job.vid, None)
            self._corrupt.pop(job.vid, None)
            self._settle_until[job.vid] = self.clock() + 2.0 * max(
                1, getattr(self.master, "pulse_seconds", 1)
            )
            self._verdicts.setdefault(job.vid, {}).update(
                state="repaired", last_result=result, last_error=None,
            )
            obs_incident.record(
                "repair_completed", vid=job.vid,
                rebuilt=result.get("rebuilt"),
                rebuilder=result.get("rebuilder"),
            )
            log.info(
                "repaired ec volume %d: rebuilt %s on %s",
                job.vid, result["rebuilt"], result["rebuilder"],
            )
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — the job's failure IS the
            # datum: it drives backoff/parking, never crashes the loop
            attempts = self._backoff.get(job.vid, (0, 0.0))[0] + 1
            delay = min(
                self.cfg.backoff_base_seconds * 2 ** (attempts - 1),
                self.cfg.backoff_max_seconds,
            )
            self._backoff[job.vid] = (attempts, self.clock() + delay)
            self._verdicts.setdefault(job.vid, {}).update(
                state="backoff", attempts=attempts, last_error=str(e),
            )
            obs_incident.record(
                "repair_failed", vid=job.vid, attempts=attempts,
                error=str(e),
                parked=bool(attempts >= self.cfg.max_attempts),
            )
            if attempts >= self.cfg.max_attempts:
                self._parked[job.vid] = str(e)
                self.totals["failed"] += 1
                stats.MASTER_REPAIR_FAILED.inc()
                self._verdicts[job.vid]["state"] = "failed"
                log.error(
                    "repair of volume %d parked after %d attempts: %s",
                    job.vid, attempts, e,
                )
            else:
                self.totals["backoff_retry"] += 1
                stats.MASTER_REPAIR_BACKOFF.labels(reason="retry").inc()
                log.warning(
                    "repair of volume %d failed (attempt %d, retry in "
                    "%.1fs): %s", job.vid, attempts, delay, e,
                )
        finally:
            self._inflight.pop(job.vid, None)
            stats.MASTER_REPAIR_INFLIGHT.set(len(self._inflight))

    # ----------------------------------------------------------- scrub pass

    async def _scrub_pass(
        self,
        nodes: list[TopoNode],
        shard_map: dict[int, dict[int, str]],
    ) -> None:
        """Master-driven parity sweep: for each EC volume with a node
        holding all 14 shards, one VolumeEcShardsVerify (bulk-stamped;
        csrc/scrub.cu when the shards are device-resident, else K1).
        A single mismatching parity row localizes the corruption to
        that parity shard and enters the repair queue; a multi-row
        mismatch (corrupt DATA shard — the parity system can't name it)
        is surfaced loudly for `ec.scrub` diagnosis instead of guessing
        a shard to drop."""
        by_url = {n.url: n for n in nodes}
        for vid, shards in sorted(shard_map.items()):
            if vid in self._corrupt or vid in self._inflight:
                continue
            holders: dict[str, set[int]] = {}
            for sid, url in shards.items():
                holders.setdefault(url, set()).add(sid)
            full = sorted(
                url for url, sids in holders.items()
                if len(sids) == TOTAL_SHARDS and url in by_url
            )
            if not full:
                continue
            node = by_url[full[0]]
            try:
                r = await self.env.volume_stub(
                    node.grpc_address
                ).VolumeEcShardsVerify(
                    volume_server_pb2.VolumeEcShardsVerifyRequest(
                        volume_id=vid
                    ),
                    # bounded: a hung scrub target must not wedge the
                    # whole repair cycle
                    timeout=600.0,
                )
            except Exception as e:  # noqa: BLE001 — a failed scrub is a
                # skipped verdict, not a dead repair plane
                log.warning("scrub of volume %d on %s failed: %s",
                            vid, node.url, e)
                continue
            mism = list(r.parity_mismatch_bytes)
            rows = [i for i, m in enumerate(mism) if m]
            if not rows:
                continue
            if len(rows) == 1:
                sid = DATA_SHARDS + rows[0]
                log.error(
                    "scrub verdict: volume %d parity shard %d corrupt "
                    "on %s (%s mismatch bytes) — scheduling repair",
                    vid, sid, node.url, mism[rows[0]],
                )
                self.report_corrupt(vid, {sid: node.url})
            else:
                self._verdicts.setdefault(vid, {}).update(
                    state="corrupt_unlocalized", scrub_mismatch=mism,
                )
                log.error(
                    "scrub verdict: volume %d has %d mismatching parity "
                    "rows on %s — a DATA shard is corrupt; run ec.scrub "
                    "/ ec.rebuild to diagnose", vid, len(rows), node.url,
                )

    # --------------------------------------------------------------- status

    def unhealthy_for(self) -> float | None:
        """Seconds the cluster has been CONTINUOUSLY under-redundant
        (None when healthy) — the live half of the time-to-healthy SLO:
        the histogram observes episodes after they end, this exposes
        the one still running so obs/slo.py can burn DURING it."""
        if self._unhealthy_since is None:
            return None
        return max(0.0, self.clock() - self._unhealthy_since)

    def status(self) -> dict[str, Any]:
        """The repair block of /cluster/health.json (and
        volume.repair.status)."""
        now = self.clock()
        return {
            "enabled": self.cfg.enabled,
            "paused": self.paused,
            "breaker_deferred": bool(now < self._breaker_deferred_until),
            "queue_depth": self._queue_depth,
            "inflight": sorted(self._inflight),
            "backoff": {
                str(vid): {
                    "attempts": attempts,
                    "next_retry_in_s": round(max(0.0, next_ok - now), 3),
                }
                for vid, (attempts, next_ok) in sorted(
                    self._backoff.items()
                )
            },
            "failed": {str(v): e for v, e in sorted(self._parked.items())},
            "totals": dict(self.totals),
            "volumes": {
                str(vid): dict(v)
                for vid, v in sorted(self._verdicts.items())
            },
            "last_convergence_unix_ms": (
                int(self.last_convergence_unix * 1e3)
                if self.last_convergence_unix is not None else None
            ),
            "last_time_to_healthy_s": self.last_time_to_healthy_s,
        }
