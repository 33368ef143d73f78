"""volume.repair.* commands: the self-healing repair plane's operator
surface, a copy of seaweedfs_tpu/shell/command_repair.py (status reads
the master's /cluster/health.json; pause/resume are master RPCs)."""
from __future__ import annotations

import json

from ..pb import master_pb2
from .commands import command, parse_flags


@command("volume.repair.status")
async def cmd_volume_repair_status(env, args):
    """[-json] : the master's autonomous EC repair plane — queue depth,
    in-flight jobs, per-volume verdicts (missing/corrupt shards,
    attempts, state), backoff/parked volumes, and the last convergence
    (time-to-healthy); -json dumps the raw repair block"""
    from .command_cluster import fetch_cluster_health

    flags = parse_flags(args)
    health = await fetch_cluster_health(env)
    repair = health.get("repair")
    if not repair:
        env.write(
            "no repair plane in cluster health (an older master?)"
        )
        return
    if "json" in flags:
        env.write(json.dumps(repair, indent=2, sort_keys=True))
        return
    state = "PAUSED" if repair["paused"] else (
        "deferred (breaker open)" if repair["breaker_deferred"]
        else "running" if repair["enabled"] else "DISABLED"
    )
    totals = repair["totals"]
    env.write(
        f"repair {state}: queue={repair['queue_depth']} "
        f"inflight={repair['inflight']} "
        f"completed={totals['completed']} failed={totals['failed']} "
        f"backoff(retry/breaker)={totals['backoff_retry']}"
        f"/{totals['backoff_breaker']}"
    )
    if repair.get("last_time_to_healthy_s") is not None:
        env.write(
            f"last convergence: {repair['last_time_to_healthy_s']}s "
            f"to healthy at unix_ms={repair['last_convergence_unix_ms']}"
        )
    for vid, v in sorted(
        repair.get("volumes", {}).items(), key=lambda kv: int(kv[0])
    ):
        missing = v.get("missing") or []
        line = (
            f"  ec volume {vid}: {v.get('state', '?')}"
            f" missing={missing}" if missing
            else f"  ec volume {vid}: {v.get('state', '?')}"
        )
        if v.get("corrupt"):
            line += f" corrupt={v['corrupt']}"
        if v.get("attempts"):
            line += f" attempts={v['attempts']}"
        if v.get("last_error"):
            line += f" last_error={v['last_error']!r}"
        env.write(line)
    for vid, b in sorted(
        repair.get("backoff", {}).items(), key=lambda kv: int(kv[0])
    ):
        env.write(
            f"  ec volume {vid}: backoff attempts={b['attempts']} "
            f"next retry in {b['next_retry_in_s']}s"
        )
    for vid, err in sorted(
        repair.get("failed", {}).items(), key=lambda kv: int(kv[0])
    ):
        env.write(f"  ec volume {vid}: PARKED after max attempts: {err}")


@command("volume.repair.pause")
async def cmd_volume_repair_pause(env, args):
    """pause the autonomous EC repair scheduler (planned maintenance);
    detection and status stay live, no new repair jobs start"""
    await env.master_stub.PauseRepair(master_pb2.PauseRepairRequest())
    env.write("repair scheduler paused")


@command("volume.repair.resume")
async def cmd_volume_repair_resume(env, args):
    """resume the autonomous EC repair scheduler after a pause"""
    await env.master_stub.ResumeRepair(master_pb2.ResumeRepairRequest())
    env.write("repair scheduler resumed")
