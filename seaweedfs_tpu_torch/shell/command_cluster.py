"""cluster.* commands (reference: weed/shell/command_cluster_ps.go etc.).

The port of the cluster.health half of seaweedfs_tpu/shell/
command_cluster.py: the master's /cluster/health.json, fetched over the
port's HTTP client (server/http.py).  cluster.ps and the raft verbs wait
for ROADMAP A4c-5; cluster.slo, cluster.timeline, cluster.tail and
cluster.incident.dump for A7c.
"""
from __future__ import annotations

import json
import urllib.parse

from ..pb import server_address
from ..server.http import Client
from .commands import command, parse_flags


async def http_get_json(hostport: str, path: str,
                        params: dict | None = None) -> tuple[int, object]:
    """GET http://hostport/path?params -> (status, the JSON body or None
    when the body is not JSON)."""
    host, _, port = hostport.rpartition(":")
    if params:
        path += "?" + urllib.parse.urlencode(params)
    cl = Client(host, int(port))
    try:
        status, _, body = await cl.request("GET", path)
    finally:
        await cl.close()
    try:
        return status, json.loads(body)
    except ValueError:
        return status, None


async def fetch_cluster_health(env) -> dict:
    """GET /cluster/health.json from the master's HTTP port (shared by
    cluster.health, volume.repair.status and the volume.* readers)."""
    addr = server_address.http_address(env.masters[0])
    status, doc = await http_get_json(addr, "/cluster/health.json")
    if status != 200:
        raise ValueError(
            f"http://{addr}/cluster/health.json returned HTTP {status}")
    return doc


def _fmt_size(n: int) -> str:
    # a copy of the reference shell's fs.ls formatter (shell/command_fs.py),
    # which the port has not ported yet
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024


def fmt_bytes(n: int) -> str:
    # one shell-wide byte formatter
    return _fmt_size(n)


@command("cluster.health")
async def cmd_cluster_health(env, args):
    """[-json] : aggregated cluster health from heartbeat telemetry —
    per-node freshness (stale after 2 missed pulses), device HBM
    used/budget/headroom, dispatcher queue/occupancy/shed, EC residency
    map, and merged per-stage p50/p99 latency estimates"""
    flags = parse_flags(args)
    health = await fetch_cluster_health(env)
    if "json" in flags:
        env.write(json.dumps(health, indent=2, sort_keys=True))
        return
    cluster = health["cluster"]
    env.write(
        f"nodes: {cluster['nodes_total']} "
        f"({cluster['nodes_stale']} stale; stale after "
        f"{health['stale_after_seconds']:.1f}s without a heartbeat)"
    )
    env.write(
        "  {:<22} {:>7} {:>6} {:>20} {:>6} {:>9} {:>7} {:>8}".format(
            "node", "age_s", "stale", "hbm used/budget", "queue",
            "inflight", "shed", "overlap"
        )
    )
    for url, n in health["nodes"].items():
        dev = n.get("device", {})
        disp = n.get("dispatcher", {})
        hbm = (
            f"{fmt_bytes(dev['used_bytes'])}/{fmt_bytes(dev['budget_bytes'])}"
            if dev else "-"
        )
        ov = disp.get("overlap_fraction")
        env.write(
            "  {:<22} {:>7.1f} {:>6} {:>20} {:>6} {:>9} {:>7} {:>8}".format(
                url, n["age_seconds"], "YES" if n["stale"] else "no",
                hbm, disp.get("queue_depth", "-"),
                disp.get("inflight", "-"), disp.get("shed_total", "-"),
                # >1 means the double-buffer's staging slots overlapped
                f"{ov:.2f}" if isinstance(ov, (int, float)) else "-",
            )
        )
    residency = cluster.get("ec_volume_residency", {})
    if residency:
        env.write("ec residency (vid: node=shards):")
        for vid, by_node in residency.items():
            env.write(
                f"  {vid}: "
                + " ".join(f"{u}={c}" for u, c in by_node.items())
            )
    stages = cluster.get("stages", {})
    if stages:
        env.write("stage latency estimates (merged digests):")

        def us(v):  # the schema allows null quantiles (empty buckets)
            return "-" if v is None else f"{v * 1e6:.1f}us"

        for stage, s in stages.items():
            env.write(
                f"  {stage:<18} n={s['count']:<8} "
                f"p50={us(s['p50_seconds'])} p99={us(s['p99_seconds'])}"
                + (f" (+{s['overflow']} overflow)" if s["overflow"] else "")
            )
