"""cluster.* commands (reference: weed/shell/command_cluster_ps.go etc.).

The port of seaweedfs_tpu/shell/command_cluster.py: cluster.ps and the
raft verbs cluster.raft.{ps,add,remove} over the master's rpcs
(ListClusterNodes, RaftListClusterServers, RaftAddServer,
RaftRemoveServer), and the observability readers cluster.health,
cluster.slo, cluster.timeline, cluster.tail and cluster.incident.dump over
the port's HTTP client (server/http.py), with the reference's output,
and cluster.check (VolumeServerStatus on every volume server).
"""
from __future__ import annotations

import asyncio
import json
import urllib.parse

from ..pb import RpcError, StatusCode, master_pb2, server_address
from ..server.http import fetch, fetch_following
from .commands import command, parse_flags


async def http_get_json(hostport: str, path: str,
                        params: dict | None = None) -> tuple[int, object]:
    """GET http://hostport/path?params -> (status, the JSON body or None
    when the body is not JSON)."""
    if params:
        path += "?" + urllib.parse.urlencode(params)
    status, _, body = await fetch_following(hostport, "GET", path)
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


def fmt_bytes(n: int) -> str:
    # one shell-wide byte formatter (fs.ls uses the same one)
    from .command_fs import _fmt_size

    return _fmt_size(n)


@command("cluster.ps")
async def cmd_cluster_ps(env, args):
    """list masters, filers/clients, and volume servers
    (command_cluster_ps.go)"""
    nodes, limit_mb = await env.collect_topology()
    env.write(f"masters: {', '.join(env.masters)}")
    try:
        resp = await env.master_stub.ListClusterNodes(
            master_pb2.ListClusterNodesRequest()
        )
        by_type: dict[str, list[str]] = {}
        for cn in resp.cluster_nodes:
            by_type.setdefault(cn.client_type, []).append(cn.address)
        for ctype in sorted(by_type):
            env.write(f"{ctype}s: {', '.join(sorted(by_type[ctype]))}")
    except RpcError as e:
        # older masters lack the RPC; anything else is worth surfacing
        if e.code() != StatusCode.UNIMPLEMENTED:
            env.write(f"cluster node listing failed: {e.code()}")
    env.write(f"volume size limit: {limit_mb} MB")
    for n in nodes:
        env.write(
            f"  {n.data_center}/{n.rack}/{n.url}"
            f"  volumes={len(n.volumes)} ec_vols={len(n.ec_shards)}"
            f" free_slots={n.free_slots()}"
        )


@command("cluster.raft.ps")
async def cmd_cluster_raft_ps(env, args):
    """list raft cluster servers (command_cluster_raft_ps.go)"""
    resp = await env.master_stub.RaftListClusterServers(
        master_pb2.RaftListClusterServersRequest()
    )
    env.write(f"term: {resp.term}")
    for s in resp.cluster_servers:
        env.write(f"  {s.id}{'  leader' if s.is_leader else ''}")


@command("cluster.raft.add")
async def cmd_cluster_raft_add(env, args):
    """-id <raft grpc addr> : add a master to the raft cluster
    (command_cluster_raft_add.go).  Start the new master with -peers
    including the existing members, then add it here."""
    env.confirm_is_locked()
    flags = parse_flags(args)
    await env.master_stub.RaftAddServer(
        master_pb2.RaftAddServerRequest(id=flags["id"])
    )
    env.write(f"added raft server {flags['id']}")


@command("cluster.raft.remove")
async def cmd_cluster_raft_remove(env, args):
    """-id <raft grpc addr> : remove a master from the raft cluster
    (command_cluster_raft_remove.go)"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    await env.master_stub.RaftRemoveServer(
        master_pb2.RaftRemoveServerRequest(id=flags["id"])
    )
    env.write(f"removed raft server {flags['id']}")


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


@command("cluster.slo")
async def cmd_cluster_slo(env, args):
    """[-json] : declared SLOs and their live burn state from the
    master's SLO engine — per-objective fast/slow burn rates, budget
    remaining, violation counts, and the latency objective's windowed
    p99 estimate (obs/slo.py)"""
    flags = parse_flags(args)
    health = await fetch_cluster_health(env)
    slo = health.get("slo") or {}
    if "json" in flags:
        env.write(json.dumps(slo, indent=2, sort_keys=True))
        return
    objectives = slo.get("objectives") or {}
    if not slo.get("enabled", False) or not objectives:
        env.write(
            "no SLOs declared (set -obs.slo.readP99Ms / "
            "-obs.slo.errorRatePct / -obs.slo.timeToHealthySeconds / "
            "-obs.slo.breakerOpenPct on the master)"
        )
        return
    env.write(
        f"windows: fast={slo['fast_window_seconds']:.0f}s "
        f"slow={slo['slow_window_seconds']:.0f}s "
        f"threshold={slo['burn_threshold']}"
    )
    env.write(
        "  {:<16} {:>10} {:>10} {:>10} {:>8} {:>10} {:>6}".format(
            "slo", "target", "fast_burn", "slow_burn", "budget",
            "violations", "state"
        )
    )
    for name, o in objectives.items():
        target = o["target"]
        target_s = (
            f"{target * 1e3:.1f}ms" if name == "read_p99"
            else f"{target:.0f}s" if name == "time_to_healthy"
            else f"{target * 100:.2f}%"
        )
        env.write(
            "  {:<16} {:>10} {:>10.2f} {:>10.2f} {:>7.0%} {:>10} {:>6}".format(
                name, target_s, o["fast_burn"], o["slow_burn"],
                o["budget_remaining"], o["violations_total"],
                "BURN" if o["violating"] else "ok",
            )
        )
        if name == "read_p99" and o.get("window_p99_seconds") is not None:
            overflow = o.get("window_p99_overflow", 0)
            env.write(
                f"    window p99 ~{o['window_p99_seconds'] * 1e3:.2f}ms "
                f"(stage {o['stage']}"
                + (f"; +{overflow} overflow — estimate is a floor"
                   if overflow else "")
                + ")"
            )


@command("cluster.timeline")
async def cmd_cluster_timeline(env, args):
    """[-window <seconds>] [-json] : the cluster flight timeline —
    clock-aligned ~1s samples shipped in heartbeats from every node
    (per-workload device busy/dispatch deltas, QoS depth/shed/breaker,
    ingest pressure, resident bytes, slowest-trace exemplars)"""
    flags = parse_flags(args)
    addr = server_address.http_address(env.masters[0])
    params = {}
    if flags.get("window"):
        params["window"] = flags["window"]
    status, doc = await http_get_json(addr, "/debug/timeline", params)
    if status != 200:
        raise ValueError(
            f"http://{addr}/debug/timeline returned HTTP {status}")
    if "json" in flags:
        env.write(json.dumps(doc, indent=2, sort_keys=True))
        return
    samples = doc.get("samples", [])
    env.write(
        f"nodes: {', '.join(doc.get('nodes', [])) or '-'}  "
        f"samples: {len(samples)}"
        + (f"  window: {doc['window_seconds']:.0f}s"
           if doc.get("window_seconds") else "")
    )
    if not samples:
        env.write(
            "no samples yet (nodes ship one per heartbeat; check "
            "-obs.timeline.disable)"
        )
        return
    for row in samples:
        for node, s in sorted(row.get("nodes", {}).items()):
            busy = " ".join(
                f"{wl}={ms:.0f}ms"
                for wl, ms in sorted(s.get("busy_ms", {}).items())
            )
            qos = s.get("qos", {})
            shed = sum(qos.get("shed", {}).values())
            ingest = s.get("ingest", {})
            line = (
                f"  t={row['t']} {node}: "
                + (busy or "idle")
                + (f" qshed={shed}" if shed else "")
                + (f" ingest={fmt_bytes(ingest['bytes'])}"
                   if ingest.get("bytes") else "")
                + (f" backpressure={ingest['backpressure']}"
                   if ingest.get("backpressure") else "")
            )
            ex = s.get("exemplar")
            if ex:
                line += (
                    f"  [slowest {ex['name']} {ex['ms']:.1f}ms "
                    f"trace={ex['trace_id']} span={ex['span']}]"
                )
            env.write(line)


@command("cluster.tail")
async def cmd_cluster_tail(env, args):
    """[-limit N] [-json] : the cluster tail-forensics view — every
    node's /debug/tail (per-route latency stats + critical-path
    composition + pinned slow/incident traces) merged into one route
    table and a worst-offenders list; feed a pin's trace id to
    volume.trace.why for the assembled critical path"""
    flags = parse_flags(args)
    limit = int(flags.get("limit", 10))
    master = server_address.http_address(env.masters[0])
    status, health = await http_get_json(master, "/cluster/health.json")
    if status != 200:
        raise ValueError(
            f"{master}/cluster/health.json returned HTTP {status}")
    targets = [master] + sorted(health.get("nodes", {}))

    async def one(u):
        try:
            st, _, body = await fetch(u, "GET", "/debug/tail", timeout=2.5)
            if st != 200:
                return u, None
            return u, json.loads(body)
        except (OSError, asyncio.TimeoutError, ValueError):
            return u, None

    docs = dict(await asyncio.gather(*(one(u) for u in targets)))
    if "json" in flags:
        env.write(json.dumps(docs, indent=2, sort_keys=True))
        return
    routes: dict = {}
    pins = []
    reached = 0
    for u, doc in sorted(docs.items()):
        if doc is None:
            continue
        reached += 1
        for route, st in doc.get("routes", {}).items():
            agg = routes.setdefault(
                route,
                {"count": 0, "total_s": 0.0, "pinned": 0, "seg_s": {}},
            )
            agg["count"] += st.get("count", 0)
            agg["total_s"] += st.get("total_s", 0.0)
            agg["pinned"] += st.get("pinned", 0)
            for seg, sec in st.get("segments_s", {}).items():
                agg["seg_s"][seg] = agg["seg_s"].get(seg, 0.0) + sec
        for p in doc.get("pinned", []):
            pins.append({**p, "node": u})
    env.write(f"tail view from {reached}/{len(targets)} nodes")
    for route, agg in sorted(
        routes.items(), key=lambda kv: -kv[1]["total_s"]
    ):
        total = agg["total_s"]
        comp = " ".join(
            f"{seg}={sec * 100.0 / total:.0f}%"
            for seg, sec in sorted(
                agg["seg_s"].items(), key=lambda kv: -kv[1]
            )
            if total > 0 and sec > 0
        )
        env.write(
            f"  {route:<24} n={agg['count']:<6} {total:8.3f}s "
            f"pinned={agg['pinned']:<4} {comp}"
        )
    pins.sort(key=lambda p: -p.get("total_ms", 0.0))
    for p in pins[:limit]:
        env.write(
            f"  pin {p['trace_id']} {p.get('name', '?')} "
            f"{p.get('total_ms', 0):.1f}ms [{p.get('reason', '?')}] "
            f"@{p['node']}"
        )
    if not pins:
        env.write(
            "  no pinned traces yet (nothing beat its route's p99 "
            "estimate; check -obs.tail.disable / -obs.tail.floorMs)"
        )


@command("cluster.incident.dump")
async def cmd_cluster_incident_dump(env, args):
    """[-window <seconds>] [-json] : snapshot the cluster's flight
    recorders + trace rings into one incident bundle on the master
    (same fan-out an SLO violation triggers; needs -obs.incident.dir)"""
    flags = parse_flags(args)
    addr = server_address.http_address(env.masters[0])
    path = "/cluster/incident/dump"
    if flags.get("window"):
        path += "?" + urllib.parse.urlencode({"window": flags["window"]})
    status, _, body = await fetch_following(addr, "POST", path)
    payload = json.loads(body)
    if status != 200:
        raise ValueError(
            payload.get("error",
                        f"http://{addr}/cluster/incident/dump returned "
                        f"HTTP {status}")
        )
    if "json" in flags:
        env.write(json.dumps(payload, indent=2, sort_keys=True))
        return
    corr = payload.get("correlation", {})
    env.write(f"incident bundle written: {payload['path']}")
    env.write(
        f"  nodes snapshotted: {len(payload.get('nodes', []))} "
        f"({corr.get('nodes_with_data', 0)} with data)"
    )
    multi = corr.get("trace_ids_multi_node", [])
    env.write(
        f"  trace ids seen on 2+ nodes: {len(multi)}"
        + (f" (e.g. {multi[0]})" if multi else "")
    )
    prof = payload.get("profile")
    if prof:
        env.write(
            "  device profile: "
            + (prof.get("trace_dir") or f"failed ({prof.get('error')})")
            + f" on {prof.get('node')}"
        )


@command("cluster.check")
async def cmd_cluster_check(env, args):
    """sanity-check cluster connectivity (master + every volume server)"""
    from ..pb import volume_server_pb2

    nodes, _ = await env.collect_topology()
    ok = 0
    for n in nodes:
        try:
            await env.volume_stub(n.grpc_address).VolumeServerStatus(
                volume_server_pb2.VolumeServerStatusRequest()
            )
            ok += 1
        except Exception as e:  # noqa: BLE001
            env.write(f"  {n.url}: UNREACHABLE ({e})")
    env.write(f"{ok}/{len(nodes)} volume servers reachable")
