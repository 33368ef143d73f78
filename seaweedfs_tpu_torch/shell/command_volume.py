"""volume.* commands: vacuum, replica placement, and the readers of the
device planes' telemetry.

The port of seaweedfs_tpu/shell/command_volume.py's volume.vacuum,
volume.vacuum.disable, volume.vacuum.enable (the master's vacuum rpcs),
volume.configure.replication (VolumeConfigure on every holder), and its
device-plane half: volume.device.status [-hot], volume.device.attribution,
volume.tier.status, volume.ingest.status, volume.trace and
volume.trace.why.  The readers read the master's /cluster/health.json and
each volume server's /debug/device/hot, /debug/device/attribution,
/debug/traces and /debug/critpath over the port's HTTP client;
volume.trace.why asks the master's /debug/critpath (the cross-node
assembly) unless -node names one server.  The other volume.* commands
wait for ROADMAP A4c-6.
"""
from __future__ import annotations

import json

from ..pb import master_pb2, volume_server_pb2
from .command_cluster import fetch_cluster_health, fmt_bytes, http_get_json
from .commands import command, parse_flags


@command("volume.vacuum")
async def cmd_volume_vacuum(env, args):
    """-garbageThreshold 0.3 [-volumeId N] : trigger a master vacuum pass"""
    flags = parse_flags(args)
    await env.master_stub.VacuumVolume(
        master_pb2.VacuumVolumeRequest(
            garbage_threshold=float(flags.get("garbageThreshold", 0.3)),
            volume_id=int(flags.get("volumeId", 0)),
        )
    )
    env.write("vacuum pass requested")


@command("volume.vacuum.disable")
async def cmd_volume_vacuum_disable(env, args):
    """pause master vacuum (periodic + manual) — command_volume_vacuum_disable.go"""
    await env.master_stub.DisableVacuum(master_pb2.DisableVacuumRequest())
    env.write("vacuum disabled")


@command("volume.vacuum.enable")
async def cmd_volume_vacuum_enable(env, args):
    """resume master vacuum — command_volume_vacuum_enable.go"""
    await env.master_stub.EnableVacuum(master_pb2.EnableVacuumRequest())
    env.write("vacuum enabled")


@command("volume.configure.replication")
async def cmd_volume_configure_replication(env, args):
    """-volumeId N -replication XYZ : change a volume's replica placement
    on every holder (command_volume_configure_replication.go); persists
    into the on-disk superblock"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    replication = flags["replication"]
    nodes, _ = await env.collect_topology()
    holders = [n for n in nodes if any(v["id"] == vid for v in n.volumes)]
    if not holders:
        raise ValueError(f"volume {vid} not found in topology")
    failures = []
    for node in holders:
        resp = await env.volume_stub(node.grpc_address).VolumeConfigure(
            volume_server_pb2.VolumeConfigureRequest(
                volume_id=vid, replication=replication
            )
        )
        if resp.error:
            env.write(f"{node.url}: {resp.error}")
            failures.append(node.url)
        else:
            env.write(f"{node.url}: volume {vid} -> replication {replication}")
    if failures:
        # a partial application leaves replicas with divergent superblocks
        # — that must fail loudly, not read as success
        raise ValueError(
            f"replication change failed on {', '.join(failures)}; "
            f"replicas may now disagree"
        )


@command("volume.device.status")
async def cmd_volume_device_status(env, args):
    """[-node <host:port>] [-hot [N]] : per-node device shard-cache
    status from the master's telemetry plane — HBM used/budget/
    headroom (aggregate AND one row per mesh device under the
    lane-sharded layout), resident shard counts per EC volume, compile-cache
    hit/miss, evictions, pin claims.  -hot additionally fetches each
    node's /debug/device/hot: the per-call-shape dispatch counters and
    latency EWMAs, hottest first — "what shape is the device actually
    spending its time in" as one command"""
    flags = parse_flags(args)
    want = flags.get("node") or flags.get("")
    health = await fetch_cluster_health(env)
    nodes = health["nodes"]
    if want:
        if want not in nodes:
            raise ValueError(
                f"node {want!r} not in telemetry plane (known: "
                f"{', '.join(sorted(nodes)) or 'none'})"
            )
        nodes = {want: nodes[want]}
    hot_limit = 0
    if "hot" in flags:
        hot_limit = 10 if flags["hot"] == "true" else int(flags["hot"])
    for url, n in nodes.items():
        state = "STALE" if n["stale"] else "fresh"
        dev = n.get("device")
        if not dev:
            env.write(
                f"{url} [{state}] no device telemetry "
                "(cache disabled or pre-telemetry server)"
            )
            continue
        env.write(
            f"{url} [{state}] hbm {fmt_bytes(dev['used_bytes'])}"
            f"/{fmt_bytes(dev['budget_bytes'])} "
            f"(headroom {fmt_bytes(dev['headroom_bytes'])}) "
            f"shards={dev['resident_shards']} "
            f"evictions={dev['evictions']} pin_claims={dev['pin_claims']} "
            f"compile hit/miss={dev['compile_hits']}/{dev['compile_misses']} "
            # the reference's compile-cache columns: the port compiles
            # nothing per shape, so they read 0/0 and OFF (ROADMAP §C)
            f"compile_cache="
            f"{'on' if dev.get('compile_cache_enabled') else 'OFF'}"
        )
        # per-device breakdown (mesh residency): a lopsided mesh —
        # whole-pins crowding one chip while the lane-sharded volumes
        # spread evenly — shows as one row per device, not an aggregate
        for row in dev.get("per_device", []):
            env.write(
                f"  device {row['device']}: "
                f"{fmt_bytes(row['used_bytes'])}"
                f"/{fmt_bytes(row['budget_bytes'])} "
                f"(headroom {fmt_bytes(row['headroom_bytes'])})"
            )
        for vid, count in dev["resident_shards_by_volume"].items():
            env.write(f"  ec volume {vid}: {count} resident shards")
        if hot_limit and not n["stale"]:
            await _print_hot_shapes(env, url, hot_limit)


@command("volume.device.attribution")
async def cmd_volume_device_attribution(env, args):
    """[-node <host:port>] [-json] : per-workload device-time
    attribution from each node's ledger (/debug/device/attribution) —
    busy seconds, dispatches, bytes, and queue wait per workload class
    (serving_interactive/serving_bulk/ingest/scrub/repair/warmup/bulk),
    with the per-device-label breakdown.  "Who is burning the
    accelerator" as one command"""
    flags = parse_flags(args)
    want = flags.get("node") or flags.get("")
    health = await fetch_cluster_health(env)
    urls = sorted(health["nodes"])
    if want:
        if want not in urls:
            raise ValueError(
                f"node {want!r} not in telemetry plane (known: "
                f"{', '.join(urls) or 'none'})"
            )
        urls = [want]
    docs = []
    for url in urls:
        try:
            status, doc = await http_get_json(
                url, "/debug/device/attribution")
            if status != 200:
                raise ValueError(f"HTTP {status}")
            docs.append(doc)
        except Exception as e:  # noqa: BLE001 — one unreachable node
            # must not kill the whole sweep
            env.write(f"{url}: unavailable ({e})")
    if "json" in flags:
        env.write(json.dumps(docs, indent=2, sort_keys=True))
        return
    for doc in docs:
        total = doc.get("total_busy_seconds", 0.0)
        env.write(
            f"{doc['node']} device busy {total:.3f}s"
            + ("" if doc.get("enabled", True)
               else "  [ledger DISABLED: -obs.ledger.disable]")
        )
        workloads = doc.get("workloads", {})
        if not workloads:
            env.write("  nothing dispatched yet")
            continue
        env.write(
            "  {:<20} {:>10} {:>10} {:>8} {:>10} {:>10}".format(
                "workload", "busy_s", "share", "calls", "bytes", "qwait_s"
            )
        )
        for wl, row in sorted(
            workloads.items(), key=lambda kv: -kv[1]["busy_s"]
        ):
            share = row["busy_s"] / total if total > 0 else 0.0
            env.write(
                "  {:<20} {:>10.3f} {:>9.1%} {:>8} {:>10} {:>10.3f}".format(
                    wl, row["busy_s"], share, row["dispatches"],
                    fmt_bytes(row["bytes"]), row["queue_wait_s"],
                )
            )
            devices = row.get("devices", {})
            if len(devices) > 1:
                for dev, d in sorted(devices.items()):
                    env.write(
                        f"    device {dev}: {d['busy_s']:.3f}s "
                        f"calls={d['dispatches']} "
                        f"bytes={fmt_bytes(d['bytes'])}"
                    )


async def _print_hot_shapes(env, url: str, limit: int) -> None:
    """Fetch + print one node's /debug/device/hot view (the
    rs_resident per-call-shape dispatch counters/latency EWMAs)."""
    try:
        status, payload = await http_get_json(
            url, "/debug/device/hot", {"limit": str(limit)})
        if status != 200:
            raise ValueError(f"HTTP {status}")
    except Exception as e:  # noqa: BLE001 — one unreachable node must
        # not kill the whole status sweep
        env.write(f"  hot shapes: unavailable ({e})")
        return
    shapes = payload.get("shapes", [])
    aot = payload.get("aot", {})
    env.write(
        f"  hot shapes (aot compiled={aot.get('compiled', 0)} "
        f"pending={aot.get('pending', 0)} failed={aot.get('failed', 0)}):"
    )
    if not shapes:
        env.write("    none dispatched yet")
    for s in shapes:
        env.write(
            f"    {s['kernel']}{' g' + str(s['groups']) if s['groups'] > 1 else ''}"
            f" fetch={s['fetch']} tile={s['tile']}"
            f" count={s['count_bucket']}: {s['dispatches']} dispatches,"
            f" ewma {s['ewma_ms']}ms,"
            f" last {s['last_dispatch_age_s']}s ago"
        )


@command("volume.tier.status")
async def cmd_volume_tier_status(env, args):
    """[-node <host:port>] : per-node residency-ladder view from the
    master's telemetry plane — EC volume census by tier (hbm / host RAM
    / disk), cumulative promotion/demotion counters (the thrash
    signal), and host-RAM warm-tier occupancy"""
    flags = parse_flags(args)
    want = flags.get("node") or flags.get("")
    health = await fetch_cluster_health(env)
    nodes = health["nodes"]
    if want:
        if want not in nodes:
            raise ValueError(
                f"node {want!r} not in telemetry plane (known: "
                f"{', '.join(sorted(nodes)) or 'none'})"
            )
        nodes = {want: nodes[want]}
    for url, n in nodes.items():
        state = "STALE" if n["stale"] else "fresh"
        tiers = n.get("tiering")
        if not tiers:
            env.write(
                f"{url} [{state}] no tiering telemetry "
                "(ladder disabled or pre-telemetry server)"
            )
            continue
        env.write(
            f"{url} [{state}] hbm={tiers['hbm_volumes']} "
            f"host={tiers['host_volumes']} volumes; "
            f"host tier {fmt_bytes(tiers['host_bytes'])}; "
            # promotions vs demotions: a demotion rate chasing the
            # promotion rate means the ladder is thrashing — widen
            # -ec.tier.promoteRatio / -ec.tier.minResidencySeconds
            f"promotions={tiers['promotions_total']} "
            f"demotions={tiers['demotions_total']}"
        )
    cluster = health.get("cluster", {})
    tv = cluster.get("tier_volumes")
    if tv:
        env.write(
            f"cluster: hbm={tv['hbm']} host={tv['host']} volumes, "
            f"host tier {fmt_bytes(cluster.get('tier_host_bytes', 0))}, "
            f"promotions={cluster.get('tier_promotions_total', 0)} "
            f"demotions={cluster.get('tier_demotions_total', 0)}"
        )


@command("volume.ingest.status")
async def cmd_volume_ingest_status(env, args):
    """[-node <host:port>] : per-node streaming-ingest view from the
    master's telemetry plane — write bytes accepted, stripe rows
    encoded online (device vs host codec), writes shed at the door,
    group-commit fsyncs, live per-volume pipelines, and seals that
    skipped the offline encode"""
    flags = parse_flags(args)
    want = flags.get("node") or flags.get("")
    health = await fetch_cluster_health(env)
    nodes = health["nodes"]
    if want:
        if want not in nodes:
            raise ValueError(
                f"node {want!r} not in telemetry plane (known: "
                f"{', '.join(sorted(nodes)) or 'none'})"
            )
        nodes = {want: nodes[want]}
    for url, n in nodes.items():
        state = "STALE" if n["stale"] else "fresh"
        ing = n.get("ingest")
        if not ing:
            env.write(
                f"{url} [{state}] no ingest telemetry "
                "(plane disabled or pre-telemetry server)"
            )
            continue
        env.write(
            f"{url} [{state}] {fmt_bytes(ing['bytes_total'])} written; "
            f"rows device={ing['rows_device']} host={ing['rows_host']}; "
            # every shed here was refused AT THE DOOR — the client got a
            # fast 429/504 instead of a doomed slow upload
            f"shed={ing['shed_total']} fsyncs={ing['fsyncs_total']} "
            f"pipelines={ing['active_pipelines']} "
            f"streamed_seals={ing['streamed_seals']}"
        )
    ci = health.get("cluster", {}).get("ingest")
    if ci:
        env.write(
            f"cluster: {fmt_bytes(ci['bytes_total'])} written, rows "
            f"device={ci['rows_device']} host={ci['rows_host']}, "
            f"shed={ci['shed_total']} fsyncs={ci['fsyncs_total']} "
            f"pipelines={ci['active_pipelines']} "
            f"streamed_seals={ci['streamed_seals']}"
        )


@command("volume.trace")
async def cmd_volume_trace(env, args):
    """-node <host:port> [-limit N] [-id <trace_id>] [-since <seconds>]
    : fetch /debug/traces from a running volume server and pretty-print
    the recent request traces (trace id, per-span stage durations,
    annotations) newest-first; -id fetches one trace instead of the
    ring, -since only traces still active in the last N seconds (the
    burn window an incident bundle covers; a long-stalled request
    finishing inside it counts) — both filter before the limit"""
    flags = parse_flags(args)
    node = flags.get("node") or flags.get("")
    if not node:
        raise ValueError(
            "volume.trace -node <host:port(http)> [-limit N] "
            "[-id <trace_id>] [-since <seconds>]"
        )
    limit = int(flags.get("limit", 10))
    params = {"limit": str(limit)}
    if flags.get("id"):
        params["id"] = flags["id"]
    if flags.get("since"):
        params["since"] = flags["since"]
    status, payload = await http_get_json(node, "/debug/traces", params)
    if status == 404 and flags.get("id"):
        # the endpoint's JSON error body carries the contract wording;
        # keep the shell line identical either way
        env.write(
            f"{node}: trace {flags['id']!r} not found "
            "(evicted or never traced)"
        )
        return
    if status != 200:
        raise ValueError(f"{node}/debug/traces returned HTTP {status}")
    traces = payload.get("traces", [])
    if not traces:
        env.write(f"{node}: no traces recorded")
        return
    for t in traces:
        env.write(
            f"trace {t['trace_id']} [{t['role']}] {t['name']} "
            f"{t['duration_us'] / 1000:.2f}ms status={t.get('status', '')}"
        )
        for sp in t.get("spans", []):
            ann = " ".join(
                f"{k}={v}" for k, v in (sp.get("annotations") or {}).items()
            )
            env.write(
                f"  +{sp['offset_us']:>8}us {sp['duration_us']:>8}us "
                f"{sp['name']}{'  ' + ann if ann else ''}"
            )


@command("volume.trace.why")
async def cmd_volume_trace_why(env, args):
    """-id <trace_id> [-node <host:port>] [-json] : critical-path
    attribution for one request — fetch /debug/critpath?id= (from the
    master by default, which stitches the cross-node DAG from every
    node's ring + tail pins and reconciles clocks; -node asks one
    server for its local view instead) and print where the
    client-visible wall time went: queue_wait / device_execute /
    host_reconstruct / disk / network_gap / untraced"""
    from ..pb import server_address

    flags = parse_flags(args)
    trace_id = flags.get("id") or flags.get("")
    if not trace_id:
        raise ValueError(
            "volume.trace.why -id <trace_id> [-node <host:port(http)>] "
            "[-json]"
        )
    node = flags.get("node") or server_address.http_address(env.masters[0])
    url = f"http://{node}/debug/critpath"
    status, doc = await http_get_json(node, "/debug/critpath",
                                      {"id": trace_id})
    if status == 404:
        env.write(
            f"{node}: trace {trace_id!r} not found "
            "(evicted or never traced)"
        )
        return
    if status != 200:
        raise ValueError(f"{url} returned HTTP {status}")
    if "json" in flags:
        env.write(json.dumps(doc, indent=2, sort_keys=True))
        return
    total_us = doc.get("total_us", 0)
    env.write(
        f"trace {doc['trace_id']} {doc.get('name', '?')} "
        f"(route {doc.get('route', '?')}) "
        f"{total_us / 1000:.2f}ms status={doc.get('status', '')}"
    )
    parts = ", ".join(
        f"{p['server']}[{p['role']}]" for p in doc.get("participants", [])
    )
    env.write(
        f"participants: {parts or '-'}"
        + (f"  coverage: {doc['coverage_pct']:.1f}%"
           if doc.get("coverage_pct") is not None else "")
    )
    segs = doc.get("segments_us", {})
    pcts = doc.get("segments_pct", {})
    for seg, us in segs.items():
        bar = "#" * int(round((pcts.get(seg, 0.0)) / 5))
        env.write(
            f"  {seg:<16} {us:>10}us {pcts.get(seg, 0.0):>6.2f}%  {bar}"
        )
    for u, err in sorted(doc.get("fetch_errors", {}).items()):
        env.write(f"  (fan-out {u}: {err})")

    def _walk(n, depth):
        env.write(
            f"  {'  ' * depth}[{n.get('server', '?')}] {n.get('name', '?')} "
            f"+{n.get('offset_us', 0)}us {n.get('duration_us', 0)}us"
        )
        for c in n.get("children", []):
            _walk(c, depth + 1)

    tree = doc.get("tree")
    if tree:
        _walk(tree, 0)
