"""`benchmark` — concurrent cluster write/read benchmark
(reference: weed/command/benchmark.go:26-196 — `weed benchmark`,
defaults -c=16 -n=1048576 -size=1024; prints throughput + latency
percentiles in the README.md:533-583 format).

The port of seaweedfs_tpu/command/benchmark.py: the same flags, report and
percentiles, with the reference's aiohttp sessions replaced by keep-alive
connections of server/http.py's client, pooled per volume server.
"""
from __future__ import annotations

import asyncio
import os
import time
import urllib.parse

NAME = "benchmark"
HELP = "benchmark concurrent writes/reads against a running cluster"


def add_args(p) -> None:
    p.add_argument("-master", dest="master", default="127.0.0.1:9333")
    p.add_argument("-c", dest="concurrency", type=int, default=16)
    p.add_argument("-n", dest="count", type=int, default=4096)
    p.add_argument("-size", dest="size", type=int, default=1024)
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="000")
    p.add_argument("-noread", dest="no_read", action="store_true")


def _percentiles(lats: list[float]) -> dict:
    if not lats:  # all requests failed: report zeros, not a traceback
        return {k: 0.0 for k in ("avg", "p50", "p95", "p99", "max")}
    lats = sorted(lats)

    def at(p):
        return lats[min(len(lats) - 1, int(p / 100 * len(lats)))] * 1000

    return {
        "avg": sum(lats) / len(lats) * 1000,
        "p50": at(50),
        "p95": at(95),
        "p99": at(99),
        "max": lats[-1] * 1000,
    }


def _report(title: str, n_ok: int, n_err: int, total_bytes: int, dt: float, lats):
    p = _percentiles(lats)
    dt = dt or 1e-9
    print(f"\n{title}:")
    print(f"Completed requests:      {n_ok}")
    print(f"Failed requests:         {n_err}")
    print(f"Requests per second:     {n_ok / dt:.2f}")
    print(f"Transfer rate:           {total_bytes / dt / 1024:.2f} KB/s")
    print(
        f"Latency ms (avg/p50/p95/p99/max): "
        f"{p['avg']:.1f} / {p['p50']:.1f} / {p['p95']:.1f} / "
        f"{p['p99']:.1f} / {p['max']:.1f}"
    )


class _Pool:
    """Idle keep-alive connections per "host:port", as an HTTP client
    session keeps them: a request takes one (or opens one) and gives it
    back when it is done."""

    def __init__(self):
        self._idle: dict[str, list] = {}

    def take(self, hostport: str):
        from ..server.http import Client

        idle = self._idle.setdefault(hostport, [])
        if idle:
            return idle.pop()
        host, _, port = hostport.rpartition(":")
        return Client(host, int(port))

    def give(self, hostport: str, client) -> None:
        self._idle[hostport].append(client)

    async def close(self) -> None:
        for idle in self._idle.values():
            for c in idle:
                await c.close()
        self._idle.clear()


async def run(args) -> None:
    from ..operation import assign, lookup_file_id, upload_data

    fids: list[str] = []
    lats: list[float] = []
    errors = 0
    payload = os.urandom(args.size)
    sem = asyncio.Semaphore(args.concurrency)
    pool = _Pool()

    async def write_one(i: int):
        nonlocal errors
        async with sem:
            t0 = time.perf_counter()
            try:
                a = await assign(
                    args.master,
                    collection=args.collection,
                    replication=args.replication,
                )
                client = pool.take(a.url)
                try:
                    await upload_data(
                        f"http://{a.url}/{a.fid}",
                        payload,
                        f"bench{i}",
                        jwt=a.auth,
                        client=client,
                    )
                finally:
                    pool.give(a.url, client)
                fids.append(a.fid)
                lats.append(time.perf_counter() - t0)
            except Exception:  # noqa: BLE001
                errors += 1

    try:
        t0 = time.perf_counter()
        await asyncio.gather(*(write_one(i) for i in range(args.count)))
        dt = time.perf_counter() - t0
        _report("Write Benchmark", len(fids), errors, len(fids) * args.size,
                dt, lats)

        if args.no_read or not fids:
            return

        read_lats: list[float] = []
        read_errors = 0

        async def read_one(fid: str):
            nonlocal read_errors
            async with sem:
                t0 = time.perf_counter()
                try:
                    urls = await lookup_file_id(args.master, fid)
                    parts = urllib.parse.urlsplit(urls[0])
                    client = pool.take(parts.netloc)
                    try:
                        status, _, body = await client.request(
                            "GET", parts.path)
                    except BaseException:
                        await client.close()
                        raise
                    finally:
                        pool.give(parts.netloc, client)
                    if status != 200 or len(body) != args.size:
                        read_errors += 1
                        return
                    read_lats.append(time.perf_counter() - t0)
                except Exception:  # noqa: BLE001
                    read_errors += 1

        t0 = time.perf_counter()
        await asyncio.gather(*(read_one(f) for f in fids))
        dt = time.perf_counter() - t0
        _report(
            "Read Benchmark", len(read_lats), read_errors,
            len(read_lats) * args.size, dt, read_lats,
        )
    finally:
        await pool.close()
