"""FilerServer: the namespace tier's HTTP + RPC host.

The port of seaweedfs_tpu/server/filer.py (reference:
weed/server/filer_server.go, filer_server_handlers_read.go,
filer_server_handlers_write_autochunk.go, filer_grpc_server.go,
filer_grpc_server_rename.go, filer_grpc_server_sub_meta.go) on the port's
own planes: HTTP on server/http.py's `HTTPServer` and client, RPCs on
pb/rpc.py, the master subscription on wdclient/.

One asyncio process:
  - the data plane on every path: POST/PUT auto-chunking uploads (the body
    is read off the socket `maxMB` at a time, raw or as the first part of
    a multipart form, and each chunk assigned and uploaded to volume
    servers), GET/HEAD streamed reads with Range and conditional GETs and
    directory listings, DELETE with recursive;
  - the `SeaweedFiler` service: entry CRUD, AtomicRenameEntry,
    AssignVolume proxy, metadata subscription (replay + live tail), KV;
  - a MasterClient subscription for vid -> location lookups and leader
    tracking.

The filer never touches the device and never imports torch: every file it
serves is needles on volume servers, which answer a chunk of an
EC-encoded volume with a lost shard through their degraded read.
"""
from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import logging
import os
import time
import urllib.parse

from ..filer import (
    Attr,
    Entry,
    Filer,
    FilerError,
    MODE_DIR,
    MemoryStore,
    NotEmptyError,
    NotFoundError,
    etag_of_chunks,
    new_full_path,
    view_from_chunks,
)
from .. import obs, stats
from ..utils import faultpolicy
from ..operation.assign import assign as assign_rpc
from ..operation.delete import delete_files
from ..operation.upload import upload_data
from ..pb import (
    RpcServer,
    StatusCode,
    Stub,
    channel,
    filer_pb2,
    master_pb2,
    server_address,
)
from ..security import guard as guard_mod
from ..wdclient import MasterClient
from .http import (
    Client,
    HTTPError,
    HTTPServer,
    Request,
    Response,
    StreamResponse,
)

log = logging.getLogger("filer")

# per-chunk-fetch fallback timeout when the request carries no deadline
# budget (the front door stamps one by default; this bounds direct
# callers) — generous for a 4MB chunk off a loaded peer, finite always
_CHUNK_FETCH_TIMEOUT_S = 30.0
# idle keep-alive connections kept per volume server for chunk fetches
_POOL_PER_SERVER = 32


def _json(obj, status: int = 200, headers=None) -> Response:
    return Response(status, json.dumps(obj).encode(), headers=headers,
                    content_type="application/json; charset=utf-8")


class _ClientPool:
    """Keep-alive connections to the volume servers, a few per server
    (the reference's one aiohttp session pools them the same way)."""

    def __init__(self):
        self._idle: dict[str, list[Client]] = {}

    async def get(self, hostport: str, path: str, headers: dict,
                  timeout: float | None) -> tuple[int, bytes]:
        idle = self._idle.setdefault(hostport, [])
        if idle:
            c = idle.pop()
        else:
            host, _, port = hostport.rpartition(":")
            c = Client(host, int(port))
        try:
            status, _, body = await asyncio.wait_for(
                c.request("GET", path, headers=headers), timeout)
        except BaseException:
            await c.close()
            raise
        if len(idle) < _POOL_PER_SERVER:
            idle.append(c)
        else:
            await c.close()
        return status, body

    async def close(self) -> None:
        for conns in self._idle.values():
            for c in conns:
                await c.close()
        self._idle.clear()


class FilerServer:
    def __init__(
        self,
        masters: list[str],
        store=None,
        ip: str = "127.0.0.1",
        port: int = 8888,
        grpc_port: int = 0,
        max_mb: int = 4,
        collection: str = "",
        replication: str = "",
        data_center: str = "",
        rack: str = "",
        meta_log_path: str | None = None,
        save_inside_limit: int = 0,  # inline files <= this many bytes in metadata
        dir_buckets: str = "/buckets",
        metrics_port: int | None = 0,  # 0 = auto-assign; None = disabled
        cipher: bool = False,  # AES-GCM encrypt chunks at rest (util/cipher.go)
        compress_chunks: bool = True,  # compress compressible chunks (util/compression.go)
        chunk_cache_mb: int = 64,
        chunk_cache_dir: str | None = None,
        upload_parallelism: int = 4,  # concurrent chunk uploads per file
        white_list: list[str] | None = None,  # [access] white_list guard
        metrics_address: str = "",  # pushgateway host:port (ref -metrics.address)
        metrics_interval_seconds: int = 15,  # ref -metrics.intervalSeconds
    ):
        if cipher:
            from ..utils.cipher import require

            require()  # refuse at start, not on the first write
        self.metrics_address = metrics_address
        self.metrics_interval_seconds = metrics_interval_seconds
        self._metrics_push_task = None
        self.masters = masters
        self.guard = guard_mod.Guard(white_list)
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port or (port + 10000 if port else 0)
        self._grpc_port_given = bool(grpc_port)
        self.max_mb = max_mb
        self.collection = collection
        self.replication = replication
        self.data_center = data_center
        self.rack = rack
        self.save_inside_limit = save_inside_limit
        self.dir_buckets = dir_buckets
        self.metrics_port = metrics_port
        self.cipher = cipher
        self.compress_chunks = compress_chunks
        self.upload_parallelism = max(1, upload_parallelism)
        from ..filer.chunk_cache import ChunkCache

        self.chunk_cache = ChunkCache(
            mem_limit_bytes=chunk_cache_mb * 1024 * 1024,
            disk_dir=chunk_cache_dir,
        )
        self.filer = Filer(
            store if store is not None else MemoryStore(),
            delete_file_ids_fn=self._delete_file_ids,
            meta_log_path=meta_log_path,
            fetch_manifest_fn=lambda c: self._fetch_chunk_decoded(
                c.file_id, bytes(c.cipher_key), c.is_compressed
            ),
        )
        self.master_client = MasterClient(
            masters,
            client_type="filer",
            client_address=f"{ip}:{port}",
            data_center=data_center,
        )
        self._rpc: RpcServer | None = None
        self._http: HTTPServer | None = None
        self._metrics_http: HTTPServer | None = None
        self._pool = _ClientPool()
        self._conf_cache = None
        self._conf_cache_ts = 0.0

    # -------------------------------------------------- path storage rules

    def _filer_conf(self):
        """Cached /etc/seaweedfs/filer.conf (filer_conf.go); the 2s TTL
        bounds staleness after a live fs.configure edit without a store
        read per request."""
        from ..filer.path_conf import CONF_PATH, FilerConf

        now = time.time()
        if self._conf_cache is not None and now - self._conf_cache_ts < 2.0:
            return self._conf_cache
        try:
            blob = bytes(self.filer.find_entry(CONF_PATH).content)
            conf = FilerConf.from_bytes(blob)
        except Exception:  # noqa: BLE001 — absent/garbled conf = no rules
            conf = FilerConf()
        self._conf_cache = conf
        self._conf_cache_ts = now
        return conf

    def _conf_rule(self, path: str):
        return self._filer_conf().match(path)

    def _check_writable(self, path: str) -> None:
        """Raise 403 when a filer.conf rule marks the path read-only —
        shared by HTTP writes AND the RPC mutation surface so no client
        can bypass a quota lock."""
        from ..filer.path_conf import CONF_PATH

        if path == CONF_PATH:
            return  # editing the conf itself must never be locked out
        rule = self._conf_rule(path)
        if rule and rule.read_only:
            raise HTTPError(
                403, f"{rule.location_prefix} is read-only (filer.conf)")

    # ----------------------------------------------------------- lifecycle

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def advertise_url(self) -> str:
        """host:port[.grpc] — the explicit RPC form when the +10000
        convention doesn't hold (dynamically assigned ports)."""
        if self.grpc_port == self.port + 10000:
            return self.url
        return f"{self.ip}:{self.port}.{self.grpc_port}"

    async def start(self) -> None:
        self._rpc = RpcServer(self.ip, self.grpc_port)
        self._rpc.add_servicer(filer_pb2, "SeaweedFiler", self)
        try:
            self.grpc_port = await self._rpc.start()
        except (OSError, OverflowError) as e:
            if self._grpc_port_given:
                raise
            # the derived port + 10000 is taken or past 65535: any free
            # port serves, since the master's registry carries the
            # advertised host:port.grpc
            log.warning("RPC port %d unusable (%s); taking a free one",
                        self.grpc_port, e)
            self._rpc.port = 0
            self.grpc_port = await self._rpc.start()
        # no whole-body cap: uploads are read maxMB at a time
        self._http = HTTPServer(self._http_dispatch, self.ip, self.port,
                                client_max_size=None, guard=self.guard)
        await self._http.start()
        self.port = self._http.port

        # /metrics on its own port: the data plane owns the whole
        # namespace, so a filer path "/metrics" must stay a file path
        # (the reference also serves metrics on a dedicated -metricsPort);
        # the traces, the flight recorder and the stack dumps ride it for
        # the same reason
        if self.metrics_port is not None:
            routes = {
                "/metrics": self.h_metrics,
                "/debug/traces": obs.traces_handler,
                "/debug/incident": obs.incident.incident_handler,
            }
            if os.environ.get("SWFS_DEBUG") == "1":
                from ..utils.profiling import debug_stacks_handler

                routes["/debug/stacks"] = debug_stacks_handler

            async def route(request: Request) -> Response:
                handler = routes.get(request.path)
                if handler is None:
                    raise HTTPError(404)
                return await handler(request)

            self._metrics_http = HTTPServer(route, self.ip, self.metrics_port)
            await self._metrics_http.start()
            self.metrics_port = self._metrics_http.port

        self.master_client.client_address = self.advertise_url
        await self.master_client.start()
        self._metrics_push_task = stats.start_push_loop(
            "filer", self.url, self.metrics_address,
            self.metrics_interval_seconds,
        )
        log.info("filer listening http=%s grpc=%s", self.port, self.grpc_port)

    async def stop(self) -> None:
        if self._metrics_push_task is not None:
            self._metrics_push_task.cancel()
            try:
                await self._metrics_push_task
            except asyncio.CancelledError:
                pass
        await self.master_client.stop()
        if self._rpc is not None:
            await self._rpc.stop(0.5)
        if self._http is not None:
            await self._http.stop()
        if self._metrics_http is not None:
            await self._metrics_http.stop()
        await self._pool.close()
        self.filer.shutdown()

    async def h_metrics(self, request: Request) -> Response:
        return Response(
            body=stats.generate_latest(stats.REGISTRY),
            content_type=stats.CONTENT_TYPE_LATEST,
        )

    # -------------------------------------------------- chunk data movement

    async def _delete_file_ids(self, fids: list[str]) -> None:
        await delete_files(self.master_client.current_master, fids)

    async def _assign(self, count: int = 1, collection: str = "", replication: str = "",
                      ttl: str = "", data_center: str = ""):
        return await assign_rpc(
            self.master_client.current_master,
            count=count,
            collection=collection or self.collection,
            replication=replication or self.replication,
            ttl=ttl,
            data_center=data_center or self.data_center,
        )

    async def _upload_chunk(
        self, data: bytes, offset: int, filename: str,
        collection: str = "", replication: str = "", ttl: str = "",
        mime: str = "", qos_tier: str = "",
    ) -> filer_pb2.FileChunk:
        # compress-then-encrypt; chunk.size stays the logical (plaintext)
        # length so the interval algebra never sees wire sizes
        payload = data
        is_compressed = False
        cipher_key = b""
        if self.compress_chunks:
            from ..utils.compression import maybe_compress

            ext = "." + filename.rsplit(".", 1)[-1] if "." in filename else ""
            payload, is_compressed = maybe_compress(payload, mime, ext)
        if self.cipher:
            from ..utils.cipher import encrypt, gen_cipher_key

            cipher_key = gen_cipher_key()
            payload = encrypt(payload, cipher_key)
        a = await self._assign(1, collection, replication, ttl)
        # carry the write tier and remaining deadline budget to the
        # volume server's ingest admission (the doomed upload is refused
        # there, before any bytes hit the .dat)
        hdr = dict(faultpolicy.outbound_headers())
        if qos_tier:
            hdr["X-Seaweed-QoS"] = qos_tier
        result = await upload_data(
            f"http://{a.url}/{a.fid}",
            payload,
            filename=filename,
            compress=False,
            jwt=a.auth,
            headers=hdr,
        )
        return filer_pb2.FileChunk(
            file_id=a.fid,
            offset=offset,
            size=len(data),
            modified_ts_ns=time.time_ns(),
            e_tag=result.get("eTag", ""),
            cipher_key=cipher_key,
            is_compressed=is_compressed,
        )

    async def _lookup_urls(self, file_id: str) -> list[str]:
        vid = int(file_id.split(",")[0])
        locs = await self.master_client.lookup_or_fetch(vid)
        return [f"http://{l.url}/{file_id}" for l in locs]

    async def _cache_get(self, file_id: str) -> bytes | None:
        # the disk tier blocks; keep it off the event loop
        if self.chunk_cache.disk_dir:
            blob = await asyncio.to_thread(self.chunk_cache.get, file_id)
        else:
            blob = self.chunk_cache.get(file_id)
        stats.FILER_CHUNK_CACHE.labels(
            result="miss" if blob is None else "hit").inc()
        return blob

    async def _cache_put(self, file_id: str, blob: bytes) -> None:
        if self.chunk_cache.disk_dir:
            await asyncio.to_thread(self.chunk_cache.put, file_id, blob)
        else:
            self.chunk_cache.put(file_id, blob)

    async def _fetch_chunk_decoded(
        self, file_id: str, cipher_key: bytes, is_compressed: bool
    ) -> bytes:
        """Whole chunk, decrypted/decompressed, through the chunk cache.
        Cipher and compressed chunks can't be range-read, so they always
        come through here (the reference streams them whole too)."""
        blob = await self._cache_get(file_id)
        if blob is not None:
            return blob
        raw = await self._fetch_whole(file_id)
        if cipher_key:
            from ..utils.cipher import decrypt

            raw = decrypt(raw, cipher_key)
        if is_compressed:
            from ..utils.compression import decompress

            raw = decompress(raw)
        await self._cache_put(file_id, raw)
        return raw

    async def _get(self, url: str, headers: dict) -> tuple[int, bytes]:
        parts = urllib.parse.urlsplit(url)
        return await self._pool.get(
            parts.netloc, parts.path, headers,
            # hard per-fetch timeout from the remaining request budget (a
            # hung volume server must not pin this filer read past its
            # deadline)
            faultpolicy.rpc_timeout_s(_CHUNK_FETCH_TIMEOUT_S,
                                      what="chunk_fetch"),
        )

    async def _fetch_view(self, view) -> bytes:
        """One ChunkView's bytes from a volume server (Range read)."""
        if view.cipher_key or view.is_gzipped:
            blob = await self._fetch_chunk_decoded(
                view.file_id, view.cipher_key, view.is_gzipped
            )
            return blob[
                view.offset_in_chunk: view.offset_in_chunk + view.view_size
            ]
        cached = await self._cache_get(view.file_id)
        if cached is not None:
            return cached[
                view.offset_in_chunk: view.offset_in_chunk + view.view_size
            ]
        urls = await self._lookup_urls(view.file_id)
        if not urls:
            raise HTTPError(500, f"chunk {view.file_id}: no locations")
        last_err = None
        for url in urls:
            hdr = {**obs.outbound_headers(), **faultpolicy.outbound_headers()}
            if not (view.offset_in_chunk == 0 and view.view_size == view.chunk_size):
                hdr["Range"] = (
                    f"bytes={view.offset_in_chunk}-"
                    f"{view.offset_in_chunk + view.view_size - 1}"
                )
            try:
                with obs.span(
                    "chunk_fetch", file_id=view.file_id,
                    bytes=view.view_size,
                ):
                    status, data = await self._get(url, hdr)
                    if status >= 300:
                        raise RuntimeError(f"{url}: HTTP {status}")
                if view.is_full_chunk:
                    await self._cache_put(view.file_id, data)
                return data
            except Exception as e:  # noqa: BLE001 — try the next replica
                last_err = e
        raise HTTPError(500, f"chunk {view.file_id}: {last_err}")

    async def _fetch_whole(self, file_id: str) -> bytes:
        urls = await self._lookup_urls(file_id)
        last_err: Exception | None = None
        for url in urls:
            try:
                with obs.span("chunk_fetch", file_id=file_id):
                    status, data = await self._get(url, {
                        **obs.outbound_headers(),
                        **faultpolicy.outbound_headers(),
                    })
                if status < 300:
                    return data
                last_err = RuntimeError(f"{url}: HTTP {status}")
            except Exception as e:  # noqa: BLE001 — try the next replica
                last_err = e
        raise RuntimeError(f"{file_id}: unreachable ({last_err})")

    async def _resolve_views(self, chunks, offset: int, size: int):
        """view_from_chunks with async manifest resolution."""
        from ..filer.manifest import resolve_chunk_manifest

        has_manifest = any(c.is_chunk_manifest for c in chunks)
        if has_manifest:
            blobs: dict[str, bytes] = {}
            for c in chunks:
                if c.is_chunk_manifest:
                    blobs[c.file_id] = await self._fetch_chunk_decoded(
                        c.file_id, bytes(c.cipher_key), c.is_compressed
                    )

            def lookup(fid):
                if fid not in blobs:
                    raise KeyError(fid)
                return blobs[fid]

            chunks, _ = resolve_chunk_manifest(lookup, chunks, offset, offset + size)
        return view_from_chunks(chunks, offset, size)

    # ------------------------------------------------------- HTTP handlers

    async def _http_dispatch(self, request: Request) -> Response:
        # manual trace scope (the data plane owns the whole namespace, so
        # the obs middleware's path exclusions don't apply here): adopt
        # an inbound trace id or start one, echo it on the response, and
        # record the filer-side spans for the fan-out this request does
        tid, psid = obs.parse_trace_header(
            request.headers.get(obs.TRACE_HEADER, "")
        )
        trace, token = obs.start_trace(
            f"{request.method} {request.path}", "filer",
            self.url, trace_id=tid, parent_span_id=psid,
        )
        status = 500
        # a streamed body's head goes out inside the handler: it stamps
        # the trace id from here before it prepares
        request.trace = trace
        try:
            # the filer is a deadline front door too: adopt the inbound
            # budget or stamp the default, so the chunk fetches below
            # ride one continuous budget (utils/faultpolicy.py)
            with faultpolicy.request_scope(request.headers):
                resp = await self._http_dispatch_inner(request)
            status = resp.status
            if not isinstance(resp, StreamResponse):
                obs.stamp_trace_header(resp, trace)
            return resp
        except HTTPError as e:
            status = e.status
            obs.stamp_trace_header(e, trace)
            raise
        except faultpolicy.DeadlineExceeded as e:
            status = 504
            timeout = HTTPError(504, str(e))
            obs.stamp_trace_header(timeout, trace)  # correlate the shed
            raise timeout
        finally:
            obs.finish_trace(trace, token, status)

    async def _http_dispatch_inner(self, request: Request) -> Response:
        try:
            if request.method in ("GET", "HEAD"):
                with stats.time_request(
                    stats.FILER_REQUEST_COUNTER, stats.FILER_REQUEST_HISTOGRAM, "get"
                ):
                    return await self.h_get(request)
            if request.method in ("POST", "PUT"):
                with stats.time_request(
                    stats.FILER_REQUEST_COUNTER, stats.FILER_REQUEST_HISTOGRAM, "post"
                ):
                    return await self.h_write(request)
            if request.method == "DELETE":
                with stats.time_request(
                    stats.FILER_REQUEST_COUNTER, stats.FILER_REQUEST_HISTOGRAM, "delete"
                ):
                    return await self.h_delete(request)
        except HTTPError:
            raise
        except NotFoundError:
            raise HTTPError(404)
        except (FilerError, NotEmptyError) as e:
            raise HTTPError(409, str(e))
        raise HTTPError(405, headers={"Allow": "DELETE,GET,POST,PUT"})

    @staticmethod
    def _req_path(request: Request) -> tuple[str, bool]:
        p = request.path
        return p.rstrip("/") or "/", p.endswith("/") and p != "/"

    async def h_get(self, request: Request) -> Response:
        path, _ = self._req_path(request)
        entry = self.filer.find_entry(path)  # NotFoundError → 404
        if entry.is_directory:
            return await self._list_dir(request, path)
        return await self._stream_file(request, entry)

    async def _list_dir(self, request: Request, path: str) -> Response:
        q = request.query
        limit = int(q.get("limit", 100))
        last = q.get("lastFileName", "")
        prefix = q.get("namePattern", "").rstrip("*")
        entries = self.filer.list_directory_entries(
            path, start_file_name=last, limit=limit + 1, prefix=prefix
        )
        more = len(entries) > limit
        entries = entries[:limit]
        from . import ui

        if ui.wants_html(request):
            # browser directory listing (reference filer_ui/filer.html)
            return Response(
                body=ui.render_filer_listing(path, entries, limit, more).encode(),
                content_type="text/html; charset=utf-8",
            )
        return _json(
            {
                "Path": path,
                "Entries": [_entry_json(e) for e in entries],
                "Limit": limit,
                "LastFileName": entries[-1].name if entries else "",
                "ShouldDisplayLoadMore": more,
            }
        )

    async def _stream_file(self, request: Request, entry: Entry) -> Response:
        total = entry.size()
        mime = entry.attr.mime or "application/octet-stream"
        from .conditional import (
            canonical_header,
            content_disposition,
            format_http_date,
            is_persisted_header,
            not_modified,
        )

        headers = {
            "Accept-Ranges": "bytes",
            "Last-Modified": format_http_date(entry.attr.mtime),
        }
        if entry.chunks:
            headers["ETag"] = f'"{etag_of_chunks(entry.chunks)}"'
        if entry.attr.md5:
            headers["Content-MD5"] = base64.b64encode(entry.attr.md5).decode()

        # replay stored caching/presentation headers (an explicit stored
        # Content-Disposition wins over the synthesized filename one, like
        # the reference's early return in adjustHeaderContentDisposition)
        for xk, xv in entry.extended.items():
            if is_persisted_header(xk):
                headers[canonical_header(xk)] = xv.decode("utf-8", "replace")
        if "Content-Disposition" not in headers:
            cd = content_disposition(request, entry.name)
            if cd:
                headers["Content-Disposition"] = cd
        if not_modified(request, headers.get("ETag", ""), entry.attr.mtime):
            return Response(304, headers=headers, content_type=mime)

        offset, size, status = 0, total, 200
        rng = request.http_range
        if rng.start is not None or rng.stop is not None:
            start = rng.start or 0
            if start < 0:  # suffix range "bytes=-N"
                start, stop = max(total + start, 0), total
            else:
                stop = min(rng.stop if rng.stop is not None else total, total)
            if start >= stop:
                raise HTTPError(416)
            offset, size, status = start, stop - start, 206
            headers["Content-Range"] = f"bytes {start}-{start + size - 1}/{total}"

        headers["Content-Length"] = str(size)
        if request.method == "HEAD":
            return Response(status, headers=headers, content_type=mime)

        resp = StreamResponse(status, headers=headers, content_type=mime)
        obs.stamp_trace_header(resp, getattr(request, "trace", None))
        await resp.prepare(request)
        pos = offset
        stop = offset + size
        if entry.content and pos < len(entry.content):
            # inlined head (appends may have added chunks past it)
            end = min(stop, len(entry.content))
            await resp.write(bytes(entry.content[pos:end]))
            pos = end
        if pos < stop and not entry.chunks and entry.extended.get("remote.key"):
            # remote-mounted entry with no cached chunks: read through the
            # storage backend (filer_server_handlers_read.go remote path)
            storage = self._remote_storage(entry)
            rkey = entry.extended["remote.key"].decode()
            piece = 1 << 16
            while pos < stop:
                n = min(piece, stop - pos)
                blob = await asyncio.to_thread(storage.pread, rkey, n, pos)
                if not blob:
                    break
                await resp.write(blob)
                pos += len(blob)
        if pos < stop:
            views = await self._resolve_views(entry.chunks, pos, stop - pos)
            for v in views:
                if v.view_offset > pos:  # hole → zeros
                    await resp.write(b"\x00" * (v.view_offset - pos))
                await resp.write(await self._fetch_view(v))
                pos = v.view_offset + v.view_size
            if pos < stop:
                await resp.write(b"\x00" * (stop - pos))
        await resp.write_eof()
        return resp

    def _remote_storage(self, entry: Entry):
        """The storage backend a remote-mounted entry names (the `local`
        type; `s3` is refused by storage/backend.py until the port has
        an S3 client)."""
        from ..storage import backend as backend_mod

        backend_name = entry.extended.get("remote.backend", b"").decode()
        btype, _, bid = backend_name.partition(".")
        try:
            return backend_mod.get_backend(btype, bid or "default")
        except KeyError:
            pass
        # config was registered via remote.configure into our own KV
        # (shells run in other processes) — lazy-load it
        try:
            cfg = self.filer.store.kv_get(
                f"remote.conf/{backend_name}".encode()
            )
        except NotFoundError:
            raise HTTPError(
                502, f"storage backend {backend_name} not configured")
        backend_mod.configure(json.loads(cfg))
        return backend_mod.get_backend(btype, bid or "default")

    async def h_write(self, request: Request) -> Response:
        path, had_slash = self._req_path(request)
        q = request.query
        self._check_writable(path)
        # mkdir: POST to a path ending in "/" with no content-type
        if (
            request.method == "POST"
            and had_slash
            and not request.headers.get("Content-Type")
        ):
            await self.filer.create_entry(
                Entry(
                    full_path=path,
                    attr=Attr(
                        mtime=int(time.time()), crtime=int(time.time()),
                        mode=0o770 | MODE_DIR,
                    ),
                )
            )
            return _json({"name": path}, status=201)

        chunk_size = int(q.get("maxMB", self.max_mb)) * 1024 * 1024
        rule = self._conf_rule(path)
        collection = q.get("collection") or (
            rule.collection if rule else ""
        ) or self.collection
        replication = q.get("replication") or (
            rule.replication if rule else ""
        ) or self.replication
        ttl_str = q.get("ttl") or (rule.ttl if rule else "")
        try:
            from ..storage.types import TTL

            ttl_sec = TTL.parse(ttl_str).minutes * 60
        except ValueError as e:
            raise HTTPError(400, str(e))
        is_append = q.get("op") == "append"

        filename = ""
        content_type = request.headers.get("Content-Type", "")
        reader = request.content
        if request.method == "POST" and content_type.startswith("multipart/"):
            mp = await request.multipart()
            part = await mp.next()
            if part is None:
                raise HTTPError(400, "empty multipart body")
            filename = part.filename or ""
            content_type = part.headers.get("Content-Type", "")
            reader = part
        if content_type == "application/octet-stream":
            content_type = ""

        # if POSTing to a directory, the file lands inside it
        if had_slash and filename:
            path = new_full_path(path, filename)
        elif filename and path != "/":
            try:
                if self.filer.find_entry(path).is_directory:
                    path = new_full_path(path, filename)
            except NotFoundError:
                pass

        md5 = hashlib.md5()
        small_content = b""
        offset = 0
        buf = bytearray()
        eof = False
        # chunk uploads run in a bounded parallel window — the volume
        # servers take them concurrently (the reference uploads chunks via
        # a worker pool the same way)
        tasks: list[asyncio.Task] = []
        upload_name = filename or path.rsplit("/", 1)[-1]
        # write tier rides the same header the read path uses; the s3
        # gateway stamps it (multipart parts = bulk), direct PUTs may too
        qos_tier = request.headers.get("X-Seaweed-QoS", "")

        def launch(data: bytes, off: int) -> None:
            tasks.append(
                asyncio.create_task(
                    self._upload_chunk(
                        data, off, upload_name,
                        collection, replication, ttl_str, mime=content_type,
                        qos_tier=qos_tier,
                    )
                )
            )

        async def abort_uploads() -> None:
            """Cancel in-flight chunk tasks and GC whatever landed."""
            for t_ in tasks:
                if not t_.done():
                    t_.cancel()
            results = await asyncio.gather(*tasks, return_exceptions=True)
            fids = [
                r.file_id for r in results
                if isinstance(r, filer_pb2.FileChunk)
            ]
            if fids:
                await self._delete_file_ids(fids)

        try:
            while not eof:
                while len(buf) < chunk_size and not eof:
                    piece = await reader.read(min(chunk_size - len(buf), 1 << 20))
                    if not piece:
                        eof = True
                    else:
                        buf.extend(piece)
                data = bytes(buf)
                buf.clear()
                if not data and offset > 0:
                    break
                md5.update(data)
                if (
                    eof
                    and offset == 0
                    and len(data) <= self.save_inside_limit
                    and not is_append
                ):
                    small_content = data
                    offset = len(data)
                    break
                if not data:  # empty file: an entry with no chunks
                    break
                launch(data, offset)
                offset += len(data)
                # bound read-ahead: at most `upload_parallelism` chunk
                # buffers in flight (wait only on PENDING tasks — done
                # ones would make FIRST_COMPLETED a hot spin)
                while True:
                    pending = [t_ for t_ in tasks if not t_.done()]
                    if len(pending) < self.upload_parallelism:
                        break
                    await asyncio.wait(
                        pending, return_when=asyncio.FIRST_COMPLETED
                    )
                # a failed chunk aborts the upload NOW, not after the
                # remaining gigabytes have been read and uploaded
                failed = next(
                    (
                        t_ for t_ in tasks
                        if t_.done() and not t_.cancelled() and t_.exception()
                    ),
                    None,
                )
                if failed is not None:
                    raise failed.exception()

            results = await asyncio.gather(*tasks)
        except asyncio.CancelledError:
            await abort_uploads()
            raise
        except HTTPError:
            await abort_uploads()  # a refused or malformed body
            raise
        except Exception as e:  # noqa: BLE001 — client abort, chunk failure
            await abort_uploads()
            raise HTTPError(500, f"chunk upload failed: {e}")
        chunks = list(results)

        if is_append:
            entry = await self.filer.append_chunks(path, chunks)
            size = entry.size()
        else:
            # fold huge chunk lists into manifests before saving metadata
            if len(chunks) > 1000:
                chunks = await self._manifestize_async(
                    chunks, collection, replication
                )
            now = int(time.time())
            mode = int(q.get("mode", "0660"), 8)
            # persist caching/presentation headers + Seaweed-* pairs with
            # the entry; reads replay them (reference autochunk
            # SaveAmzMetaData shape, write_autochunk.go:245-258)
            from .conditional import persistable_headers

            extended = {
                k: v.encode()
                for k, v in persistable_headers(request.headers).items()
            }
            entry = Entry(
                full_path=path,
                attr=Attr(
                    mtime=now, crtime=now, mode=mode,
                    uid=0, gid=0, mime=content_type,
                    ttl_sec=ttl_sec, md5=md5.digest(), file_size=offset,
                ),
                chunks=chunks,
                content=small_content,
                extended=extended,
            )
            old_chunks = []
            try:
                old = self.filer.find_entry(path)
                # overwriting a hard-linked name rewrites the SHARED
                # content: inherit the id so every other name sees the new
                # data, and the replaced chunks are safe to GC exactly
                # because all names now point at the replacement
                entry.hard_link_id = old.hard_link_id
                old_chunks = list(old.chunks)
            except NotFoundError:
                pass
            await self.filer.create_entry(entry)
            if old_chunks:
                await self.filer.delete_unused_chunks(old_chunks, chunks)
            size = offset

        return _json(
            {"name": path.rsplit("/", 1)[-1], "size": size},
            status=201,
            headers={"Content-MD5": base64.b64encode(md5.digest()).decode()},
        )

    async def _manifestize_async(self, chunks, collection, replication):
        """Pre-upload manifest blobs then fold the list."""
        from ..filer.manifest import maybe_manifestize_async

        return await maybe_manifestize_async(
            lambda blob: self._upload_chunk(
                blob, 0, "manifest", collection, replication
            ),
            chunks,
        )

    async def h_delete(self, request: Request) -> Response:
        path, _ = self._req_path(request)
        q = request.query
        try:
            await self.filer.delete_entry_meta_and_data(
                path,
                is_recursive=q.get("recursive") == "true",
                ignore_recursive_error=q.get("ignoreRecursiveError") == "true",
                is_delete_data=q.get("skipChunkDeletion") != "true",
            )
        except NotFoundError:
            raise HTTPError(404)
        except NotEmptyError as e:
            raise HTTPError(409, str(e))
        return Response(204)

    # --------------------------------------------------------- RPC service

    async def LookupDirectoryEntry(self, request, context):
        try:
            entry = self.filer.find_entry(
                new_full_path(request.directory, request.name)
            )
        except NotFoundError:
            await context.abort(StatusCode.NOT_FOUND, "not found")
        return filer_pb2.LookupDirectoryEntryResponse(entry=entry.to_pb())

    async def ListEntries(self, request, context):
        remaining = request.limit or (1 << 31)
        start = request.start_from_file_name
        inclusive = request.inclusive_start_from
        while remaining > 0:
            ask = min(remaining, 1024)
            batch = self.filer.list_directory_entries(
                request.directory,
                start_file_name=start,
                include_start=inclusive,
                limit=ask,
                prefix=request.prefix,
            )
            for e in batch:
                yield filer_pb2.ListEntriesResponse(entry=e.to_pb())
            if len(batch) < ask:
                return
            remaining -= len(batch)
            start, inclusive = batch[-1].name, False

    async def CreateEntry(self, request, context):
        try:
            self._check_writable(
                f"{request.directory.rstrip('/')}/{request.entry.name}"
            )
        except HTTPError as e:
            return filer_pb2.CreateEntryResponse(error=e.text)
        entry = Entry.from_pb(request.directory, request.entry)
        old = None
        try:
            old = self.filer.find_entry(entry.full_path)
        except NotFoundError:
            pass
        try:
            await self.filer.create_entry(
                entry,
                o_excl=request.o_excl,
                is_from_other_cluster=request.is_from_other_cluster,
                signatures=list(request.signatures),
            )
        except FilerError as e:
            return filer_pb2.CreateEntryResponse(error=str(e))
        if old is not None and old.chunks:
            if old.hard_link_id and old.hard_link_id != entry.hard_link_id:
                # the name detached from its link group: drop ONE ref;
                # the shared chunks live on for the other names
                self.filer._release_hard_link(old)
            else:
                await self.filer.delete_unused_chunks(
                    old.chunks, entry.chunks
                )
        return filer_pb2.CreateEntryResponse()

    async def UpdateEntry(self, request, context):
        try:
            self._check_writable(
                f"{request.directory.rstrip('/')}/{request.entry.name}"
            )
        except HTTPError as e:
            await context.abort(StatusCode.PERMISSION_DENIED, e.text)
        entry = Entry.from_pb(request.directory, request.entry)
        old = None
        try:
            old = self.filer.find_entry(entry.full_path)
        except NotFoundError:
            pass
        await self.filer.update_entry(
            old, entry, signatures=list(request.signatures)
        )
        if old is not None:
            if old.hard_link_id and old.hard_link_id != entry.hard_link_id:
                self.filer._release_hard_link(old)  # name left the group
            else:
                await self.filer.delete_unused_chunks(
                    old.chunks, entry.chunks
                )
        return filer_pb2.UpdateEntryResponse()

    async def AppendToEntry(self, request, context):
        try:
            self._check_writable(
                f"{request.directory.rstrip('/')}/{request.entry_name}"
            )
        except HTTPError as e:
            await context.abort(StatusCode.PERMISSION_DENIED, e.text)
        await self.filer.append_chunks(
            new_full_path(request.directory, request.entry_name),
            list(request.chunks),
        )
        return filer_pb2.AppendToEntryResponse()

    async def DeleteEntry(self, request, context):
        try:
            await self.filer.delete_entry_meta_and_data(
                new_full_path(request.directory, request.name),
                is_recursive=request.is_recursive,
                ignore_recursive_error=request.ignore_recursive_error,
                is_delete_data=request.is_delete_data,
                signatures=list(request.signatures),
            )
        except NotFoundError:
            return filer_pb2.DeleteEntryResponse()
        except NotEmptyError as e:
            return filer_pb2.DeleteEntryResponse(error=str(e))
        return filer_pb2.DeleteEntryResponse()

    async def AtomicRenameEntry(self, request, context):
        try:
            # renames must not GROW a read-only subtree (moving OUT of one
            # is allowed — quota locks block growth, not shrinkage)
            self._check_writable(
                f"{request.new_directory.rstrip('/')}/{request.new_name}"
            )
        except HTTPError as e:
            await context.abort(StatusCode.PERMISSION_DENIED, e.text)
        try:
            await self.filer.atomic_rename(
                request.old_directory,
                request.old_name,
                request.new_directory,
                request.new_name,
                signatures=list(request.signatures),
            )
        except NotFoundError:
            await context.abort(StatusCode.NOT_FOUND, "source not found")
        return filer_pb2.AtomicRenameEntryResponse()

    async def AssignVolume(self, request, context):
        rule = self._conf_rule(request.path) if request.path else None
        if rule and rule.read_only:
            return filer_pb2.AssignVolumeResponse(
                error=f"{rule.location_prefix} is read-only (filer.conf)"
            )
        try:
            a = await self._assign(
                max(request.count, 1),
                request.collection or (rule.collection if rule else ""),
                request.replication or (rule.replication if rule else ""),
                _seconds_to_ttl(request.ttl_sec)
                or (rule.ttl if rule else ""),
                request.data_center,
            )
        except Exception as e:  # noqa: BLE001
            return filer_pb2.AssignVolumeResponse(error=str(e))
        return filer_pb2.AssignVolumeResponse(
            file_id=a.fid,
            count=a.count,
            auth=a.auth,
            collection=request.collection or self.collection,
            replication=request.replication or self.replication,
            location=filer_pb2.Location(
                url=a.url, public_url=a.public_url, grpc_port=a.grpc_port
            ),
        )

    async def LookupVolume(self, request, context):
        resp = filer_pb2.LookupVolumeResponse()
        for vid_str in request.volume_ids:
            vid = int(vid_str.split(",")[0])
            locs = await self.master_client.lookup_or_fetch(vid)
            resp.locations_map[vid_str].CopyFrom(
                filer_pb2.Locations(
                    locations=[
                        filer_pb2.Location(
                            url=l.url, public_url=l.public_url, grpc_port=l.grpc_port
                        )
                        for l in locs
                    ]
                )
            )
        return resp

    async def CollectionList(self, request, context):
        stub = self._master_stub()
        resp = await stub.CollectionList(
            master_pb2.CollectionListRequest(
                include_normal_volumes=request.include_normal_volumes,
                include_ec_volumes=request.include_ec_volumes,
            ),
            timeout=30.0,  # master metadata round-trip
        )
        return filer_pb2.CollectionListResponse(
            collections=[filer_pb2.Collection(name=c.name) for c in resp.collections]
        )

    async def DeleteCollection(self, request, context):
        stub = self._master_stub()
        await stub.CollectionDelete(
            master_pb2.CollectionDeleteRequest(name=request.collection),
            timeout=60.0,  # deletes fan out to volume servers
        )
        return filer_pb2.DeleteCollectionResponse()

    async def Statistics(self, request, context):
        stub = self._master_stub()
        resp = await stub.Statistics(
            master_pb2.StatisticsRequest(
                replication=request.replication,
                collection=request.collection,
                ttl=request.ttl,
                disk_type=request.disk_type,
            ),
            timeout=30.0,  # master metadata round-trip
        )
        return filer_pb2.StatisticsResponse(
            total_size=resp.total_size,
            used_size=resp.used_size,
            file_count=resp.file_count,
        )

    async def GetFilerConfiguration(self, request, context):
        return filer_pb2.GetFilerConfigurationResponse(
            masters=self.masters,
            replication=self.replication,
            collection=self.collection,
            max_mb=self.max_mb,
            dir_buckets=self.dir_buckets,
        )

    async def SubscribeMetadata(self, request, context):
        async for ev in self.filer.meta_log.subscribe(
            since_ns=request.since_ns, path_prefix=request.path_prefix
        ):
            sigs = ev.event_notification.signatures
            if request.signature and request.signature in sigs:
                continue  # originated from this subscriber — loop guard
            yield ev

    async def KvGet(self, request, context):
        try:
            value = self.filer.store.kv_get(bytes(request.key))
        except NotFoundError:
            return filer_pb2.KvGetResponse()
        return filer_pb2.KvGetResponse(value=value)

    async def KvPut(self, request, context):
        self.filer.store.kv_put(bytes(request.key), bytes(request.value))
        return filer_pb2.KvPutResponse()

    def _master_stub(self):
        return Stub(
            channel(server_address.grpc_address(self.master_client.current_master)),
            master_pb2,
            "Seaweed",
        )


def _seconds_to_ttl(sec: int) -> str:
    """Seconds → the master's TTL string units (m/h/d/w; rounds up to a
    minute — the reference's needle.SecondsToTTL does the same)."""
    if sec <= 0:
        return ""
    if sec % 86400 == 0:
        return f"{sec // 86400}d"
    if sec % 3600 == 0:
        return f"{sec // 3600}h"
    return f"{max(1, (sec + 59) // 60)}m"


def _entry_json(e: Entry) -> dict:
    return {
        "FullPath": e.full_path,
        "Mtime": e.attr.mtime,
        "Crtime": e.attr.crtime,
        "Mode": e.attr.mode,
        "Uid": e.attr.uid,
        "Gid": e.attr.gid,
        "Mime": e.attr.mime,
        "TtlSec": e.attr.ttl_sec,
        "FileSize": e.size(),
        "IsDirectory": e.is_directory,
        "Md5": base64.b64encode(e.attr.md5).decode() if e.attr.md5 else "",
    }
