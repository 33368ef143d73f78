"""A small HTTP/1.1 server on asyncio streams, standing in for aiohttp.

The reference's servers run on aiohttp, which the machine with the card
does not have.  This module gives the volume server what it used of it
and nothing more: the request line, headers, `Content-Length` and chunked
bodies (read on demand, under a size cap), `Expect: 100-continue`,
keep-alive, `HEAD`, and responses with a status, headers and a body.

Each connection is its own task and serves its requests in order, so
concurrent clients reach the handler concurrently — the concurrency the
EC read dispatcher coalesces into batches.  The handler runs on the event
loop: it must hand disk and device work to `asyncio.to_thread`.

A response body larger than one socket buffer is written under its
`stall_budget` (seconds, 0 = none): a client that drains it slower than
that is disconnected instead of holding the needle's buffers open (and the
abort is recorded in the flight recorder, obs/incident.py).
"""
from __future__ import annotations

import asyncio
import json
import logging
import urllib.parse
from http import HTTPStatus

from .. import stats

log = logging.getLogger("http")

_MAX_HEADERS = 100
_STREAM_CHUNK = 64 * 1024
# how long a connection closed on a refused body keeps discarding what
# the client still sends (see _linger)
_LINGER_S = 2.0


class Headers:
    """Case-insensitive header map (the last of repeated headers wins)."""

    def __init__(self, items=()):
        self._d: dict[str, tuple[str, str]] = {}
        for k, v in items:
            self[k] = v

    def __setitem__(self, key: str, value: str) -> None:
        self._d[key.lower()] = (key, str(value))

    def __getitem__(self, key: str) -> str:
        return self._d[key.lower()][1]

    def __contains__(self, key: str) -> bool:
        return key.lower() in self._d

    def get(self, key: str, default=None):
        item = self._d.get(key.lower())
        return default if item is None else item[1]


class HTTPError(Exception):
    """Raise from a handler to answer with `status` (and `text` as the
    body, `headers` added)."""

    def __init__(self, status: int, text: str = "", headers=None):
        self.status = status
        self.text = text or f"{status}: {HTTPStatus(status).phrase}"
        self.headers = dict(headers or {})
        super().__init__(self.text)


class Response:
    def __init__(self, status: int = 200, body=b"", headers=None,
                 content_type: str = "text/plain; charset=utf-8",
                 stall_budget: float = 0.0):
        self.status = status
        self.body = body  # bytes, or a memoryview the socket write reads
        self.headers = dict(headers or {})
        self.headers.setdefault("Content-Type", content_type)
        self.stall_budget = stall_budget


def json_response(obj, status: int = 200) -> Response:
    return Response(status, json.dumps(obj).encode(),
                    content_type="application/json; charset=utf-8")


class Request:
    def __init__(self, method: str, target: str, version: str,
                 headers: Headers, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, max_body: int,
                 remote: str = ""):
        self.method = method
        # the peer's IP address (aiohttp's request.remote)
        self.remote = remote
        self.version = version
        self.headers = headers
        parts = urllib.parse.urlsplit(target)
        self.path = urllib.parse.unquote(parts.path)
        self.query_string = parts.query
        # first value of each key, like aiohttp's request.query.get
        self.query: dict[str, str] = {}
        for k, v in urllib.parse.parse_qsl(parts.query, keep_blank_values=True):
            self.query.setdefault(k, v)
        self._reader = reader
        self._writer = writer
        self._max_body = max_body
        self._body: bytes | None = None
        # True once reading the body failed: the rest of it is unread
        self.refused = False
        cl = headers.get("Content-Length")
        self.content_length = int(cl) if cl is not None else None
        if self.content_length is not None and self.content_length < 0:
            raise HTTPError(400, "negative Content-Length")
        self._chunked = "chunked" in headers.get("Transfer-Encoding", "").lower()

    @property
    def body_pending(self) -> bool:
        """A body was announced and nothing of it has been read yet."""
        return self._body is None and (
            bool(self.content_length) or self._chunked)

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("Connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"

    async def read(self) -> bytes:
        """The whole body (read from the socket on first call)."""
        if self._body is not None:
            return self._body
        if self.content_length is None and not self._chunked:
            self._body = b""
            return self._body
        try:
            self._body = await self._read_body()
        except HTTPError:
            self.refused = True
            raise
        return self._body

    async def _read_body(self) -> bytes:
        if (self.content_length or 0) > self._max_body:
            raise HTTPError(413, "request body too large")
        if self.headers.get("Expect", "").lower() == "100-continue":
            self._writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        if self._chunked:
            parts, total = [], 0
            while True:
                line = await self._reader.readline()
                try:
                    size = int(line.split(b";")[0], 16)
                except ValueError:
                    raise HTTPError(400, "malformed chunk size")
                if size == 0:
                    while (await self._reader.readline()) not in (b"\r\n", b""):
                        pass  # trailers
                    break
                total += size
                if total > self._max_body:
                    raise HTTPError(413, "request body too large")
                parts.append(await self._reader.readexactly(size))
                await self._reader.readexactly(2)
            return b"".join(parts)
        return await self._reader.readexactly(self.content_length)

    @property
    def http_range(self) -> slice:
        """The `Range: bytes=...` header as a slice (aiohttp's
        request.http_range): `a-b` -> [a, b+1), `a-` -> [a, None),
        `-n` -> [-n, None); no header -> [None, None).  One range only;
        anything else raises ValueError."""
        raw = self.headers.get("Range")
        if raw is None:
            return slice(None, None)
        unit, _, spec = raw.partition("=")
        if unit.strip() != "bytes" or "," in spec:
            raise ValueError(f"unsupported range {raw!r}")
        first, dash, last = spec.strip().partition("-")
        if not dash or not (first or last):
            raise ValueError(f"malformed range {raw!r}")
        if not first:
            return slice(-int(last), None)
        start = int(first)
        if not last:
            return slice(start, None)
        stop = int(last) + 1
        if stop <= start:
            raise ValueError(f"malformed range {raw!r}")
        return slice(start, stop)


async def _read_head(reader: asyncio.StreamReader):
    """-> (method, target, version, Headers), or None at a clean EOF."""
    line = await reader.readline()
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").split()
    except ValueError:
        raise HTTPError(400, "malformed request line")
    if not version.startswith("HTTP/1."):
        raise HTTPError(505)
    headers = Headers()
    for _ in range(_MAX_HEADERS + 1):
        raw = await reader.readline()
        if raw in (b"\r\n", b"\n", b""):
            return method.upper(), target, version, headers
        name, sep, value = raw.decode("latin-1").partition(":")
        if not sep:
            raise HTTPError(400, "malformed header line")
        headers[name.strip()] = value.strip()
    raise HTTPError(431)


class HTTPServer:
    """`handler(request) -> Response` served on host:port (0 = any free
    port; `port` holds the bound one after start).  With a `guard`
    (security/guard.py) whose white list is set, a request from a peer
    outside it is answered 403 before the handler runs, as the reference's
    guard middleware does."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0,
                 client_max_size: int = 256 << 20, guard=None):
        self.handler = handler
        self.guard = guard if guard is not None and guard.enabled else None
        self.host = host
        self.port = port
        self.client_max_size = client_max_size
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.Task] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        # end the open connections first: wait_closed() waits for them
        for task in list(self._conns):
            task.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def _serve_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        peer = writer.get_extra_info("peername")
        remote = peer[0] if peer else ""
        try:
            while True:
                try:
                    head = await _read_head(reader)
                    if head is None:
                        break
                    req = Request(*head, reader, writer, self.client_max_size,
                                  remote)
                except HTTPError as e:
                    await self._write(writer, "GET", _error_response(e),
                                      close=True)
                    break
                except ValueError:
                    await self._write(writer, "GET",
                                      _error_response(HTTPError(400)),
                                      close=True)
                    break
                resp = await self._handle(req)
                # a body the handler left unread (a shed at the write door,
                # a 404) is drained after the answer, as aiohttp sends it,
                # so the client learns the verdict before its upload.  A
                # client that waits for 100 Continue sends no body after a
                # final answer: that connection closes instead.
                unread = req.body_pending
                close = req.refused or not req.keep_alive or (
                    unread and req.headers.get("Expect", "").lower() == "100-continue")
                if not await self._write(writer, req.method, resp, close):
                    break
                if unread and not close:
                    try:
                        await req.read()
                    except HTTPError:
                        close = True  # refused: the rest stays unread
                if close:
                    if unread:  # a refused body is unread too
                        await _linger(reader, writer)
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away
        finally:
            self._conns.discard(task)
            writer.close()

    async def _handle(self, req: Request) -> Response:
        if self.guard is not None and not self.guard.allowed(req.remote):
            return _error_response(
                HTTPError(403, self.guard.refusal(req.remote)))
        try:
            return await self.handler(req)
        except HTTPError as e:
            return _error_response(e)
        except Exception:  # noqa: BLE001 — one request's failure is a 500
            log.exception("%s %s failed", req.method, req.path)
            return _error_response(HTTPError(500))

    async def _write(self, writer, method: str, resp: Response,
                     close: bool) -> bool:
        """Write one response; False when the connection was aborted."""
        body = resp.body if method != "HEAD" else b""
        headers = dict(resp.headers)
        headers.setdefault("Content-Length", str(len(resp.body)))
        headers["Connection"] = "close" if close else "keep-alive"
        phrase = HTTPStatus(resp.status).phrase
        head = [f"HTTP/1.1 {resp.status} {phrase}"]
        head += [f"{k}: {v}" for k, v in headers.items()]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        if len(body):
            writer.write(body)
        if resp.stall_budget > 0 and len(body) > _STREAM_CHUNK:
            try:
                await asyncio.wait_for(writer.drain(), resp.stall_budget)
            except asyncio.TimeoutError:
                stats.VOLUME_SERVER_RESPONSE_STALL_ABORTS.inc()
                from ..obs import incident as obs_incident

                obs_incident.record(
                    "stall_abort", bytes=len(body),
                    budget_s=round(resp.stall_budget, 1),
                )
                log.warning(
                    "read response stalled past its %.1fs budget (%d bytes); "
                    "disconnecting slow client", resp.stall_budget, len(body),
                )
                # abort, not close: close() would keep draining the
                # buffered backlog to the dribbling client
                writer.transport.abort()
                return False
        else:
            await writer.drain()
        return True


async def _linger(reader, writer) -> None:
    """Half-close, then discard what the client still sends of a refused
    body for up to _LINGER_S: closing with unread bytes would make the
    kernel answer them with a reset, which can destroy the response in
    flight before the client reads it."""
    async def discard():
        while await reader.read(_STREAM_CHUNK):
            pass

    try:
        writer.write_eof()
        await asyncio.wait_for(discard(), _LINGER_S)
    except (asyncio.TimeoutError, ConnectionError, OSError):
        pass


def _error_response(e: HTTPError) -> Response:
    return Response(e.status, e.text.encode(), headers=e.headers)


class Client:
    """One keep-alive HTTP/1.1 client connection on asyncio streams
    (reconnects when the server closed it).  Enough to drive the servers
    of this package: every response they send carries Content-Length."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._reader = None
        self._writer = None

    async def request(self, method: str, path: str, headers=None,
                      body: bytes = b"") -> tuple[int, Headers, bytes]:
        """-> (status, headers, body)."""
        if self._writer is None:
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port
            )
        lines = [f"{method} {path} HTTP/1.1", f"Host: {self.host}:{self.port}",
                 f"Content-Length: {len(body)}"]
        lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
        self._writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
        if body:
            self._writer.write(body)
        await self._writer.drain()
        line = await self._reader.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        status = int(line.split()[1])
        resp_headers = Headers()
        while (raw := await self._reader.readline()) not in (b"\r\n", b""):
            name, _, value = raw.decode("latin-1").partition(":")
            resp_headers[name.strip()] = value.strip()
        n = int(resp_headers.get("Content-Length", "0"))
        data = b"" if method == "HEAD" else await self._reader.readexactly(n)
        if resp_headers.get("Connection", "").lower() == "close":
            await self.close()
        return status, resp_headers, data

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except ConnectionError:
                pass
            self._writer = self._reader = None


async def fetch(hostport: str, method: str, path: str, headers=None,
                body: bytes = b"", timeout: float | None = None):
    """One request to "host:port" on a connection of its own, within
    `timeout` seconds (None: no limit) -> (status, headers, body)."""
    host, _, port = hostport.rpartition(":")
    cl = Client(host, int(port))
    try:
        return await asyncio.wait_for(
            cl.request(method, path, headers=headers, body=body), timeout)
    finally:
        await cl.close()


async def fetch_following(hostport: str, method: str, path: str):
    """One request, following redirects as the reference's aiohttp client
    does (a follower master answers its control paths with a 307 to the
    leader; a volume server in -readMode redirect a GET with a 301)
    -> (status, headers, body)."""
    for _ in range(10):
        status, headers, body = await fetch(hostport, method, path)
        location = headers.get("Location")
        if status not in (301, 302, 303, 307, 308) or not location:
            break
        parts = urllib.parse.urlsplit(location)
        hostport = parts.netloc or hostport
        path = parts.path + (f"?{parts.query}" if parts.query else "")
    return status, headers, body


async def get_json(hostport: str, path: str, timeout: float | None = None):
    """GET http://hostport/path -> the JSON body; ValueError on a status
    other than 200."""
    status, _, body = await fetch(hostport, "GET", path, timeout=timeout)
    if status != 200:
        raise ValueError(f"http://{hostport}{path} returned HTTP {status}")
    return json.loads(body)
