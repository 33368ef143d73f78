"""A small HTTP/1.1 server on asyncio streams, standing in for aiohttp.

The reference's servers run on aiohttp, which the machine with the card
does not have.  This module gives the servers what they used of it and
nothing more: the request line, headers, `Content-Length` and chunked
bodies (read whole on demand under a size cap, or piece by piece through
`Request.content`, with no cap where the server was built with
`client_max_size=None`), `multipart/form-data` parts read piece by piece
(`Request.multipart`), `Expect: 100-continue`, keep-alive, `HEAD`, and
responses with a status, headers and a body — or, for a body produced
while it is sent, a `StreamResponse` the handler prepares and writes
itself (the filer's chunked GETs).

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

    def items(self):
        """(name as sent, value) pairs."""
        return list(self._d.values())


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


class StreamResponse:
    """A response whose body the handler writes while it produces it
    (aiohttp's web.StreamResponse): `await resp.prepare(request)` sends
    the head, `await resp.write(data)` each piece, `await resp.write_eof()`
    ends it; then the handler returns `resp`.  `Content-Length` must be in
    `headers` (every answer of these servers carries one).  A piece the
    client drains slower than `stall_budget` seconds (0 = no limit)
    aborts the connection, as Response's does; a body shorter than its
    Content-Length (the handler failed midway) closes it."""

    def __init__(self, status: int = 200, headers=None,
                 content_type: str = "application/octet-stream",
                 stall_budget: float = 0.0):
        self.status = status
        self.headers = dict(headers or {})
        self.headers.setdefault("Content-Type", content_type)
        self.stall_budget = stall_budget
        self._writer = None
        self._head_only = False
        self._left = 0
        self.finished = False
        self.close = False  # the head said Connection: close

    async def prepare(self, request: "Request") -> None:
        if self._writer is not None:
            return
        self._left = int(self.headers["Content-Length"])
        self._head_only = request.method == "HEAD"
        self._writer = request._writer
        request.response_started = self
        self.close = request.close_after_answer
        self._writer.write(_head_bytes(self.status, self.headers, self.close))
        if self._head_only or self._left == 0:
            self._left = 0
            self.finished = True
            await self._writer.drain()

    async def write(self, data) -> None:
        if self._head_only or not len(data):
            return
        if len(data) > self._left:
            raise ValueError("write past the response's Content-Length")
        self._left -= len(data)
        self._writer.write(data)
        if not await _drain(self._writer, self.stall_budget, len(data)):
            raise ConnectionResetError("client stalled past its budget")
        if self._left == 0:
            self.finished = True

    async def write_eof(self) -> None:
        if self._left:
            raise ValueError(
                f"response ended {self._left} bytes short of its length")
        self.finished = True


class Request:
    def __init__(self, method: str, target: str, version: str,
                 headers: Headers, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, max_body: int | None,
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
        self._max_body = max_body  # None: no cap (the filer's uploads)
        self._body: bytes | None = None
        # True once reading the body failed: the rest of it is unread
        self.refused = False
        # the StreamResponse whose head went out, if the handler sent one
        self.response_started: StreamResponse | None = None
        cl = headers.get("Content-Length")
        self.content_length = int(cl) if cl is not None else None
        if self.content_length is not None and self.content_length < 0:
            raise HTTPError(400, "negative Content-Length")
        self._chunked = "chunked" in headers.get("Transfer-Encoding", "").lower()
        # the incremental reader's state
        self._left = self.content_length or 0  # Content-Length bytes unread
        self._chunk_left = 0  # bytes unread of the current chunk
        self._eof = not (bool(self.content_length) or self._chunked)
        self._taken = 0  # body bytes read so far
        self._continued = False
        self.content = BodyReader(self)

    @property
    def body_pending(self) -> bool:
        """A body was announced and some of it is still unread."""
        return not self._eof

    @property
    def close_after_answer(self) -> bool:
        """The connection closes after this request's answer: the client
        asked so, reading its body failed, or it waits for 100 Continue
        on a body the handler left unread (it sends none after a final
        answer)."""
        return self.refused or not self.keep_alive or (
            self.body_pending
            and self.headers.get("Expect", "").lower() == "100-continue")

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
        if self._taken:
            raise RuntimeError("the body was already read piece by piece")
        if not self._chunked:
            # a Content-Length body: one readexactly off the socket
            self._body = await self._read_some(self._left, exact=True)
            return self._body
        parts = []
        while piece := await self.content.read(1 << 20):
            parts.append(piece)
        self._body = b"".join(parts)
        return self._body

    async def drain(self) -> None:
        """Read and drop what is left of the body (under the cap)."""
        while await self.content.read(_STREAM_CHUNK):
            pass

    async def _read_some(self, n: int, exact: bool = False) -> bytes:
        """Up to n body bytes off the socket (b"" at the body's end; with
        `exact`, all n of a Content-Length body); refuses a body past the
        cap with 413, a malformed one with 400."""
        try:
            return await self._read_some_inner(n, exact)
        except HTTPError:
            self.refused = True
            self._eof = True
            raise

    async def _read_some_inner(self, n: int, exact: bool) -> bytes:
        if self._eof or n <= 0:
            return b""
        cap = self._max_body
        if not self._continued:
            self._continued = True
            if cap is not None and (self.content_length or 0) > cap:
                raise HTTPError(413, "request body too large")
            if self.headers.get("Expect", "").lower() == "100-continue":
                self._writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        if not self._chunked:
            want = min(n, self._left)
            data = await (self._reader.readexactly(want) if exact
                          else self._reader.read(want))
            if not data:
                raise asyncio.IncompleteReadError(b"", self._left)
            self._left -= len(data)
            self._eof = self._left == 0
            self._taken += len(data)
            return data
        if self._chunk_left == 0:
            line = await self._reader.readline()
            try:
                size = int(line.split(b";")[0], 16)
            except ValueError:
                raise HTTPError(400, "malformed chunk size")
            if size == 0:
                while (await self._reader.readline()) not in (b"\r\n", b""):
                    pass  # trailers
                self._eof = True
                return b""
            if cap is not None and self._taken + size > cap:
                raise HTTPError(413, "request body too large")
            self._chunk_left = size
        data = await self._reader.read(min(n, self._chunk_left))
        if not data:
            raise asyncio.IncompleteReadError(b"", self._chunk_left)
        self._chunk_left -= len(data)
        self._taken += len(data)
        if self._chunk_left == 0:
            await self._reader.readexactly(2)  # the chunk's CRLF
        return data

    async def multipart(self) -> "MultipartReader":
        """The `multipart/form-data` body's parts, read piece by piece
        (aiohttp's request.multipart())."""
        return MultipartReader(self)

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


class BodyReader:
    """`request.content` (aiohttp's StreamReader): `await read(n)` -> up to
    n bytes of the body, b"" at its end."""

    def __init__(self, request: Request):
        self._req = request

    async def read(self, n: int) -> bytes:
        return await self._req._read_some(n)


class BodyPart:
    """One part of a multipart body: `headers`, `name`, `filename`, and
    `await read(n)` -> up to n bytes of its data, b"" at the part's end."""

    def __init__(self, mp: "MultipartReader", headers: Headers):
        self._mp = mp
        self.headers = headers
        self.name, self.filename = _disposition(
            headers.get("Content-Disposition", ""))
        self.at_end = False

    async def read(self, n: int) -> bytes:
        if self.at_end:
            return b""
        return await self._mp._part_data(self, n)


def _disposition(value: str) -> tuple[str | None, str | None]:
    """Content-Disposition -> (name, filename), as email's parser reads
    them (quoted or bare values, RFC 2231 forms included)."""
    if not value:
        return None, None
    import email.message
    import email.policy

    m = email.message.EmailMessage(policy=email.policy.HTTP)
    m["Content-Disposition"] = value
    return m.get_param("name", header="Content-Disposition"), m.get_filename()


class MultipartReader:
    """The parts of a `multipart/*` request body, read off the socket
    piece by piece (aiohttp's MultipartReader): `await next()` -> the next
    BodyPart, or None after the last.  A part's unread data is skipped
    when the next one is asked for."""

    def __init__(self, request: Request):
        import email.message
        import email.policy

        m = email.message.EmailMessage(policy=email.policy.HTTP)
        m["Content-Type"] = request.headers.get("Content-Type", "")
        boundary = m.get_boundary()
        if not boundary:
            raise HTTPError(400, "multipart body without a boundary")
        self._req = request
        self._dash = b"--" + boundary.encode("latin-1")
        self._delim = b"\r\n" + self._dash
        self._buf = bytearray()
        self._started = False
        self._done = False
        self._part: BodyPart | None = None

    async def _fill(self, want: int) -> bool:
        """Read body bytes until the buffer holds `want`; False at the
        body's end."""
        while len(self._buf) < want:
            piece = await self._req.content.read(max(want - len(self._buf),
                                                     _STREAM_CHUNK))
            if not piece:
                return False
            self._buf += piece
        return True

    async def _line(self) -> bytes:
        while (i := self._buf.find(b"\r\n")) < 0:
            if not await self._fill(len(self._buf) + 1):
                raise HTTPError(400, "truncated multipart body")
        line = bytes(self._buf[:i])
        del self._buf[:i + 2]
        return line

    async def next(self) -> BodyPart | None:
        if self._done:
            return None
        if self._part is not None:
            while await self._part.read(_STREAM_CHUNK):
                pass
        if not self._started:
            self._started = True
            # preamble, then the first delimiter line
            while (line := await self._line()) != self._dash:
                if line == self._dash + b"--":
                    self._done = True
                    return None
        elif self._part is None or not self._part.at_end:
            raise HTTPError(400, "malformed multipart body")
        headers = Headers()
        while line := await self._line():
            name, sep, value = line.decode("latin-1").partition(":")
            if not sep:
                raise HTTPError(400, "malformed multipart part header")
            headers[name.strip()] = value.strip()
        self._part = BodyPart(self, headers)
        return self._part

    async def _part_data(self, part: BodyPart, n: int) -> bytes:
        d = self._delim
        while True:
            i = self._buf.find(d)
            if i >= 0:
                if i == 0:
                    # the delimiter: then "--" (the last part) or CRLF
                    if not await self._fill(len(d) + 2):
                        raise HTTPError(400, "truncated multipart body")
                    tail = bytes(self._buf[len(d):len(d) + 2])
                    del self._buf[:len(d) + 2]
                    part.at_end = True
                    if tail == b"--":
                        self._done = True
                    elif tail != b"\r\n":
                        raise HTTPError(400, "malformed multipart delimiter")
                    return b""
                take = min(n, i)
            else:
                # keep what could be the start of the delimiter
                take = min(n, len(self._buf) - len(d) + 1)
            if take > 0:
                out = bytes(self._buf[:take])
                del self._buf[:take]
                return out
            if not await self._fill(len(self._buf) + 1):
                raise HTTPError(400, "truncated multipart body")


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
                started = req.response_started
                if started is not None:
                    # the handler sent its own head (and said there whether
                    # the connection stays); one cut short ends it
                    close = not started.finished or started.close
                else:
                    close = req.close_after_answer
                    if not await self._write(writer, req.method, resp, close):
                        break
                if unread and not close:
                    try:
                        await req.drain()
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
            if req.response_started is not None:
                raise ConnectionResetError(e.text)  # too late to answer
            return _error_response(e)
        except ConnectionError:
            raise  # the client went away (or stalled) mid-answer
        except Exception:  # noqa: BLE001 — one request's failure is a 500
            log.exception("%s %s failed", req.method, req.path)
            if req.response_started is not None:
                raise ConnectionResetError("handler failed mid-answer")
            # aiohttp's answer to a handler's unhandled exception
            return _error_response(HTTPError(
                500, "500 Internal Server Error\n\nServer got itself in trouble"))

    async def _write(self, writer, method: str, resp: Response,
                     close: bool) -> bool:
        """Write one response; False when the connection was aborted."""
        body = resp.body if method != "HEAD" else b""
        headers = dict(resp.headers)
        if resp.status in (204, 304):
            # a status without a body: aiohttp sends neither header
            headers.pop("Content-Type", None)
            headers.pop("Content-Length", None)
            body = b""
        else:
            headers.setdefault("Content-Length", str(len(resp.body)))
        writer.write(_head_bytes(resp.status, headers, close))
        if len(body):
            writer.write(body)
        return await _drain(writer, resp.stall_budget, len(body))


def _head_bytes(status: int, headers: dict, close: bool) -> bytes:
    headers = dict(headers)
    headers["Connection"] = "close" if close else "keep-alive"
    head = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}"]
    head += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")


async def _drain(writer, stall_budget: float, nbytes: int) -> bool:
    """Wait until the socket takes what was written, within
    `stall_budget` seconds for a body over one socket buffer; False when
    the client stalled past it and the connection was aborted."""
    if not (stall_budget > 0 and nbytes > _STREAM_CHUNK):
        await writer.drain()
        return True
    try:
        await asyncio.wait_for(writer.drain(), stall_budget)
    except asyncio.TimeoutError:
        stats.VOLUME_SERVER_RESPONSE_STALL_ABORTS.inc()
        from ..obs import incident as obs_incident

        obs_incident.record(
            "stall_abort", bytes=nbytes, budget_s=round(stall_budget, 1),
        )
        log.warning(
            "read response stalled past its %.1fs budget (%d bytes); "
            "disconnecting slow client", stall_budget, nbytes,
        )
        # abort, not close: close() would keep draining the buffered
        # backlog to the dribbling client
        writer.transport.abort()
        return False
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
                      body=b"") -> tuple[int, Headers, bytes]:
        """-> (status, headers, body).  `body` is bytes, or a binary file
        object sent from its position to its end in pieces read on a
        worker thread (an upload larger than memory)."""
        status, resp_headers, n = await self._send(method, path, headers,
                                                   body)
        data = b"" if method == "HEAD" else await self._reader.readexactly(n)
        await self._done(resp_headers)
        return status, resp_headers, data

    async def request_into(self, method: str, path: str, sink,
                           headers=None) -> tuple[int, Headers]:
        """Like `request`, with no request body, handing a 2xx answer's
        body to `sink(piece)` a socket read at a time instead of holding
        it (another answer's body is read and dropped) -> (status,
        headers)."""
        status, resp_headers, n = await self._send(method, path, headers,
                                                   b"")
        while n > 0 and method != "HEAD":
            piece = await self._reader.read(min(n, 1 << 20))
            if not piece:
                raise asyncio.IncompleteReadError(b"", n)
            n -= len(piece)
            if status < 300:
                sink(piece)
        await self._done(resp_headers)
        return status, resp_headers

    async def _send(self, method, path, headers, body):
        """Send one request -> (status, headers, body length)."""
        if self._writer is None:
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port
            )
        if isinstance(body, (bytes, bytearray, memoryview)):
            length = len(body)
        else:
            import os

            length = os.fstat(body.fileno()).st_size - body.tell()
        lines = [f"{method} {path} HTTP/1.1", f"Host: {self.host}:{self.port}",
                 f"Content-Length: {length}"]
        lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
        self._writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
        if isinstance(body, (bytes, bytearray, memoryview)):
            if body:
                self._writer.write(body)
        else:
            left = length
            while left > 0:
                piece = await asyncio.to_thread(body.read, min(left, 1 << 20))
                if not piece:
                    raise EOFError("the file ended before its size")
                left -= len(piece)
                self._writer.write(piece)
                await self._writer.drain()
        await self._writer.drain()
        line = await self._reader.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        status = int(line.split()[1])
        resp_headers = Headers()
        while (raw := await self._reader.readline()) not in (b"\r\n", b""):
            name, _, value = raw.decode("latin-1").partition(":")
            resp_headers[name.strip()] = value.strip()
        return status, resp_headers, int(resp_headers.get("Content-Length", "0"))

    async def _done(self, resp_headers: Headers) -> None:
        if resp_headers.get("Connection", "").lower() == "close":
            await self.close()

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
