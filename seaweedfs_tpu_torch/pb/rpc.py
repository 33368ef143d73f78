"""The RPC plane: protobuf messages over asyncio streams, standing in for
grpc.aio as server/http.py stands in for aiohttp.

The reference (seaweedfs_tpu/pb/rpc.py) derives gRPC stubs and handlers from
protoc's descriptors; the card's machine has neither grpc nor protobuf.
This module keeps the reference's surface — `Stub(channel(addr), pb,
"Service")` with one attribute per rpc, a servicer object whose methods are
named after the rpcs, `RpcError.code()`, a 32 MiB message cap, the trace id
and the remaining deadline riding every call's metadata — on a wire of its
own.  It is NOT gRPC's HTTP/2 framing: a peer speaking real gRPC cannot
connect.

One TCP listener per server.  A connection carries one call at a time, and
a finished call leaves the connection to the next one (clients keep a pool
per address).  Every frame is a 1-byte type and a 4-byte big-endian length,
then the payload:

    CALL    {"path": "/package.Service/Method", "md": [[k, v], ...],
             "timeout": seconds | null}                  (client -> server)
    MSG     one serialized message                          (both ways)
    END     the client sent its last message               (client -> server)
    STATUS  {"code": int, "details": str}; ends the call   (server -> client)

Unary and server-streaming calls send CALL, one MSG and END together;
bidirectional streams (SendHeartbeat) interleave MSGs both ways until END
and STATUS.  A client that leaves a call early (a timeout, a failure, a
broken stream) closes that connection instead of returning it to the pool,
so the server sees EOF and cancels the handler.

`sync_channel_cached(addr)` is a thread-safe blocking client with its own
connection pool per address, for hooks that run on worker threads (the
volume server's remote shard reader, under asyncio.to_thread).
"""
from __future__ import annotations

import asyncio
import enum
import inspect
import json
import logging
import socket
import struct
import threading
import time

from . import wire

log = logging.getLogger("rpc")

MAX_MESSAGE_SIZE = 32 * 1024 * 1024  # reference pb/grpc_client_server.go

F_CALL, F_MSG, F_END, F_STATUS = 1, 2, 3, 4
_HDR = struct.Struct(">BI")
# CALL and STATUS payloads are small; a larger one is a broken peer
_MAX_CONTROL = 1 << 20


class StatusCode(enum.Enum):
    """gRPC's status codes (the numbers are gRPC's)."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """A call that did not end OK (grpc.RpcError's shape: `.code()` and
    `.details()`)."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class _Abort(Exception):
    """Raised by ServicerContext.abort: ends the call with a status."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(details)
        self.code = code
        self.details = details


# the role a served call's trace carries; raft rides the master's listener
_SERVICE_ROLES = {"Seaweed": "master", "SeaweedRaft": "master",
                  "SeaweedFiler": "filer", "VolumeServer": "volume"}


# ------------------------------------------------------------------ frames


def _frame(ftype: int, payload: bytes = b"") -> bytes:
    return _HDR.pack(ftype, len(payload)) + payload


def _json_frame(ftype: int, obj) -> bytes:
    return _frame(ftype, json.dumps(obj, separators=(",", ":")).encode())


async def _read_frame(reader: asyncio.StreamReader) -> tuple[int, bytes | None]:
    """-> (type, payload); payload None when a MSG was over the cap (its
    bytes were read and dropped, so the stream stays in step)."""
    ftype, n = _HDR.unpack(await reader.readexactly(_HDR.size))
    if ftype == F_MSG and n > MAX_MESSAGE_SIZE:
        while n > 0:
            n -= len(await reader.readexactly(min(n, 1 << 20)))
        return ftype, None
    if ftype != F_MSG and n > _MAX_CONTROL:
        raise ConnectionError(f"rpc: control frame of {n} bytes")
    return ftype, (await reader.readexactly(n) if n else b"")


def _check_size(data: bytes, what: str) -> None:
    if len(data) > MAX_MESSAGE_SIZE:
        raise RpcError(
            StatusCode.RESOURCE_EXHAUSTED,
            f"{what}: message of {len(data)} bytes is over the "
            f"{MAX_MESSAGE_SIZE}-byte cap",
        )


def _methods(pb, service_name: str):
    return pb.SERVICES[service_name].methods.values()


# ------------------------------------------------------- metadata hooks


def _outbound(metadata, timeout):
    """The reference's _trace_wrap_call: attach the active trace id and the
    remaining deadline budget to every outbound call, and bound a call made
    inside a deadline scope by what is left of it.  Explicit caller
    metadata and timeouts win; outside any scope nothing is added (long
    streams such as SendHeartbeat stay unbounded)."""
    from ..obs import trace as obs_trace
    from ..utils import faultpolicy

    if metadata is None:
        metadata = (obs_trace.grpc_metadata() or ()) + (
            faultpolicy.grpc_metadata() or ()
        )
    if timeout is None:
        rem = faultpolicy.remaining_s()
        if rem is not None:
            timeout = max(rem, 1e-3)
    return [list(kv) for kv in (metadata or ())], timeout


# ------------------------------------------------------------------ server


class ServicerContext:
    """What a handler gets beside its request (grpc.aio's context subset)."""

    def __init__(self, metadata: list):
        self._md = [tuple(kv) for kv in metadata]

    def invocation_metadata(self):
        return tuple(self._md)

    async def abort(self, code: StatusCode, details: str = ""):
        raise _Abort(code, details)


class _Inbound:
    """The requests of one call, as the connection's reader loop hands
    them over."""

    END = object()

    def __init__(self, method: wire.MethodDesc):
        self.method = method
        self.queue: asyncio.Queue = asyncio.Queue()
        self.overcap = False

    def __aiter__(self):
        return self

    async def __anext__(self):
        item = await self.queue.get()
        if item is self.END:
            self.queue.put_nowait(self.END)  # stay exhausted
            raise StopAsyncIteration
        return item


class RpcServer:
    """One listener serving any number of servicers (one per service)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._handlers: dict[str, tuple[wire.MethodDesc, object, str]] = {}
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.Task] = set()

    def add_servicer(self, pb, service_name: str, servicer) -> None:
        """Serve every rpc of `service_name` that `servicer` has a method
        for; the rest answer UNIMPLEMENTED."""
        role = _SERVICE_ROLES.get(service_name, service_name.lower())
        for m in _methods(pb, service_name):
            fn = getattr(servicer, m.name, None)
            if fn is not None:
                self._handlers[m.full_path] = (m, fn, role)

    async def start(self) -> int:
        """Bind and serve; a TLS listener requiring client certificates
        when security/tls.py is configured."""
        from ..security import tls

        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self.port,
            limit=1 << 20, reuse_address=True, ssl=tls.server_ssl(),
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self, grace: float | None = 0.0) -> None:
        if self._server is None:
            return
        self._server.close()
        if grace and self._conns:
            await asyncio.wait(self._conns, timeout=grace)
        for task in list(self._conns):
            task.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        try:
            await asyncio.wait_for(self._server.wait_closed(), 1.0)
        except asyncio.TimeoutError:
            pass
        self._server = None

    async def _serve_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        peer = writer.get_extra_info("peername")
        peer = f"{peer[0]}:{peer[1]}" if peer else ""
        cur_task: asyncio.Task | None = None
        inbound: _Inbound | None = None
        try:
            while True:
                try:
                    ftype, payload = await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if ftype == F_CALL:
                    if cur_task is not None and not cur_task.done():
                        log.warning("rpc: %s sent a call mid-call", peer)
                        break
                    hdr = json.loads(payload)
                    entry = self._handlers.get(hdr.get("path", ""))
                    if entry is None:
                        # still read this call's frames up to its END
                        inbound = _Inbound(None)
                        writer.write(_json_frame(F_STATUS, {
                            "code": StatusCode.UNIMPLEMENTED.value,
                            "details": f"method {hdr.get('path')} not found",
                        }))
                        cur_task = None
                        continue
                    inbound = _Inbound(entry[0])
                    cur_task = asyncio.create_task(
                        self._run_call(entry, hdr, inbound, writer)
                    )
                elif ftype == F_MSG:
                    if inbound is None or inbound.method is None:
                        continue
                    if payload is None:
                        inbound.overcap = True
                        if cur_task is not None:
                            cur_task.cancel()
                        continue
                    inbound.queue.put_nowait(payload)
                elif ftype == F_END:
                    if inbound is not None:
                        inbound.queue.put_nowait(_Inbound.END)
                else:
                    log.warning("rpc: %s sent frame type %d", peer, ftype)
                    break
        finally:
            if cur_task is not None and not cur_task.done():
                cur_task.cancel()
                await asyncio.gather(cur_task, return_exceptions=True)
            writer.close()
            self._conns.discard(task)

    async def _run_call(self, entry, hdr, inbound: _Inbound, writer) -> None:
        """Run one call's handler (cancelled at the caller's timeout) and
        write its STATUS."""
        method, fn, role = entry
        timeout = hdr.get("timeout")
        ctx = ServicerContext(hdr.get("md") or [])
        code, details = StatusCode.OK, ""
        try:
            async with asyncio.timeout(timeout):
                await self._invoke(method, fn, role, inbound, ctx, writer)
        except _Abort as e:
            code, details = e.code, e.details
        except RpcError as e:
            code, details = e.code(), e.details()
        except asyncio.CancelledError:
            if not inbound.overcap:
                raise  # the client left: nobody to answer
            code = StatusCode.RESOURCE_EXHAUSTED
            details = (f"received a message over the {MAX_MESSAGE_SIZE}-"
                       "byte cap")
        except TimeoutError as e:
            # the caller's timeout, or a spent budget the handler adopted
            # (faultpolicy.DeadlineExceeded is a TimeoutError)
            code = StatusCode.DEADLINE_EXCEEDED
            details = str(e) or "deadline exceeded"
        except Exception as e:  # noqa: BLE001 — the status carries it
            code = StatusCode.UNKNOWN
            details = f"{type(e).__name__}: {e}"
            log.debug("rpc %s failed", method.full_path, exc_info=True)
        try:
            writer.write(_json_frame(
                F_STATUS, {"code": code.value, "details": details}))
            await writer.drain()
        except ConnectionError:
            pass

    async def _invoke(self, method: wire.MethodDesc, fn, role: str,
                      inbound: _Inbound, ctx: ServicerContext,
                      writer) -> None:
        from ..obs import trace as obs_trace
        from ..utils import faultpolicy

        md = dict(ctx.invocation_metadata())
        tid, psid = obs_trace.parse_trace_header(
            md.get(obs_trace.GRPC_TRACE_KEY, ""))
        t, token = (obs_trace.start_trace(
            f"grpc {method.name}", role, trace_id=tid, parent_span_id=psid)
            if tid is not None else (None, None))
        status = "OK"

        async def requests():
            async for raw in inbound:
                yield method.input.FromString(raw)

        async def send(resp) -> None:
            data = resp.SerializeToString()
            _check_size(data, method.full_path)
            writer.write(_frame(F_MSG, data))
            await writer.drain()

        try:
            with faultpolicy.adopt_scope_from_metadata(md):
                if method.client_streaming:
                    arg = requests()
                else:
                    raw = await inbound.queue.get()
                    if raw is _Inbound.END:
                        raise _Abort(StatusCode.INTERNAL, "no request sent")
                    arg = method.input.FromString(raw)
                if inspect.isasyncgenfunction(fn):
                    async for resp in fn(arg, ctx):
                        await send(resp)
                else:
                    resp = await fn(arg, ctx)
                    if resp is None:
                        if not method.server_streaming:
                            raise _Abort(StatusCode.INTERNAL,
                                         f"{method.name} returned nothing")
                    else:
                        await send(resp)
        except BaseException:
            status = "error"
            raise
        finally:
            obs_trace.finish_trace(t, token, status)


# ------------------------------------------------------------ async client


class _Conn:
    __slots__ = ("reader", "writer", "reused")

    def __init__(self, reader, writer, reused=False):
        self.reader = reader
        self.writer = writer
        self.reused = reused

    def close(self) -> None:
        self.writer.close()


class _LostBeforeAnswer(RpcError):
    """The connection died before the first frame of the answer: on a
    pooled connection the server had already closed, the call never ran."""


def _split(address: str) -> tuple[str, int]:
    host, _, port = address.rpartition(":")
    return host, int(port)


class Channel:
    """Async connection pool to one address (grpc.aio.Channel's role).
    Connections belong to the event loop that opened them: a pool used
    from a new loop starts over."""

    def __init__(self, address: str):
        self.address = address
        self._idle: list[_Conn] = []
        self._loop = None

    async def _acquire(self) -> _Conn:
        loop = asyncio.get_running_loop()
        if loop is not self._loop:
            self._idle = []  # the old loop's transports die with it
            self._loop = loop
        while self._idle:
            conn = self._idle.pop()
            if not conn.writer.is_closing() and not conn.reader.at_eof():
                conn.reused = True
                return conn
            conn.close()
        from ..security import tls

        host, port = _split(self.address)
        ctx = tls.client_ssl()
        try:
            reader, writer = await asyncio.open_connection(
                host, port, limit=1 << 20, ssl=ctx,
                server_hostname=host if ctx is not None else None)
        except OSError as e:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"connect {self.address}: {e}") from e
        return _Conn(reader, writer)

    def _release(self, conn: _Conn) -> None:
        if len(self._idle) < 64 and self._loop is not None:
            self._idle.append(conn)
        else:
            conn.close()

    async def close(self) -> None:
        idle, self._idle = self._idle, []
        if self._loop is asyncio.get_running_loop():
            for conn in idle:
                conn.close()

    async def _open_call(self, path, first: bytes | None, md, timeout,
                         fresh: bool = False) -> _Conn:
        """Send CALL (+ the one request and END when `first` is given)."""
        hdr = _json_frame(F_CALL, {"path": path, "md": md,
                                   "timeout": timeout})
        body = hdr if first is None else (
            hdr + _frame(F_MSG, first) + _frame(F_END))
        if fresh:
            self._idle = []
        conn = await self._acquire()
        try:
            conn.writer.write(body)
            await conn.writer.drain()
        except ConnectionError as e:
            conn.close()
            raise (_LostBeforeAnswer if conn.reused else RpcError)(
                StatusCode.UNAVAILABLE, f"{path}: {e}") from e
        return conn

    def _finish(self, conn: _Conn, reusable: bool) -> None:
        if reusable:
            self._release(conn)
        else:
            conn.close()

    async def _responses(self, conn: _Conn, path: str, output, deadline):
        """Yield decoded responses until the STATUS; raise RpcError unless
        it is OK.  The connection goes back to the pool only after a clean
        STATUS (the caller adds its own condition through `reusable`)."""
        got_any = False
        while True:
            rem = None if deadline is None else deadline - time.monotonic()
            if rem is not None and rem <= 0:
                raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                               f"{path}: deadline exceeded")
            try:
                if rem is None:
                    ftype, payload = await _read_frame(conn.reader)
                else:
                    ftype, payload = await asyncio.wait_for(
                        _read_frame(conn.reader), rem)
            except asyncio.TimeoutError:
                raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                               f"{path}: deadline exceeded") from None
            except (asyncio.IncompleteReadError, ConnectionError) as e:
                cls = (_LostBeforeAnswer if conn.reused and not got_any
                       else RpcError)
                raise cls(StatusCode.UNAVAILABLE,
                          f"{path}: connection lost: {e}") from e
            got_any = True
            if ftype == F_MSG:
                if payload is None:
                    raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                                   f"{path}: response over the cap")
                yield output.FromString(payload)
            elif ftype == F_STATUS:
                st = json.loads(payload)
                code = StatusCode(st.get("code", 2))
                if code != StatusCode.OK:
                    raise _EndedWith(code, st.get("details", ""))
                return
            else:
                raise RpcError(StatusCode.INTERNAL,
                               f"{path}: unexpected frame {ftype}")


class _EndedWith(RpcError):
    """A non-OK STATUS: the call ended cleanly, the connection is fine."""


class _UnaryMethod:
    def __init__(self, ch: Channel, m: wire.MethodDesc):
        self._ch = ch
        self._m = m

    async def __call__(self, request, timeout=None, metadata=None):
        m = self._m
        data = request.SerializeToString()
        _check_size(data, m.full_path)
        md, timeout = _outbound(metadata, timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        for attempt in (0, 1):
            conn = None
            out = None
            try:
                conn = await self._ch._open_call(m.full_path, data, md,
                                                 timeout, fresh=attempt > 0)
                async for resp in self._ch._responses(conn, m.full_path,
                                                      m.output, deadline):
                    out = resp
            except _LostBeforeAnswer:
                if conn is not None:
                    conn.close()
                if attempt:
                    raise
                continue
            except _EndedWith as e:
                self._ch._finish(conn, True)
                raise RpcError(e.code(), e.details()) from None
            except BaseException:
                if conn is not None:
                    conn.close()
                raise
            self._ch._finish(conn, True)
            if out is None:
                raise RpcError(StatusCode.INTERNAL,
                               f"{m.full_path}: no response")
            return out


class _StreamCall:
    """A server-streaming or bidirectional call: iterate it for the
    responses (grpc.aio's call object)."""

    def __init__(self, ch: Channel, m: wire.MethodDesc, request, timeout,
                 metadata):
        self._ch = ch
        self._m = m
        self._request = request
        self._md, self._timeout = _outbound(metadata, timeout)

    def __aiter__(self):
        return self._run()

    async def _run(self):
        m = self._m
        deadline = None if self._timeout is None else (
            time.monotonic() + self._timeout)
        pump = None
        pump_err: list[BaseException] = []
        if not m.client_streaming:
            data = self._request.SerializeToString()
            _check_size(data, m.full_path)
            conn = await self._ch._open_call(m.full_path, data, self._md,
                                             self._timeout)
        else:
            conn = await self._ch._open_call(m.full_path, None, self._md,
                                             self._timeout)

            async def pump_requests():
                try:
                    async for req in self._request:
                        data = req.SerializeToString()
                        _check_size(data, m.full_path)
                        conn.writer.write(_frame(F_MSG, data))
                        await conn.writer.drain()
                    conn.writer.write(_frame(F_END))
                    await conn.writer.drain()
                except asyncio.CancelledError:
                    raise
                except BaseException as e:  # noqa: BLE001 — ends the call
                    pump_err.append(e)
                    conn.close()

            pump = asyncio.ensure_future(pump_requests())
        reusable = False
        try:
            async for resp in self._ch._responses(conn, m.full_path,
                                                  m.output, deadline):
                yield resp
            reusable = pump is None or (pump.done() and not pump_err)
        except _EndedWith as e:
            reusable = pump is None or (pump.done() and not pump_err)
            raise RpcError(e.code(), e.details()) from None
        except RpcError as e:
            if pump_err:
                err = pump_err[0]
                if isinstance(err, RpcError):
                    raise err from None
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"{m.full_path}: sending failed: {err}") from e
            raise
        finally:
            if pump is not None and not pump.done():
                pump.cancel()
                await asyncio.gather(pump, return_exceptions=True)
            self._ch._finish(conn, reusable)


class _StreamMethod:
    def __init__(self, ch: Channel, m: wire.MethodDesc):
        self._ch = ch
        self._m = m

    def __call__(self, request, timeout=None, metadata=None) -> _StreamCall:
        return _StreamCall(self._ch, self._m, request, timeout, metadata)


# ------------------------------------------------------------- sync client


class SyncChannel:
    """Blocking connection pool to one address; thread-safe (each call
    takes a socket of its own from the pool)."""

    def __init__(self, address: str):
        self.address = address
        self._idle: list[socket.socket] = []
        self._lock = threading.Lock()

    def _acquire(self, timeout) -> tuple[socket.socket, bool]:
        with self._lock:
            if self._idle:
                return self._idle.pop(), True
        from ..security import tls

        host, port = _split(self.address)
        try:
            s = socket.create_connection((host, port), timeout=timeout)
        except OSError as e:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"connect {self.address}: {e}") from e
        ctx = tls.client_ssl()
        try:
            if ctx is not None:
                s = ctx.wrap_socket(s, server_hostname=host)
        except OSError as e:
            s.close()
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"connect {self.address}: {e}") from e
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s, False

    def _release(self, s: socket.socket) -> None:
        with self._lock:
            if len(self._idle) < 64:
                self._idle.append(s)
                return
        s.close()

    def close(self) -> None:
        with self._lock:
            for s in self._idle:
                s.close()
            self._idle.clear()

    def call(self, m: wire.MethodDesc, request, timeout=None, metadata=None):
        """Yield the decoded responses of a unary or server-streaming call."""
        data = request.SerializeToString()
        _check_size(data, m.full_path)
        md, timeout = _outbound(metadata, timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        body = (_json_frame(F_CALL, {"path": m.full_path, "md": md,
                                     "timeout": timeout})
                + _frame(F_MSG, data) + _frame(F_END))
        for attempt in (0, 1):
            s, reused = self._acquire(timeout)
            try:
                s.settimeout(timeout)
                s.sendall(body)
                break
            except OSError as e:
                s.close()
                if not reused or attempt:
                    raise RpcError(StatusCode.UNAVAILABLE, str(e)) from e
        ok = False
        try:
            while True:
                try:
                    ftype, payload = _sync_read_frame(s, deadline)
                except socket.timeout:
                    raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                                   f"{m.full_path}: deadline exceeded")
                except (OSError, EOFError) as e:
                    raise RpcError(StatusCode.UNAVAILABLE,
                                   f"{m.full_path}: connection lost: {e}")
                if ftype == F_MSG:
                    if payload is None:
                        raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                                       f"{m.full_path}: response over the cap")
                    yield m.output.FromString(payload)
                elif ftype == F_STATUS:
                    st = json.loads(payload)
                    ok = True
                    code = StatusCode(st.get("code", 2))
                    if code != StatusCode.OK:
                        raise RpcError(code, st.get("details", ""))
                    return
                else:
                    raise RpcError(StatusCode.INTERNAL,
                                   f"{m.full_path}: unexpected frame {ftype}")
        finally:
            if ok:
                self._release(s)
            else:
                s.close()


def _sync_recv(s: socket.socket, n: int, deadline) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if deadline is not None:
            rem = deadline - time.monotonic()
            if rem <= 0:
                raise socket.timeout("deadline exceeded")
            s.settimeout(rem)
        k = s.recv_into(view[got:])
        if k == 0:
            raise EOFError("peer closed the connection")
        got += k
    return buf


def _sync_read_frame(s: socket.socket, deadline):
    ftype, n = _HDR.unpack(_sync_recv(s, _HDR.size, deadline))
    if ftype == F_MSG and n > MAX_MESSAGE_SIZE:
        while n > 0:
            n -= len(_sync_recv(s, min(n, 1 << 20), deadline))
        return ftype, None
    if ftype != F_MSG and n > _MAX_CONTROL:
        raise OSError(f"rpc: control frame of {n} bytes")
    return ftype, (bytes(_sync_recv(s, n, deadline)) if n else b"")


class _SyncUnary:
    def __init__(self, ch: SyncChannel, m: wire.MethodDesc):
        self._ch = ch
        self._m = m

    def __call__(self, request, timeout=None, metadata=None):
        out = None
        for resp in self._ch.call(self._m, request, timeout, metadata):
            out = resp
        return out


class _SyncStream:
    def __init__(self, ch: SyncChannel, m: wire.MethodDesc):
        self._ch = ch
        self._m = m

    def __call__(self, request, timeout=None, metadata=None):
        return self._ch.call(self._m, request, timeout, metadata)


# -------------------------------------------------------------------- stubs


class Stub:
    """Client stub: one attribute per rpc of `service_name`, built from the
    proto.  Over a `Channel` the attributes are coroutines (unary) or
    async-iterable calls (streaming); over a `SyncChannel` they block."""

    def __init__(self, ch, pb, service_name: str):
        for m in _methods(pb, service_name):
            if isinstance(ch, SyncChannel):
                if m.client_streaming:
                    continue  # no caller streams requests synchronously
                fn = (_SyncStream if m.server_streaming else _SyncUnary)(ch, m)
            elif m.client_streaming or m.server_streaming:
                fn = _StreamMethod(ch, m)
            else:
                fn = _UnaryMethod(ch, m)
            setattr(self, m.name, fn)


_channels: dict[str, Channel] = {}
_sync_channels: dict[str, SyncChannel] = {}
_sync_lock = threading.Lock()


def channel(address: str) -> Channel:
    """The shared async pool of one address (the reference caches one
    connection per server, pb/grpc_client_server.go).  Pools belong to the
    event loop that made their connections: `close_all_channels` at the
    end of a loop's life."""
    ch = _channels.get(address)
    if ch is None:
        ch = _channels[address] = Channel(address)
    return ch


def sync_channel_cached(address: str) -> SyncChannel:
    """The shared blocking pool of one address, for worker-thread hooks on
    hot paths: the degraded-read survivor gather dials up to 10 peers a
    read, and a fresh connection per shard is the tail the reference's
    chaos sweep found.  Callers must not close what they get here."""
    with _sync_lock:
        ch = _sync_channels.get(address)
        if ch is None:
            ch = _sync_channels[address] = SyncChannel(address)
        return ch


def drop_cached_channels() -> None:
    """Forget every cached pool, so the next dial takes the current TLS
    setting (security/tls.py configure); the blocking pools' idle sockets
    close now, the async pools' with their event loop."""
    _channels.clear()
    with _sync_lock:
        for ch in _sync_channels.values():
            ch.close()
        _sync_channels.clear()


async def close_all_channels() -> None:
    for ch in list(_channels.values()):
        await ch.close()
    _channels.clear()
    with _sync_lock:
        for ch in _sync_channels.values():
            ch.close()
        _sync_channels.clear()
