"""The port's protobuf wire and RPC plane (seaweedfs_tpu_torch/pb/).

Three things, mirroring tests/test_pb.py:

  1. the `.proto` files are byte copies of the JAX package's;
  2. every message of both files, filled with seeded random values (nested
     messages, repeated fields and maps included), serializes to exactly
     the bytes the reference's protoc-generated `_pb2` writes
     (`SerializeToString`), and each side parses the other's bytes back to
     an equal message;
  3. the RPC plane carries unary, server-streaming and bidirectional calls,
     refuses a message over the 32 MiB cap, ends a call whose propagated
     deadline budget runs out with DEADLINE_EXCEEDED, and serves the
     blocking client from a worker thread.

Map entries are written in key order by the port; protobuf leaves the
order of several entries unspecified (the reference's writes them in an
order of its own), so messages with maps of one entry are held
byte-for-byte and maps of several entries by parsing each side's bytes
with the other."""
import asyncio
import filecmp
import os
import threading
import zlib

import numpy as np
import pytest

from seaweedfs_tpu.pb import master_pb2 as ref_master
from seaweedfs_tpu.pb import volume_server_pb2 as ref_volume
from seaweedfs_tpu_torch.pb import (
    RpcError,
    RpcServer,
    StatusCode,
    Stub,
    channel,
    close_all_channels,
    master_pb2,
    server_address,
    sync_channel_cached,
    volume_server_pb2,
    wire,
)
from seaweedfs_tpu_torch.pb import rpc as rpc_mod
from seaweedfs_tpu_torch.utils import faultpolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = {"master.proto": (master_pb2, ref_master),
         "volume_server.proto": (volume_server_pb2, ref_volume)}


@pytest.mark.parametrize("name", sorted(FILES))
def test_proto_files_are_copies(name):
    assert filecmp.cmp(
        os.path.join(REPO, "seaweedfs_tpu_torch", "pb", name),
        os.path.join(REPO, "seaweedfs_tpu", "pb", name), shallow=False)


def test_server_address():
    assert server_address.parse("localhost:9333") == ("localhost", 9333, 19333)
    assert server_address.parse("h:8080.18081") == ("h", 8080, 18081)
    assert server_address.grpc_address("h:9333") == "h:19333"


# --------------------------------------------------------------- messages


def _messages(ns, prefix=""):
    """Every message class of a parsed file, nested ones included."""
    out = []
    for name in sorted(vars(ns)):
        cls = getattr(ns, name)
        if isinstance(cls, type) and issubclass(cls, wire.Message):
            out.append(cls)
    seen = set()
    stack = list(out)
    while stack:
        cls = stack.pop()
        if cls in seen:
            continue
        seen.add(cls)
        for fd in cls._fields.values():
            for sub in (fd.message, fd.value_message):
                if sub is not None:
                    stack.append(sub)
    return sorted(seen, key=lambda c: c.DESCRIPTOR_NAME)


ALL_MESSAGES = [
    (fname, cls.DESCRIPTOR_NAME)
    for fname, (port_ns, _) in sorted(FILES.items())
    for cls in _messages(port_ns)
]


def _ref_class(ref_mod, full_name):
    parts = full_name.split(".")[1:]  # drop the package
    cls = getattr(ref_mod, parts[0])
    for p in parts[1:]:
        cls = getattr(cls, p)
    return cls


def _scalar(rng, kind, allow_default=True):
    if allow_default and rng.random() < 0.15:
        return {"string": "", "bytes": b"", "bool": False,
                "double": 0.0, "float": 0.0}.get(kind, 0)
    if kind == "string":
        alphabet = list("abcxyz019 _-") + ["é", "ß", "中", "😀"]
        return "".join(rng.choice(alphabet)
                       for _ in range(int(rng.integers(1, 24))))
    if kind == "bytes":
        return rng.bytes(int(rng.integers(1, 64)))
    if kind == "bool":
        return True
    if kind == "double":
        return float(rng.choice([-1.5, 0.25, 3.0e9, -0.0, 1e-300])) \
            if rng.random() < 0.3 else float(rng.normal() * 1e3)
    if kind == "float":
        return float(np.float32(rng.normal() * 100))
    lo, hi = {
        "int32": (-(1 << 31), 1 << 31), "int64": (-(1 << 63), 1 << 63),
        "uint32": (0, 1 << 32), "uint64": (0, 1 << 64),
        "sint32": (-(1 << 31), 1 << 31), "sint64": (-(1 << 63), 1 << 63),
        "fixed32": (0, 1 << 32), "fixed64": (0, 1 << 64),
        "sfixed32": (-(1 << 31), 1 << 31), "sfixed64": (-(1 << 63), 1 << 63),
        "enum": (0, 3),
    }[kind]
    if rng.random() < 0.5:  # small values: one-byte varints
        return int(rng.integers(max(lo, -3), min(hi, 200)))
    span = hi - lo
    return lo + int.from_bytes(rng.bytes(8), "little") % span


def _random_tree(rng, cls, depth, max_map):
    """{field: value} for one message, nested messages as subtrees."""
    tree = {}
    for fd in cls._ordered:
        if rng.random() < 0.2:
            continue  # unset
        if fd.kind == "map":
            n = int(rng.integers(0, max_map + 1))
            keys = {_scalar(rng, fd.key_kind, allow_default=False)
                    for _ in range(n)}
            tree[fd.name] = {k: _scalar(rng, fd.value_kind) for k in keys}
        elif fd.kind == "message":
            if depth <= 0:
                continue
            if fd.repeated:
                tree[fd.name] = [
                    _random_tree(rng, fd.message, depth - 1, max_map)
                    for _ in range(int(rng.integers(0, 3)))]
            else:
                tree[fd.name] = _random_tree(rng, fd.message, depth - 1,
                                             max_map)
        elif fd.repeated:
            tree[fd.name] = [_scalar(rng, fd.kind)
                             for _ in range(int(rng.integers(0, 5)))]
        else:
            tree[fd.name] = _scalar(rng, fd.kind)
    return tree


def _build(cls, tree, resolve):
    """A message of `cls` (a port class, or resolved to the reference's)
    from a tree."""
    target = resolve(cls)
    kw = {}
    for name, val in tree.items():
        fd = cls._fields[name]
        if fd.kind == "message" and fd.repeated:
            kw[name] = [_build(fd.message, v, resolve) for v in val]
        elif fd.kind == "message":
            kw[name] = _build(fd.message, val, resolve)
        else:
            kw[name] = val
    return target(**kw)


@pytest.mark.parametrize("fname,msg_name", ALL_MESSAGES)
def test_message_bytes_equal_the_reference(fname, msg_name):
    port_ns, ref_mod = FILES[fname]
    cls = next(c for c in _messages(port_ns) if c.DESCRIPTOR_NAME == msg_name)
    rng = np.random.default_rng(zlib.crc32(msg_name.encode()))
    for trial in range(12):
        tree = _random_tree(rng, cls, depth=3, max_map=1)
        port = _build(cls, tree, lambda c: c)
        ref = _build(cls, tree,
                     lambda c: _ref_class(ref_mod, c.DESCRIPTOR_NAME))
        data = port.SerializeToString()
        assert data == ref.SerializeToString(), (msg_name, trial, tree)
        # round trips both ways
        assert cls.FromString(data) == port
        assert type(ref).FromString(data) == ref
        assert cls.FromString(ref.SerializeToString()) == port


@pytest.mark.parametrize("fname", sorted(FILES))
def test_multi_entry_maps_parse_both_ways(fname):
    port_ns, ref_mod = FILES[fname]
    rng = np.random.default_rng(7)
    with_maps = [c for c in _messages(port_ns)
                 if any(fd.kind == "map" for fd in c._fields.values())]
    assert with_maps or fname == "volume_server.proto"
    for cls in with_maps:
        for _ in range(8):
            tree = _random_tree(rng, cls, depth=2, max_map=6)
            port = _build(cls, tree, lambda c: c)
            ref = _build(cls, tree,
                         lambda c: _ref_class(ref_mod, c.DESCRIPTOR_NAME))
            assert type(ref).FromString(port.SerializeToString()) == ref
            assert cls.FromString(ref.SerializeToString()) == port


def test_wire_details():
    """Proto3 presence, packed repeated fields, zigzag and negative varints,
    and a default sub-message that attaches on its first write."""
    hb = master_pb2.Heartbeat()
    tel = hb.telemetry
    assert not hb.HasField("telemetry") and hb.SerializeToString() == b""
    tel.compile_hits = 3
    assert hb.HasField("telemetry")
    assert hb.SerializeToString() == ref_master.Heartbeat(
        telemetry=ref_master.VolumeServerTelemetry(compile_hits=3)
    ).SerializeToString()
    s = master_pb2.StageDigest(bucket_counts=[0, 1, 300], sum_seconds=-0.0)
    assert s.SerializeToString() == ref_master.StageDigest(
        bucket_counts=[0, 1, 300], sum_seconds=-0.0).SerializeToString()
    lease = master_pb2.LeaseAdminTokenRequest(previous_token=-5)
    assert lease.SerializeToString() == ref_master.LeaseAdminTokenRequest(
        previous_token=-5).SerializeToString()
    assert len(lease.SerializeToString()) == 11  # 10-byte varint + tag
    ns = wire.parse("""
        syntax = "proto3";
        package t;
        enum Color { RED = 0; BLUE = 2; }
        message M { sint32 a = 1; sint64 b = 2; Color c = 3;
                    fixed32 d = 4; sfixed64 e = 5; float f = 6;
                    repeated sint32 g = 7; }
    """)
    m = ns.M(a=-1, b=-(1 << 40), c=ns.BLUE, d=7, e=-9, f=0.5, g=[-2, 2])
    data = m.SerializeToString()
    assert data[:2] == b"\x08\x01"  # zigzag(-1) == 1
    assert ns.M.FromString(data) == m and ns.M.FromString(data).g == [-2, 2]
    with pytest.raises(wire.DecodeError):
        master_pb2.Heartbeat.FromString(b"\x0a\x05ab")


# ------------------------------------------------------------- RPC plane


class FakeMaster:
    def __init__(self):
        self.seen_md = []
        self.seen_remaining = []

    async def Assign(self, request, context):
        return master_pb2.AssignResponse(
            fid=f"1,00000064{0xDEAD:08x}", count=request.count or 1
        )

    async def SendHeartbeat(self, request_iterator, context):
        async for hb in request_iterator:
            yield master_pb2.HeartbeatResponse(
                volume_size_limit=1000, leader=hb.ip
            )

    async def LookupEcVolume(self, request, context):
        # a slow handler: the caller's budget runs out first
        self.seen_md.append(dict(context.invocation_metadata()))
        self.seen_remaining.append(faultpolicy.remaining_s())
        await asyncio.sleep(5)
        return master_pb2.LookupEcVolumeResponse()

    async def VolumeList(self, request, context):
        # the handler's own budget check, adopted from the caller's
        await asyncio.sleep(0.15)
        faultpolicy.check_remaining("volume list")
        return master_pb2.VolumeListResponse()

    async def Statistics(self, request, context):
        await context.abort(StatusCode.NOT_FOUND, "no such collection")


class FakeVolume:
    async def CopyFile(self, request, context):
        for i in range(request.stop_offset):
            yield volume_server_pb2.CopyFileResponse(
                file_content=bytes([i]) * (1000 + i))

    async def VolumeEcShardRead(self, request, context):
        # one response past the cap
        yield volume_server_pb2.VolumeEcShardReadResponse(
            data=b"x" * (rpc_mod.MAX_MESSAGE_SIZE + 1))


def _serve(coro_fn):
    async def go():
        server = RpcServer()
        master = FakeMaster()
        server.add_servicer(master_pb2, "Seaweed", master)
        server.add_servicer(volume_server_pb2, "VolumeServer", FakeVolume())
        port = await server.start()
        try:
            await coro_fn(f"127.0.0.1:{port}", master)
        finally:
            await close_all_channels()
            await server.stop()

    asyncio.run(go())


def test_unary_streaming_and_bidi():
    async def go(addr, master):
        stub = Stub(channel(addr), master_pb2, "Seaweed")
        resp = await stub.Assign(master_pb2.AssignRequest(count=3))
        assert resp.count == 3 and resp.fid.startswith("1,")

        async def pulses():
            for ip in ("a", "b", "c"):
                yield master_pb2.Heartbeat(ip=ip)

        got = [r.leader async for r in stub.SendHeartbeat(pulses())]
        assert got == ["a", "b", "c"]

        vstub = Stub(channel(addr), volume_server_pb2, "VolumeServer")
        chunks = [r.file_content async for r in vstub.CopyFile(
            volume_server_pb2.CopyFileRequest(stop_offset=5))]
        assert chunks == [bytes([i]) * (1000 + i) for i in range(5)]

        with pytest.raises(RpcError) as ei:
            await stub.LookupVolume(master_pb2.LookupVolumeRequest())
        assert ei.value.code() == StatusCode.UNIMPLEMENTED
        with pytest.raises(RpcError) as ei:
            await stub.Statistics(master_pb2.StatisticsRequest())
        assert ei.value.code() == StatusCode.NOT_FOUND
        assert ei.value.details() == "no such collection"
        # the connection survived every ending above and is reused
        assert (await stub.Assign(master_pb2.AssignRequest())).count == 1
        assert len(channel(addr)._idle) == 1

    _serve(go)


def test_message_over_the_cap_is_refused():
    async def go(addr, master):
        vstub = Stub(channel(addr), volume_server_pb2, "VolumeServer")
        big = volume_server_pb2.WriteNeedleBlobRequest(
            needle_blob=b"y" * (rpc_mod.MAX_MESSAGE_SIZE + 1))
        with pytest.raises(RpcError) as ei:
            await vstub.WriteNeedleBlob(big)
        assert ei.value.code() == StatusCode.RESOURCE_EXHAUSTED
        with pytest.raises(RpcError) as ei:
            async for _ in vstub.VolumeEcShardRead(
                    volume_server_pb2.VolumeEcShardReadRequest()):
                pass
        assert ei.value.code() == StatusCode.RESOURCE_EXHAUSTED
        stub = Stub(channel(addr), master_pb2, "Seaweed")
        assert (await stub.Assign(master_pb2.AssignRequest(count=2))).count == 2

    _serve(go)


def test_a_propagated_deadline_ends_the_call():
    async def go(addr, master):
        stub = Stub(channel(addr), master_pb2, "Seaweed")
        t0 = asyncio.get_running_loop().time()
        with faultpolicy.deadline_scope(0.3):
            with pytest.raises(RpcError) as ei:
                await stub.LookupEcVolume(master_pb2.LookupEcVolumeRequest())
        assert ei.value.code() == StatusCode.DEADLINE_EXCEEDED
        assert asyncio.get_running_loop().time() - t0 < 2.0
        md = master.seen_md[0]
        assert 0 < float(md[faultpolicy.GRPC_DEADLINE_KEY]) <= 300
        assert 0 < master.seen_remaining[0] <= 0.3
        # the server side: the handler adopted the budget and found it spent
        with faultpolicy.deadline_scope(0.1):
            with pytest.raises(RpcError) as ei:
                await stub.VolumeList(master_pb2.VolumeListRequest(),
                                      timeout=5.0)
        assert ei.value.code() == StatusCode.DEADLINE_EXCEEDED
        # outside any scope nothing is stamped
        assert (await stub.Assign(master_pb2.AssignRequest())).count == 1

    _serve(go)


def test_sync_client_from_a_worker_thread():
    async def go(addr, master):
        def work():
            assert threading.current_thread() is not threading.main_thread()
            ch = sync_channel_cached(addr)
            assert sync_channel_cached(addr) is ch
            vstub = Stub(ch, volume_server_pb2, "VolumeServer")
            chunks = [r.file_content for r in vstub.CopyFile(
                volume_server_pb2.CopyFileRequest(stop_offset=3), timeout=5)]
            stub = Stub(ch, master_pb2, "Seaweed")
            resp = stub.Assign(master_pb2.AssignRequest(count=4), timeout=5)
            try:
                stub.LookupEcVolume(master_pb2.LookupEcVolumeRequest(),
                                    timeout=0.2)
            except RpcError as e:
                code = e.code()
            return chunks, resp.count, code

        results = await asyncio.gather(*[asyncio.to_thread(work)
                                         for _ in range(4)])
        for chunks, count, code in results:
            assert chunks == [bytes([i]) * (1000 + i) for i in range(3)]
            assert count == 4 and code == StatusCode.DEADLINE_EXCEEDED

    _serve(go)


def test_an_unreachable_address_is_unavailable():
    async def go():
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        stub = Stub(channel(f"127.0.0.1:{port}"), master_pb2, "Seaweed")
        with pytest.raises(RpcError) as ei:
            await stub.Assign(master_pb2.AssignRequest(), timeout=2)
        assert ei.value.code() == StatusCode.UNAVAILABLE
        await close_all_channels()

    asyncio.run(go())
