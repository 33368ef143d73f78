"""Write JWTs, the white-list guard and mutual TLS in the port, held against
the JAX package's.

- The JWT helpers (security/jwt.py) of both packages give the same tokens
  and the same verdicts (tests/test_security.py is the model).
- security.toml parses to the same key, lifetime, white list and TLS
  files in both packages.
- A master and two volume servers of each package, with the key from a
  security.toml: the same status and body for each write and delete on a
  volume placed `001` (no token, a token for another fid, an expired one,
  the master's token by header and by ?jwt=, a replicated write carrying
  it, an unsigned replica write), and Assign's token authorizes the write.
- A peer outside `[access] white_list` gets the reference's 403 from both
  the master and the volume server.
- Mutual TLS on the port's RPC plane: a cluster whose heartbeats, assigns
  and peer calls ride TLS; a client with the CA's certificate is served,
  one without a certificate and a plaintext one are refused.
"""
import asyncio
import time

import pytest

from seaweedfs_tpu import security as ref_security
from seaweedfs_tpu.operation import assign as ref_assign
from seaweedfs_tpu.operation import lookup_file_id_with_auth as ref_lookup_auth
from seaweedfs_tpu.operation import upload_data as ref_upload
from seaweedfs_tpu.repair import RepairConfig
from seaweedfs_tpu.security import guard as ref_guard
from seaweedfs_tpu.security import tls as ref_tls
from seaweedfs_tpu.server.master import MasterServer as RefMaster
from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer
from seaweedfs_tpu.utils import config as ref_config
from seaweedfs_tpu_torch import security as port_security
from seaweedfs_tpu_torch.operation import assign as port_assign
from seaweedfs_tpu_torch.operation import lookup_file_id_with_auth as port_lookup_auth
from seaweedfs_tpu_torch.operation import upload_data as port_upload
from seaweedfs_tpu_torch.pb import RpcError, Stub, channel, volume_server_pb2
from seaweedfs_tpu_torch.pb.rpc import Channel, SyncChannel
from seaweedfs_tpu_torch.repair import RepairConfig as PortRepairConfig
from seaweedfs_tpu_torch.security import guard as port_guard
from seaweedfs_tpu_torch.security import tls as port_tls
from seaweedfs_tpu_torch.server.cluster import LocalCluster as PortCluster
from seaweedfs_tpu_torch.server.http import Client
from seaweedfs_tpu_torch.server.master import MasterServer as PortMaster
from seaweedfs_tpu_torch.server.volume import VolumeServer as PortVolumeServer
from seaweedfs_tpu_torch.utils import config as port_config

PACKAGES = {"ref": ref_security, "port": port_security}
KEY = "t0psecret"
VID = 5

SECURITY_TOML = f"""
[jwt.signing]
key = "{KEY}"
expires_after_seconds = 30

[access]
white_list = ["127.0.0.1", "10.0.0.0/8"]

[tls]
ca = "/etc/swfs/ca.crt"
cert = "/etc/swfs/server.crt"
key = "/etc/swfs/server.key"
"""


class _FakeRequest:
    def __init__(self, query=None, headers=None):
        self.query = query or {}
        self.headers = headers or {}


# ---------------------------------------------------------------- unit: jwt


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_jwt_round_trip_and_refusals(pkg):
    sec = PACKAGES[pkg]
    tok = sec.encode_jwt("secret", {"fid": "3,01abcd",
                                    "exp": int(time.time()) + 60})
    assert sec.decode_jwt("secret", tok)["fid"] == "3,01abcd"
    with pytest.raises(sec.JwtError):
        sec.decode_jwt("other-key", tok)
    head, _, sig = tok.split(".")
    other = sec.encode_jwt("secret", {"fid": "9,ffffff"}).split(".")[1]
    with pytest.raises(sec.JwtError):
        sec.decode_jwt("secret", f"{head}.{other}.{sig}")
    with pytest.raises(sec.JwtError, match="expired"):
        sec.decode_jwt("secret", sec.encode_jwt(
            "secret", {"fid": "3,01abcd", "exp": int(time.time()) - 5}))
    for bad in ("", "x", "a.b", "a.b.c.d", "!!.??.!!"):
        with pytest.raises(sec.JwtError):
            sec.decode_jwt("secret", bad)
    assert sec.gen_volume_write_jwt("", "3,01abcd") == ""
    key = "k"
    tok = sec.gen_volume_write_jwt(key, "3,01abcd")
    req = _FakeRequest(headers={"Authorization": f"Bearer {tok}"})
    assert sec.verify_volume_write_jwt(key, req, "3,01abcd")
    assert sec.verify_volume_write_jwt(key, req, "3,01abcd_2")
    assert not sec.verify_volume_write_jwt(key, req, "3,99ffff")
    assert sec.verify_volume_write_jwt(
        key, _FakeRequest(query={"jwt": tok}), "3,01abcd")
    assert not sec.verify_volume_write_jwt(key, _FakeRequest(), "3,01abcd")
    assert sec.verify_volume_write_jwt("", _FakeRequest(), "3,01abcd")


def test_jwt_tokens_are_byte_equal(monkeypatch):
    claims = {"fid": "7,0a1b2c3d4e", "exp": 1_800_000_000}
    assert port_security.encode_jwt(KEY, claims) == \
        ref_security.encode_jwt(KEY, claims)
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.0)
    for exp in (10, 0):
        assert port_security.gen_volume_write_jwt(KEY, "7,0a1b", exp) == \
            ref_security.gen_volume_write_jwt(KEY, "7,0a1b", exp)
    for tok in (port_security.gen_volume_write_jwt(KEY, "7,0a1b"), "a.b.c"):
        verdicts = []
        for sec in (port_security, ref_security):
            try:
                verdicts.append(sec.decode_jwt(KEY, tok))
            except sec.JwtError as e:
                verdicts.append(str(e))
        assert verdicts[0] == verdicts[1]


def test_security_toml_parses_alike(tmp_path):
    (tmp_path / "security.toml").write_text(SECURITY_TOML)
    dirs = [str(tmp_path)]
    assert port_config.jwt_signing_key(dirs) == \
        ref_config.jwt_signing_key(dirs) == KEY
    assert port_config.jwt_expires_sec(dirs) == \
        ref_config.jwt_expires_sec(dirs) == 30
    assert port_guard.from_security_toml(dirs) == \
        ref_guard.from_security_toml(dirs) == ["127.0.0.1", "10.0.0.0/8"]
    port_cfg = port_tls.from_security_toml(dirs)
    ref_cfg = ref_tls.from_security_toml(dirs)
    assert (port_cfg.ca, port_cfg.cert, port_cfg.key) == (
        ref_cfg.ca, ref_cfg.cert, ref_cfg.key) == (
        "/etc/swfs/ca.crt", "/etc/swfs/server.crt", "/etc/swfs/server.key")
    (tmp_path / "security.toml").write_text('[tls]\nca = "/x/ca.crt"\n')
    for mod in (port_tls, ref_tls):
        with pytest.raises(ValueError, match="missing"):
            mod.from_security_toml(dirs)
    empty = tmp_path / "none"
    empty.mkdir()
    for mod in (port_tls, ref_tls):
        assert mod.from_security_toml([str(empty)]) is None
    assert port_config.jwt_signing_key([str(empty)]) == ""
    g = port_guard.Guard(["127.0.0.1", "10.0.0.0/8", "::1"])
    r = ref_guard.Guard(["127.0.0.1", "10.0.0.0/8", "::1"])
    for ip in ("127.0.0.1", "10.3.4.5", "::1", "192.168.1.1", "not-an-ip"):
        assert g.allowed(ip) == r.allowed(ip)
    assert not port_guard.Guard([]).enabled and port_guard.Guard([]).allowed(
        "8.8.8.8")


# ---------------------------------------------------------------- clusters


class _Side:
    """A master and two volume servers of one package, the key read from
    a security.toml; both servers hold vid 5 placed 001."""

    def __init__(self, kind, base, key):
        self.kind = kind
        self.base = base
        self.key = key

    async def start(self):
        import os

        dirs = [os.path.join(self.base, f"vs{i}") for i in (0, 1)]
        if self.kind == "port":
            self.master = PortMaster(
                port=0, volume_size_limit_mb=64, pulse_seconds=1,
                jwt_signing_key=self.key,
                ec_repair=PortRepairConfig(enabled=False))
            make = lambda d: PortVolumeServer(  # noqa: E731
                masters=[self.master.advertise_url], directories=[d],
                port=0, grpc_port=0, pulse_seconds=1, ec_backend="torch",
                jwt_signing_key=self.key)
        else:
            self.master = RefMaster(
                port=0, volume_size_limit_mb=64, pulse_seconds=1,
                jwt_signing_key=self.key,
                ec_repair=RepairConfig(enabled=False))
            make = lambda d: RefVolumeServer(  # noqa: E731
                masters=[self.master.advertise_url], directories=[d],
                port=0, grpc_port=0, pulse_seconds=1, ec_backend="numpy",
                jwt_signing_key=self.key)
        await self.master.start()
        self.vss = []
        for d in dirs:
            vs = make(d)
            vs.store.add_volume(VID, replica_placement="001")
            await vs.start()
            self.vss.append(vs)
            for _ in range(500):
                if len(self.master.topo.data_nodes()) == len(self.vss):
                    break
                await asyncio.sleep(0.02)
        for _ in range(500):
            if len(self.master.topo.lookup_volume("", VID) or []) == 2:
                break
            await asyncio.sleep(0.02)
        else:
            raise AssertionError("the master never saw both copies")

    async def stop(self):
        for vs in self.vss:
            await vs.stop()
        await self.master.stop()
        if self.kind == "port":
            from seaweedfs_tpu_torch.pb import close_all_channels

            await close_all_channels()

    async def call(self, i, method, path, body=b"", headers=None):
        vs = self.vss[i]
        c = Client(vs.ip, vs.port)
        try:
            st, _, data = await c.request(method, path, headers, body)
        finally:
            await c.close()
        return st, data

    async def lookup_auth(self, fid):
        fn = port_lookup_auth if self.kind == "port" else ref_lookup_auth
        urls, auth = await fn(self.master.advertise_url, fid)
        return sorted(u.replace(self.vss[0].url, "vs0").replace(
            self.vss[1].url, "vs1") for u in urls), auth


async def _write_script(side: _Side, sec) -> list:
    """Every write and delete of the module docstring, on one side: ->
    [(step, status, body)] with the fid's volume server named by index."""
    await side.start()
    seen = []
    try:
        fid, other = f"{VID},01637037d6", f"{VID},02637037d6"
        urls, auth = await side.lookup_auth(fid)
        _, other_auth = await side.lookup_auth(other)
        assert auth and other_auth and auth != other_auth
        assert sec.decode_jwt(side.key, auth)["fid"] == fid
        seen.append(("lookup", urls))
        expired = sec.encode_jwt(side.key, {"fid": fid,
                                            "exp": int(time.time()) - 5})
        ct = {"Content-Type": "application/x-test"}

        def bearer(tok):
            return {**ct, "Authorization": f"Bearer {tok}"}

        steps = [
            ("no_token", 0, "POST", f"/{fid}", ct),
            ("other_fid", 0, "POST", f"/{fid}", bearer(other_auth)),
            ("expired", 0, "POST", f"/{fid}", bearer(expired)),
            ("wrong_key", 0, "POST", f"/{fid}", bearer(
                sec.gen_volume_write_jwt("wrong-key", fid))),
            ("unsigned_replica", 1, "POST", f"/{fid}?type=replicate", ct),
            ("good_query", 0, "POST", f"/{fid}?jwt={auth}", ct),
            ("good_header", 0, "POST", f"/{fid}", bearer(auth)),
        ]
        for name, i, method, path, headers in steps:
            st, data = await side.call(i, method, path,
                                       f"body of {name}".encode(), headers)
            seen.append((name, st, data))
        for i in (0, 1):  # the replicated write carried the token
            seen.append((f"get_{i}", *await side.call(i, "GET", f"/{fid}")))
        seen.append(("delete_no_token",
                     *await side.call(0, "DELETE", f"/{fid}")))
        seen.append(("delete_other", *await side.call(
            0, "DELETE", f"/{fid}", headers=bearer(other_auth))))
        seen.append(("delete", *await side.call(
            0, "DELETE", f"/{fid}", headers=bearer(auth))))
        for i in (0, 1):
            seen.append((f"after_delete_{i}",
                         *await side.call(i, "GET", f"/{fid}")))
        # Assign signs its fid; the token authorizes that write only
        assign = port_assign if side.kind == "port" else ref_assign
        upload = port_upload if side.kind == "port" else ref_upload
        a = await assign(side.master.advertise_url, replication="001")
        assert sec.decode_jwt(side.key, a.auth)["fid"] == a.fid
        doc = await upload(f"http://{a.url}/{a.fid}", b"assigned" * 100,
                           "a.bin", jwt=a.auth)
        seen.append(("assign_upload", doc["size"]))
        seen.append(("assign_other_fid", *await side.call(
            0, "POST", f"/{other}", b"x", bearer(a.auth))))
    finally:
        await side.stop()
    return seen


def test_write_jwt_statuses_match_the_reference(tmp_path):
    (tmp_path / "security.toml").write_text(SECURITY_TOML)
    dirs = [str(tmp_path)]
    port_key = port_config.jwt_signing_key(dirs)
    ref_key = ref_config.jwt_signing_key(dirs)
    ref = asyncio.run(_write_script(
        _Side("ref", str(tmp_path / "ref"), ref_key), ref_security))
    port = asyncio.run(_write_script(
        _Side("port", str(tmp_path / "port"), port_key), port_security))
    got = {s[0]: s[1:] for s in ref}
    assert got["lookup"] == (["http://vs0/5,01637037d6",
                              "http://vs1/5,01637037d6"],)
    for name in ("no_token", "other_fid", "expired", "wrong_key",
                 "unsigned_replica", "delete_no_token", "delete_other",
                 "assign_other_fid"):
        assert got[name] == (401, b"missing or invalid write jwt"), name
    for name in ("good_query", "good_header", "delete"):
        assert got[name][0] == 200, name
    assert got["get_0"] == got["get_1"] == (200, b"body of good_header")
    assert got["after_delete_0"][0] == got["after_delete_1"][0] == 404
    assert port == ref


def test_white_list_refuses_like_the_reference(tmp_path):
    """A peer outside `[access] white_list` gets 403 "request from
    127.0.0.1 not allowed" from both packages' masters and volume servers;
    a list that holds it lets it through."""

    async def ask(server, path):
        c = Client("127.0.0.1", server.port)
        try:
            st, h, body = await c.request("GET", path)
        finally:
            await c.close()
        return st, h.get("Content-Type"), body

    async def go(white_list, sub):
        d = tmp_path / sub
        servers = [
            PortMaster(port=0, white_list=white_list,
                       ec_repair=PortRepairConfig(enabled=False)),
            RefMaster(port=0, white_list=white_list,
                      ec_repair=RepairConfig(enabled=False)),
            PortVolumeServer([], [str(d / "p")], port=0, ec_backend="numpy",
                             white_list=white_list),
            RefVolumeServer(masters=[], directories=[str(d / "r")], port=0,
                            grpc_port=0, ec_backend="numpy",
                            white_list=white_list),
        ]
        for s in servers:
            await (s.start(heartbeat=False) if s is servers[3]
                   else s.start())
        try:
            masters = [await ask(s, "/dir/status") for s in servers[:2]]
            volumes = [await ask(s, "/status") for s in servers[2:]]
        finally:
            for s in servers:
                await s.stop()
        return masters, volumes

    masters, volumes = asyncio.run(go(["10.0.0.0/8"], "deny"))
    want = (403, "text/plain; charset=utf-8",
            b"request from 127.0.0.1 not allowed")
    assert masters == [want, want] and volumes == [want, want]
    masters, volumes = asyncio.run(go(["127.0.0.0/8"], "allow"))
    assert [m[0] for m in masters + volumes] == [200] * 4


# ---------------------------------------------------------------- mutual TLS


def test_mutual_tls_on_the_rpc_plane(tmp_path, monkeypatch):
    pytest.importorskip("cryptography")
    import ssl

    from seaweedfs_tpu_torch.operation import lookup_file_id

    pki = port_tls.generate_test_pki(str(tmp_path / "pki"))
    no_cert = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    no_cert.load_verify_locations(pki.ca)

    async def go():
        c = PortCluster(n_volume_servers=2, base_dir=str(tmp_path / "c"),
                        ec_backend="torch",
                        master_kwargs={"ec_repair": PortRepairConfig(
                            enabled=False)})
        await c.start()  # the heartbeats ride TLS
        try:
            master = c.master.advertise_url
            a = await port_assign(master)
            await port_upload(f"http://{a.url}/{a.fid}", b"tls" * 1000, "t")
            assert await lookup_file_id(master, a.fid) == [
                f"http://{a.url}/{a.fid}"]
            vs = c.volume_servers[1]
            ok = await Stub(channel(vs.grpc_url), volume_server_pb2,
                            "VolumeServer").VolumeServerStatus(
                volume_server_pb2.VolumeServerStatusRequest(), timeout=10)
            assert list(ok.data_dirs) == [loc.directory
                                          for loc in vs.store.locations]

            def sync_status():
                # blocking: on a worker thread, off this loop's servers
                return Stub(SyncChannel(vs.grpc_url), volume_server_pb2,
                            "VolumeServer").VolumeServerStatus(
                    volume_server_pb2.VolumeServerStatusRequest(),
                    timeout=10)

            assert list((await asyncio.to_thread(sync_status)).data_dirs) \
                == list(ok.data_dirs)
            # a client without a certificate, and a plaintext one: refused
            for ctx in (no_cert, None):
                monkeypatch.setattr(port_tls, "client_ssl", lambda: ctx)
                with pytest.raises(RpcError):
                    await Stub(Channel(vs.grpc_url), volume_server_pb2,
                               "VolumeServer").VolumeServerStatus(
                        volume_server_pb2.VolumeServerStatusRequest(),
                        timeout=10)
                with pytest.raises(RpcError):
                    await asyncio.to_thread(sync_status)
            monkeypatch.undo()
        finally:
            await c.stop()

    port_tls.configure(pki)
    try:
        asyncio.run(go())
    finally:
        port_tls.configure(None)
