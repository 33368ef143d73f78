"""security.toml-driven mutual TLS for the port's RPC plane.

Port of seaweedfs_tpu/security/tls.py.  The reference wraps grpc
credentials; the port's RPC plane (pb/rpc.py) runs its own frames on
asyncio streams (`RpcServer`, `Channel`) and on blocking sockets
(`SyncChannel`), so here TLS is a standard-library `ssl.SSLContext` given
to all three: the listener requires and verifies a client certificate
signed by the configured CA, and every client presents its own and
verifies the server's against the same CA (and its address against the
certificate's names).

Process-global, as the reference's security.toml is: `configure()` once at
startup (the command line does it from `from_security_toml()`), after
which `RpcServer.start()` binds a TLS listener and new channels dial TLS.

security.toml shape:

    [tls]
    ca   = "/etc/seaweedfs/ca.crt"
    cert = "/etc/seaweedfs/server.crt"
    key  = "/etc/seaweedfs/server.key"
"""
from __future__ import annotations

import dataclasses
import os
import ssl


@dataclasses.dataclass(frozen=True)
class TlsConfig:
    ca: str  # CA bundle path (verifies peers both ways)
    cert: str  # this process's certificate path
    key: str  # this process's private key path


_config: TlsConfig | None = None
# "server" / "client" -> the context built from _config (files read once)
_contexts: dict[str, ssl.SSLContext] = {}


def configure(cfg: TlsConfig | None) -> None:
    """Set (or clear) the process-wide TLS config.  Cached channels are
    dropped so new dials pick up the change."""
    global _config
    _config = cfg
    _contexts.clear()
    from ..pb import rpc

    rpc.drop_cached_channels()


def configured() -> TlsConfig | None:
    return _config


def from_security_toml(dirs=None) -> TlsConfig | None:
    """[tls] section of security.toml -> TlsConfig (None when absent)."""
    from ..utils import config as config_util

    kw = {"dirs": dirs} if dirs else {}
    cfg = config_util.load_config("security", **kw)
    section = cfg.get("tls") or {}
    present = {k for k in ("ca", "cert", "key") if section.get(k)}
    if len(present) == 3:
        return TlsConfig(
            ca=section["ca"], cert=section["cert"], key=section["key"]
        )
    if present:
        # a half-filled section must fail, not silently serve plaintext
        # while the operator believes mTLS is on
        missing = {"ca", "cert", "key"} - present
        raise ValueError(
            f"security.toml [tls] is missing {sorted(missing)} — set all "
            "of ca/cert/key or none"
        )
    return None


def server_context(cfg: TlsConfig) -> ssl.SSLContext:
    """The listener's context: its own certificate, and a client
    certificate required and verified against the CA (mutual TLS)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cfg.cert, cfg.key)
    ctx.load_verify_locations(cfg.ca)
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(cfg: TlsConfig) -> ssl.SSLContext:
    """A dialer's context: the server verified against the CA and its
    address against the certificate's names; this process's certificate
    presented."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(cfg.ca)
    ctx.load_cert_chain(cfg.cert, cfg.key)
    return ctx


def _context(side: str, build) -> ssl.SSLContext | None:
    cfg = _config
    if cfg is None:
        return None
    ctx = _contexts.get(side)
    if ctx is None:
        ctx = _contexts[side] = build(cfg)
    return ctx


def server_ssl() -> ssl.SSLContext | None:
    """The listener context when TLS is configured, else None."""
    return _context("server", server_context)


def client_ssl() -> ssl.SSLContext | None:
    """The dialer context when TLS is configured, else None."""
    return _context("client", client_context)


def generate_test_pki(directory: str, hosts=("127.0.0.1", "localhost")) -> TlsConfig:
    """Self-signed CA + one server/client cert for tests and scaffolding
    (the reference points users at openssl; in-process generation keeps
    the e2e TLS test hermetic).  Needs the `cryptography` package, imported
    here only."""
    import datetime
    import ipaddress as ipa

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    os.makedirs(directory, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)

    def make_key():
        return rsa.generate_private_key(public_exponent=65537, key_size=2048)

    ca_key = make_key()
    ca_name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "seaweedfs-test-ca")]
    )
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name)
        .issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=1))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), True)
        .sign(ca_key, hashes.SHA256())
    )

    leaf_key = make_key()
    san = []
    for h in hosts:
        try:
            san.append(x509.IPAddress(ipa.ip_address(h)))
        except ValueError:
            san.append(x509.DNSName(h))
    leaf_cert = (
        x509.CertificateBuilder()
        .subject_name(
            x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, hosts[-1])])
        )
        .issuer_name(ca_name)
        .public_key(leaf_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=1))
        .add_extension(x509.SubjectAlternativeName(san), False)
        .sign(ca_key, hashes.SHA256())
    )

    paths = {}
    for name, data in (
        ("ca.crt", ca_cert.public_bytes(serialization.Encoding.PEM)),
        ("server.crt", leaf_cert.public_bytes(serialization.Encoding.PEM)),
        (
            "server.key",
            leaf_key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.TraditionalOpenSSL,
                serialization.NoEncryption(),
            ),
        ),
    ):
        p = os.path.join(directory, name)
        with open(p, "wb") as f:
            f.write(data)
        paths[name] = p
    return TlsConfig(
        ca=paths["ca.crt"], cert=paths["server.crt"], key=paths["server.key"]
    )
