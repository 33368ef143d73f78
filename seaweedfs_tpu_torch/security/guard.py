"""IP-whitelist Guard for the public HTTP planes.

A copy of seaweedfs_tpu/security/guard.py without its aiohttp middleware:
the check runs in server/http.py's HTTPServer, which answers 403 with the
reference's text to a peer outside the list before any handler runs.

Reference: weed/security/guard.go:52-105 — handlers wrapped by a Guard
reject requests from addresses outside `[access] white_list` (exact IPs
or CIDR ranges) in security.toml.  An empty list means open access.
"""
from __future__ import annotations

import ipaddress


class Guard:
    def __init__(self, white_list: list[str] | None = None):
        self.networks: list[ipaddress._BaseNetwork] = []
        for item in white_list or []:
            item = item.strip()
            if not item:
                continue
            if "/" not in item:
                item += "/32" if ":" not in item else "/128"
            self.networks.append(ipaddress.ip_network(item, strict=False))

    @property
    def enabled(self) -> bool:
        return bool(self.networks)

    def allowed(self, ip: str) -> bool:
        if not self.networks:
            return True
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            return False
        return any(addr in net for net in self.networks)

    @staticmethod
    def refusal(ip: str) -> str:
        """The 403 body the reference's middleware answers with."""
        return f"request from {ip} not allowed"


def from_security_toml(dirs=None) -> list[str]:
    """[access] white_list from security.toml."""
    from ..utils import config as config_util

    kw = {"dirs": dirs} if dirs else {}
    cfg = config_util.load_config("security", **kw)
    wl = (cfg.get("access") or {}).get("white_list") or []
    return [str(x) for x in wl]
