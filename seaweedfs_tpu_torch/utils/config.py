"""Layered TOML configuration, mirroring the reference's viper loader.

A copy of seaweedfs_tpu/utils/config.py.

Reference: weed/util/config.go — config files named
<name>.toml are discovered in ./, ~/.seaweedfs/, and /etc/seaweedfs/ (first
hit wins); command-line flags override file values.  `weed scaffold`
generates commented templates (command/scaffold.go).

Typical files: security.toml ([jwt.signing] key — write-auth signing key;
[access] white_list; [tls] ca/cert/key), master.toml.
"""
from __future__ import annotations

import os

import tomllib

SEARCH_DIRS = (".", os.path.expanduser("~/.seaweedfs"), "/etc/seaweedfs")


def find_config(name: str, dirs=SEARCH_DIRS) -> str | None:
    """Path of the first <dir>/<name>.toml that exists, else None."""
    for d in dirs:
        path = os.path.join(d, name + ".toml")
        if os.path.isfile(path):
            return path
    return None


def load_config(name: str, dirs=SEARCH_DIRS) -> dict:
    """Parsed <name>.toml from the search path ({} when absent)."""
    path = find_config(name, dirs)
    if path is None:
        return {}
    with open(path, "rb") as f:
        return tomllib.load(f)


def get_path(cfg: dict, dotted: str, default=None):
    """cfg["a"]["b"] via "a.b" (viper-style access)."""
    node = cfg
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def storage_backends(dirs=SEARCH_DIRS) -> dict:
    """[storage.backend.<type>.<id>] sections from master.toml, flattened
    to the storage/backend.py configure() shape {"s3.default": {...}}
    (reference backend.go LoadConfiguration reads the same master.toml
    section)."""
    section = get_path(load_config("master", dirs), "storage.backend", {}) or {}
    out = {}
    for btype, ids in section.items():
        if not isinstance(ids, dict):
            continue
        for bid, conf in ids.items():
            if isinstance(conf, dict):
                out[f"{btype}.{bid}"] = {"type": btype, **conf}
    return out


def jwt_signing_key(dirs=SEARCH_DIRS) -> str:
    """The volume-write JWT signing key from security.toml
    (reference scaffold: [jwt.signing] key = ...)."""
    return get_path(load_config("security", dirs), "jwt.signing.key", "") or ""


def jwt_expires_sec(dirs=SEARCH_DIRS, default: int = 10) -> int:
    """Write-token lifetime from security.toml ([jwt.signing]
    expires_after_seconds)."""
    return int(
        get_path(
            load_config("security", dirs),
            "jwt.signing.expires_after_seconds",
            default,
        )
    )
