"""`.vif` sidecar: volume info as protojson (version, replication, tiering).

The reference marshals volume_server_pb.VolumeInfo with protojson
(the reference's weed/storage/volume_info/volume_info.go:63-88), i.e. the
file is plain JSON with camelCase proto field names — so a dict round-trip
here stays byte-compatible in spirit and interoperable in practice.
"""
from __future__ import annotations

import json
import os


def load_volume_info(path: str) -> dict:
    """Returns {} if the file is absent/unreadable (MaybeLoadVolumeInfo)."""
    try:
        with open(path, "r") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def save_volume_info(path: str, info: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f, indent=2)
    os.replace(tmp, path)
