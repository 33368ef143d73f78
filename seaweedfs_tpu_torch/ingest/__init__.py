"""Streaming ingest plane: write-path EC encode as data arrives.

Port of seaweedfs_tpu/ingest/.  `IngestPlane` (pipeline.py) sits on the
volume server's write path: uploads are admitted through QoS write tiers
and the deadline budget at the front door, land in per-volume
`IngestPipeline`s that stage completed stripe rows in a bounded arena of
pinned host rows and EC-encode them on the card (K1, ops/rs_ingest.py)
while the `.dat` is still growing, and group-commit their fsyncs.
`ec_generate` of a streamed volume then only sweeps the zero-padded tail
row — the bulk after-the-fact batch job becomes an online pipeline.
"""
import importlib

from .config import IngestConfig

# the pipeline brings the stream encoder, and so torch: it loads on its
# first use, so that a process that parses the volume command's flags
# (every command's parser) starts without it


def __getattr__(name: str):
    if name not in ("GroupCommitter", "IngestPipeline", "IngestPlane"):
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(".pipeline", __name__), name)
    globals()[name] = value
    return value


__all__ = [
    "GroupCommitter",
    "IngestConfig",
    "IngestPipeline",
    "IngestPlane",
]
