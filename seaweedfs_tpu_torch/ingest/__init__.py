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
from .config import IngestConfig
from .pipeline import GroupCommitter, IngestPipeline, IngestPlane

__all__ = [
    "GroupCommitter",
    "IngestConfig",
    "IngestPipeline",
    "IngestPlane",
]
