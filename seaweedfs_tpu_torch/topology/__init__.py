"""Master control plane: the cluster's volume and EC-shard placement.

A copy of seaweedfs_tpu/topology/ (reference: weed/topology/): the
DC/rack/node tree, per-collection volume layouts, XYZ replica-placement
growth, the EC shard map and the sequencer.  Master-driven vacuum
(`vacuum.py`) waits for ROADMAP A4c.
"""
from .node import DataCenter, DataNode, EcShardInfo, Rack
from .sequence import MemorySequencer, SnowflakeSequencer
from .topology import Collection, EcShardLocations, Topology
from .volume_growth import NoFreeSpace, VolumeGrowOption, VolumeGrowth, target_count_per_request
from .volume_layout import VolumeLayout, VolumeLocationList

__all__ = [
    "DataCenter",
    "DataNode",
    "Rack",
    "EcShardInfo",
    "Collection",
    "EcShardLocations",
    "Topology",
    "MemorySequencer",
    "SnowflakeSequencer",
    "VolumeGrowOption",
    "VolumeGrowth",
    "NoFreeSpace",
    "target_count_per_request",
    "VolumeLayout",
    "VolumeLocationList",
]
