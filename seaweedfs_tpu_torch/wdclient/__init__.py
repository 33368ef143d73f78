"""Cluster client: master subscription + volume-id location map (the port
of seaweedfs_tpu/wdclient/).

Reference: weed/wdclient/ (2.3k LoC) — MasterClient.KeepConnectedToMaster
streaming location updates into a vidMap used by filers/mounts/shells.
"""
from .vid_map import Location, VidMap
from .masterclient import MasterClient

__all__ = ["Location", "VidMap", "MasterClient"]
