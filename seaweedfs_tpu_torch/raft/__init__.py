"""Raft between masters (the port of seaweedfs_tpu/raft/)."""
from .node import LEADER, FOLLOWER, NotLeader, RaftNode

__all__ = ["FOLLOWER", "LEADER", "NotLeader", "RaftNode"]
