"""Self-healing repair plane: the master's autonomous EC repair loop.

The port of seaweedfs_tpu/repair/: the telemetry plane
(stats/cluster.py), the shell's rebuild fan-out (shell/command_ec.py)
and the serving QoS are joined by a scheduler that acts: it detects
shard loss, corruption and stale nodes, plans prioritized,
rate-limited repairs, and runs them as QoS-bulk traffic that yields to
the interactive front door.  Every job ends in a VolumeEcShardsRebuild
on the rebuilder, which is K1 on the card.
"""
from .config import RepairConfig
from .planner import PlanResult, RepairJob, plan
from .scheduler import RepairScheduler

__all__ = ["PlanResult", "RepairConfig", "RepairJob", "RepairScheduler", "plan"]
