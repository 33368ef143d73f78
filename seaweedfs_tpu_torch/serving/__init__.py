"""Continuous-batching dispatch for the resident EC read path.

Port of seaweedfs_tpu/serving/ for one card: `Coalescer` packs concurrent
needle reads of one resident volume into wide `read_needles_batch` calls
(one ragged launch of csrc/fused_reconstruct.cu each), `EcReadDispatcher`
keeps several batches in flight and sheds saturation to the native
per-read path, and `QosController` puts tier budgets, deadline shedding
and a breaker in front of the queue.  `TieringController` (tiering.py)
moves EC volumes between HBM, host RAM and disk by decayed read and write
heat.
"""
from .config import ServingConfig
from .coalescer import Coalescer, ReadRequest
from .dispatcher import EcReadDispatcher
from .qos import Breaker, QosController, normalize_tier
from .tiering import HeatTracker, HostShardCache, TieringController

__all__ = [
    "Breaker",
    "Coalescer",
    "EcReadDispatcher",
    "HeatTracker",
    "HostShardCache",
    "QosController",
    "ReadRequest",
    "ServingConfig",
    "TieringController",
    "normalize_tier",
]
