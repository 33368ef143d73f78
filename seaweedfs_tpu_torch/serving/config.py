"""Knobs for the continuous-batching EC serving dispatcher.

Port of seaweedfs_tpu/serving/config.py.  `aot` is not here: the CUDA
kernels take runtime shapes, so no read is ever shed as a cold shape and
the flag would do nothing.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ServingConfig:
    """Tunables for `EcReadDispatcher` (CLI: the -ec.serving.* flags)."""

    # route EC reads of resident volumes through the batching dispatcher;
    # False serves every read on the native per-read path
    # (-ec.serving.disable)
    enabled: bool = True
    # widest coalesced batch (-ec.serving.maxBatch)
    max_batch: int = 256
    # admission window: when a dispatch slot frees and the queue holds a
    # partial batch, wait this long for the batch to fill before
    # dispatching.  Only applied once a drain loop is already hot (the
    # first batch after idle dispatches immediately), so a lone request
    # never waits.  0 disables the window.  (-ec.serving.maxWaitUs)
    max_wait_us: int = 200
    # pipelined batches in flight: batch N+1's device call overlaps
    # batch N's D2H + response fan-out (-ec.serving.maxInflight)
    max_inflight: int = 4
    # backpressure: queued requests beyond this fall back to the native
    # per-read path (counted in the fallback metric) instead of growing
    # the queue without bound (-ec.serving.maxQueue)
    max_queue: int = 2048
    # resident system the reconstruct kernel serves through: "flat" (the
    # port cache's default) or "blockdiag" (the g-group block-diagonal
    # system, the JAX serving default); both run csrc/fused_reconstruct.cu
    # (-ec.serving.layout)
    layout: str = "flat"
    # double-buffered device staging: 2 pipeline slots let batch N+1
    # launch on its own stream while batch N drains its D2H; False = one
    # slot, the serial baseline (-ec.serving.overlap.disable)
    overlap: bool = True
    # mesh residency (-ec.serving.mesh.disable): lane-shard resident
    # volumes across the local cards (parallel/mesh.py), so a volume's
    # resident capacity is every card's memory and a batch's lane work
    # runs 1/n per card.  Only takes effect when >1 card is visible.
    mesh: bool = True
    # cards the serving mesh may span (-ec.serving.mesh.devices): 0 =
    # every local card, n = the first n
    mesh_devices: int = 0
    # volumes whose shard files are smaller than this pin whole onto the
    # least-loaded card instead of lane-sharding
    # (-ec.serving.mesh.minShardMB)
    mesh_min_shard_mb: int = 8
    # multi-process pod mesh (-ec.mesh.coordinator / -ec.mesh.processId /
    # -ec.mesh.processCount): with processCount > 1 this server joins one
    # torch.distributed group at the coordinator as rank processId and
    # residency lane-shards across every process's cards.  1 (the
    # default) never contacts a coordinator.
    mesh_coordinator: str = ""
    mesh_process_id: int = 0
    mesh_process_count: int = 1
    # zero-copy response writes (-ec.serving.zerocopy.disable): needle
    # payloads stay memoryviews over the pread/reconstruct buffers all
    # the way into the socket write; False materializes bytes
    zero_copy: bool = True
    # QoS admission control (-ec.qos.disable): per-tier queue budgets,
    # deadline-aware shedding, and a trip/recover breaker in front of
    # the coalescer (serving/qos.py)
    qos: bool = True
    # per-tier queue budgets (-ec.qos.interactiveQueue /
    # -ec.qos.bulkQueue); the defaults partition max_queue
    qos_interactive_queue: int = 1792
    qos_bulk_queue: int = 256
    # deadline budgets (ms): a request whose estimated queue wait already
    # exceeds its tier deadline sheds to the host path at admission; 0
    # disables (-ec.qos.interactiveDeadlineMs / -ec.qos.bulkDeadlineMs)
    qos_interactive_deadline_ms: int = 2000
    qos_bulk_deadline_ms: int = 20000
    # breaker: this many CONSECUTIVE sheds trip a tier's breaker for
    # recoverSeconds, then half-open probe (-ec.qos.tripAfter /
    # -ec.qos.recoverSeconds)
    qos_trip_after: int = 64
    qos_recover_seconds: float = 1.0
    # slow-client guard: per-response stall budget = stall_budget_seconds
    # + body_bytes / (stall_min_rate_kbps KB/s); 0 budget disables
    # (-ec.qos.stallBudgetSeconds / -ec.qos.stallMinRateKBps)
    stall_budget_seconds: float = 30.0
    stall_min_rate_kbps: int = 64
    # heat-tiered residency ladder (serving/tiering.py): HBM -> host-RAM
    # reconstruct cache -> disk, driven by decayed per-volume read and
    # write heat.  -ec.tier.disable turns the ladder off (residency falls
    # back to the mount-time pin + blind LRU budget eviction).
    tier: bool = True
    # rebalance cadence of the volume server's tier loop
    # (-ec.tier.intervalSeconds); 0 disables the loop — rebalance() can
    # still be driven by hand
    tier_interval_seconds: float = 5.0
    # host-RAM warm tier budget (-ec.tier.hostCacheMB); 0 disables the
    # host tier, so demotions fall straight to disk
    tier_host_cache_mb: int = 0
    # heat decay half-life (-ec.tier.halfLifeSeconds): popularity is an
    # exponentially-decayed read counter, so idle volumes cool to zero
    tier_half_life_seconds: float = 60.0
    # hysteresis, promotion side (-ec.tier.promoteRatio): a swap needs
    # the candidate to out-heat the coldest eligible resident by this
    # factor — the demotion threshold sits promoteRatio BELOW the
    # promotion threshold, so equally hot volumes never flap
    tier_promote_ratio: float = 1.5
    # hysteresis, time side (-ec.tier.minResidencySeconds): a promoted
    # volume is not swap-eligible before this age; over-budget pressure
    # demotions ignore it (staying over budget would re-trigger the
    # blind LRU eviction the ladder replaces)
    tier_min_residency_seconds: float = 10.0
    # QoS weight of bulk-tier reads in the heat signal
    # (-ec.tier.bulkWeight): a background scan must not out-heat the
    # interactive front door's hot set
    tier_bulk_weight: float = 0.25

    @property
    def max_wait_s(self) -> float:
        return self.max_wait_us / 1e6

    def stall_budget_for(self, nbytes: int) -> float:
        """Total seconds a response of `nbytes` may take before the
        dribbling client is disconnected (0 = unbounded)."""
        if self.stall_budget_seconds <= 0:
            return 0.0
        return self.stall_budget_seconds + nbytes / (
            max(1, self.stall_min_rate_kbps) * 1024.0
        )

    @property
    def multiprocess(self) -> bool:
        """True when this server is one member of a multi-process pod
        mesh (residency spans hosts)."""
        return self.mesh_process_count > 1

    @property
    def pipeline_slots(self) -> int:
        return 2 if self.overlap else 1

    def validated(self) -> "ServingConfig":
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if self.max_queue < self.max_batch:
            raise ValueError("max_queue must be >= max_batch")
        if self.max_wait_us < 0:
            raise ValueError("max_wait_us must be >= 0")
        if self.layout not in ("flat", "blockdiag"):
            raise ValueError("layout must be 'flat' or 'blockdiag'")
        if self.mesh_devices < 0:
            raise ValueError("mesh_devices must be >= 0 (0 = all local)")
        if self.mesh_min_shard_mb < 0:
            raise ValueError("mesh_min_shard_mb must be >= 0")
        if self.mesh_process_count < 1:
            raise ValueError("mesh_process_count must be >= 1")
        if self.mesh_process_count > 1:
            # the rendezvous happens at startup: a malformed config dies
            # here, before the server takes traffic
            host, sep, port = self.mesh_coordinator.rpartition(":")
            if not (sep and host and port.isdigit() and 0 < int(port) < 65536):
                raise ValueError(
                    "mesh_coordinator must be host:port when "
                    f"mesh_process_count > 1 (got {self.mesh_coordinator!r})"
                )
            if not 0 <= self.mesh_process_id < self.mesh_process_count:
                raise ValueError(
                    f"mesh_process_id {self.mesh_process_id} out of range "
                    f"for mesh_process_count {self.mesh_process_count}"
                )
        elif self.mesh_process_id != 0:
            raise ValueError(
                "mesh_process_id must be 0 when mesh_process_count is 1"
            )
        if self.qos_interactive_queue < 1 or self.qos_bulk_queue < 1:
            raise ValueError("qos tier queue budgets must be >= 1")
        if (
            self.qos_interactive_deadline_ms < 0
            or self.qos_bulk_deadline_ms < 0
        ):
            raise ValueError("qos deadlines must be >= 0 (0 disables)")
        if self.qos_trip_after < 1:
            raise ValueError("qos_trip_after must be >= 1")
        if self.qos_recover_seconds <= 0:
            raise ValueError("qos_recover_seconds must be > 0")
        if self.stall_min_rate_kbps < 1:
            raise ValueError("stall_min_rate_kbps must be >= 1")
        if self.tier_interval_seconds < 0:
            raise ValueError("tier_interval_seconds must be >= 0")
        if self.tier_host_cache_mb < 0:
            raise ValueError("tier_host_cache_mb must be >= 0")
        if self.tier_half_life_seconds <= 0:
            raise ValueError("tier_half_life_seconds must be > 0")
        if self.tier_promote_ratio < 1.0:
            raise ValueError(
                "tier_promote_ratio must be >= 1 (hysteresis margin)"
            )
        if self.tier_min_residency_seconds < 0:
            raise ValueError("tier_min_residency_seconds must be >= 0")
        if not 0.0 <= self.tier_bulk_weight <= 1.0:
            raise ValueError("tier_bulk_weight must be in [0, 1]")
        return self
