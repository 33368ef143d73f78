"""Knobs for the master's self-healing repair plane (-ec.repair.* flags).

The scheduler closes the last manual loop in the pipeline: where the
reference expects a human in `weed shell` running `ec.rebuild` /
`ec.balance` when volumes degrade, these knobs bound how aggressively
the master does it autonomously — scan cadence, repair concurrency,
retry backoff, and the optional master-driven scrub sweep that feeds
corrupt-shard verdicts into the queue.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RepairConfig:
    """Tunables for `RepairScheduler` (CLI: the -ec.repair.* flags)."""

    # run the autonomous repair loop at all (-ec.repair.disable); off,
    # the master still exposes the repair status plane, but only manual
    # `ec.rebuild` restores redundancy
    enabled: bool = True
    # scan cadence (-ec.repair.intervalSeconds): each cycle diffs the
    # topology's EC census against full redundancy and (re)plans the
    # queue; sub-second intervals are for tests/bench only
    interval_seconds: float = 5.0
    # concurrent repair jobs (-ec.repair.maxInflight): each job is one
    # volume's gather -> rebuild -> remount choreography; the fan-out
    # within a job is bounded separately by fanout_concurrency
    max_inflight: int = 2
    # per-RPC fan-out width inside one job (-ec.repair.fanout), passed
    # straight to the shell's gather/spread helpers
    fanout_concurrency: int = 4
    # exponential backoff for a volume whose repair FAILED
    # (-ec.repair.backoffBaseSeconds doubling up to
    # -ec.repair.backoffMaxSeconds); attempts beyond
    # -ec.repair.maxAttempts park the volume as failed until the next
    # topology change re-observes it
    backoff_base_seconds: float = 1.0
    backoff_max_seconds: float = 60.0
    max_attempts: int = 8
    # master-driven scrub sweep cadence (-ec.repair.scrubIntervalSeconds):
    # every interval, one node holding all 14 shards of each EC volume
    # verifies parity (VolumeEcShardsVerify: csrc/scrub.cu when the
    # shards are resident, else K1 over the shard files) and corrupt
    # verdicts enter the repair queue.  0 disables
    # the sweep — verdicts can still arrive via report_corrupt()
    scrub_interval_seconds: float = 0.0
    # breaker subordination: while ANY fresh node's telemetry reports an
    # open interactive QoS breaker, the scheduler defers new repair work
    # for this long (-ec.repair.breakerPauseSeconds) instead of adding
    # bulk shard traffic to an overloaded front door
    breaker_pause_seconds: float = 2.0

    def validated(self) -> "RepairConfig":
        if self.interval_seconds < 0:
            raise ValueError("interval_seconds must be >= 0")
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if self.fanout_concurrency < 1:
            raise ValueError("fanout_concurrency must be >= 1")
        if self.backoff_base_seconds <= 0:
            raise ValueError("backoff_base_seconds must be > 0")
        if self.backoff_max_seconds < self.backoff_base_seconds:
            raise ValueError("backoff_max_seconds must be >= base")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.scrub_interval_seconds < 0:
            raise ValueError("scrub_interval_seconds must be >= 0")
        if self.breaker_pause_seconds < 0:
            raise ValueError("breaker_pause_seconds must be >= 0")
        return self
