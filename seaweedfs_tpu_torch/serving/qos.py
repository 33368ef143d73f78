"""QoS admission control for the EC serving dispatcher.

Port of seaweedfs_tpu/serving/qos.py.  Three policies in front of the
queue, all exported as `SeaweedFS_volumeServer_ec_qos_*` series, and every
shed and breaker transition recorded in the flight recorder
(obs/incident.py), stamped with the ambient trace:

  1. TIER BUDGETS — requests carry a tier ("interactive" front-door
     reads vs "bulk" background traffic, from the X-Seaweed-QoS header);
     each tier owns a slice of the queue, so bulk saturation sheds bulk,
     never interactive.
  2. DEADLINE-AWARE SHED — admission estimates the queue wait from an
     EWMA of recent per-needle service time; a request whose estimated
     wait already exceeds its tier deadline is served on the host path
     NOW instead of joining a queue it will time out inside.
  3. BREAKER — sustained shedding trips a per-tier breaker that
     fast-fails (host path) for a cooldown, then half-opens for a probe.

The clock is injectable, so tests drive this and the reference on one
sequence.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable

from .. import stats
from ..obs import incident as obs_incident

if TYPE_CHECKING:
    from .config import ServingConfig

INTERACTIVE = "interactive"
BULK = "bulk"
TIERS = (INTERACTIVE, BULK)

# admit() verdicts (shed reasons; None = admitted)
SHED_QUEUE_BUDGET = "queue_budget"
SHED_DEADLINE = "deadline"
SHED_BREAKER_OPEN = "breaker_open"


def normalize_tier(raw: str | None) -> str:
    """Map a client-supplied tier string onto a known tier (unknown or
    absent -> interactive: the front door must not be deniable into the
    bulk budget by a typo)."""
    return raw if raw in TIERS else INTERACTIVE


class Breaker:
    """Consecutive-rejection circuit breaker with half-open recovery.

    closed -> (trip_after consecutive rejections) -> open for
    `cooldown_s` -> half-open (allow() passes probes) -> one success
    closes, one rejection re-opens.  Open-state fast-fails do NOT extend
    the trip (the cooldown clock runs from the trip), so a storm of
    arrivals can't hold the breaker open forever.

    `clock` is injectable for tests (defaults to time.monotonic).
    """

    CLOSED, HALF_OPEN, OPEN = 0, 1, 2

    def __init__(
        self,
        trip_after: int = 64,
        cooldown_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.trip_after = max(1, int(trip_after))
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._consecutive = 0
        self._opened_at: float | None = None

    @property
    def state(self) -> int:
        if self._opened_at is None:
            return self.CLOSED
        if self._clock() - self._opened_at >= self.cooldown_s:
            return self.HALF_OPEN
        return self.OPEN

    def allow(self) -> bool:
        """True when a request may be evaluated (closed or half-open)."""
        return self.state != self.OPEN

    def record_rejection(self) -> None:
        st = self.state
        if st == self.HALF_OPEN:
            # failed probe: re-open for a fresh cooldown
            self._opened_at = self._clock()
            return
        if st == self.OPEN:
            return  # fast-fails don't extend the trip
        self._consecutive += 1
        if self._consecutive >= self.trip_after:
            self._opened_at = self._clock()

    def record_success(self) -> None:
        self._consecutive = 0
        self._opened_at = None


@dataclass
class TierPolicy:
    name: str
    queue_budget: int  # max requests of this tier queued at once
    deadline_s: float  # 0 = no deadline shedding for this tier


class QosController:
    """Per-tier admission bookkeeping for EcReadDispatcher.

    The dispatcher calls `admit()` before offering to the coalescer,
    `enqueued()/dequeued()` around the queue hop, and
    `observe_service()` after each batch so the deadline estimate tracks
    the device's actual service rate.  All state is event-loop-
    confined (no locks): every caller runs on the dispatcher's loop.
    """

    # EWMA weight for new service-time observations; ~last 10 batches
    _ALPHA = 0.2

    def __init__(
        self,
        policies: dict[str, TierPolicy],
        trip_after: int = 64,
        cooldown_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.policies = policies
        self._queued: dict[str, int] = {t: 0 for t in policies}
        self._breakers: dict[str, Breaker] = {
            t: Breaker(trip_after, cooldown_s, clock) for t in policies
        }
        # last gauge-published breaker state per tier: the gauge is only
        # touched on transitions, not on every hot-path admission
        self._published_state: dict[str, int] = {t: -1 for t in policies}
        # per-needle service seconds EWMA; None until a batch seeds it
        self._service_s: float | None = None
        # the seed rule (a departure from the reference): the first
        # batch after a start does not seed the estimate
        self._first_seen = False

    @classmethod
    def from_config(cls, cfg: ServingConfig) -> "QosController":
        """Build from a ServingConfig (the -ec.qos.* flags)."""
        return cls(
            {
                INTERACTIVE: TierPolicy(
                    INTERACTIVE,
                    cfg.qos_interactive_queue,
                    cfg.qos_interactive_deadline_ms / 1e3,
                ),
                BULK: TierPolicy(
                    BULK, cfg.qos_bulk_queue, cfg.qos_bulk_deadline_ms / 1e3
                ),
            },
            trip_after=cfg.qos_trip_after,
            cooldown_s=cfg.qos_recover_seconds,
        )

    # ------------------------------------------------------------ admission

    def breaker_state(self, tier: str) -> int:
        return self._breakers[tier].state

    def estimated_wait_s(self, queue_depth: int, max_inflight: int) -> float:
        """Expected queue wait for a request admitted behind
        `queue_depth` others: depth x the EWMA per-needle service time,
        divided by the pipeline width actually draining the queue."""
        if self._service_s is None or queue_depth <= 0:
            return 0.0
        return queue_depth * self._service_s / max(1, max_inflight)

    def admit(
        self,
        tier: str,
        queue_depth: int,
        max_inflight: int,
        remaining_s: float | None = None,
    ) -> str | None:
        """None = may proceed to the coalescer; else the shed reason.
        Counts sheds; the SUCCESS side (admitted counter, breaker
        success, queue accounting) is committed by `enqueued()` only
        once the coalescer actually accepted the request — the global
        max_queue backstop can still reject between the two, and that
        rejection must read as overload (`saturated()`), not success.

        `remaining_s` is the request's propagated deadline budget
        (utils/faultpolicy.py): when present, the deadline shed judges
        the estimated queue wait against min(tier deadline, remaining
        budget) — the admission end of ONE continuous budget stamped at
        the front door, instead of a local per-tier guess."""
        pol = self.policies[tier]
        br = self._breakers[tier]
        if br.state != self._published_state[tier]:
            # breaker TRANSITION: the gauge flip doubles as the flight
            # recorder's moment — "when exactly did the front door trip"
            names = ("closed", "half_open", "open")
            prev = self._published_state[tier]
            obs_incident.record(
                "qos_breaker", tier=tier, state=names[br.state],
                prev=names[prev] if 0 <= prev < len(names) else "unset",
            )
            self._published_state[tier] = br.state
            stats.VOLUME_SERVER_EC_QOS_BREAKER_STATE.labels(tier=tier).set(
                br.state
            )
        if not br.allow():
            stats.VOLUME_SERVER_EC_QOS_SHED.labels(
                tier=tier, reason=SHED_BREAKER_OPEN
            ).inc()
            obs_incident.record(
                "qos_shed", tier=tier, reason=SHED_BREAKER_OPEN
            )
            return SHED_BREAKER_OPEN
        # the effective deadline: the tier policy's, tightened by the
        # request's own remaining budget when one was propagated
        deadline_s = pol.deadline_s
        if remaining_s is not None:
            deadline_s = (
                min(deadline_s, remaining_s) if deadline_s > 0
                else remaining_s
            )
        reason = None
        if self._queued[tier] >= pol.queue_budget:
            reason = SHED_QUEUE_BUDGET
        elif (
            deadline_s > 0
            and self.estimated_wait_s(queue_depth, max_inflight)
            > deadline_s
        ):
            reason = SHED_DEADLINE
        if reason is not None:
            br.record_rejection()
            stats.VOLUME_SERVER_EC_QOS_SHED.labels(
                tier=tier, reason=reason
            ).inc()
            obs_incident.record(
                "qos_shed", tier=tier, reason=reason,
                queue_depth=queue_depth,
            )
            return reason
        return None

    def saturated(self, tier: str) -> None:
        """The global max_queue backstop rejected a request admit()
        passed: count it as a queue_budget shed and feed the breaker —
        sustained coalescer saturation must be able to trip into
        fast-fail exactly like a tier-budget overload."""
        self._breakers[tier].record_rejection()
        stats.VOLUME_SERVER_EC_QOS_SHED.labels(
            tier=tier, reason=SHED_QUEUE_BUDGET
        ).inc()
        obs_incident.record(
            "qos_shed", tier=tier, reason=SHED_QUEUE_BUDGET,
            saturated=True,
        )

    # ----------------------------------------------------------- accounting

    def enqueued(self, tier: str) -> None:
        """Commit a successful admission (the coalescer accepted)."""
        self._breakers[tier].record_success()
        stats.VOLUME_SERVER_EC_QOS_ADMITTED.labels(tier=tier).inc()
        self._queued[tier] += 1
        stats.VOLUME_SERVER_EC_QOS_QUEUE_DEPTH.labels(tier=tier).set(
            self._queued[tier]
        )

    def dequeued(self, tier: str) -> None:
        self._queued[tier] = max(0, self._queued[tier] - 1)
        stats.VOLUME_SERVER_EC_QOS_QUEUE_DEPTH.labels(tier=tier).set(
            self._queued[tier]
        )

    def observe_service(self, per_needle_s: float, pinning: bool = False) -> None:
        """Feed one batch's per-needle service time into the EWMA the
        deadline estimate rides on.

        Departure from the reference: neither the first batch after a
        start nor a batch served while a pin uploaded (`pinning`) seeds
        the estimate.  Both are outliers (warm-up, a card busy with the
        upload): seeded by one, the estimate alone sheds a queue of
        reads on the interactive deadline that the next batches serve in
        a fraction of it.  Once seeded the EWMA is the reference's."""
        if per_needle_s <= 0:
            return
        if self._service_s is None:
            first, self._first_seen = not self._first_seen, True
            if first or pinning:
                return
            self._service_s = per_needle_s
        else:
            self._service_s += self._ALPHA * (per_needle_s - self._service_s)

    def shutdown(self) -> None:
        """Zero the per-tier gauges on clean dispatcher shutdown (the
        registry is process-global; see EcReadDispatcher.shutdown)."""
        for tier in self.policies:
            stats.VOLUME_SERVER_EC_QOS_QUEUE_DEPTH.labels(tier=tier).set(0)
            stats.VOLUME_SERVER_EC_QOS_BREAKER_STATE.labels(tier=tier).set(0)
            self._published_state[tier] = 0
