"""Deadline propagation: the deadline part of seaweedfs_tpu/utils/faultpolicy.py.

The front door stamps a budget (`X-Seaweed-Deadline-Ms` header, else the
configured default); it rides a contextvar, so it crosses awaits and
`asyncio.to_thread` hops; and admission refuses doomed work early
(`check_remaining`) instead of burning a queue slot on a request its
client already abandoned.  A spent budget surfaces as DeadlineExceeded,
which the volume server answers with 504, and is recorded in the flight
recorder (obs/incident.py).

The peer half of the reference module (hedged gathers, retry budgets,
per-peer latency EWMAs, gRPC metadata) belongs to the RPC plane, ROADMAP
A4b.
"""
from __future__ import annotations

import contextvars
import time
from dataclasses import dataclass
from typing import Optional

from .. import stats

DEADLINE_HEADER = "X-Seaweed-Deadline-Ms"


class DeadlineExceeded(TimeoutError):
    """The request's deadline budget is already spent — the work is
    doomed; refuse it instead of executing toward a client that gave
    up."""


@dataclass
class FaultPolicyConfig:
    """The `-ec.rpc.deadlineMs` flag (command/volume.py), process-global
    like ServingConfig."""

    # default front-door budget in ms stamped on requests that arrive
    # WITHOUT an X-Seaweed-Deadline-Ms header; 0 disables stamping
    deadline_ms: int = 30_000

    def validated(self) -> "FaultPolicyConfig":
        if self.deadline_ms < 0:
            raise ValueError("deadline_ms must be >= 0")
        return self


CONFIG = FaultPolicyConfig()


def configure(cfg: FaultPolicyConfig) -> None:
    """Apply the -ec.rpc.deadlineMs flag; process-global."""
    global CONFIG
    CONFIG = cfg.validated()


# absolute time.monotonic() deadline of the request being served in
# this context (None = no budget)
_DEADLINE: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "faultpolicy_deadline", default=None
)


def remaining_s() -> float | None:
    """Seconds left in the ambient budget, or None outside any scope.
    May be <= 0 — the budget is spent; callers shed via
    `check_remaining`."""
    dl = _DEADLINE.get()
    return None if dl is None else dl - time.monotonic()


def check_remaining(what: str = "") -> float | None:
    """Remaining budget, raising DeadlineExceeded (counted + recorded)
    when it is already spent — the refuse-doomed-work-early gate every
    admission point shares."""
    rem = remaining_s()
    if rem is not None and rem <= 0:
        stats.VOLUME_SERVER_EC_DEADLINE_EXCEEDED.inc()
        from ..obs import incident as obs_incident

        obs_incident.record("deadline_exceeded", what=what)
        raise DeadlineExceeded(
            f"{what or 'request'}: deadline budget spent "
            f"({-rem * 1e3:.1f}ms past)"
        )
    return rem


class deadline_scope:
    """Stamp a deadline budget for the block.  An ambient TIGHTER
    deadline always wins — a hop may only subtract from the budget,
    never extend it.  `budget_s=None` is a no-op scope."""

    __slots__ = ("budget_s", "_token")

    def __init__(self, budget_s: float | None):
        self.budget_s = budget_s
        self._token = None

    def __enter__(self) -> "deadline_scope":
        if self.budget_s is not None:
            dl = time.monotonic() + self.budget_s
            cur = _DEADLINE.get()
            if cur is not None:
                dl = min(dl, cur)
            self._token = _DEADLINE.set(dl)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            try:
                _DEADLINE.reset(self._token)
            except ValueError:
                pass  # exited from a different context


def parse_deadline_ms(value: str) -> float | None:
    """Header value -> budget ms, None when absent/garbage (a malformed
    budget must not 400 a read — it degrades to the default stamp)."""
    try:
        ms = float(value)
    except (TypeError, ValueError):
        return None
    return ms if ms == ms and 0 < ms < 1e10 else None  # NaN-safe


def request_scope(headers) -> deadline_scope:
    """The front door: adopt the inbound `X-Seaweed-Deadline-Ms`
    budget, else stamp the configured default (CONFIG.deadline_ms; 0
    disables)."""
    ms = parse_deadline_ms(headers.get(DEADLINE_HEADER, ""))
    if ms is None:
        ms = CONFIG.deadline_ms or None
    return deadline_scope(None if ms is None else ms / 1e3)


class detached:
    """Null the ambient deadline for the block.  Long-lived workers
    spawned from inside a request's scope (the dispatcher's drain lanes)
    must NOT inherit the spawning request's budget: the copied contextvar
    would otherwise expire mid-lane and doom every LATER request's batch
    served by that lane."""

    __slots__ = ("_token",)

    def __enter__(self) -> "detached":
        self._token = _DEADLINE.set(None)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            _DEADLINE.reset(self._token)
        except ValueError:
            pass  # exited from a different context
