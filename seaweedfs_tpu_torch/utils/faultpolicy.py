"""Tail-tolerant fault policy for every cross-node hop: the port of
seaweedfs_tpu/utils/faultpolicy.py.

  * DEADLINE PROPAGATION — the front door stamps a budget
    (`X-Seaweed-Deadline-Ms` header / `x-seaweed-deadline` RPC metadata,
    attached and adopted by pb/rpc.py like the trace id); each hop
    subtracts elapsed time, derives every outbound RPC's hard per-call
    timeout from the REMAINING budget, and refuses doomed work early
    (`check_remaining`).  The deadline rides a contextvar, so it crosses
    awaits and `asyncio.to_thread` hops.  A spent budget surfaces as
    DeadlineExceeded, which the volume server answers with 504.
  * HEDGED GATHERS — `hedged_gather` issues the `need` cheapest fetches
    (per-peer latency EWMAs pick them), arms a hedge to a spare holder when
    a fetch exceeds its peer's EWMA-quantile threshold, takes the first
    `need` completions and abandons the losers — bounded by a hedge token
    budget so hedging can never double cluster load.  RS(10,4) makes the
    hedge free: any 10 of 14 shards reconstruct.
  * RETRY BUDGETS — `retry_rpc` is the one backoff/jitter/deadline retry
    helper (the shell's fan-out rides it); each peer owns a token-bucket
    retry budget, so a sick node degrades into fast-fail instead of a
    retry storm.

Every decision is counted: the `SeaweedFS_volumeServer_ec_{hedge_sent,
hedge_wins, hedge_cancelled, deadline_exceeded, retry_budget_exhausted}`
series, flight-recorder events (`hedge`, `deadline_exceeded`,
`retry_budget`), and process-local `totals()`.
"""
from __future__ import annotations

import contextvars
import random
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, wait
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .. import stats

DEADLINE_HEADER = "X-Seaweed-Deadline-Ms"
GRPC_DEADLINE_KEY = "x-seaweed-deadline"

# fallback per-call bound for control-plane RPCs made OUTSIDE any
# deadline scope (background loops, shell verbs): bounded beats the
# unbounded wait; hot-path callers pass tighter defaults
DEFAULT_RPC_TIMEOUT_S = 300.0
# overall bound on one survivor gather when no ambient budget is
# tighter: past this the gather returns what it has (the caller's
# InsufficientShards is the honest verdict, not an infinite wait)
DEFAULT_GATHER_TIMEOUT_S = 10.0
# patience floor before a pending fetch is REPLACED from the spares
# outright (no hedge token needed): far past any plausible tail, the
# fetch is treated as failed-slow — this bounds a read's worst case
# even when the hedge budget is drained, and it is not a hedge because
# the abandoned fetch's bytes were given up on, not raced
GATHER_PATIENCE_MIN_S = 0.5


class DeadlineExceeded(TimeoutError):
    """The request's deadline budget is already spent — the work is
    doomed; refuse it instead of executing toward a client that gave
    up."""


@dataclass
class FaultPolicyConfig:
    """The `-ec.rpc.*` flags (command/volume.py), process-global like
    ServingConfig."""

    # default front-door budget in ms stamped on requests that arrive
    # WITHOUT an X-Seaweed-Deadline-Ms header; 0 disables stamping
    # (-ec.rpc.deadlineMs)
    deadline_ms: int = 30_000
    # per-peer latency quantile a fetch must exceed before a hedge is
    # armed to a spare holder, 0<q<1 (-ec.rpc.hedgeQuantile); higher =
    # hedge later = fewer hedges
    hedge_quantile: float = 0.95
    # hedge token budget as a percentage of primary fetches: each
    # primary deposits pct/100 tokens, each hedge spends one, so
    # hedging adds at most pct% cluster load (-ec.rpc.hedgeBudgetPct);
    # 0 disables hedging
    hedge_budget_pct: float = 10.0
    # per-peer retry budget as a percentage of first attempts: each
    # first attempt deposits pct/100 tokens at its peer's bucket, each
    # RETRY spends one — a sick peer fast-fails once its bucket drains
    # (-ec.rpc.retryBudgetPct); 0 disables retries entirely
    retry_budget_pct: float = 10.0

    def validated(self) -> "FaultPolicyConfig":
        if self.deadline_ms < 0:
            raise ValueError("deadline_ms must be >= 0")
        if not (0.0 < self.hedge_quantile < 1.0):
            raise ValueError("hedge_quantile must be in (0, 1)")
        if self.hedge_budget_pct < 0 or self.retry_budget_pct < 0:
            raise ValueError("budget percentages must be >= 0")
        return self


CONFIG = FaultPolicyConfig()

# process-local decision totals, mirrored to the Prometheus series;
# tests and the chip smoke read these
_TOTALS_LOCK = threading.Lock()
_TOTALS = {
    "hedge_sent": 0,
    "hedge_wins": 0,
    "hedge_cancelled": 0,
    "deadline_exceeded": 0,
    "retry_budget_exhausted": 0,
    "retries": 0,
    "retry_attempts": 0,
}


def totals() -> dict:
    with _TOTALS_LOCK:
        return dict(_TOTALS)


def reset_totals() -> None:
    with _TOTALS_LOCK:
        for k in _TOTALS:
            _TOTALS[k] = 0


def _count(key: str, n: int = 1, metric: bool = True) -> None:
    with _TOTALS_LOCK:
        _TOTALS[key] += n
    if not metric:
        return
    counter = {
        "hedge_sent": stats.VOLUME_SERVER_EC_HEDGE_SENT,
        "hedge_wins": stats.VOLUME_SERVER_EC_HEDGE_WINS,
        "hedge_cancelled": stats.VOLUME_SERVER_EC_HEDGE_CANCELLED,
        "deadline_exceeded": stats.VOLUME_SERVER_EC_DEADLINE_EXCEEDED,
        "retry_budget_exhausted":
            stats.VOLUME_SERVER_EC_RETRY_BUDGET_EXHAUSTED,
    }.get(key)
    if counter is not None:
        counter.inc(n)


# ------------------------------------------------------------- deadlines

# absolute time.monotonic() deadline of the request being served in
# this context (None = no budget: background work stays unbounded-ish,
# bounded only by explicit per-call defaults)
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
        _count("deadline_exceeded")
        from ..obs import incident as obs_incident

        obs_incident.record("deadline_exceeded", what=what)
        raise DeadlineExceeded(
            f"{what or 'request'}: deadline budget spent "
            f"({-rem * 1e3:.1f}ms past)"
        )
    return rem


def rpc_timeout_s(default_s: float | None = DEFAULT_RPC_TIMEOUT_S,
                  what: str = "") -> float | None:
    """Hard per-call timeout for one outbound RPC: the remaining budget
    when a deadline scope is active (raising DeadlineExceeded when it is
    already spent), else `default_s`.  Never returns <= 0."""
    rem = check_remaining(what)
    if rem is None:
        return default_s
    return rem if default_s is None else min(rem, default_s)


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
                # exited from a different context (streaming handlers
                # resume across task contexts) — same defensive shape
                # as obs.trace.finish_trace
                pass


def parse_deadline_ms(value: str) -> float | None:
    """Header/metadata value -> budget ms, None when absent/garbage
    (a malformed budget must not 400 a read — it degrades to the
    default stamp)."""
    try:
        ms = float(value)
    except (TypeError, ValueError):
        return None
    return ms if ms == ms and 0 < ms < 1e10 else None  # NaN-safe


def request_scope(headers) -> deadline_scope:
    """The front door: adopt the inbound `X-Seaweed-Deadline-Ms`
    budget, else stamp the configured default (CONFIG.deadline_ms; 0
    disables).  Every HTTP entry point wraps its handler in this, so
    whichever server a request hits FIRST becomes the budget's
    origin and every later hop only subtracts."""
    ms = parse_deadline_ms(headers.get(DEADLINE_HEADER, ""))
    if ms is None:
        ms = CONFIG.deadline_ms or None
    return deadline_scope(None if ms is None else ms / 1e3)


def adopt_scope_from_metadata(md: dict) -> deadline_scope:
    """gRPC handler side: adopt the inbound remaining budget; never
    stamps a default (background streams must stay budget-free)."""
    ms = parse_deadline_ms(md.get(GRPC_DEADLINE_KEY, ""))
    return deadline_scope(None if ms is None else ms / 1e3)


class detached:
    """Null the ambient deadline for the block — the faultpolicy twin
    of obs.trace.detached.  Long-lived workers spawned from inside a
    request's scope (the dispatcher's drain lanes) must NOT inherit the
    spawning request's budget: the copied contextvar would otherwise
    expire mid-lane and doom every LATER request's batch served by that
    lane."""

    __slots__ = ("_token",)

    def __enter__(self) -> "detached":
        self._token = _DEADLINE.set(None)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            _DEADLINE.reset(self._token)
        except ValueError:
            pass  # exited from a different context (defensive)


def outbound_headers() -> dict:
    """Headers for outbound HTTP fan-out: the REMAINING budget in ms
    (empty outside any scope, or once the budget is spent — the callee
    would only refuse it)."""
    rem = remaining_s()
    if rem is None or rem <= 0:
        return {}
    return {DEADLINE_HEADER: f"{rem * 1e3:.0f}"}


def grpc_metadata() -> tuple | None:
    """Metadata for outbound gRPC, or None outside any scope."""
    rem = remaining_s()
    if rem is None or rem <= 0:
        return None
    return ((GRPC_DEADLINE_KEY, f"{rem * 1e3:.0f}"),)


def configure(cfg: FaultPolicyConfig) -> None:
    """Apply the -ec.rpc.* flags; process-global like stats.REGISTRY."""
    global CONFIG
    CONFIG = cfg.validated()


# ------------------------------------------------------- peer latency EWMA


class _Ewma:
    """Mean + mean-absolute-deviation EWMA of one peer's fetch latency
    (the dispatch->fetch EWMA shape, kept per peer)."""

    __slots__ = ("mean", "dev", "n")
    ALPHA = 0.2

    def __init__(self) -> None:
        self.mean = 0.0
        self.dev = 0.0
        self.n = 0

    def observe(self, x: float) -> None:
        if self.n == 0:
            self.mean = x
            self.dev = x / 2
        else:
            err = x - self.mean
            self.mean += self.ALPHA * err
            self.dev += self.ALPHA * (abs(err) - self.dev)
        self.n += 1


class PeerLatency:
    """Per-peer latency EWMAs + the hedge threshold derived from them.

    `threshold_s(peer)` approximates the CONFIG.hedge_quantile latency
    quantile as mean + k*dev with k = -ln(1-q) (exact for an
    exponential tail, a deliberate overestimate for lighter tails —
    hedging late is cheap, hedging early burns the budget).  Unknown
    peers fall back to the all-peer aggregate; with no observations at
    all there is no threshold and no hedging (the EWMAs prime on the
    first calm gathers)."""

    _FLOOR_S = 1e-3  # never hedge on sub-ms jitter

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._peers: dict[Any, _Ewma] = {}
        self._all = _Ewma()

    def observe(self, peer: Any, seconds: float) -> None:
        with self._lock:
            e = self._peers.get(peer)
            if e is None:
                if len(self._peers) >= 4096:  # probe traffic must not
                    self._peers.clear()       # grow this unboundedly
                e = self._peers[peer] = _Ewma()
            e.observe(seconds)
            self._all.observe(seconds)

    def mean_s(self, peer: Any) -> float | None:
        with self._lock:
            e = self._peers.get(peer)
            if e is not None and e.n > 0:
                return e.mean
            return self._all.mean if self._all.n > 0 else None

    def aggregate_mean_s(self) -> float | None:
        with self._lock:
            return self._all.mean if self._all.n > 0 else None

    def threshold_s(self, peer: Any) -> float | None:
        import math

        k = -math.log(max(1e-9, 1.0 - CONFIG.hedge_quantile))
        with self._lock:
            e = self._peers.get(peer)
            if e is None or e.n == 0:
                e = self._all
            if e.n == 0:
                return None
            # the 2x-mean floor guards the degenerate low-jitter case:
            # near-constant observed latency drives dev toward 0 and
            # mean + k*dev toward the mean itself — and a fetch within
            # 2x its peer's typical latency is not a tail worth hedging
            return max(self._FLOOR_S, e.mean + k * e.dev, 2.0 * e.mean)

    def reset(self) -> None:
        with self._lock:
            self._peers.clear()
            self._all = _Ewma()


PEER_LATENCY = PeerLatency()


# ---------------------------------------------------------- token budgets


class TokenBucket:
    """Deposit-per-event token bucket: `deposit()` adds a fraction per
    qualifying event, `take()` spends whole tokens.  The cap bounds the
    burst; `initial` lets the first slow fetch hedge before any deposit
    has accrued."""

    def __init__(self, cap: float = 8.0, initial: float = 1.0) -> None:
        self._lock = threading.Lock()
        self.cap = cap
        self._tokens = min(initial, cap)

    def deposit(self, amount: float) -> None:
        with self._lock:
            self._tokens = min(self.cap, self._tokens + amount)

    def take(self, cost: float = 1.0) -> bool:
        with self._lock:
            if self._tokens >= cost:
                self._tokens -= cost
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def reset(self, initial: float = 1.0) -> None:
        with self._lock:
            self._tokens = min(initial, self.cap)


HEDGE_BUDGET = TokenBucket()


class RetryBudgets:
    """Per-peer retry token buckets: first attempts deposit
    CONFIG.retry_budget_pct/100, retries spend 1 — so retry volume is
    bounded at ~pct% of traffic per peer and a sick peer degrades into
    fast-fail instead of a storm."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._peers: dict[str, TokenBucket] = {}

    def _bucket(self, peer: str) -> TokenBucket:
        with self._lock:
            b = self._peers.get(peer)
            if b is None:
                if len(self._peers) >= 4096:
                    self._peers.clear()
                b = self._peers[peer] = TokenBucket(cap=8.0, initial=1.0)
            return b

    def on_attempt(self, peer: str) -> None:
        self._bucket(peer).deposit(CONFIG.retry_budget_pct / 100.0)

    def try_retry(self, peer: str) -> bool:
        if CONFIG.retry_budget_pct <= 0:
            return False
        return self._bucket(peer).take(1.0)

    def reset(self) -> None:
        with self._lock:
            self._peers.clear()


RETRY_BUDGETS = RetryBudgets()


# --------------------------------------------------------------- retry_rpc


async def retry_rpc(
    call_factory,
    what: str,
    *,
    timeout_s: float = DEFAULT_RPC_TIMEOUT_S,
    attempts: int = 3,
    peer: str = "",
    base_delay_s: float = 0.2,
):
    """Await `call_factory()` (a fresh RPC per attempt) under a
    deadline, retrying TRANSIENT transport failures with exponential
    backoff + full jitter, gated by the peer's retry token budget.

    This is the ONE retry implementation (the shell's fan-out rides it).  The
    shard-move RPCs are all idempotent (copy overwrites, mount/unmount/
    delete converge), so a retry after an ambiguous failure is safe —
    but deterministic server verdicts (NOT_FOUND, FAILED_PRECONDITION,
    ...) surface immediately instead of burning attempts*timeout on an
    answer that will not change.  Each attempt's wait_for timeout is
    capped by the remaining deadline budget; a spent budget raises
    DeadlineExceeded before any attempt.  A drained retry budget
    fast-fails with the LAST transport error (counted in
    ..._retry_budget_exhausted_total + a `retry_budget` flight-recorder
    event) — under a sick peer that is the designed behavior, not an
    error in the caller."""
    import asyncio

    from ..pb.rpc import RpcError, StatusCode

    transient = (
        StatusCode.UNAVAILABLE,
        StatusCode.DEADLINE_EXCEEDED,
        StatusCode.UNKNOWN,  # ambiguous transport failures
    )
    delay = base_delay_s
    for attempt in range(1, attempts + 1):
        per_call = rpc_timeout_s(timeout_s, what=what)
        if attempt == 1:
            RETRY_BUDGETS.on_attempt(peer)
        _count("retry_attempts", metric=False)
        try:
            return await asyncio.wait_for(call_factory(), per_call)
        except (RpcError, asyncio.TimeoutError, ConnectionError) as e:
            code = e.code() if isinstance(e, RpcError) else None
            if code is not None and code not in transient:
                raise  # a real answer, not a delivery problem
            if attempt == attempts:
                raise RuntimeError(
                    f"{what} failed after {attempts} attempts: {e!r}"
                ) from e
            if not RETRY_BUDGETS.try_retry(peer):
                _count("retry_budget_exhausted")
                from ..obs import incident as obs_incident

                obs_incident.record(
                    "retry_budget", what=what, peer=peer, attempt=attempt
                )
                raise RuntimeError(
                    f"{what} failed after {attempt} attempt(s): retry "
                    f"budget exhausted for peer {peer or '<unset>'}: {e!r}"
                ) from e
            _count("retries", metric=False)
            # full jitter: synchronized retries from many callers are
            # themselves the storm the budget exists to prevent
            await asyncio.sleep(delay * (0.5 + random.random()))
            delay *= 2


# ------------------------------------------------------------ hedged gather


@dataclass
class GatherResult:
    """What one hedged survivor gather did — the caller's annotations
    and the memo decision both read it."""

    got: dict[int, bytes] = field(default_factory=dict)
    sent: int = 0            # total fetches issued (primaries + spares)
    ok: int = 0              # fetches whose bytes were used or valid
    hedges_sent: int = 0
    hedge_wins: int = 0
    hedges_cancelled: int = 0
    deadline_hit: bool = False


def hedged_gather(
    need: int,
    candidates: list[int],
    fetch: Callable[[int], Optional[bytes]],
    *,
    pool,
    validate: Callable[[Optional[bytes]], bool] | None = None,
    peer_of: Callable[[int], Any] | None = None,
    pod_of: Callable[[int], Any] | None = None,
    deadline_s: float | None = None,
    what: str = "",
) -> GatherResult:
    """Fetch `need` of the `candidates` shard ids via `fetch`, hedging
    around tail-slow peers.

      * the `need` cheapest candidates (per-peer latency EWMA means)
        are issued first; the rest are SPARES;
      * a pending fetch that exceeds its peer's EWMA-quantile threshold
        arms ONE hedge to the next spare — if the hedge token budget
        allows (each primary deposits hedge_budget_pct/100 tokens, so
        hedging is load-bounded by construction);
      * a FAILED fetch (None / wrong size / exception) is replaced from
        the spares immediately — that is recovery, not hedging, and
        spends no hedge tokens (wave widening);
      * the first `need` valid completions win; stragglers are
        cancelled where still queued and abandoned where already
        running (their per-call RPC timeout frees the pool thread — the
        gather never waits for them);
      * the whole gather is bounded by `deadline_s` (default: the
        remaining ambient budget, capped at DEFAULT_GATHER_TIMEOUT_S) —
        on expiry it returns what it has and the caller's
        InsufficientShards tells the truth.

    Each fetch runs under a copy of the caller's contextvars (trace id
    + deadline propagate through the shared pool).  Sync
    by design: the degraded read path already runs on a to_thread
    worker."""
    res = GatherResult()
    if need <= 0 or not candidates:
        return res
    rem = remaining_s()
    if deadline_s is None:
        deadline_s = DEFAULT_GATHER_TIMEOUT_S
    if rem is not None:
        deadline_s = min(deadline_s, max(0.0, rem))
    t_end = time.monotonic() + deadline_s
    if validate is None:
        validate = lambda b: b is not None  # noqa: E731

    key_of = peer_of if peer_of is not None else (lambda sid: None)
    pod_key = pod_of if pod_of is not None else (lambda sid: "")

    def _mean(sid: int) -> float:
        m = PEER_LATENCY.mean_s(key_of(sid))
        return m if m is not None else 0.0

    ranked = sorted(candidates, key=_mean)  # cheapest first, stable
    spares = ranked[need:]

    def _pop_spare(avoid_sid: int | None = None) -> int:
        """Next spare, preferring one whose holder sits OUTSIDE the
        pod of `avoid_sid`'s holder: mesh-pod members serve one
        SPMD residency mesh in lockstep and stall together, so a hedge
        or replacement routed back into the slow peer's own pod is
        likely to hit the very stall it exists to route around.
        Cheapest-first order is preserved within the preference, and
        with no pod information (pod_of absent / "" pods) this is
        exactly spares.pop(0)."""
        if avoid_sid is not None and len(spares) > 1:
            avoid = pod_key(avoid_sid)
            if avoid:
                for i, sid in enumerate(spares):
                    if pod_key(sid) != avoid:
                        return spares.pop(i)
        return spares.pop(0)
    ctx = contextvars.copy_context()
    # per-fetch budget: each submitted fetch runs under its own tight
    # deadline scope (never extending the ambient one), so a HUNG peer
    # releases its pool thread in ~seconds instead of holding it for
    # the fetch implementation's full fallback timeout — without this,
    # one hung holder's abandoned fetches starve the shared gather pool
    # and queue every later gather behind them (the 7s pile-up the
    # reference's fault sweep measured)
    agg = PEER_LATENCY.aggregate_mean_s()
    # with no latency data at all (cold start) the budget stays the
    # full gather deadline: a deployment where a healthy fetch takes
    # over a second must not fail its first-ever degraded read
    fetch_budget_s = deadline_s if agg is None else min(
        deadline_s, max(2 * GATHER_PATIENCE_MIN_S, 30.0 * agg)
    )

    def _budgeted_fetch(sid: int):
        with deadline_scope(fetch_budget_s):
            return fetch(sid)

    class _Fetch:
        __slots__ = ("sid", "peer", "t0", "is_hedge", "hedged", "future",
                     "trigger", "observed_slow", "replaced")

        def __init__(self, sid, is_hedge=False, trigger=None):
            self.sid = sid
            self.peer = key_of(sid)
            self.t0 = time.monotonic()
            self.is_hedge = is_hedge
            self.hedged = False   # a hedge was armed FOR this fetch
            self.trigger = trigger  # the slow fetch this hedge covers
            self.observed_slow = False  # censored EWMA feed happened
            self.replaced = False  # a patience replacement was issued
            self.future: Future = pool.submit(
                ctx.copy().run, _budgeted_fetch, sid
            )

    pending: list[_Fetch] = [_Fetch(sid) for sid in ranked[:need]]
    res.sent = len(pending)
    for _ in pending:
        HEDGE_BUDGET.deposit(CONFIG.hedge_budget_pct / 100.0)

    from ..obs import incident as obs_incident

    while len(res.got) < need:
        now = time.monotonic()
        if now >= t_end:
            res.deadline_hit = True
            break
        if not pending:
            if not spares:
                break  # nothing left to try
            f = _Fetch(spares.pop(0))
            pending.append(f)
            res.sent += 1
            HEDGE_BUDGET.deposit(CONFIG.hedge_budget_pct / 100.0)
        # wake at the earliest hedge-arming moment among pending
        # un-hedged fetches, else just poll toward the deadline
        tick = t_end - now
        for p in pending:
            if p.hedged or not spares:
                continue
            th = PEER_LATENCY.threshold_s(p.peer)
            if th is not None:
                tick = min(tick, p.t0 + th - now)
        done, _ = wait(
            {p.future for p in pending},
            timeout=min(max(tick, 0.002), 0.25),
            return_when=FIRST_COMPLETED,
        )
        now = time.monotonic()
        still: list[_Fetch] = []
        for p in pending:
            if p.future not in done:
                still.append(p)
                continue
            try:
                data = p.future.result()
            except Exception:  # noqa: BLE001 — a failed fetch is a miss
                data = None
            if p.peer is not None:
                # successes feed the EWMAs with their real latency; a
                # FAILURE only feeds them when it took LONGER than the
                # peer's current mean (a timed-out hung fetch is strong
                # "at least this slow" evidence, but a fast-failing
                # peer — immediate UNAVAILABLE — must never be recorded
                # as "cheap" and re-picked as a primary forever)
                elapsed = now - p.t0
                if validate(data) or elapsed > (
                    PEER_LATENCY.mean_s(p.peer) or 0.0
                ):
                    PEER_LATENCY.observe(p.peer, elapsed)
            if validate(data) and p.sid not in res.got:
                res.got[p.sid] = data  # type: ignore[assignment]
                res.ok += 1
                if p.is_hedge and p.trigger is not None and (
                    p.trigger.sid not in res.got
                ):
                    # the spare came back before the slow primary it
                    # covered: a hedge WIN — the tail the whole
                    # mechanism exists to cut
                    res.hedge_wins += 1
                    _count("hedge_wins")
        # failure replacements AFTER the completion sweep: top up to
        # `need` fetches genuinely in flight, counting the whole
        # surviving pending set — replacing per-failure mid-sweep
        # over-fetched when a covering hedge was still running
        while spares and len(res.got) + len(still) < need:
            still.append(_Fetch(spares.pop(0)))
            res.sent += 1
            HEDGE_BUDGET.deposit(CONFIG.hedge_budget_pct / 100.0)
        pending = still
        if len(res.got) >= need:
            break
        # arm hedges for fetches past their peer's quantile threshold;
        # far past it (the patience bound) a pending fetch is REPLACED
        # from the spares outright — no hedge token needed, so a
        # drained hedge budget can delay recovery but never pin a read
        # at the full gather deadline
        for p in list(pending):
            if p.is_hedge or not spares:
                continue
            age = now - p.t0
            th = PEER_LATENCY.threshold_s(p.peer)
            slow = th is not None and age >= th
            if slow and not p.observed_slow and p.peer is not None:
                # censored observation AT DETECTION time (not gather
                # end): concurrent gathers must stop picking a hung
                # peer as a primary before the first slow gather even
                # finishes
                p.observed_slow = True
                PEER_LATENCY.observe(p.peer, age)
            if (
                slow
                and not p.hedged
                and CONFIG.hedge_budget_pct > 0
                and HEDGE_BUDGET.take(1.0)
            ):
                h = _Fetch(_pop_spare(p.sid), is_hedge=True, trigger=p)
                p.hedged = True
                pending.append(h)
                res.sent += 1
                res.hedges_sent += 1
                _count("hedge_sent")
                obs_incident.record(
                    "hedge", what=what, slow_sid=p.sid, hedge_sid=h.sid,
                    waited_ms=round(age * 1e3, 2),
                )
                continue
            patience = GATHER_PATIENCE_MIN_S
            if th is not None:
                patience = max(patience, 8.0 * th)
            if age >= patience and not p.hedged and not p.replaced:
                p.replaced = True
                if p.peer is not None:
                    # a patience replacement is a give-up: feed the
                    # EWMAs the full wait NOW (not just the weak
                    # at-threshold observation) so concurrent gathers
                    # reorder the sick peer out of their primary sets
                    # within one patience cycle
                    PEER_LATENCY.observe(p.peer, age)
                pending.append(_Fetch(_pop_spare(p.sid)))
                res.sent += 1
                HEDGE_BUDGET.deposit(CONFIG.hedge_budget_pct / 100.0)
    # losers: cancel what never started; abandon what is running (its
    # own RPC timeout frees the thread) — count the hedges we walked
    # away from so amplification is measurable end to end
    now = time.monotonic()
    for p in pending:
        if not p.future.cancel() and p.peer is not None:
            # CENSORED latency observation: the fetch was abandoned
            # still running, so the elapsed wait is a latency floor.
            # This is what steers the EWMAs away from a hung peer — a
            # fetch that never completes would otherwise never be
            # observed, and the hung peer would stay "cheap" and be
            # picked as a primary on every later gather.
            PEER_LATENCY.observe(p.peer, now - p.t0)
        if p.is_hedge:
            res.hedges_cancelled += 1
            _count("hedge_cancelled")
    if res.deadline_hit:
        _count("deadline_exceeded")
        obs_incident.record(
            "deadline_exceeded", what=what or "hedged_gather",
            got=len(res.got), need=need,
        )
    return res
