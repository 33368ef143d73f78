"""Device-time attribution ledger: who is burning the card.

Port of seaweedfs_tpu/obs/devledger.py (host-only, copied over the port's
stats/metrics).  Several workloads share the device: serving reconstruct
(interactive and bulk QoS tiers), the parity scrub, the bulk executor's
encode (bulk), rebuild (repair) and verify (scrub) legs.  Every device
section is tagged with a workload class and accumulates busy seconds,
dispatch count, boundary bytes and queue wait per class *per device*,
exported as the SeaweedFS_volumeServer_device_* series and served at
GET /debug/device/attribution.

Tagging rides a contextvar, so the class set at the edge (the QoS tier in
the serving dispatcher, the scrub calls) propagates through
asyncio.to_thread into the ops layer without threading a parameter
through every call.  Worker threads that outlive the tagging context (the
bulk Codec's leg) re-enter a class explicitly via `workload(...)`.

Busy seconds are the wall of the device section, as in the reference:
DevicePipeline.slot records its slot seconds (the resident reconstructs
and the scrub run in a slot) and the bulk Codec its leg seconds, so the
per-class sums equal DevicePipeline.total_busy_s plus Codec.busy_s
(tests/test_torch_devledger.py).  The card's own kernel time is what
CUDA events measure (chip_smoke.py reports both).
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Any

from ..stats import metrics as stats_metrics

# the reference's seven classes + the escape hatch; also the metric label
# universe (stats/metrics.py DEVICE_WORKLOADS is the same tuple, so the
# series declaration and the ledger can't drift)
WORKLOADS = stats_metrics.DEVICE_WORKLOADS
UNTAGGED = "untagged"

_WORKLOAD: contextvars.ContextVar[str] = contextvars.ContextVar(
    "swfs_device_workload", default=UNTAGGED
)
_DEVICE: contextvars.ContextVar[str] = contextvars.ContextVar(
    "swfs_device_label", default="default"
)


def current_workload() -> str:
    return _WORKLOAD.get()


def current_device() -> str:
    return _DEVICE.get()


@contextlib.contextmanager
def workload(cls: str, device: str | None = None):
    """Tag every device dispatch in this context (and in
    asyncio.to_thread hops made from it) with workload class `cls`;
    `device` optionally pins the device label too (mesh / an index /
    default / host)."""
    if cls not in WORKLOADS:
        cls = UNTAGGED
    tok = _WORKLOAD.set(cls)
    dtok = _DEVICE.set(device) if device is not None else None
    try:
        yield
    finally:
        _WORKLOAD.reset(tok)
        if dtok is not None:
            _DEVICE.reset(dtok)


@contextlib.contextmanager
def device(label: str):
    """Pin only the device label (the workload class flows from the
    caller's context) — reconstruct knows placement, not tenancy."""
    tok = _DEVICE.set(label)
    try:
        yield
    finally:
        _DEVICE.reset(tok)


class DeviceLedger:
    """Thread-safe per-(workload, device) accumulator, mirrored to the
    SeaweedFS_volumeServer_device_* counters on every record."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.enabled = True
        # (workload, device) -> [busy_s, dispatches, bytes, queue_wait_s]
        self._cells: dict[tuple[str, str], list[float]] = {}

    def record(
        self,
        workload: str | None = None,
        device: str | None = None,
        busy_s: float = 0.0,
        dispatches: int = 0,
        nbytes: int = 0,
        queue_wait_s: float = 0.0,
    ) -> None:
        if not self.enabled:
            return
        wl = workload if workload is not None else _WORKLOAD.get()
        if wl not in WORKLOADS:
            wl = UNTAGGED
        dev = device if device is not None else _DEVICE.get()
        with self._lock:
            cell = self._cells.setdefault(
                (wl, dev), [0.0, 0.0, 0.0, 0.0]
            )
            cell[0] += busy_s
            cell[1] += dispatches
            cell[2] += nbytes
            cell[3] += queue_wait_s
        if busy_s:
            stats_metrics.VOLUME_SERVER_DEVICE_BUSY_SECONDS.labels(
                workload=wl, device=dev
            ).inc(busy_s)
        if dispatches:
            stats_metrics.VOLUME_SERVER_DEVICE_DISPATCHES.labels(
                workload=wl, device=dev
            ).inc(dispatches)
        if nbytes:
            stats_metrics.VOLUME_SERVER_DEVICE_DISPATCH_BYTES.labels(
                workload=wl, device=dev
            ).inc(nbytes)
        if queue_wait_s:
            stats_metrics.VOLUME_SERVER_DEVICE_QUEUE_WAIT_SECONDS.labels(
                workload=wl, device=dev
            ).inc(queue_wait_s)

    def snapshot(self) -> dict[str, Any]:
        """{workload: {devices: {label: {...}}, totals}} — the
        volume.device.attribution document and the timeline sampler's
        counter source."""
        with self._lock:
            cells = {k: list(v) for k, v in self._cells.items()}
        out: dict[str, Any] = {}
        for (wl, dev), (busy, calls, nbytes, wait) in sorted(cells.items()):
            doc = out.setdefault(
                wl,
                {
                    "busy_s": 0.0, "dispatches": 0, "bytes": 0,
                    "queue_wait_s": 0.0, "devices": {},
                },
            )
            doc["busy_s"] += busy
            doc["dispatches"] += int(calls)
            doc["bytes"] += int(nbytes)
            doc["queue_wait_s"] += wait
            doc["devices"][dev] = {
                "busy_s": busy, "dispatches": int(calls),
                "bytes": int(nbytes), "queue_wait_s": wait,
            }
        return out

    def busy_by_workload(self) -> dict[str, float]:
        with self._lock:
            out: dict[str, float] = {}
            for (wl, _dev), cell in self._cells.items():
                out[wl] = out.get(wl, 0.0) + cell[0]
            return out

    def dispatches_by_workload(self) -> dict[str, int]:
        with self._lock:
            out: dict[str, int] = {}
            for (wl, _dev), cell in self._cells.items():
                out[wl] = out.get(wl, 0) + int(cell[1])
            return out

    def total_busy_s(self) -> float:
        with self._lock:
            return sum(cell[0] for cell in self._cells.values())

    def reset_for_tests(self) -> None:
        with self._lock:
            self._cells.clear()


LEDGER = DeviceLedger()


def record(**kw) -> None:
    """Module-level shorthand used by the dispatch sites (workload=/
    device= default to the context)."""
    LEDGER.record(**kw)


def configure(enabled: bool) -> None:
    """-obs.ledger.disable: recording becomes a no-op (the series stay
    registered, they just stop moving)."""
    LEDGER.enabled = bool(enabled)
