"""The port's flight recorder (seaweedfs_tpu_torch/obs/incident.py), held
against the JAX package's.

Mirrors tests/test_incident_plane.py's unit cases and the event-ring race
of tests/test_trace_ring_stress.py: the config validators agree, record()
stamps the ambient trace id and flags it for tail pinning, the ring's
filters work, and the decisions the port makes are recorded — QoS sheds
and breaker transitions (serving/qos.py, the same shed sequence through
both packages' controllers), dispatcher saturation
(serving/dispatcher.py) and spent deadline budgets
(utils/faultpolicy.py).  /debug/incident is driven with a request
stand-in.
"""
import asyncio
import dataclasses
import json
import threading
import time
from types import SimpleNamespace

import lockwatch
import pytest

from seaweedfs_tpu.obs import incident as jax_incident
from seaweedfs_tpu.serving import qos as jax_qos
from seaweedfs_tpu_torch import obs
from seaweedfs_tpu_torch.obs import incident as obs_incident
from seaweedfs_tpu_torch.obs import tailstore
from seaweedfs_tpu_torch.serving import EcReadDispatcher, ServingConfig
from seaweedfs_tpu_torch.serving import qos
from seaweedfs_tpu_torch.utils import faultpolicy


@pytest.fixture(autouse=True)
def _restore_incident_config():
    """Both recorders are process-global; every test gets the defaults
    and an empty ring back."""
    obs_incident.EVENTS.clear()
    jax_incident.EVENTS.clear()
    yield
    for mod in (obs_incident, jax_incident):
        mod.configure(mod.IncidentConfig())
        mod.EVENTS.clear()


def test_incident_config_validation_equals_reference():
    assert dataclasses.asdict(obs_incident.IncidentConfig()) == \
        dataclasses.asdict(jax_incident.IncidentConfig())
    assert obs_incident.IncidentConfig().validated().events == 512
    grid = {
        "events": (0, 1, 512),
        "keep": (0, 1, 16),
        "min_interval_seconds": (-1.0, 0.0, 60.0),
        "profile_seconds": (-1.0, 0.0, 5.0),
    }
    verdicts = set()
    for field, values in grid.items():
        for v in values:
            outcomes = []
            for mod in (obs_incident, jax_incident):
                try:
                    cfg = mod.IncidentConfig(**{field: v}).validated()
                    outcomes.append(("ok", dataclasses.asdict(cfg)))
                except ValueError:
                    outcomes.append(("raise", None))
            assert outcomes[0] == outcomes[1], (field, v)
            verdicts.add(outcomes[0][0])
    assert verdicts == {"ok", "raise"}


def test_record_stamps_ambient_trace_id():
    t, tok = obs.start_trace("GET /x", "volume", "srv")
    try:
        obs_incident.record("qos_shed", tier="interactive", reason="t")
    finally:
        obs.finish_trace(t, tok, 200)
    obs_incident.record("tier_promote", vid=7)  # outside any trace
    ev = obs_incident.EVENTS.snapshot()
    assert ev[0]["kind"] == "tier_promote" and ev[0]["trace_id"] == ""
    assert ev[1]["kind"] == "qos_shed"
    assert ev[1]["trace_id"] == t.trace_id
    assert ev[1]["details"] == {"tier": "interactive", "reason": "t"}
    assert set(ev[1]) == {"unix_ms", "kind", "trace_id", "details"}


def test_record_disabled_is_a_noop():
    obs_incident.configure(obs_incident.IncidentConfig(enabled=False))
    obs_incident.record("qos_shed", tier="bulk", reason="x")
    assert obs_incident.EVENTS.snapshot() == []


def test_event_ring_since_kind_limit_filters_equal_reference():
    base_s = 1_700_000_000
    rings = (obs_incident.EventRing(4), jax_incident.EventRing(4))
    for ring in rings:
        for i in range(6):
            ring.add({"unix_ms": (base_s + i) * 1000,
                      "kind": "a" if i % 2 else "b",
                      "trace_id": "", "details": {"i": i}})
    for kw in ({}, {"since_unix": base_s + 3}, {"kind": "a", "limit": 2},
               {"limit": 1}, {"kind": "c"}):
        got = [e["details"]["i"] for e in rings[0].snapshot(**kw)]
        assert got == [e["details"]["i"] for e in rings[1].snapshot(**kw)]
    assert [e["details"]["i"] for e in rings[0].snapshot()] == [5, 4, 3, 2]
    assert [e["details"]["i"] for e in
            rings[0].snapshot(since_unix=base_s + 3)] == [5, 4, 3]


def test_record_flags_the_ambient_trace_for_tail_pinning():
    store = tailstore.TailStore(node="vs1", capacity=4, floor_ms=1e9)
    store.install()
    try:
        t, tok = obs.start_trace("GET /1,ab", "volume", "vs1")
        obs_incident.record("qos_shed", tier="interactive", reason="x")
        obs.finish_trace(t, tok, 200)
        pins = store.snapshot(trace_id=t.trace_id)
        assert [p["reason"] for p in pins] == ["incident:qos_shed"]
        t, tok = obs.start_trace("GET /1,cd", "volume", "vs1")
        obs_incident.record("tier_promote", vid=1)  # not a tail trigger
        obs.finish_trace(t, tok, 200)
        assert not store.snapshot(trace_id=t.trace_id)
    finally:
        store.uninstall()


def _events(mod):
    return [(e["kind"], e["details"]) for e in mod.EVENTS.snapshot()]


def test_qos_shed_and_breaker_transitions_equal_reference():
    """The same admission sequence through both packages' controllers
    records the same events."""
    for q_mod, inc in ((qos, obs_incident), (jax_qos, jax_incident)):
        now = [0.0]
        q = q_mod.QosController(
            {q_mod.INTERACTIVE: q_mod.TierPolicy(q_mod.INTERACTIVE, 1, 0.0)},
            trip_after=2, cooldown_s=60.0, clock=lambda: now[0],
        )
        q.enqueued(q_mod.INTERACTIVE)  # budget (1) now full
        assert q.admit(q_mod.INTERACTIVE, 1, 4) == "queue_budget"
        assert q.admit(q_mod.INTERACTIVE, 1, 4) == "queue_budget"  # trips
        assert q.admit(q_mod.INTERACTIVE, 1, 4) == "breaker_open"
        q.saturated(q_mod.INTERACTIVE)
        now[0] = 61.0
        q.dequeued(q_mod.INTERACTIVE)
        assert q.admit(q_mod.INTERACTIVE, 0, 4) is None  # half-open probe
    got, want = _events(obs_incident), _events(jax_incident)
    assert got == want
    kinds = [k for k, _ in got]
    assert kinds.count("qos_shed") == 4
    states = [d["state"] for k, d in reversed(got) if k == "qos_breaker"]
    assert states[0] == "closed" and "open" in states


def test_dispatcher_saturation_is_recorded():
    """A read the full coalescer sheds to the native path records
    dispatch_saturated, stamped with the reading request's trace."""

    class Store:
        def ec_volume_is_resident(self, vid):
            return True

        def read_ec_needle(self, vid, nid, cookie, remote, use_device,
                           zero_copy):
            return b"native"

        def read_ec_needles_batch(self, vid, requests, remote_read=None,
                                  zero_copy=False):
            time.sleep(0.01)
            return [b"x"] * len(requests)

    async def go():
        d = EcReadDispatcher(Store(), lambda vid: None, ServingConfig(
            max_batch=1, max_queue=1, max_inflight=1, qos=False))

        async def traced(nid):
            t, tok = obs.start_trace(f"GET /{nid}", "volume")
            try:
                return t, await d.read(1, nid, None)
            finally:
                obs.finish_trace(t, tok, 200)

        return await asyncio.gather(*(traced(n) for n in range(1, 5)))

    results = asyncio.run(go())
    sat = obs_incident.EVENTS.snapshot(kind="dispatch_saturated")
    shed = [t.trace_id for t, body in results if body == b"native"]
    assert shed and sorted(e["trace_id"] for e in sat) == sorted(shed)
    assert set(sat[0]["details"]) == {"vid", "tier", "queue_depth"}


def test_spent_deadline_is_recorded():
    with faultpolicy.deadline_scope(-1.0):
        with pytest.raises(faultpolicy.DeadlineExceeded):
            faultpolicy.check_remaining("ec read admission")
    ev = obs_incident.EVENTS.snapshot(kind="deadline_exceeded")
    assert [e["details"] for e in ev] == [{"what": "ec read admission"}]


def test_incident_handler_serves_events_and_traces():
    obs_incident.record("qos_shed", tier="bulk", reason="deadline")
    obs_incident.record("qos_breaker", tier="bulk", state="open",
                        prev="closed")
    t, tok = obs.start_trace("GET /9,ab", "volume")
    obs.finish_trace(t, tok, 200)

    def call(**query):
        req = SimpleNamespace(query={k: str(v) for k, v in query.items()})
        resp = asyncio.run(obs_incident.incident_handler(req))
        return resp.status, json.loads(resp.body)

    status, doc = call()
    assert status == 200
    assert set(doc) == {"generated_unix_ms", "events", "traces"}
    assert [e["kind"] for e in doc["events"]] == ["qos_breaker", "qos_shed"]
    assert doc["traces"][0]["trace_id"] == t.trace_id
    _, doc = call(kind="qos_shed", limit=1, since=60)
    assert [e["kind"] for e in doc["events"]] == ["qos_shed"]
    assert len(doc["traces"]) == 1


def test_event_ring_snapshot_races_record_and_resize():
    errors: list = []
    stop = threading.Event()
    with lockwatch.watch():
        ring = obs_incident.EventRing(capacity=64)

        def writer(wid):
            try:
                i = 0
                while not stop.is_set():
                    ring.add({"unix_ms": int(time.time() * 1e3),
                              "kind": f"kind{i % 3}", "trace_id": "",
                              "details": {"w": wid, "i": i}})
                    i += 1
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        def churner():
            try:
                cap = 8
                while not stop.is_set():
                    ring.resize(cap)
                    cap = 8 if cap == 256 else cap * 2
                    ring.snapshot(since_unix=time.time() - 1, limit=16,
                                  kind="kind1")
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = ([threading.Thread(target=writer, args=(w,))
                    for w in range(3)]
                   + [threading.Thread(target=churner) for _ in range(2)])
        for th in threads:
            th.start()
        time.sleep(1.0)
        stop.set()
        for th in threads:
            th.join(timeout=10)
            assert not th.is_alive(), "stress thread wedged"
    assert not errors, errors
    snap = ring.snapshot()
    assert all(snap[i]["unix_ms"] >= snap[i + 1]["unix_ms"] - 100
               for i in range(len(snap) - 1))
