"""The port's serving stack (serving/, utils/faultpolicy.py, utils/tasks.py,
stats/metrics.py) held against the JAX package's.

`Coalescer`, `Breaker` and `QosController` run one seeded sequence of
operations through both packages, with an injected clock, and must make
the same decision at every step.  The dispatcher runs the deterministic
scenarios of tests/test_serving_dispatcher.py and test_qos_admission.py
against both packages on their FakeStore double, then against the port's
real Store over a degraded EC volume resident in a CPU DeviceShardCache,
byte-equal to the reference Store.
"""
import asyncio
import logging
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu import serving as jax_serving
from seaweedfs_tpu import stats as jax_stats
from seaweedfs_tpu.serving import qos as jax_qos
from seaweedfs_tpu.storage import disk_location as jax_dl
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.utils import faultpolicy as jax_fp
from seaweedfs_tpu_torch import serving, stats
from seaweedfs_tpu_torch.ops import rs_resident
from seaweedfs_tpu_torch.serving import qos
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.utils import faultpolicy
from seaweedfs_tpu_torch.utils.tasks import spawn_logged

from test_serving_dispatcher import FakeStore
from test_torch_store import EC_VID, build_dir, cpu_cache, wait_resident

PKGS = {"jax": jax_serving, "torch": serving}


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


# --------------------------------------------------------------- coalescer


def test_coalescer_same_decisions_on_a_seeded_sequence():
    async def go():
        loop = asyncio.get_running_loop()
        rng = np.random.default_rng(11)
        cs = {k: m.Coalescer(max_batch=5, max_queue=12) for k, m in PKGS.items()}
        for step in range(2000):
            if rng.random() < 0.7:
                vid, nid = int(rng.integers(0, 3)), step
                got = {k: c.offer(PKGS[k].ReadRequest(
                    vid, nid, None, loop.create_future(), loop.time()))
                    for k, c in cs.items()}
            else:
                got = {k: {v: [r.nid for r in rs] for v, rs in c.take().items()}
                       for k, c in cs.items()}
            assert got["torch"] == got["jax"], step
            assert len(cs["torch"]) == len(cs["jax"])
            assert cs["torch"].saturated == cs["jax"].saturated

    asyncio.run(go())


# --------------------------------------------------------------------- QoS


def test_breaker_same_states_on_a_seeded_sequence():
    rng = np.random.default_rng(12)
    clk = FakeClock()
    bs = {"jax": jax_qos.Breaker(trip_after=3, cooldown_s=2.0, clock=clk),
          "torch": qos.Breaker(trip_after=3, cooldown_s=2.0, clock=clk)}
    for step in range(3000):
        op = rng.integers(0, 4)
        for b in bs.values():
            if op == 0:
                b.record_rejection()
            elif op == 1:
                b.record_success()
        if op == 2:
            clk.now += float(rng.uniform(0, 1.5))
        assert bs["torch"].state == bs["jax"].state, step
        assert bs["torch"].allow() == bs["jax"].allow()


def _controllers(clk):
    policies = lambda mod: {  # noqa: E731
        mod.INTERACTIVE: mod.TierPolicy(mod.INTERACTIVE, 6, 0.05),
        mod.BULK: mod.TierPolicy(mod.BULK, 3, 0.0),
    }
    return {"jax": jax_qos.QosController(policies(jax_qos), trip_after=4,
                                         cooldown_s=1.0, clock=clk),
            "torch": qos.QosController(policies(qos), trip_after=4,
                                       cooldown_s=1.0, clock=clk)}


def test_qos_controller_same_decisions_on_a_seeded_sequence():
    rng = np.random.default_rng(13)
    clk = FakeClock()
    cs = _controllers(clk)
    decisions = []
    first_skipped = False
    for step in range(4000):
        tier = ("interactive", "bulk")[int(rng.integers(0, 2))]
        op = int(rng.integers(0, 6))
        if op == 0:
            depth, inflight = int(rng.integers(0, 40)), int(rng.integers(1, 5))
            rem = None if rng.random() < 0.5 else float(rng.uniform(-0.01, 0.1))
            got = {k: c.admit(tier, depth, inflight, remaining_s=rem)
                   for k, c in cs.items()}
            decisions.append(got["torch"])
        elif op == 1:
            got = {k: c.enqueued(tier) for k, c in cs.items()}
        elif op == 2:
            got = {k: c.dequeued(tier) for k, c in cs.items()}
        elif op == 3:
            got = {k: c.saturated(tier) for k, c in cs.items()}
        elif op == 4:
            # the port's seed rule (a departure, see
            # test_first_batch_does_not_seed_the_estimate): the first
            # observation after a start seeds nothing, so the reference
            # is fed the same sequence without it
            s = float(rng.uniform(0, 0.01))
            got = {"torch": cs["torch"].observe_service(s)}
            if s <= 0 or not first_skipped:
                got["jax"] = None
                first_skipped = first_skipped or s > 0
            else:
                got["jax"] = cs["jax"].observe_service(s)
        else:
            clk.now += float(rng.uniform(0, 0.6))
            got = {k: None for k in cs}
        assert got["torch"] == got["jax"], step
        for t in ("interactive", "bulk"):
            assert cs["torch"].breaker_state(t) == cs["jax"].breaker_state(t)
        assert cs["torch"].estimated_wait_s(7, 2) == cs["jax"].estimated_wait_s(7, 2)
    # the sequence reached every verdict
    assert {None, qos.SHED_QUEUE_BUDGET, qos.SHED_DEADLINE,
            qos.SHED_BREAKER_OPEN} <= set(decisions)


def test_first_batch_does_not_seed_the_estimate():
    """The port's departure from the reference's estimator: the first
    batch after a start (thread and allocator warm-up on a loaded box:
    0.57-0.81 s a needle against 0.04-0.34 s for the batches after it)
    and a batch served while a pin uploads do not seed the service-time
    EWMA.  Fed that first batch, the reference sheds a queue of 11
    interactive reads on its 2 s deadline; the port admits them."""
    clk = FakeClock()
    pol = lambda mod: {  # noqa: E731
        mod.INTERACTIVE: mod.TierPolicy(mod.INTERACTIVE, 64, 2.0),
        mod.BULK: mod.TierPolicy(mod.BULK, 64, 0.0),
    }
    ref = jax_qos.QosController(pol(jax_qos), clock=clk)
    port = qos.QosController(pol(qos), clock=clk)
    for c in (ref, port):
        c.observe_service(0.8)
    assert ref.estimated_wait_s(11, 4) == pytest.approx(2.2)
    assert port.estimated_wait_s(11, 4) == 0.0
    assert ref.admit("interactive", 11, 4) == jax_qos.SHED_DEADLINE
    assert port.admit("interactive", 11, 4) is None
    # a batch served while a pin uploads does not seed either
    port.observe_service(0.9, pinning=True)
    assert port.estimated_wait_s(11, 4) == 0.0
    # the next batch seeds, and from there the EWMA is the reference's,
    # pinning or not
    port.observe_service(0.2)
    ref2 = jax_qos.QosController(pol(jax_qos), clock=clk)
    ref2.observe_service(0.2)
    for s, pinning in ((0.9, True), (0.1, False), (0.3, True)):
        port.observe_service(s, pinning=pinning)
        ref2.observe_service(s)
        assert port.estimated_wait_s(11, 4) == ref2.estimated_wait_s(11, 4)
    # a deadline shed still happens when the seeded estimate earns it
    port.observe_service(3.0)
    assert port.admit("interactive", 11, 4) == qos.SHED_DEADLINE


def test_dispatcher_marks_batches_served_during_a_pin():
    """The dispatcher tells the estimator when a pin was uploading during
    a batch: the cache's pin activity (puts in flight, puts started)
    changes across the batch or was non-zero at its start."""
    cache = rs_resident.DeviceShardCache(1 << 22, shard_quantum=1 << 20,
                                         device="cpu")
    a0 = cache.pin_activity()
    assert a0 == (0, 0)
    cache.put(1, 0, b"x" * 100)
    assert cache.pin_activity() == (0, 1)
    seen = []

    class Q:
        def observe_service(self, s, pinning=False):
            seen.append(pinning)

    class St:
        ec_device_cache = cache

        def read_ec_needles_batch(self, vid, items, remote, zero_copy):
            if vid == 2:
                cache.put(2, 0, b"y" * 100)
            return [None] * len(items)

    async def go():
        d = serving.EcReadDispatcher(St(), lambda vid: None)
        d.qos = Q()
        loop = asyncio.get_running_loop()
        for vid in (1, 2, 1):
            r = serving.ReadRequest(vid, 1, None, loop.create_future(),
                                    loop.time())
            await d._serve_batch(vid, [r])

    asyncio.run(go())
    assert seen == [False, True, False]


def test_normalize_tier_and_from_config_equal():
    for raw in ("interactive", "bulk", "", None, "BULK", "x"):
        assert qos.normalize_tier(raw) == jax_qos.normalize_tier(raw)
    cfg, jcfg = serving.ServingConfig(), jax_serving.ServingConfig()
    a, b = qos.QosController.from_config(cfg), jax_qos.QosController.from_config(jcfg)
    assert {k: vars(p) for k, p in a.policies.items()} == \
        {k: vars(p) for k, p in b.policies.items()}


# ------------------------------------------------------------------ config


def test_serving_config_defaults_and_validation_equal():
    port, ref = serving.ServingConfig(), jax_serving.ServingConfig()
    shared = set(vars(port)) - {"layout"}
    assert shared <= set(vars(ref))
    assert {k: getattr(port, k) for k in shared} == \
        {k: getattr(ref, k) for k in shared}
    # the one default that differs: the port serves the flat system
    assert (port.layout, ref.layout) == ("flat", "blockdiag")
    assert port.pipeline_slots == ref.pipeline_slots == 2
    assert port.max_wait_s == ref.max_wait_s
    for n in (0, 1 << 16, 10 << 20):
        assert port.stall_budget_for(n) == ref.stall_budget_for(n)
    for bad in (dict(max_batch=0), dict(max_queue=4, max_batch=8),
                dict(max_inflight=0), dict(max_wait_us=-1), dict(layout="x"),
                dict(qos_bulk_queue=0), dict(qos_interactive_deadline_ms=-1),
                dict(qos_trip_after=0), dict(qos_recover_seconds=0),
                dict(stall_min_rate_kbps=0)):
        for mod in PKGS.values():
            with pytest.raises(ValueError):
                mod.ServingConfig(**bad).validated()
    assert serving.ServingConfig(overlap=False).pipeline_slots == 1


# -------------------------------------------------------------- deadlines


def test_deadline_helpers_equal():
    for raw in ("", "abc", "nan", "0", "-5", "250", "1e12", "12.5", None):
        assert faultpolicy.parse_deadline_ms(raw) == jax_fp.parse_deadline_ms(raw)
    assert faultpolicy.remaining_s() is None
    with faultpolicy.deadline_scope(5.0):
        outer = faultpolicy.remaining_s()
        with faultpolicy.deadline_scope(60.0):  # a hop never extends
            assert faultpolicy.remaining_s() <= outer
        with faultpolicy.detached():
            assert faultpolicy.remaining_s() is None
        with faultpolicy.deadline_scope(0.5):
            assert faultpolicy.remaining_s() <= 0.5
    with faultpolicy.request_scope({"X-Seaweed-Deadline-Ms": "250"}):
        assert 0 < faultpolicy.remaining_s() <= 0.25
    with faultpolicy.request_scope({}):  # the default stamp, 30 s
        assert 29 < faultpolicy.remaining_s() <= 30
    n0 = stats.VOLUME_SERVER_EC_DEADLINE_EXCEEDED.value
    with faultpolicy.deadline_scope(-0.001):
        with pytest.raises(faultpolicy.DeadlineExceeded):
            faultpolicy.check_remaining("x")
    assert stats.VOLUME_SERVER_EC_DEADLINE_EXCEEDED.value == n0 + 1
    assert issubclass(faultpolicy.DeadlineExceeded, TimeoutError)


def test_spawn_logged_retains_and_logs(caplog):
    async def go():
        reg = set()

        async def boom():
            raise RuntimeError("lane died")

        task = spawn_logged(boom(), logging.getLogger("t"), "lane", reg)
        assert task in reg
        await asyncio.gather(task, return_exceptions=True)
        await asyncio.sleep(0)
        assert task not in reg

    with caplog.at_level(logging.WARNING):
        asyncio.run(go())
    assert "lane died" in caplog.text


# -------------------------------------------------------------- metrics


def test_metric_series_carry_the_reference_names():
    """The port's declared metric families (name, type, label names) are
    the reference's, less the ones the port does not serve, plus its own
    families: the kernels' launch counts, and the remote shard reader's
    fetches and bytes (which the cluster's chip phase reads per GET).
    Families, not samples: a
    labelled family shows samples only once some caller has touched a
    child, so a sample comparison would depend on what ran before it in
    the process."""
    def fam(name, kind, labels):
        return name.removesuffix("_total"), kind, tuple(labels)

    ref = {fam(c._name, c._type, c._labelnames)
           for c in jax_stats.REGISTRY._collector_to_names}
    ours = {fam(m.name, m.kind, m.labelnames)
            for m in stats.REGISTRY.collect()}
    own = (stats.VOLUME_SERVER_EC_KERNEL_LAUNCHES,
           stats.VOLUME_SERVER_EC_REMOTE_SHARD_READS,
           stats.VOLUME_SERVER_EC_REMOTE_SHARD_BYTES)
    assert ours - ref == {fam(m.name, m.kind, m.labelnames) for m in own}
    # every reference family of the slices ported so far is declared,
    # the ingest plane's and the residency ladder's included
    ported = ("volumeServer_ingest_", "volumeServer_ec_tier_",
              "volumeServer_device_", "request_stage_seconds", "critpath_")
    want = {f for f in ref if f[0].removeprefix("SeaweedFS_").startswith(ported)}
    assert len([f for f in want if "_ingest_" in f[0]]) == 8
    assert len([f for f in want if "_ec_tier_" in f[0]]) == 5
    assert want <= ours, want - ours
    # one bucket per batch width: the quantiles are exact
    h = stats.metrics.Histogram("t_hist", "t", buckets=(1, 2, 3))
    for v in (1, 2, 2, 3, 9):
        h.observe(v)
    assert h.cumulative() == [(1.0, 1), (2.0, 3), (3.0, 4), (float("inf"), 5)]
    assert h.count == 5 and h.sum == 17


# ---------------------------------------------------- dispatcher scenarios


def make(pkg, store, **kw):
    defaults = dict(max_inflight=1, max_wait_us=0)
    defaults.update(kw)
    m = PKGS[pkg]
    return m.EcReadDispatcher(store, lambda vid: None, m.ServingConfig(**defaults))


@pytest.mark.parametrize("pkg", list(PKGS))
def test_batched_results_identical_and_isolated(pkg):
    async def go():
        store = FakeStore()
        d = make(pkg, store, max_inflight=3, max_wait_us=100)
        nids = list(range(40)) + [666]
        got = await asyncio.gather(*(d.read(7, n, None) for n in nids),
                                   return_exceptions=True)
        for n, g in zip(nids, got):
            if n == 666:
                assert isinstance(g, KeyError)
            else:
                assert g == store.read_ec_needle(7, n)
        assert sum(len(b) for b in store.batch_calls) == len(nids)
        assert max(len(b) for b in store.batch_calls) > 1

    asyncio.run(go())


def _window(pkg, max_wait_us):
    async def go():
        gate = threading.Event()
        store = FakeStore(gate=gate)
        d = make(pkg, store, max_wait_us=max_wait_us)
        first = asyncio.ensure_future(d.read(1, 0, None))
        while not store.batch_calls:
            await asyncio.sleep(0.001)
        second = asyncio.ensure_future(d.read(1, 1, None))
        await asyncio.sleep(0.001)

        async def trickle():
            await asyncio.sleep(0.02)
            return await d.read(1, 2, None)

        third = asyncio.ensure_future(trickle())
        gate.set()
        await asyncio.gather(first, second, third)
        return store.batch_calls

    return asyncio.run(go())


def test_admission_window_same_batches():
    for wait in (100_000, 0):
        assert _window("torch", wait) == _window("jax", wait)
    assert _window("torch", 100_000)[1] == [1, 2]


def _backpressure(pkg):
    async def go():
        gate = threading.Event()
        store = FakeStore(gate=gate)
        d = make(pkg, store, max_batch=2, max_queue=2)
        first = asyncio.ensure_future(d.read(1, 0, None))
        while not store.batch_calls:
            await asyncio.sleep(0.001)
        rest = [asyncio.ensure_future(d.read(1, n, None)) for n in range(1, 8)]
        while len(store.native_calls) < 5:
            await asyncio.sleep(0.001)
        gate.set()
        results = await asyncio.gather(first, *rest)
        assert results == [store._value(1, n) for n in range(8)]
        return store.batch_calls, sorted(store.native_calls)

    return asyncio.run(go())


def test_tiny_queue_sheds_to_native_and_counts_the_fallback():
    f0 = stats.VOLUME_SERVER_EC_BATCH_FALLBACK.value
    n0 = stats.VOLUME_SERVER_EC_READ_ROUTE.labels(route="native").value
    got = _backpressure("torch")
    assert stats.VOLUME_SERVER_EC_BATCH_FALLBACK.value - f0 == 5
    assert stats.VOLUME_SERVER_EC_READ_ROUTE.labels(route="native").value - n0 == 5
    assert got == _backpressure("jax")
    assert len(got[1]) == 5


@pytest.mark.parametrize("pkg", list(PKGS))
def test_max_batch_and_pipelining(pkg):
    async def go():
        store = FakeStore(batch_sleep=0.05)
        d = make(pkg, store, max_inflight=3, max_batch=4)
        await asyncio.gather(*(d.read(1, n, None) for n in range(24)))
        assert max(len(b) for b in store.batch_calls) <= 4
        assert store.peak_active >= 2, store.batch_calls
        assert d.inflight == 0 and d.queue_depth == 0

    asyncio.run(go())


def test_bulk_tier_sheds_keeps_interactive():
    async def go(pkg):
        gate = threading.Event()
        store = FakeStore(gate=gate)
        d = make(pkg, store, max_batch=1, max_queue=64, qos_bulk_queue=1,
                 qos_interactive_queue=63)
        first = asyncio.ensure_future(d.read(1, 0, None))
        while not store.batch_calls:
            await asyncio.sleep(0.001)
        bulk = [asyncio.ensure_future(d.read(1, n, None, tier="bulk"))
                for n in range(1, 4)]
        inter = [asyncio.ensure_future(d.read(1, n, None)) for n in range(4, 7)]
        while len(store.native_calls) < 2:
            await asyncio.sleep(0.001)
        gate.set()
        await asyncio.gather(first, *bulk, *inter)
        return sorted(store.native_calls)

    assert asyncio.run(go("torch")) == asyncio.run(go("jax")) == [2, 3]


# ------------------------------------------------- dispatcher on the Store


@pytest.fixture(scope="module")
def degraded(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving_src")
    _, coded = build_dir(str(d))
    ref = jax_store.Store([jax_dl.DiskLocation(str(d))], ec_backend="numpy")
    want = {nid: ref.read_ec_needle(EC_VID, nid, cookie)
            for nid, cookie, _ in coded}
    ref.close()
    return str(d), coded, want


@pytest.fixture
def port_store(degraded):
    d, coded, want = degraded
    store = Store([DiskLocation(d)], ec_backend="torch",
                  ec_device_cache=cpu_cache())
    try:
        assert wait_resident(store, EC_VID)
        yield store, coded, want
    finally:
        store.close()


def _route_counts():
    return {r: stats.VOLUME_SERVER_EC_READ_ROUTE.labels(route=r).value
            for r in ("batched", "native")}


def test_64_concurrent_reads_batched_byte_equal(port_store):
    store, coded, want = port_store

    async def go():
        d = serving.EcReadDispatcher(store, lambda vid: None,
                                     serving.ServingConfig(max_inflight=2))
        b0 = stats.VOLUME_SERVER_EC_BATCH_SIZE.count
        r0 = _route_counts()
        reqs = [coded[i % len(coded)] for i in range(64)]
        got = await asyncio.gather(*(d.read(EC_VID, nid, cookie)
                                     for nid, cookie, _ in reqs))
        for (nid, cookie, data), n in zip(reqs, got):
            w = want[nid]
            assert (n.id, n.cookie, bytes(n.data)) == (w.id, w.cookie, w.data)
            assert bytes(n.data) == data
        batches = stats.VOLUME_SERVER_EC_BATCH_SIZE.count - b0
        routes = {k: v - r0[k] for k, v in _route_counts().items()}
        assert 1 <= batches < 64
        assert routes == {"batched": 64, "native": 0}
        # a bad cookie fails alone
        with pytest.raises(PermissionError):
            await d.read(EC_VID, coded[0][0], coded[0][1] ^ 1)

    asyncio.run(go())
    assert store.find_ec_volume(EC_VID).device_misses == 0


def test_unpinned_routes_native_and_disabled_uses_the_device(degraded, monkeypatch):
    d, coded, want = degraded
    nid, cookie, data = coded[0]
    calls = []
    real = rs_resident.reconstruct_intervals

    def counting(*a, **kw):
        calls.append(len(a[2]))
        return real(*a, **kw)

    monkeypatch.setattr(rs_resident, "reconstruct_intervals", counting)
    cold = Store([DiskLocation(d)], ec_backend="torch")  # no cache
    try:
        r0 = _route_counts()
        n = asyncio.run(serving.EcReadDispatcher(cold, lambda vid: None)
                        .read(EC_VID, nid, cookie))
        assert bytes(n.data) == data and not calls
        assert _route_counts()["native"] - r0["native"] == 1
    finally:
        cold.close()
    hot = Store([DiskLocation(d)], ec_backend="torch",
                ec_device_cache=cpu_cache())
    try:
        assert wait_resident(hot, EC_VID)
        disp = serving.EcReadDispatcher(
            hot, lambda vid: None, serving.ServingConfig(enabled=False))
        r0 = _route_counts()
        n = asyncio.run(disp.read(EC_VID, nid, cookie))
        assert bytes(n.data) == data
        assert calls  # disabled dispatcher: the per-read device branch
        assert _route_counts()["native"] - r0["native"] == 1
    finally:
        hot.close()


def test_spent_deadline_raises_at_admission(port_store):
    store, coded, _ = port_store

    async def go():
        d = serving.EcReadDispatcher(store, lambda vid: None)
        with faultpolicy.deadline_scope(-0.001):
            with pytest.raises(faultpolicy.DeadlineExceeded):
                await d.read(EC_VID, coded[0][0], coded[0][1])
        assert d.queue_depth == 0

    asyncio.run(go())


def test_two_lanes_return_uncorrupted_bodies(port_store):
    """Several lanes in flight at once, each batch on its own pipeline
    slot, zero-copy bodies: every body equals the written needle after
    all lanes finished (no view aliases a buffer a later batch reused)."""
    store, coded, _ = port_store
    store.ec_device_cache.pipeline.set_slots(2)

    async def go():
        d = serving.EcReadDispatcher(
            store, lambda vid: None,
            serving.ServingConfig(max_inflight=2, max_batch=8, max_wait_us=0))
        got = await asyncio.gather(*(d.read(EC_VID, nid, cookie)
                                     for _ in range(3)
                                     for nid, cookie, _ in coded))
        return got

    t0 = time.perf_counter()
    got = asyncio.run(go())
    assert time.perf_counter() - t0 < 60
    assert all(isinstance(n.data, memoryview) for n in got)
    want = [data for _ in range(3) for _, _, data in coded]
    assert [bytes(n.data) for n in got] == want
