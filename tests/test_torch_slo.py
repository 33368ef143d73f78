"""The port's SLO engine (seaweedfs_tpu_torch/obs/slo.py) held against the
JAX package's (seaweedfs_tpu/obs/slo.py): every case of
tests/test_slo_engine.py runs on both engines with the same stub
telemetry, repair plane and pinned clock, pulse by pulse; the verdict
lists of every evaluate() and the final status() must be equal, and the
reference test's own assertions hold on the port.  All of it is host
arithmetic: no tolerance.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

from seaweedfs_tpu.obs import slo as ref_slo
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu_torch.obs import slo as port_slo
from seaweedfs_tpu_torch.stats import metrics as port_metrics

N_BUCKETS = len(port_metrics.STAGE_SECONDS_BUCKETS) + 1
SIDES = (port_slo, ref_slo)


def test_ladder_and_stages_equal_the_reference():
    assert port_metrics.STAGE_SECONDS_BUCKETS == ref_metrics.STAGE_SECONDS_BUCKETS
    assert port_metrics.TRACE_STAGES == ref_metrics.TRACE_STAGES
    for name in ("P99_BUDGET_FRACTION", "TTH_BUDGET_FRACTION", "SLO_NAMES"):
        assert getattr(port_slo, name) == getattr(ref_slo, name), name


class StubTelemetry:
    """Just the three accessors the engine samples."""

    def __init__(self):
        self.buckets: dict[str, list[float]] = {}
        self.reads = 0
        self.sheds = 0
        self.breakers = 0

    def stage_buckets(self, stage):
        b = self.buckets.get(stage)
        return list(b) if b is not None else None

    def read_shed_totals(self):
        return self.reads, self.sheds

    def breakers_open(self):
        return self.breakers


class StubRepair:
    def __init__(self):
        self.unhealthy_s: float | None = None

    def unhealthy_for(self):
        return self.unhealthy_s


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class Side:
    """One package's engine over its own stubs, driven pulse by pulse;
    `log` holds every evaluate()'s verdicts."""

    def __init__(self, mod, cfg_kw, repair=False):
        self.mod = mod
        self.tel = StubTelemetry()
        self.rep = StubRepair() if repair else None
        self.clock = Clock()
        self.eng = mod.SloEngine(mod.SloConfig(**cfg_kw), self.tel,
                                 repair=self.rep, clock=self.clock)
        self.log: list = []

    def evaluate(self):
        fired = self.eng.evaluate()
        self.log.append(fired)
        return fired

    def pulse(self, good=0, bad=0, dt=5.0):
        """One pulse: `good` observations in the fastest bucket, `bad` in
        the +Inf overflow."""
        self.clock.t += dt
        b = self.tel.buckets.setdefault("batch_dispatch", [0.0] * N_BUCKETS)
        b[0] += good
        b[-1] += bad
        return self.evaluate()


def _both(cfg_kw, repair=False):
    return [Side(mod, cfg_kw, repair) for mod in SIDES]


def _equal(port: Side, ref: Side):
    assert port.log == ref.log
    assert port.eng.status() == ref.eng.status()
    assert port.eng.evaluations == ref.eng.evaluations


# ----------------------------------------------------------- BurnWindow


@pytest.mark.parametrize("samples,window,budget,now,expect", [
    ([], 60, 0.01, 100.0, 0.0),
    ([(95.0, 1, 100)], 60, 0.01, 100.0, 1.0),
    ([(95.0, 5, 100)], 60, 0.01, 100.0, 5.0),
    ([(30.0, 50, 100), (95.0, 0, 100)], 60, 0.01, 100.0, 0.0),
    ([(70.0, 1, 100), (95.0, 1, 100)], 60, 0.01, 100.0, 1.0),
])
def test_burn_window_table(samples, window, budget, now, expect):
    got = []
    for mod in SIDES:
        w = mod.BurnWindow(retain_seconds=600)
        for t, bad, total in samples:
            w.observe(t, bad, total)
        got.append((w.burn(window, budget, now),
                    w.fractions(window, now)))
    assert got[0] == got[1]
    assert got[0][0] == pytest.approx(expect)


def test_burn_window_retention_drops_old_samples():
    for mod in SIDES:
        w = mod.BurnWindow(retain_seconds=100)
        w.observe(0.0, 10, 10)
        w.observe(200.0, 0, 10)
        assert w.fractions(1000, 200.0) == (0.0, 10.0)


# -------------------------------------------------- fast trip / slow confirm


def _latency(fast=60.0, slow=600.0, target_ms=1.0):
    sides = _both(dict(read_p99_ms=target_ms, fast_window_seconds=fast,
                       slow_window_seconds=slow))
    for s in sides:
        s.tel.buckets["batch_dispatch"] = [0.0] * N_BUCKETS
    return sides


def test_fast_trip_needs_slow_confirm_then_fires():
    port, ref = _latency(fast=5.0, slow=15.0)
    for s in (port, ref):
        s.pulse()
        for _ in range(3):
            assert s.pulse(good=1000) == []
        fired = s.pulse(good=0, bad=100)
        spec = s.eng.specs[s.mod.READ_P99]
        assert [v["slo"] for v in fired] == [s.mod.READ_P99]
        assert spec.violating and spec.violations_total == 1
        assert spec.last_fast_burn >= spec.last_slow_burn > 1.0
        assert s.pulse(bad=50) == []
        assert spec.violations_total == 1
    _equal(port, ref)


def test_slow_window_dilution_blocks_the_fast_trip():
    port, ref = _latency(fast=5.0, slow=15.0)
    for s in (port, ref):
        s.pulse()
        for _ in range(2):
            s.pulse(good=10_000)
        assert s.pulse(good=0, bad=200) == []
        spec = s.eng.specs[s.mod.READ_P99]
        assert spec.last_fast_burn > 1.0 and spec.last_slow_burn < 1.0
        assert not spec.violating
    _equal(port, ref)


def test_recovery_resets_budget():
    port, ref = _latency(fast=5.0, slow=15.0)
    for s in (port, ref):
        s.pulse()
        s.pulse(bad=100)
        assert s.eng.status()["objectives"]["read_p99"][
            "budget_remaining"] == 0.0
        for _ in range(4):
            s.pulse(good=1000)
        doc = s.eng.status()["objectives"]["read_p99"]
        assert doc["budget_remaining"] == 1.0
        assert doc["fast_burn"] == 0.0 and doc["slow_burn"] == 0.0
        assert doc["violations_total"] == 1
    _equal(port, ref)


def test_overflow_folds_do_not_poison_p99():
    port, ref = _latency(fast=5.0, slow=50.0)
    for s in (port, ref):
        s.pulse()
        s.pulse(good=10, bad=10_000)
        p99, overflow = s.eng._window_p99()
        assert p99 is not None and math.isfinite(p99)
        assert overflow == 10_000
    assert port.eng._window_p99() == ref.eng._window_p99()
    assert port.eng._window_p99()[0] == pytest.approx(
        port_metrics.STAGE_SECONDS_BUCKETS[-1])
    _equal(port, ref)


def test_bad_from_buckets_partial_and_overflow():
    edges = port_metrics.STAGE_SECONDS_BUCKETS
    deltas = [0.0] * N_BUCKETS
    deltas[5], deltas[6], deltas[-1] = 100.0, 40.0, 7.0
    lo, hi = edges[3], edges[4]
    mid = lo + 0.25 * (hi - lo)
    deltas2 = [0.0] * N_BUCKETS
    deltas2[4] = 100.0
    cases = [(deltas, edges[5]), (deltas2, mid), ([0.0] * N_BUCKETS, 0.001)]
    got = [[mod._bad_from_buckets(d, t) for d, t in cases] for mod in SIDES]
    assert got[0] == got[1]
    assert got[0][0] == (pytest.approx(47.0), 147.0)
    assert got[0][1] == (pytest.approx(75.0), 100.0)
    assert got[0][2] == (0.0, 0.0)


@pytest.mark.parametrize("seed", range(6))
def test_bad_from_buckets_on_seeded_pulses(seed):
    rng = np.random.default_rng(seed)
    edges = port_metrics.STAGE_SECONDS_BUCKETS
    for _ in range(50):
        deltas = rng.integers(0, 50, N_BUCKETS).astype(float).tolist()
        target = float(rng.choice(list(edges) + [
            float(rng.uniform(0, edges[-1]))]))
        assert port_slo._bad_from_buckets(deltas, target) == \
            ref_slo._bad_from_buckets(deltas, target)


def test_counter_reset_clamps_negative_deltas():
    port, ref = _both(dict(error_rate_pct=1.0, fast_window_seconds=5,
                           slow_window_seconds=15))
    for s in (port, ref):
        s.tel.reads, s.tel.sheds = 1000, 500
        s.evaluate()
        s.tel.reads, s.tel.sheds = 100, 0
        s.clock.t += 5
        assert s.evaluate() == []
        assert s.eng.specs[s.mod.ERROR_RATE].last_fast_burn == 0.0
    _equal(port, ref)


def test_error_rate_and_breaker_and_tth_objectives():
    port, ref = _both(dict(error_rate_pct=1.0, breaker_open_pct=10.0,
                           time_to_healthy_seconds=30.0,
                           fast_window_seconds=5, slow_window_seconds=10),
                      repair=True)
    for s in (port, ref):
        s.evaluate()
        s.tel.reads, s.tel.sheds = 1000, 500
        s.tel.breakers = 2
        s.rep.unhealthy_s = 60.0
        s.clock.t += 5
        fired1 = {v["slo"] for v in s.evaluate()}
        s.tel.reads, s.tel.sheds = 2000, 1000
        s.clock.t += 5
        fired2 = {v["slo"] for v in s.evaluate()}
        assert {s.mod.ERROR_RATE, s.mod.BREAKER_OPEN,
                s.mod.TIME_TO_HEALTHY} <= fired1 | fired2
        for spec in s.eng.specs.values():
            assert spec.latency is False
    _equal(port, ref)


@pytest.mark.parametrize("cfg_kw", [
    dict(read_p99_ms=-1),
    dict(read_p99_ms=5, read_stage="batch_dispach"),
    dict(read_p99_ms=port_metrics.STAGE_SECONDS_BUCKETS[-1] * 1e3 + 1),
    dict(error_rate_pct=101),
    dict(fast_window_seconds=0),
    dict(fast_window_seconds=60, slow_window_seconds=30),
    dict(burn_threshold=0),
    dict(breaker_open_pct=-1),
    dict(time_to_healthy_seconds=-2),
])
def test_config_validation(cfg_kw):
    for mod in SIDES:
        with pytest.raises(ValueError):
            mod.SloConfig(**cfg_kw).validated()


def test_no_objectives_is_a_noop():
    port, ref = _both({})
    for s in (port, ref):
        assert s.eng.specs == {} and s.evaluate() == []
    _equal(port, ref)


@pytest.mark.parametrize("seed", [1, 7, 42, 2026])
def test_seeded_pulse_sequences_equal_the_reference(seed):
    """Seeded pulses through all four objectives at once: random good and
    slow observations across the ladder, reads and sheds (with counter
    resets), breakers, the repair plane's unhealthy time, and jittered
    pulse spacing; verdicts and status equal at every pulse."""
    rng = np.random.default_rng(seed)
    cfg = dict(read_p99_ms=float(rng.choice([0.5, 2.5, 10.0, 50.0])),
               error_rate_pct=2.0, breaker_open_pct=20.0,
               time_to_healthy_seconds=15.0, fast_window_seconds=3.0,
               slow_window_seconds=9.0,
               burn_threshold=float(rng.choice([0.5, 1.0, 2.0])))
    port, ref = _both(cfg, repair=True)
    for _ in range(80):
        dt = float(rng.uniform(0.5, 2.0))
        add = rng.integers(0, 40, N_BUCKETS) * (rng.random(N_BUCKETS) < 0.5)
        reads = int(rng.integers(0, 200))
        sheds = int(rng.integers(0, 10))
        reset = rng.random() < 0.05
        breakers = int(rng.integers(0, 3)) if rng.random() < 0.3 else 0
        unhealthy = (float(rng.uniform(0, 40))
                     if rng.random() < 0.4 else None)
        for s in (port, ref):
            s.clock.t += dt
            b = s.tel.buckets.setdefault("batch_dispatch", [0.0] * N_BUCKETS)
            for i, c in enumerate(add):
                b[i] += float(c)
            if reset:
                s.tel.reads, s.tel.sheds = 0, 0
            s.tel.reads += reads
            s.tel.sheds += sheds
            s.tel.breakers = breakers
            s.rep.unhealthy_s = unhealthy
            s.evaluate()
        assert port.log[-1] == ref.log[-1]
    _equal(port, ref)
    assert any(port.log), "the seeded sequence never fired"
