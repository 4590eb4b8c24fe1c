"""Port parity of the trace-driven load generator
(``repro_torch.serve.loadgen``) against the reference's
(``repro.serve.loadgen``): the counterparts of the load-generator cases of
``tests/test_autoscale.py``.

Every schedule draws from an explicit ``numpy.random.Generator``: for the
same seed and parameters both packages give the same floats, bit for bit
(compared with ``==`` on Python floats), the same session lengths and the
same ``ArrivalEvent`` lists. ``replay_trace`` on a ``FakeClock`` submits at
the same virtual instants in both and sleeps for no time at all.
"""

import dataclasses
import time

import numpy as np
import pytest

import repro.serve as J
import repro_torch.serve as T
from repro.core.denoise import DenoiseConfig as JConfig
from repro_torch.core.denoise import DenoiseConfig

CFG = dict(num_groups=4, frames_per_group=8, height=8, width=32, backend="xla")


def _both(fn, *args, seed: int, **kw):
    """``fn`` of each package on a fresh generator from ``seed``."""
    return tuple(getattr(pkg, fn)(*args, rng=np.random.default_rng(seed), **kw)
                 for pkg in (J, T))


def _bits(xs):
    return [float(x).hex() for x in xs]


@pytest.mark.parametrize("rate,duration,seed", [(5.0, 10.0, 3), (0.5, 60.0, 1), (40.0, 2.5, 7),
                                                (0.0, 10.0, 3)])
def test_poisson_schedule_bitwise(rate, duration, seed):
    ref, port = _both("poisson_schedule", rate, duration, seed=seed)
    assert _bits(port) == _bits(ref)
    assert port == sorted(port) and all(0 <= t < duration for t in port)


@pytest.mark.parametrize("kw", [dict(), dict(period_s=7.5, floor=0.3), dict(floor=0.0),
                                dict(floor=1.0)], ids=str)
def test_diurnal_schedule_bitwise(kw):
    ref, port = _both("diurnal_schedule", 20.0, 30.0, seed=9, **kw)
    assert _bits(port) == _bits(ref)
    assert len(port) <= len(T.poisson_schedule(20.0, 30.0, rng=np.random.default_rng(9)))


@pytest.mark.parametrize("kw", [
    dict(burst_at_s=5.0, burst_s=2.0, duration_s=10.0),
    dict(burst_at_s=9.0, burst_s=5.0, duration_s=10.0),   # the burst runs past the end
    dict(burst_at_s=12.0, burst_s=1.0, duration_s=10.0),  # after the end: no burst
], ids=str)
def test_flash_crowd_schedule_bitwise(kw):
    ref, port = _both("flash_crowd_schedule", 1.0, 20.0, seed=4, **kw)
    assert _bits(port) == _bits(ref)
    assert port == sorted(port)


@pytest.mark.parametrize("kw", [dict(min_groups=2, max_groups=32), dict(alpha=0.7),
                                dict(min_groups=4, max_groups=4)], ids=str)
def test_heavy_tail_groups_equal(kw):
    ref, port = _both("heavy_tail_groups", 500, seed=11, **kw)
    assert port == ref
    assert all(isinstance(n, int) for n in port)


@pytest.mark.parametrize("fn,args,kw,match", [
    ("poisson_schedule", (-1.0, 1.0), {}, "rate_hz"),
    ("poisson_schedule", (1.0, 0.0), {}, "duration_s"),
    ("diurnal_schedule", (1.0, 1.0), dict(floor=1.5), "floor"),
    ("diurnal_schedule", (1.0, 1.0), dict(period_s=0.0), "period_s"),
    ("flash_crowd_schedule", (1.0, 2.0), dict(burst_at_s=-1.0, burst_s=1.0, duration_s=5.0),
     "burst"),
    ("heavy_tail_groups", (1,), dict(min_groups=0), "min_groups"),
    ("heavy_tail_groups", (1,), dict(alpha=0.0), "alpha"),
])
def test_validation_errors_match_reference(fn, args, kw, match):
    errors = []
    for pkg in (J, T):
        with pytest.raises(ValueError, match=match) as err:
            getattr(pkg, fn)(*args, rng=np.random.default_rng(0), **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def _profiles(pkg, config):
    cfg = config(**CFG)
    return [pkg.TenantProfile("gold", cfg, weight=1.0, priority=10),
            pkg.TenantProfile("bulk", dataclasses.replace(cfg, filter_name="temporal_median"),
                              weight=3.0, priority=0)]


@pytest.mark.parametrize("kw", [dict(), dict(min_groups=4, max_groups=4, name_prefix="fc"),
                                dict(alpha=0.9, max_groups=16)], ids=str)
def test_build_trace_equal_arrival_events(kw):
    times = T.poisson_schedule(8.0, 10.0, rng=np.random.default_rng(5))
    ref = J.build_trace(_profiles(J, JConfig), times, rng=np.random.default_rng(6), **kw)
    port = T.build_trace(_profiles(T, DenoiseConfig), times, rng=np.random.default_rng(6),
                         **kw)
    assert [dataclasses.asdict(e) for e in port] == [dataclasses.asdict(e) for e in ref]
    assert _bits(e.t for e in port) == _bits(sorted(times))
    assert {e.profile for e in port} == {"gold", "bulk"}
    assert all(e.priority == 10 for e in port if e.profile == "gold")
    with pytest.raises(ValueError, match="TenantProfile"):
        T.build_trace([], times, rng=np.random.default_rng(0))
    with pytest.raises(ValueError, match="weight"):
        T.TenantProfile("bad", DenoiseConfig(**CFG), weight=0.0)


def test_tenant_profile_carries_the_ports_config():
    cfg = DenoiseConfig(**CFG)
    prof = T.TenantProfile("t", cfg, weight=2.0, priority=3)
    assert prof.config is cfg
    assert dataclasses.asdict(prof.config) == dataclasses.asdict(JConfig(**CFG))


def test_replay_trace_same_virtual_instants_and_no_sleep(monkeypatch):
    arrivals = T.flash_crowd_schedule(0.5, 2.5, burst_at_s=3.0, burst_s=2.0, duration_s=6.0,
                                      rng=np.random.default_rng(17))
    seen = {}
    for pkg, config in ((J, JConfig), (T, DenoiseConfig)):
        trace = pkg.build_trace([pkg.TenantProfile("t", config(**CFG))], arrivals,
                                rng=np.random.default_rng(0))
        clock = pkg.FakeClock()
        submits, ticks = [], []
        slept = []
        monkeypatch.setattr(time, "sleep", lambda s: slept.append(s))
        results = pkg.replay_trace(
            trace, clock=clock,
            submit=lambda ev: submits.append((clock.now(), ev.session)) or len(submits),
            on_tick=lambda now: ticks.append(now),
        )
        monkeypatch.undo()
        assert slept == []  # a FakeClock advances: no wall-clock sleep
        assert results == list(range(1, len(trace) + 1))
        assert [t for t, _ in submits] == ticks
        seen[pkg] = (_bits(t for t, _ in submits), [s for _, s in submits], clock.now())
    assert seen[T] == seen[J]
    assert seen[T][2] == pytest.approx(max(arrivals))


def test_replay_trace_sleeps_the_gap_on_a_clock_without_advance(monkeypatch):
    class Wall:  # a clock with no ``advance``: the replay sleeps the gaps
        def __init__(self):
            self.t = 0.0

        def now(self):
            return self.t

    slept = {}
    for pkg, config in ((J, JConfig), (T, DenoiseConfig)):
        clock = Wall()
        naps = []

        def nap(s, clock=clock, naps=naps):
            naps.append(s)
            clock.t += s

        monkeypatch.setattr(time, "sleep", nap)
        trace = pkg.build_trace([pkg.TenantProfile("t", config(**CFG))], [0.5, 1.25, 4.0],
                                rng=np.random.default_rng(0))
        pkg.replay_trace(trace, clock=clock, submit=lambda ev: None)
        monkeypatch.undo()
        slept[pkg] = _bits(naps)
    assert slept[T] == slept[J] == _bits([0.5, 0.75, 2.75])
