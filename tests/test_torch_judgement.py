"""Port parity of the judgement tier: ``repro_torch.obs.slo``,
``repro_torch.obs.regress`` and ``repro_torch.obs.health`` (copies of the
reference's ``repro.obs`` modules), on the CPU. The same metric traffic,
points and executor views go through both packages; every verdict, burn
rate, report and rendering must be equal.

Tolerance: equal (``==``), the same floats and strings. Virtual time only
(``FakeClock``): zero wall-clock sleeps.
"""

import dataclasses
import json
import pathlib

import pytest

from repro import obs as jobs
from repro.obs import health as jhealth
from repro.obs import regress as jregress
from repro.serve.faults import FakeClock as JFakeClock
from repro_torch import obs
from repro_torch.obs import health, regress
from repro_torch.serve.faults import FakeClock

BENCH = pathlib.Path(__file__).resolve().parents[1] / "BENCH_denoise.json"
TICK_S = 0.5


# ---------------------------------------------------------------------------
# slo: the same traffic gives the same verdicts, burn rates and instants.
# ---------------------------------------------------------------------------


def _specs(mod):
    """The same spec list, built from either package."""
    return [
        mod.SloSpec(name="miss[s0]", kind="deadline_miss_rate", target=0.05, window_s=5.0,
                    bad_metric="serve.deadline_misses", total_metric="serve.latency_s",
                    labels={"session": "s0"}),
        mod.SloSpec(name="drops", kind="frame_drop_rate", target=0.02, window_s=5.0,
                    long_window_s=20.0, bad_metric="serve.discarded",
                    total_metric="serve.latency_s", aggregate=True),
        mod.SloSpec(name="p99", kind="latency_percentile", target=0.05, window_s=5.0,
                    metric="serve.latency_s", percentile=99.0, aggregate=True, budget=0.2),
        mod.SloSpec(name="recovery", kind="recovery_time", target=3.0, window_s=5.0,
                    metric="fleet.recovery_s", percentile=100.0, aggregate=True),
    ] + mod.default_serve_slos(window_s=5.0, sessions=("s0", "s1"))[:3]


def _traffic(tick: int) -> dict:
    """Deterministic load: a miss storm in ticks 10-19, slow groups in
    ticks 25-34, drops at ticks 30-31, a recovery at tick 40."""
    return {
        "groups": {"s0": 8, "s1": 4 if tick % 3 else 0},
        "misses": 6 if 10 <= tick < 20 else (1 if tick % 7 == 0 else 0),
        "latency": 0.2 if 25 <= tick < 35 else 0.01 + 0.001 * (tick % 5),
        "discarded": 3 if tick in (30, 31) else 0,
        "recovery": 2.5 + tick / 100 if tick == 40 else None,
    }


def _drive(mod, clock, ticks=60):
    reg = mod.MetricsRegistry()
    tracer = mod.Tracer(clock)
    eng = mod.SloEngine(_specs(mod), reg, tracer=tracer, clock=clock, eval_every_s=1.0)
    rows = []
    for t in range(ticks):
        clock.advance(TICK_S)
        load = _traffic(t)
        for session, n in load["groups"].items():
            hist = reg.histogram("serve.latency_s", session=session)
            for _ in range(n):
                hist.observe(load["latency"])
        if load["misses"]:
            reg.counter("serve.deadline_misses", session="s0").inc(load["misses"])
        if load["discarded"]:
            reg.counter("serve.discarded", session="s1").inc(load["discarded"])
        if load["recovery"] is not None:
            reg.histogram("fleet.recovery_s").observe(load["recovery"])
        verdicts = eng.maybe_evaluate()
        if verdicts is not None:
            rows.append([v.to_dict() for v in verdicts])
    rows.append(eng.verdicts_dict())
    rows.append([v.to_dict() for v in eng.evaluate()])
    instants = [(e["name"], e.get("args")) for e in tracer.events()]
    return rows, instants, eng.evaluations


def test_slo_engine_same_verdicts_and_burn_rates():
    got = _drive(obs, FakeClock())
    want = _drive(jobs, JFakeClock())
    assert got == want
    rows, instants, evaluations = got
    statuses = {v["status"] for row in rows for v in row}
    assert {"ok", "breach", "no-data"} <= statuses  # the script reaches each state
    assert {"slo_breach", "slo_recovered"} <= {name for name, _ in instants}
    assert any(v["burn_short"] > 1.0 for row in rows for v in row)
    assert evaluations >= 25


def test_slo_spec_validation_same_errors():
    bad = [
        dict(name="x", kind="nope", target=0.1, window_s=1.0),
        dict(name="", kind="deadline_miss_rate", target=0.1, window_s=1.0, bad_metric="a",
             total_metric="b"),
        dict(name="x", kind="deadline_miss_rate", target=0.1, window_s=0.0, bad_metric="a",
             total_metric="b"),
        dict(name="x", kind="deadline_miss_rate", target=1.5, window_s=1.0, bad_metric="a",
             total_metric="b"),
        dict(name="x", kind="frame_drop_rate", target=0.1, window_s=1.0),
        dict(name="x", kind="latency_percentile", target=0.1, window_s=1.0),
        dict(name="x", kind="latency_percentile", target=0.1, window_s=1.0, metric="m",
             percentile=101.0),
        dict(name="x", kind="recovery_time", target=1.0, window_s=1.0, metric="m", budget=0.0),
    ]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            jobs.SloSpec(**kw)
        with pytest.raises(ValueError) as got:
            obs.SloSpec(**kw)
        assert str(got.value) == str(want.value)
    spec = _specs(obs)[0]
    with pytest.raises(ValueError, match="duplicate"):
        obs.SloEngine([spec, spec], obs.MetricsRegistry())
    assert obs.SLO_KINDS == jobs.SLO_KINDS


def test_default_serve_slos_equal():
    for kw in (dict(), dict(window_s=30.0, sessions=("a", "b"), p99_latency_s=0.1)):
        got = [dataclasses.asdict(s) for s in obs.default_serve_slos(**kw)]
        want = [dataclasses.asdict(s) for s in jobs.default_serve_slos(**kw)]
        assert got == want


# ---------------------------------------------------------------------------
# regress: the same points give the same report.
# ---------------------------------------------------------------------------


def _pts(values, name="fam", kind="speedup", field="speedup", **extra):
    return [{"name": name, "kind": kind, field: v, "run_seq": i + 1, **extra}
            for i, v in enumerate(values)]


SYNTHETIC = {
    "regressed": _pts([2.0, 2.05, 1.95, 2.02, 1.2]),
    "improved": _pts([2.0, 2.05, 1.95, 2.02, 2.8]),
    "ok": _pts([2.0, 2.05, 1.95, 2.02, 1.9]),
    "short": _pts([2.0, 1.0]),
    "unguarded": _pts([1.0, 2.0, 3.0], kind="mystery"),
    "snr": _pts([16.0, 16.1, 15.9, 16.05, 14.9], kind="snr", field="snr_db"),
    "mixed": _pts([2.0, 2.1, 1.9, 2.0, 1.5], name="a") + _pts([5.0, 5.1], name="b")
    + [{"name": "legacy", "kind": "speedup", "speedup": 1.0}, "not a dict"],
    "unordered": list(reversed(_pts([3.0, 3.1, 2.9, 3.05, 2.0]))),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_regress_synthetic_histories_equal(case):
    pts = [p for p in SYNTHETIC[case] if isinstance(p, dict)]
    for kw in (dict(), dict(min_history=2)):
        got = regress.analyze(pts, **kw)
        assert got == jregress.analyze(pts, **kw)
        for verbose in (False, True):
            assert regress.render_report(got, verbose=verbose) == jregress.render_report(
                got, verbose=verbose)
    for p in pts:
        assert regress.family_key(p) == jregress.family_key(p)


def test_regress_committed_bench_file_equal():
    pts = regress.load_points(str(BENCH))
    assert pts == jregress.load_points(str(BENCH)) and len(pts) > 100
    got = regress.analyze(pts)
    assert got == jregress.analyze(pts)
    assert regress.render_report(got, verbose=True) == jregress.render_report(got, verbose=True)
    assert json.dumps(got, sort_keys=True) == json.dumps(jregress.analyze(pts), sort_keys=True)


def test_regress_rules_equal():
    assert {k: dataclasses.asdict(r) for k, r in regress.KIND_RULES.items()} == {
        k: dataclasses.asdict(r) for k, r in jregress.KIND_RULES.items()}
    for kw in (dict(), dict(rel_tol=0.1, abs_tol=0.5)):
        with pytest.raises(ValueError) as want:
            jregress.Rule("x", "higher", **kw)
        with pytest.raises(ValueError) as got:
            regress.Rule("x", "higher", **kw)
        assert str(got.value) == str(want.value)
    rules = {"speedup": regress.Rule("speedup", "lower", abs_tol=0.2)}
    jrules = {"speedup": jregress.Rule("speedup", "lower", abs_tol=0.2)}
    pts = SYNTHETIC["regressed"]
    assert regress.analyze(pts, rules=rules) == jregress.analyze(pts, rules=jrules)


# ---------------------------------------------------------------------------
# health: capacity reference, classification, rollup and renderings.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ["alg1", "alg2", "alg3"])
@pytest.mark.parametrize(
    "shape",
    [dict(height=80, width=256, num_groups=8, frames_per_group=1000),
     dict(height=16, width=64, num_groups=6, frames_per_group=20, inter_frame_us=40.0)],
    ids=["paper", "small"],
)
def test_capacity_reference_equal(shape, algorithm):
    assert health.capacity_reference(algorithm=algorithm, **shape) == (
        jhealth.capacity_reference(algorithm=algorithm, **shape))


def test_classify_heartbeat_equal():
    views = dict(evicted={"ex1"}, dead={"ex2"}, beats={"ex0": 0.3, "ex2": 9.0, "ex4": 1.0},
                 drained={"ex4"})
    for name in ("ex0", "ex1", "ex2", "ex3", "ex4"):
        assert health.classify_heartbeat(name, **views) == jhealth.classify_heartbeat(name, **views)
    assert health.HEARTBEAT_STATES == jhealth.HEARTBEAT_STATES


def _executor(mod, name, **kw):
    base = dict(name=name, alive=True, heartbeat="healthy", last_beat_age_s=0.25, sessions=2,
                queue_depth=0, cohort_steps=12, step_ewma_s=0.004, straggler=False,
                headroom=14.25, capacity=mod.capacity_reference(
                    height=16, width=64, num_groups=6, frames_per_group=20))
    base.update(kw)
    return mod.ExecutorHealth(**base)


ROLLUPS = {
    "ok": ([dict()], [dict(status="ok", kind="deadline_miss_rate", budget_remaining=0.9)]),
    "straggler": ([dict(straggler=True)], []),
    "unknown": ([dict(heartbeat="unknown", last_beat_age_s=None, headroom=None)], []),
    "missed": ([dict(), dict(heartbeat="missed", last_beat_age_s=61.0)], []),
    "dead": ([dict(alive=False, heartbeat="healthy")], []),
    "evicted": ([dict(alive=False, heartbeat="evicted")], []),
    "breach": ([dict()], [dict(status="breach", kind="latency_percentile")]),
    "no-data": ([dict()], [dict(status="no-data", kind="deadline_miss_rate")]),
    "no-recovery-data": ([dict()], [dict(status="no-data", kind="recovery_time")]),
    "low-budget": ([dict()], [dict(status="ok", kind="frame_drop_rate", budget_remaining=0.1)]),
}


@pytest.mark.parametrize("case", sorted(ROLLUPS))
def test_rollup_and_report_renderings_equal(case):
    ex_kw, slos = ROLLUPS[case]
    exs = [_executor(health, f"ex{i}", **kw) for i, kw in enumerate(ex_kw)]
    jexs = [_executor(jhealth, f"ex{i}", **kw) for i, kw in enumerate(ex_kw)]
    slos = [dict(dict(spec=f"slo{i}", ok=v["status"] == "ok", value=0.0125 * i, target=0.05,
                      budget_remaining=0.75), **v) for i, v in enumerate(slos)]
    status = health.rollup_status(exs, slos)
    assert status == jhealth.rollup_status(jexs, slos)
    extra = dict(sessions=[{"name": "s0", "ring_occupancy": 1.5, "groups": 3}],
                 slos=slos, fleet={"events": ["kill ex1 @ step 3"], "evicted": ["ex1"]},
                 autoscale={"pool_size": 2, "target_executors": 3, "degradation_level": 1}
                 if case == "ok" else {})
    rep = health.HealthReport(at=12.5, status=status, executors=exs, **extra)
    jrep = jhealth.HealthReport(at=12.5, status=status, executors=jexs, **extra)
    assert rep.to_dict() == jrep.to_dict()
    assert rep.prometheus_text() == jrep.prometheus_text()
    assert rep.render() == jrep.render()
