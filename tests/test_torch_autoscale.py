"""Port parity of the SLO-driven autoscaler (``repro_torch.serve.autoscale``)
against the reference's (``repro.serve.autoscale``): the counterparts of
the autoscaler cases of ``tests/test_autoscale.py``.

Every scenario runs in both packages, on ``device="cpu"`` for the port and
``backend="xla"`` in both (as the reference's own autoscale tests run),
under the same ``FakeClock`` script, on the same numpy frames made by
``PrismSource`` from a seed. The ``Autoscaler``'s decisions
(``AutoscaleDecision.to_dict()``) and states (``Autoscaler.state()``), the
fleet's events and timeline kinds, and the admit/reject outcome of every
arrival equal the reference's, in order. Every surviving session's output
is bitwise equal to the reference fleet's output (a host copy) and to its
own undisturbed port ``run_pipelined`` on the same chunks. No wall-clock
sleep decides an outcome: sessions are held in flight by gated sources, and
every real wait is a bounded event wait.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

import repro.serve as J
import repro_torch.serve as T
from repro import obs as jobs
from repro.core.denoise import DenoiseConfig as JConfig
from repro_torch import obs as tobs
from repro_torch.core.denoise import DenoiseConfig
from repro_torch.core.streaming import run_pipelined
from repro_torch.data.prism import PrismSource

WAIT = 60  # every real wait is bounded; a CPU scenario takes well under that


@dataclasses.dataclass(frozen=True)
class Pkg:
    """The names a scenario takes from one package."""

    name: str
    serve: object
    obs: object
    config: type
    fleet_kw: dict

    def cfg(self, cfg: DenoiseConfig):
        return self.config(**dataclasses.asdict(cfg))


REF = Pkg("ref", J, jobs, JConfig, {})
PORT = Pkg("port", T, tobs, DenoiseConfig, {"device": "cpu"})


def _cfg(**kw):
    return DenoiseConfig(**{**dict(num_groups=4, frames_per_group=8, height=8, width=32,
                                   backend="xla"), **kw})


@pytest.fixture(scope="module")
def cfg():
    return _cfg()


@pytest.fixture(scope="module")
def chunks(cfg):
    return list(PrismSource(cfg).groups())


@pytest.fixture(scope="module")
def undisturbed(cfg, chunks):
    """The port's own undisturbed run of the chunks every session folds."""
    return run_pipelined(cfg, iter(chunks), device="cpu")[0].numpy()


class Gate:
    """Source yielding ``preload`` chunks eagerly, the rest only after
    :meth:`release`: keeps a session in flight deterministically."""

    def __init__(self, chunks, preload=0):
        self.chunks = list(chunks)
        self.preload = preload
        self.open = threading.Event()

    def release(self):
        self.open.set()

    def __iter__(self):
        for i, c in enumerate(self.chunks):
            if i >= self.preload and not self.open.is_set():
                assert self.open.wait(WAIT), "gate never released"
            yield c


@pytest.fixture
def fleets():
    """``make(pkg, **kw)`` builds a ``FleetScheduler`` of ``pkg``; every
    fleet built is shut down, even when the test fails."""
    created = []

    def make(pkg, *, elastic=True, **kw):
        if elastic:
            kw = dict(dict(max_waiting=64, coalesce_ms=0.0, slo_eval_every_s=1e9,
                           slos=[pkg.serve.admission_pressure_slo(budget=0.25, window_s=2.0)]),
                      **kw)
        fleet = pkg.serve.FleetScheduler(**{**pkg.fleet_kw, **kw})
        created.append(fleet)
        return fleet

    yield make
    for fleet in created:
        fleet.shutdown(wait=False)


def _np(out):
    return out.numpy() if hasattr(out, "numpy") and not isinstance(out, np.ndarray) \
        else np.asarray(out)


def _both(scenario, *args, **kw):
    """Run ``scenario(pkg, ...)`` for the reference, then the port."""
    return scenario(REF, *args, **kw), scenario(PORT, *args, **kw)


def _kinds(fleet):
    return [kind for kind, _, _ in fleet.timeline]


def _wait_steps(fleet, name, steps):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        rows = fleet.health(evaluate_slos=False).sessions
        if any(r["name"] == name and r["steps"] >= steps for r in rows):
            return
        time.sleep(0.005)
    raise AssertionError(f"{name} never folded {steps} groups")


# ---------------------------------------------------------------------------
# Unit surface: spec helper, ctor validation, ladder helpers.
# ---------------------------------------------------------------------------


def test_admission_pressure_slo_matches_reference():
    for kw in (dict(), dict(budget=0.25, window_s=2.0), dict(budget=0.5, name="ap")):
        spec = T.admission_pressure_slo(**kw)
        assert dataclasses.asdict(spec) == dataclasses.asdict(J.admission_pressure_slo(**kw))
    spec = T.admission_pressure_slo(budget=0.25, window_s=2.0)
    assert spec.kind == "admission_reject_rate" and spec.target == 0.25
    assert spec.window_s == spec.effective_long_window_s == 2.0
    assert spec.effective_budget_window_s == 2.0
    assert (spec.bad_metric, spec.total_metric) == ("serve.admission_rejected",
                                                   "serve.submit_attempts")


def test_autoscaler_requires_slo_engine_and_valid_band(fleets):
    def run(pkg):
        errors = []
        plain = fleets(pkg, elastic=False, clock=pkg.serve.FakeClock(), max_executors=2,
                       max_sessions=4)
        fleet = fleets(pkg, clock=pkg.serve.FakeClock(), max_executors=2, max_sessions=4)
        for target, kw in ((plain, {}), (fleet, dict(min_executors=0)),
                           (fleet, dict(min_executors=2, max_executors=1)),
                           (fleet, dict(breach_streak=0))):
            with pytest.raises(ValueError) as err:
                pkg.serve.Autoscaler(target, **kw)
            errors.append(str(err.value))
        return errors

    ref, port = _both(run)
    assert port == ref
    assert [m in e for m, e in zip(("SLO", "min_executors", "max_executors", "streak"), port)] \
        == [True] * 4


def test_autoscaler_initial_executors_shrinks_admission_cap(fleets):
    def run(pkg):
        fleet = fleets(pkg, clock=pkg.serve.FakeClock(), max_executors=3, max_sessions=6)
        before = fleet.target_executors
        scaler = pkg.serve.Autoscaler(fleet, initial_executors=1)
        return before, fleet.target_executors, fleet.max_sessions, scaler.max_executors, \
            scaler.state()

    ref, port = _both(run)
    assert port == ref
    assert port[:4] == (3, 1, 2, 3)


def test_ladder_helpers_widen_with_level(fleets, cfg):
    def run(pkg):
        fleet = fleets(pkg, clock=pkg.serve.FakeClock(), max_executors=1, max_sessions=2)
        scaler = pkg.serve.Autoscaler(fleet, max_executors=1)
        c = pkg.cfg(cfg)
        out = []
        for level in (0, 1, 2, 3, 0):
            fleet.set_degradation(level)
            pol = scaler.backoff_policy()
            got = scaler.admission_config(c)
            pallas = scaler.admission_config(dataclasses.replace(c, backend="pallas"))
            out.append(((pol.retries, pol.base_s, pol.max_s, pol.jitter), got is c,
                        dataclasses.asdict(got), pallas.backend))
        return out

    ref, port = _both(run)
    assert port == ref
    assert port[0][0][:2] == (5, 0.05) and port[0][1]
    assert port[2][2]["stream_dtype"] == "u8" and port[2][2]["overflow_policy"] == "drop_oldest"
    assert port[2][3] == "xla" and port[4][1]
    assert T.DEGRADE_LEVELS == J.DEGRADE_LEVELS == ("normal", "backoff", "downshift", "shed")


# ---------------------------------------------------------------------------
# Scenario 1: flash crowd -> slo_breach -> scale-up -> breach clears.
# ---------------------------------------------------------------------------


def _traced(pkg, clock, body):
    """Run ``body()`` with ``pkg``'s tracer on the fake clock; returns
    ``body``'s result and the validated trace's instant names."""
    tr = pkg.obs.get_tracer()
    was_enabled, old_clock = tr.enabled, tr.clock
    tr.clear()
    pkg.obs.configure(enabled=True, clock=clock)
    try:
        out = body()
        doc = tr.export_chrome()
    finally:
        pkg.obs.configure(enabled=was_enabled, clock=old_clock)
        tr.clear()
    events = pkg.obs.validate_chrome_trace(doc)
    return out, [e for e in events if e.get("ph") == "i"]


def test_flash_crowd_breach_scale_up_and_recovery(fleets, cfg, chunks, undisturbed):
    def run(pkg):
        clock = pkg.serve.FakeClock()
        c = pkg.cfg(cfg)
        Session = pkg.serve.Session

        def body():
            fleet = fleets(pkg, clock=clock, max_executors=3, max_sessions=6)
            scaler = pkg.serve.Autoscaler(fleet, min_executors=1, initial_executors=1,
                                          breach_streak=1, clear_streak=1,
                                          cooldown_down_s=1e9)
            decisions = [scaler.evaluate()]  # baseline snapshot at t=0
            caps = [fleet.max_sessions]
            gates = [Gate(chunks) for _ in range(2)]
            handles = [fleet.submit(Session(config=c, source=g, name=f"base{i}"))
                       for i, g in enumerate(gates)]
            rejected = 0
            for i in range(4):  # the crowd: the pool is full, every arrival bounces
                with pytest.raises(pkg.serve.AdmissionError):
                    fleet.submit(Session(config=c, source=iter(chunks), name=f"burst{i}"))
                rejected += 1
            clock.advance(2.0)
            decisions.append(scaler.evaluate())
            states = [scaler.state()]
            caps.append(fleet.max_sessions)
            post = [fleet.submit(Session(config=c, source=iter(chunks), name=f"post{i}"))
                    for i in range(2)]
            for g in gates:
                g.release()
            outs = [h.result(timeout=WAIT) for h in handles + post]
            for i in range(6):  # clean windows: the verdict clears
                clock.advance(2.0)
                outs.append(fleet.submit(Session(config=c, source=iter(chunks),
                                                 name=f"clean{i}")).result(timeout=WAIT))
                decisions.append(scaler.evaluate())
                states.append(scaler.state())
                if not decisions[-1].breached:
                    break
            fleet.shutdown()
            return ([d.to_dict() for d in decisions], states, caps, rejected, outs,
                    list(fleet.events), _kinds(fleet))

        return _traced(pkg, clock, body)

    (jres, jinst), (res, inst) = _both(run)
    decisions, states, caps, rejected, outs, events, kinds = res
    assert decisions == jres[0] and states == jres[1]
    assert (caps, rejected, events, kinds) == tuple(jres[2:4]) + tuple(jres[5:])
    assert [d["action"] for d in decisions[:2]] == ["hold", "scale-up"]
    assert decisions[1]["breached"] and decisions[1]["target_executors"] == 2
    assert caps == [2, 4] and not decisions[-1]["breached"]
    for (out, rep), (jout, _) in zip(outs, jres[4]):
        assert rep.groups == cfg.num_groups and rep.drops == 0
        np.testing.assert_array_equal(_np(out), np.asarray(jout))
        np.testing.assert_array_equal(_np(out), undisturbed)
    control = ("slo_breach", "fleet.scale_up", "slo_recovered", "autoscale.decision")
    names = [e["name"] for e in inst if e["name"] in control]
    # the control path's instants, in order (the executors' own come on
    # their threads, in an order of their own)
    assert names == [e["name"] for e in jinst if e["name"] in control]
    for needed in ("slo_breach", "fleet.scale_up", "slo_recovered", "autoscale.decision"):
        assert needed in names, (needed, sorted(set(names)))
    assert names.index("slo_breach") < names.index("fleet.scale_up")


def test_scale_up_replayed_from_loadgen_trace_matches_reference(fleets, cfg, chunks,
                                                                 undisturbed):
    """The same seeded flash-crowd trace, replayed on a FakeClock with an
    ``evaluate`` per arrival: identical admit/reject outcomes, decisions,
    states and scale-up marks in both packages, and in two port runs."""

    def run(pkg):
        clock = pkg.serve.FakeClock()
        fleet = fleets(pkg, clock=clock, max_executors=3, max_sessions=6)
        scaler = pkg.serve.Autoscaler(fleet, initial_executors=1, breach_streak=1,
                                      clear_streak=1, cooldown_down_s=1e9)
        rng = np.random.default_rng(17)
        arrivals = pkg.serve.flash_crowd_schedule(0.5, 2.5, burst_at_s=3.0, burst_s=2.0,
                                                  duration_s=6.0, rng=rng)
        trace = pkg.serve.build_trace([pkg.serve.TenantProfile("hold", pkg.cfg(cfg))],
                                      arrivals, rng=rng, min_groups=4, max_groups=4)
        gates, handles, outcome, decisions, states = [], [], [], [], []

        def submit(ev):
            g = Gate(chunks)
            try:
                h = fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=g,
                                                   name=ev.session, priority=ev.priority))
            except pkg.serve.AdmissionError:
                outcome.append((ev.session, "rejected"))
                return False
            gates.append(g)
            handles.append(h)
            outcome.append((ev.session, "admitted"))
            return True

        def tick(now):
            decisions.append(scaler.evaluate().to_dict())
            states.append(scaler.state())

        tick(clock.now())
        pkg.serve.replay_trace(trace, clock=clock, submit=submit, on_tick=tick)
        for g in gates:
            g.release()
        outs = [h.result(timeout=WAIT) for h in handles]
        marks = [(k, round(t, 6)) for k, _, t in fleet.timeline if k == "scale-up"]
        fleet.shutdown()
        return outcome, decisions, states, marks, fleet.autoscale_state(), outs

    ref, port = _both(run)
    again = run(PORT)
    assert port[:5] == ref[:5] == again[:5]
    assert port[4]["scale_ups"] >= 1  # the crowd forced at least one scale-up
    assert "scale-up" in [d["action"] for d in port[1]]
    for (out, rep), (jout, jrep) in zip(port[5], ref[5]):
        # a session downshifted to a drop_oldest ring drops by thread
        # timing; every other one is held bitwise
        if rep.drops == jrep.drops == 0:
            assert rep.groups == jrep.groups
            np.testing.assert_array_equal(_np(out), np.asarray(jout))
        if rep.groups == cfg.num_groups and rep.drops == 0:
            np.testing.assert_array_equal(_np(out), undisturbed)


# ---------------------------------------------------------------------------
# Scenario 2: capacity-capped ladder walk with bit-identical restore.
# ---------------------------------------------------------------------------


def test_degradation_ladder_walk_and_bit_exact_restore(fleets, cfg, chunks, undisturbed):
    def run(pkg):
        clock = pkg.serve.FakeClock()
        c = pkg.cfg(cfg)
        Session = pkg.serve.Session

        def body():
            fleet = fleets(pkg, clock=clock, max_executors=1, max_sessions=2)
            scaler = pkg.serve.Autoscaler(fleet, min_executors=1, max_executors=1,
                                          breach_streak=1, clear_streak=1,
                                          cooldown_down_s=1e9)
            decisions = [scaler.evaluate()]
            gate_gold, gate_be = Gate(chunks), Gate(chunks, preload=1)
            h_gold = fleet.submit(Session(config=c, source=gate_gold, name="gold", priority=10))
            h_be = fleet.submit(Session(config=c, source=gate_be, name="best-effort",
                                        priority=0))
            _wait_steps(fleet, "best-effort", 1)
            levels, states = [], []
            for tick in range(4):  # each breached tick climbs exactly one rung
                for i in range(3):
                    with pytest.raises(pkg.serve.AdmissionError):
                        fleet.submit(Session(config=c, source=iter(chunks), name=f"ov{tick}-{i}"))
                clock.advance(1.0)
                decisions.append(scaler.evaluate())
                levels.append(fleet.degradation_level)
                states.append(scaler.state())
            be = h_be.result(timeout=WAIT)
            cleans = []
            while fleet.degradation_level > 0:  # one rung down per clean tick
                clock.advance(2.5)
                cleans.append(fleet.submit(Session(
                    config=c, source=iter(chunks),
                    name=f"cl{fleet.degradation_level}")).result(timeout=WAIT))
                decisions.append(scaler.evaluate())
                states.append(scaler.state())
            gate_gold.release()
            gold = h_gold.result(timeout=WAIT)
            fleet.shutdown()
            return ([d.to_dict() for d in decisions], levels, states, be, gold, cleans,
                    list(fleet.events), _kinds(fleet))

        return _traced(pkg, clock, body)

    (jres, jinst), (res, inst) = _both(run)
    decisions, levels, states, (be, berep), (gold, grep), cleans, events, kinds = res
    assert decisions == jres[0] and levels == jres[1] and states == jres[2]
    assert events == jres[6] and kinds == jres[7]
    assert [d["action"] for d in decisions[1:]] == ["degrade", "degrade", "degrade", "shed",
                                                    "restore", "restore", "restore"]
    assert levels == [1, 2, 3, 3]
    assert decisions[4]["shed"] == ["best-effort"]
    # the shed victim is finalized from the groups it folded, as in the reference
    assert berep.groups == jres[3][1].groups == 1
    np.testing.assert_array_equal(_np(be), np.asarray(jres[3][0]))
    # gold survived every rung, restored before its stream went on: exact
    assert grep.groups == cfg.num_groups and grep.drops == 0
    np.testing.assert_array_equal(_np(gold), np.asarray(jres[4][0]))
    np.testing.assert_array_equal(_np(gold), undisturbed)
    for (out, rep), (jout, jrep) in zip(cleans, jres[5]):
        if rep.drops == jrep.drops == 0:  # else dropped by thread timing, as above
            np.testing.assert_array_equal(_np(out), np.asarray(jout))
            np.testing.assert_array_equal(_np(out), undisturbed)
    by = lambda events, name: [(e["args"].get("session"), e["args"].get("rung"),  # noqa: E731
                                e["args"].get("action")) for e in events if e["name"] == name]
    for name in ("degrade", "restore", "fleet.shed"):
        assert sorted(by(inst, name), key=str) == sorted(by(jinst, name), key=str), name
    assert ("gold", "downshift", "ring") in by(inst, "degrade")
    assert any(s == "best-effort" for s, _, _ in by(inst, "fleet.shed"))


# ---------------------------------------------------------------------------
# Scenario 3: the autoscaler drains a victim through live migration.
# ---------------------------------------------------------------------------


def test_autoscaler_scale_down_drains_victim_via_migration(fleets, cfg, chunks, undisturbed):
    """Two sessions on two 1-slot executors; once the breach is clear and
    the capacity plan (headroom 0.5) says one executor is enough, the
    autoscaler drains one, whose session migrates mid-stream."""

    def run(pkg):
        clock = pkg.serve.FakeClock()
        fleet = fleets(pkg, clock=clock, slots_per_executor=1, max_executors=2,
                       max_sessions=4)
        scaler = pkg.serve.Autoscaler(fleet, min_executors=1, clear_streak=1,
                                      cooldown_down_s=0.0, planner_headroom=0.5)
        decisions, states = [scaler.evaluate().to_dict()], []  # baseline snapshot at t=0
        gates = [Gate(chunks, preload=2) for _ in range(2)]
        handles = [fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=g, name=f"s{i}"))
                   for i, g in enumerate(gates)]
        for i in range(2):
            _wait_steps(fleet, f"s{i}", 2)
        hosts = sorted(r["executor"] for r in fleet.health(evaluate_slos=False).sessions)
        for _ in range(2):
            clock.advance(2.0)
            decisions.append(scaler.evaluate().to_dict())
            states.append(scaler.state())
        for g in gates:
            g.release()
        outs = [h.result(timeout=WAIT) for h in handles]
        report = fleet.health(evaluate_slos=False)
        fleet.shutdown()
        return (hosts, decisions, states, list(fleet.events), _kinds(fleet),
                [rep.migrations for _, rep in outs], report.status, report.fleet["drained"],
                outs)

    ref, port = _both(run)
    assert port[:8] == ref[:8]
    hosts, decisions, _, events, kinds, migrations, status, drained = port[:8]
    assert hosts == ["ex0", "ex1"]
    assert "scale-down" in [d["action"] for d in decisions]
    assert decisions[-1]["target_executors"] == 1
    assert kinds == ["session-migrated", "scale-down"] and sum(migrations) == 1
    assert status == "ok" and drained == ["ex0"]  # a deliberate drain is not a fault
    for (out, rep), (jout, _) in zip(port[8], ref[8]):
        assert rep.groups == cfg.num_groups and rep.drops == 0
        np.testing.assert_array_equal(_np(out), np.asarray(jout))
        np.testing.assert_array_equal(_np(out), undisturbed)


def test_autoscaler_never_empties_the_pool(fleets, cfg, chunks):
    """At ``min_executors`` with nothing in flight the controller holds,
    and the fleet itself refuses to drain its last executor."""

    def run(pkg):
        clock = pkg.serve.FakeClock()
        fleet = fleets(pkg, clock=clock, max_executors=1, max_sessions=2)
        scaler = pkg.serve.Autoscaler(fleet, min_executors=1, clear_streak=1,
                                      cooldown_down_s=0.0)
        fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=iter(chunks),
                                       name="s")).result(timeout=WAIT)
        out = []
        for _ in range(3):
            clock.advance(2.0)
            out.append(scaler.evaluate().to_dict())
        out.append(fleet.scale_down(reason="nope"))
        out.append(scaler.state())
        return out

    ref, port = _both(run)
    assert port == ref
    assert [d["action"] for d in port[:3]] == ["hold"] * 3
    assert port[3] is None and port[4]["target_executors"] == 1


def test_breach_at_max_executors_walks_the_ladder(fleets, cfg, chunks):
    """A breach with the pool at its ``max_executors`` bound never scales
    up past it: the controller degrades instead, and ``scale_up`` clamps."""

    def run(pkg):
        clock = pkg.serve.FakeClock()
        fleet = fleets(pkg, clock=clock, max_executors=2, max_sessions=4)
        scaler = pkg.serve.Autoscaler(fleet, max_executors=2, breach_streak=1)
        gates = [Gate(chunks) for _ in range(4)]
        hs = [fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=g, name=f"h{i}"))
              for i, g in enumerate(gates)]
        out = [scaler.evaluate().to_dict()]
        for i in range(3):
            with pytest.raises(pkg.serve.AdmissionError):
                fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=iter(chunks),
                                               name=f"x{i}"))
        clock.advance(2.0)
        out.append(scaler.evaluate().to_dict())
        out += [fleet.scale_up(5), fleet.scale_up(1), fleet.max_sessions, scaler.state()]
        for g in gates:
            g.release()
        [h.result(timeout=WAIT) for h in hs]
        return out

    ref, port = _both(run)
    assert port == ref
    assert port[1]["action"] == "degrade" and port[1]["target_executors"] == 2
    assert port[2:5] == [2, 2, 4]


# ---------------------------------------------------------------------------
# Health surfaces carry the elastic state (all three renderings).
# ---------------------------------------------------------------------------


def test_health_report_carries_autoscale_state(fleets, cfg, chunks):
    def run(pkg):
        fleet = fleets(pkg, clock=pkg.serve.FakeClock(), max_executors=2, max_sessions=4)
        scaler = pkg.serve.Autoscaler(fleet, max_executors=2)
        fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=iter(chunks),
                                       name="s0")).result(timeout=WAIT)
        scaler.evaluate()
        report = fleet.health(evaluate_slos=False)
        report.autoscale = scaler.state()
        text, prom = report.render(), report.prometheus_text()
        return (report.to_dict()["autoscale"], fleet.stats()["autoscale"],
                [line for line in text.splitlines() if "autoscale" in line],
                sorted(line for line in prom.splitlines() if "autoscale" in line))

    ref, port = _both(run)
    assert port == ref
    block, stats, text, prom = port
    assert block["target_executors"] == 2 and block["degradation"] == "normal"
    assert block["last_action"] is not None and stats["target_executors"] == 2
    assert any("ladder=normal(0)" in line for line in text)
    assert "health_autoscale_pool_target 2" in "\n".join(prom)
    assert "health_autoscale_degradation_level 0" in "\n".join(prom)
