"""Port parity of the session service (``repro_torch.serve``) against the
reference (``repro.serve``), on ``device="cpu"``, at the reference tests'
small configuration (G = 4, N = 20, 16 x 64).

* A 1-session run equals the reference scheduler's output and is bitwise
  the port's ``run_pipelined`` for all four filters.
* Co-scheduled sessions equal their individual runs: bitwise for every
  filter on the port's plain kernels (``backend="auto"``), and against the
  reference's direct filter calls (``backend="xla"`` in both packages).
* Scheduling and QoS: staggered joins, a forced ``drop_oldest`` drop,
  deadline misses, leave, consumer partials, admission control, a source
  error, config validation, ``stream_key``; retry under a ``FakeClock``;
  the gang path over ``BankMesh(("cpu", "cpu"))``; an injected executor
  crash.

Tolerance: bitwise, except ``spatial_box`` in bilateral mode, held within
``denoise_spatial.BILATERAL_RTOL`` against the reference (XLA and PyTorch
round ``exp`` differently) and against the port's own runs: on the CPU,
``torch.exp`` is not bitwise reproducible from call to call within one
process (a run of these tests read two calls on the same tensor 1 ulp
apart in the last 2048 elements). The kernels on the card are, and
``chip_smoke.py`` holds the service there bitwise. Every ``result()`` is
bounded and every scheduler runs in a ``with`` block or a
``try/finally`` that shuts it down.
"""

import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.denoise import DenoiseConfig as JConfig
from repro.core.denoise import StreamingDenoiser as JDenoiser
from repro.serve import FakeClock as JFakeClock
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import InjectedExecutorFailure as JInjected
from repro.serve import Session as JSession
from repro.serve import SessionScheduler as JScheduler
from repro_torch import obs
from repro_torch.core.banks import BankMesh, run_pipelined_banked
from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser
from repro_torch.core.streaming import StreamReport, run_pipelined
from repro_torch.data.prism import PrismSource
from repro_torch.kernels import denoise_spatial
from repro_torch.serve import (
    AdmissionError,
    BackoffPolicy,
    FakeClock,
    FaultPlan,
    InjectedExecutorFailure,
    Session,
    SessionHandle,
    SessionReport,
    SessionScheduler,
    retry_with_backoff,
)

#: every filter, ``spatial_box`` in both modes
FILTER_CASES = {
    "pair_average": dict(),
    "temporal_median": dict(filter_name="temporal_median"),
    "ema_variance": dict(filter_name="ema_variance"),
    "spatial_box/box": dict(filter_name="spatial_box", spatial_mode="box"),
    "spatial_box/bilateral": dict(filter_name="spatial_box", spatial_mode="bilateral"),
}
WAIT = 30  # every result() is bounded; a CPU run here takes well under 1 s
SMALL = dict(num_groups=4, frames_per_group=20, height=16, width=64, median_window=3)
CPU = dict(device="cpu")


def _cfg(**kw):
    return DenoiseConfig(**{**SMALL, **kw})


def _groups(cfg, seed=3):
    return list(PrismSource(cfg, seed=seed).groups())


def _serial(cfg, groups, steps=None):
    """Oracle: the direct filter calls on the same chunk sequence."""
    den = StreamingDenoiser(cfg, device="cpu")
    state = den.init()
    for k, g in enumerate(groups):
        state = den.ingest(state, g, step=k)
    return den.finalize(state, steps=steps)


def _j_serial(cfg, groups, steps=None):
    jcfg = JConfig(**dataclasses.asdict(cfg))
    den = JDenoiser(jcfg)
    state = den.init()
    for k, g in enumerate(groups):
        state = den.ingest(state, jnp.asarray(g), step=k)
    return np.asarray(den.finalize(state, steps=steps))


def _close(cfg, got: torch.Tensor, want) -> None:
    """Bitwise, or within BILATERAL_RTOL for the bilateral filter."""
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if cfg.filter_name == "spatial_box" and cfg.spatial_mode == "bilateral":
        np.testing.assert_allclose(got, want, rtol=denoise_spatial.BILATERAL_RTOL, atol=0)
    else:
        assert np.array_equal(got, want), float(np.abs(got - want).max())


def _gate(groups, first: int, gate: threading.Event):
    """A source that yields ``first`` groups, then waits on ``gate``."""
    def src():
        yield from groups[:first]
        gate.wait(WAIT)
        yield from groups[first:]
    return src()


def _start_together(handles, gate):
    """Open ``gate`` once every session holds its slot, so that the first
    chunk of one cannot be stepped before the others have joined."""
    _wait_for(lambda: all(h.status == "active" for h in handles), "sessions never joined")
    gate.set()


def _wait_for(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(1e-3)


# ---------------------------------------------------------------------------
# A 1-session run: the reference's output, and the port's run_pipelined.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", FILTER_CASES)
def test_one_session_equal_reference_and_run_pipelined(case):
    cfg = _cfg(backend="xla", **FILTER_CASES[case])
    groups = _groups(cfg)
    with SessionScheduler(slots_per_executor=1, max_executors=1, **CPU) as sched:
        out, rep = sched.submit(Session(config=cfg, source=iter(groups))).result(timeout=WAIT)
    with JScheduler(slots_per_executor=1, max_executors=1) as jsched:
        jcfg = JConfig(**dataclasses.asdict(cfg))
        jout, jrep = jsched.submit(JSession(config=jcfg, source=iter(groups))).result(
            timeout=WAIT)
    _close(cfg, out, jout)
    _close(cfg, out, run_pipelined(cfg, iter(groups), num_slots=2, **CPU)[0])
    assert (rep.groups, rep.frames, rep.drops, rep.deadline_misses) == (
        jrep.groups, jrep.frames, jrep.drops, jrep.deadline_misses)
    assert rep.groups == cfg.num_groups and rep.bytes_in == jrep.bytes_in
    assert 0.0 <= rep.latency_p50_ms <= rep.latency_p95_ms <= rep.latency_p99_ms


@pytest.mark.parametrize("case", FILTER_CASES)
def test_one_session_on_the_plain_kernels_bitwise_run_pipelined(case):
    cfg = _cfg(**FILTER_CASES[case])  # backend "auto": the kernels' plain versions here
    groups = _groups(cfg, seed=4)
    with SessionScheduler(slots_per_executor=1, max_executors=1, **CPU) as sched:
        out, rep = sched.submit(Session(config=cfg, source=iter(groups))).result(timeout=WAIT)
    _close(cfg, out, run_pipelined(cfg, iter(groups), num_slots=2, **CPU)[0])
    assert out.device.type == "cpu" and rep.groups == cfg.num_groups


# ---------------------------------------------------------------------------
# Co-scheduled sessions against individual runs.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("case", FILTER_CASES)
def test_three_sessions_match_individual_runs(case, backend):
    cfg = _cfg(backend=backend, **FILTER_CASES[case])
    sources = [_groups(cfg, seed=s) for s in (1, 2, 3)]
    with SessionScheduler(slots_per_executor=3, max_executors=1, **CPU) as sched:
        handles = [sched.submit(Session(config=cfg, source=iter(g), name=f"m{i}"))
                   for i, g in enumerate(sources)]
        outs = [h.result(timeout=WAIT)[0] for h in handles]
        snap = sched.stats()
    for out, groups in zip(outs, sources):
        _close(cfg, out, _serial(cfg, groups))
        if backend == "xla":
            _close(cfg, out, _j_serial(cfg, groups))
    assert snap["completed"] == 3 and len(snap["executors"]) == 1


def test_full_cohort_steps_in_place_and_partial_cohorts_gather():
    """Two sessions on a 2-slot executor with a long coalescing window fold
    every group as one full cohort; the same two on a 3-slot executor take
    the gather/scatter path. Both equal the individual runs."""
    cfg = _cfg()
    sources = [_groups(cfg, seed=s) for s in (5, 6)]
    for slots in (2, 3):
        gate = threading.Event()
        with SessionScheduler(slots_per_executor=slots, max_executors=1, coalesce_ms=10_000,
                              **CPU) as sched:
            hs = [sched.submit(Session(config=cfg, source=_gate(g, 0, gate))) for g in sources]
            _start_together(hs, gate)
            outs = [h.result(timeout=WAIT)[0] for h in hs]
            steps = sched.stats()["executors"][0]["cohort_steps"]
        assert steps == cfg.num_groups  # one cohort per group, both sessions in it
        for out, g in zip(outs, sources):
            assert torch.equal(out, _serial(cfg, g))


def test_mixed_filters_get_separate_executors():
    cfg_a, cfg_b = _cfg(), _cfg(filter_name="ema_variance")
    ga, gb = _groups(cfg_a, seed=1), _groups(cfg_b, seed=2)
    with SessionScheduler(slots_per_executor=2, max_executors=2, **CPU) as sched:
        ha = sched.submit(Session(config=cfg_a, source=iter(ga)))
        hb = sched.submit(Session(config=cfg_b, source=iter(gb)))
        oa, _ = ha.result(timeout=WAIT)
        ob, _ = hb.result(timeout=WAIT)
        snap = sched.stats()
    assert {e["filter"] for e in snap["executors"]} == {"pair_average", "ema_variance"}
    assert snap["completed"] == 2 and snap["in_flight"] == 0
    assert torch.equal(oa, _serial(cfg_a, ga)) and torch.equal(ob, _serial(cfg_b, gb))


@pytest.mark.parametrize("name", ["temporal_median", "ema_variance"])
def test_staggered_join_phase_sensitive_filter(name):
    """A session joining mid-stream runs at its own phase: the executor
    cohorts phase-sensitive filters by group index, and the join does not
    disturb the resident session's slot."""
    cfg = _cfg(num_groups=5, filter_name=name)
    ga, gb = _groups(cfg, seed=1), _groups(cfg, seed=2)
    seen = []
    gate = threading.Event()
    with SessionScheduler(slots_per_executor=2, max_executors=1, **CPU) as sched:
        ha = sched.submit(Session(config=cfg, source=_gate(ga, 2, gate), name="A",
                                  consumer=lambda k, p: seen.append(k)))
        _wait_for(lambda: len(seen) >= 2, "session A never progressed")
        hb = sched.submit(Session(config=cfg, source=iter(gb), name="B"))
        gate.set()
        oa, _ = ha.result(timeout=WAIT)
        ob, _ = hb.result(timeout=WAIT)
    assert torch.equal(oa, _serial(cfg, ga)) and torch.equal(ob, _serial(cfg, gb))


# ---------------------------------------------------------------------------
# QoS: drop_oldest, deadlines, leave, consumer hook.
# ---------------------------------------------------------------------------


def _forced_drop(session_cls, scheduler_cls, cfg, groups, **sched_kw):
    """A ``drop_oldest`` session made to drop groups 1 and 2 of 4 whatever
    the thread timing: a one-slot ring, a consumer that holds step 0 until
    the source has delivered its last group, and a source that hands over
    group 1 only once step 0 is being consumed. Groups 1-3 then arrive at a
    full ring, and each sheds the one before."""
    folding, delivered = threading.Event(), threading.Event()

    def source():
        yield groups[0]
        folding.wait(WAIT)
        yield from groups[1:]
        delivered.set()

    def hold(step, partial):
        if step == 0:
            folding.set()
            assert delivered.wait(WAIT), "the source never delivered its last group"

    with scheduler_cls(slots_per_executor=1, max_executors=1, **sched_kw) as sched:
        h = sched.submit(session_cls(config=cfg, source=source(), mode="drop_oldest",
                                     num_slots=1, consumer=hold))
        return h.result(timeout=WAIT)


def test_forced_drop_oldest_folds_the_survivors():
    cfg = _cfg()
    groups = _groups(cfg, seed=7)
    out, rep = _forced_drop(Session, SessionScheduler, cfg, groups, **CPU)
    assert (rep.mode, rep.groups, rep.drops) == ("drop_oldest", 2, 2)
    survivors = [groups[0], groups[3]]
    assert torch.equal(out, _serial(cfg, survivors, steps=2))
    jcfg = JConfig(**dataclasses.asdict(cfg))
    jout, jrep = _forced_drop(JSession, JScheduler, jcfg, groups)
    assert (jrep.groups, jrep.drops) == (2, 2)
    assert np.array_equal(out.numpy(), np.asarray(jout))


def test_queued_drop_oldest_session_sheds_then_folds_survivors():
    """A real-time session stuck in the join queue keeps shedding stale
    groups; once seated it folds only the freshest window."""
    cfg = _cfg()
    groups = _groups(cfg, seed=7)
    gate, b_staged = threading.Event(), threading.Event()

    def b_src():
        yield from groups
        b_staged.set()  # runs after the last put: B's ring holds its last 2

    sched = SessionScheduler(slots_per_executor=1, max_executors=1, max_waiting=1,
                             max_sessions=3, **CPU)
    try:
        ha = sched.submit(Session(config=cfg, source=_gate(groups, 1, gate), name="A"))
        hb = sched.submit(Session(config=cfg, source=b_src(), name="B", mode="drop_oldest",
                                  num_slots=2))
        assert b_staged.wait(WAIT), "B's producer never drained its source"
        gate.set()
        _, rep_a = ha.result(timeout=WAIT)
        out_b, rep_b = hb.result(timeout=WAIT)
    finally:
        sched.shutdown()
    assert rep_a.groups == cfg.num_groups
    assert (rep_b.mode, rep_b.groups, rep_b.drops) == ("drop_oldest", 2, 2)
    assert rep_b.queue_wait_s > 0.0
    assert torch.equal(out_b, _serial(cfg, groups[2:], steps=2))


def test_deadline_misses_counted():
    cfg = _cfg()
    with SessionScheduler(slots_per_executor=1, max_executors=1, **CPU) as sched:
        h = sched.submit(Session(config=cfg, source=iter(_groups(cfg)), deadline_ms=1e-6))
        _, rep = h.result(timeout=WAIT)
    assert rep.deadline_misses == rep.groups == cfg.num_groups
    assert rep.deadline_ms == 1e-6
    assert sched.metrics.value("serve.deadline_misses", session=rep.session) == cfg.num_groups


def test_leave_finalizes_partial_stream():
    cfg = _cfg()
    groups = _groups(cfg, seed=9)
    seen = []
    gate = threading.Event()
    sched = SessionScheduler(slots_per_executor=1, max_executors=1, **CPU)
    try:
        h = sched.submit(Session(config=cfg, source=_gate(groups, 2, gate), name="L",
                                 consumer=lambda k, p: seen.append(k)))
        _wait_for(lambda: len(seen) >= 2, "session L never progressed")
        h.leave()
        out, rep = h.result(timeout=WAIT)
        gate.set()
    finally:
        sched.shutdown()
    assert rep.groups == 2
    assert torch.equal(out, _serial(cfg, groups[:2], steps=2))


def test_consumer_partials_match_run_pipelined_consumer():
    cfg = _cfg()
    groups = _groups(cfg, seed=11)
    ref = []
    run_pipelined(cfg, iter(groups), num_slots=2, consumer=lambda k, p: ref.append(p.clone()),
                  **CPU)
    got = {}
    with SessionScheduler(slots_per_executor=1, max_executors=1, **CPU) as sched:
        h = sched.submit(Session(config=cfg, source=iter(groups),
                                 consumer=lambda k, p: got.__setitem__(k, p)))
        out, _ = h.result(timeout=WAIT)
    assert sorted(got) == list(range(cfg.num_groups))
    for k, want in enumerate(ref):
        assert torch.equal(got[k], want)
    assert torch.equal(got[cfg.num_groups - 1], out)


def test_consumer_error_fails_only_its_session():
    cfg = _cfg()
    groups = _groups(cfg)

    def boom(step, partial):
        if step == 1:
            raise ValueError("egress link down")

    with SessionScheduler(slots_per_executor=2, max_executors=1, **CPU) as sched:
        bad = sched.submit(Session(config=cfg, source=iter(groups), name="bad", consumer=boom))
        good = sched.submit(Session(config=cfg, source=iter(groups), name="good"))
        with pytest.raises(ValueError, match="egress link down"):
            bad.result(timeout=WAIT)
        out, _ = good.result(timeout=WAIT)
    assert torch.equal(out, _serial(cfg, groups))


# ---------------------------------------------------------------------------
# Admission control and error paths.
# ---------------------------------------------------------------------------


def test_admission_rejects_on_max_sessions():
    cfg = _cfg()
    groups = _groups(cfg)
    gate = threading.Event()
    sched = SessionScheduler(slots_per_executor=1, max_executors=1, max_sessions=1,
                             max_waiting=4, **CPU)
    try:
        h = sched.submit(Session(config=cfg, source=_gate(groups, 1, gate)))
        with pytest.raises(AdmissionError, match="max_sessions"):
            sched.submit(Session(config=cfg, source=iter(groups)))
        gate.set()
        h.result(timeout=WAIT)
        sched.submit(Session(config=cfg, source=iter(groups))).result(timeout=WAIT)
    finally:
        sched.shutdown()
    assert sched.metrics.value("serve.admission_rejected") == 1
    assert sched.metrics.value("serve.submit_attempts") == 3


def test_admission_rejects_on_queue_depth():
    cfg = _cfg()
    groups = _groups(cfg)
    gate = threading.Event()
    sched = SessionScheduler(slots_per_executor=1, max_executors=1, max_waiting=1,
                             max_sessions=8, **CPU)
    try:
        ha = sched.submit(Session(config=cfg, source=_gate(groups, 1, gate), name="A"))
        hb = sched.submit(Session(config=cfg, source=iter(groups), name="B"))
        with pytest.raises(AdmissionError, match="max_waiting"):
            sched.submit(Session(config=cfg, source=iter(groups), name="C"))
        gate.set()
        ha.result(timeout=WAIT)
        hb.result(timeout=WAIT)
    finally:
        sched.shutdown()


def test_source_error_fails_only_that_session():
    cfg = _cfg()
    groups = _groups(cfg)

    def broken():
        yield groups[0]
        raise RuntimeError("camera unplugged")

    with SessionScheduler(slots_per_executor=2, max_executors=1, **CPU) as sched:
        bad = sched.submit(Session(config=cfg, source=broken(), name="bad"))
        good = sched.submit(Session(config=cfg, source=iter(groups), name="good"))
        with pytest.raises(RuntimeError, match="camera unplugged"):
            bad.result(timeout=WAIT)
        out, rep = good.result(timeout=WAIT)
    assert bad.status == "failed" and good.status == "done"
    assert rep.groups == cfg.num_groups
    assert torch.equal(out, _serial(cfg, groups))


def test_session_validates_config_and_qos():
    cfg = _cfg()
    for kw, match in ((dict(config=_cfg(num_banks=2)), "num_banks"), (dict(mode="nope"), "mode"),
                      (dict(deadline_ms=0.0), "deadline_ms"), (dict(num_slots=0), "num_slots")):
        kw = {"config": cfg, "source": iter([]), **kw}
        with pytest.raises(ValueError, match=match) as got:
            Session(**kw)
        jkw = dict(kw, config=JConfig(**dataclasses.asdict(kw["config"])))
        with pytest.raises(ValueError) as want:
            JSession(**jkw)
        assert str(got.value) == str(want.value)


def test_scheduler_validates_its_arguments():
    for kw in (dict(slots_per_executor=0), dict(max_executors=0), dict(max_waiting=-1),
               dict(coalesce_ms=-1.0), dict(max_sessions=0)):
        with pytest.raises(ValueError) as got:
            SessionScheduler(**kw, **CPU)
        with pytest.raises(ValueError) as want:
            JScheduler(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="conflicts with the mesh"):
        SessionScheduler(mesh=BankMesh(("cpu", "cpu")), slots_per_executor=3)
    with pytest.raises(ValueError, match="not both"):
        SessionScheduler(mesh=BankMesh(("cpu",)), device="cpu")


def test_submit_after_shutdown_raises():
    sched = SessionScheduler(slots_per_executor=1, max_executors=1, **CPU)
    sched.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        sched.submit(Session(config=_cfg(), source=iter([])))


def test_stream_key_splits_scheduling_from_numerics():
    cfg = _cfg()
    assert cfg.stream_key() == dataclasses.replace(
        cfg, num_slots=5, overflow_policy="drop_oldest").stream_key()
    assert cfg.stream_key() != dataclasses.replace(cfg, filter_name="ema_variance").stream_key()
    assert cfg.stream_key() != dataclasses.replace(cfg, width=128).stream_key()
    assert cfg.stream_key() == JConfig(**dataclasses.asdict(cfg)).stream_key()


def test_session_report_is_stream_report():
    from repro.serve import SessionReport as JReport

    rep = SessionReport(elapsed_s=1.0, buffering_s=0.0, compute_s=0.5, frames=10, bytes_in=20)
    jrep = JReport(elapsed_s=1.0, buffering_s=0.0, compute_s=0.5, frames=10, bytes_in=20)
    assert isinstance(rep, StreamReport)
    assert SessionReport.header() == JReport.header()
    assert SessionReport.header().startswith(StreamReport.header())
    assert rep.row("x") == jrep.row("x")


def test_handle_result_timeout():
    handle = SessionHandle(Session(config=_cfg(), source=iter([])))
    with pytest.raises(TimeoutError):
        handle.result(timeout=0.01)


def test_stats_and_metrics_match_the_reference_shape():
    cfg = _cfg()
    groups = _groups(cfg)
    with SessionScheduler(slots_per_executor=2, max_executors=1, **CPU) as sched:
        sched.submit(Session(config=cfg, source=iter(groups), name="s")).result(timeout=WAIT)
        snap = sched.stats()
    with JScheduler(slots_per_executor=2, max_executors=1) as jsched:
        jcfg = JConfig(**dataclasses.asdict(cfg))
        jsched.submit(JSession(config=jcfg, source=iter(groups), name="s")).result(timeout=WAIT)
        jsnap = jsched.stats()
    assert snap.keys() == jsnap.keys()
    assert snap["executors"][0].keys() == jsnap["executors"][0].keys()
    assert {k: v for k, v in snap.items() if k != "executors"} == {
        k: v for k, v in jsnap.items() if k != "executors"}
    kinds = {k: v["type"] for k, v in sched.metrics.snapshot().items()}
    assert kinds == {k: v["type"] for k, v in jsched.metrics.snapshot().items()}
    assert "serve.latency_s{session=s}" in kinds


def test_slo_engine_ticks_after_each_cohort():
    cfg = _cfg()
    specs = obs.default_serve_slos(window_s=60.0, p99_latency_s=10.0)
    with SessionScheduler(slots_per_executor=1, max_executors=1, slos=specs,
                          slo_eval_every_s=0.0, **CPU) as sched:
        sched.submit(Session(config=cfg, source=iter(_groups(cfg)))).result(timeout=WAIT)
    eng = sched.slo_engine
    assert eng.evaluations >= cfg.num_groups
    assert [v.spec for v in eng.last_verdicts] == [s.name for s in specs]
    assert sched.metrics.value("slo.eval_errors") == 0


# ---------------------------------------------------------------------------
# Retry under a FakeClock: zero wall-clock sleep.
# ---------------------------------------------------------------------------


class _Clocked(SessionScheduler):
    """A scheduler with an injected clock, as the fleet tier has."""

    def __init__(self, clock, **kw):
        self.clock = clock
        super().__init__(**kw)


class _JClocked(JScheduler):
    def __init__(self, clock, **kw):
        self.clock = clock
        super().__init__(**kw)


def _retry_storm(cls, clock, session_cls, cfg, groups):
    """A refused submit retried until its budget is spent, then admitted."""
    import random

    gate = threading.Event()
    sched = cls(clock, slots_per_executor=1, max_executors=1, max_sessions=1,
                **({} if cls is _JClocked else CPU))
    try:
        first = sched.submit(session_cls(config=cfg, source=_gate(groups, 1, gate)))
        t0 = time.perf_counter()
        with pytest.raises(AdmissionError if cls is _Clocked else Exception) as refused:
            sched.submit_with_retry(session_cls(config=cfg, source=iter(groups)), retries=4,
                                    base_s=0.5, rng=random.Random(7))
        wall = time.perf_counter() - t0
        gate.set()
        first.result(timeout=WAIT)
        again = sched.submit_with_retry(session_cls(config=cfg, source=iter(groups)))
        again.result(timeout=WAIT)
    finally:
        sched.shutdown()
    return (type(refused.value).__name__, clock.now(), sched.metrics.value("serve.admission_retry"),
            sched.metrics.value("serve.admission_rejected")), wall


def test_submit_with_retry_runs_on_the_fake_clock():
    cfg = _cfg()
    groups = _groups(cfg)
    got, wall = _retry_storm(_Clocked, FakeClock(), Session, cfg, groups)
    want, _ = _retry_storm(_JClocked, JFakeClock(), JSession,
                           JConfig(**dataclasses.asdict(cfg)), groups)
    assert got == want
    name, virtual_s, retries, rejected = got
    assert name == "AdmissionError" and retries == 4 and rejected == 5
    assert virtual_s > 1.0 and wall < 1.0  # waited in virtual time only


def test_retry_with_backoff_schedule_is_the_reference():
    import random

    from repro.serve import BackoffPolicy as JPolicy
    from repro.serve import retry_with_backoff as j_retry

    def run(retry, policy_cls, clock):
        calls, delays = [], []

        def flaky():
            calls.append(clock.now())
            if len(calls) < 4:
                raise AdmissionError("full")
            return "admitted"

        policy = policy_cls(retries=5, base_s=0.1, max_s=0.4, jitter=0.5, rng=random.Random(3))
        out = retry(flaky, policy=policy, clock=clock,
                    on_retry=lambda a, d, e: delays.append((a, d)),
                    retry_on=(AdmissionError,))
        return out, calls, delays

    got = run(retry_with_backoff, BackoffPolicy, FakeClock())
    want = run(j_retry, JPolicy, JFakeClock())
    assert got == want and got[0] == "admitted" and len(got[2]) == 3
    with pytest.raises(ValueError, match="jitter"):
        BackoffPolicy(jitter=2.0)


# ---------------------------------------------------------------------------
# The gang path over a two-shard mesh on the host.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pair_average", "temporal_median", "ema_variance"])
def test_gang_sessions_over_a_two_shard_mesh(name):
    """Two sessions over BankMesh(("cpu", "cpu")), one per bank shard:
    equal to the port's run_pipelined_banked over the same mesh (host
    copies) and to the reference's single-device runs of each bank."""
    cfg = _cfg(num_groups=3, filter_name=name, median_window=2)
    mesh = BankMesh(("cpu", "cpu"))
    per_bank = [list(s) for s in PrismSource(cfg, seed=13).bank_sources(2)]
    gate = threading.Event()
    with SessionScheduler(mesh=mesh, max_executors=1) as sched:
        hs = [sched.submit(Session(config=cfg, source=_gate(g, 0, gate), name=f"b{b}"))
              for b, g in enumerate(per_bank)]
        _start_together(hs, gate)
        outs = [h.result(timeout=WAIT)[0] for h in hs]
        steps = sched.stats()["executors"][0]["cohort_steps"]
    ref, _ = run_pipelined_banked(dataclasses.replace(cfg, num_banks=2),
                                  [iter(g) for g in per_bank], mesh)
    assert steps == cfg.num_groups  # every step a gang step over both shards
    for b, out in enumerate(outs):
        assert torch.equal(out, ref.cpu()[b])
        assert np.array_equal(out.numpy(), _j_serial(dataclasses.replace(cfg, backend="pallas"),
                                                     per_bank[b]))


def test_one_session_over_a_one_shard_mesh_matches_banked_executor():
    cfg = _cfg(filter_name="temporal_median")
    mesh = BankMesh(("cpu",))
    src = PrismSource(cfg, seed=5)
    ref, _ = run_pipelined_banked(cfg, src.bank_sources(1), mesh, num_slots=2)
    with SessionScheduler(mesh=mesh, max_executors=1) as sched:
        out, rep = sched.submit(Session(config=cfg, source=iter(src.bank_source(0)))).result(
            timeout=WAIT)
    assert torch.equal(out, ref[0]) and rep.groups == cfg.num_groups


def test_gang_waits_for_every_occupied_slot():
    """A gang step needs a chunk from every occupied slot: a session whose
    source stalls holds its co-tenant at the barrier, and both finish
    equal to their individual runs once it resumes."""
    cfg = _cfg(num_groups=3)
    mesh = BankMesh(("cpu", "cpu"))
    ga, gb = _groups(cfg, seed=1), _groups(cfg, seed=2)
    start, gate = threading.Event(), threading.Event()
    seen = []
    with SessionScheduler(mesh=mesh, max_executors=1) as sched:
        ha = sched.submit(Session(config=cfg, source=_gate(ga, 0, start), name="fast",
                                  consumer=lambda k, p: seen.append(k)))
        hb = sched.submit(Session(config=cfg, source=_gate(gb, 1, gate), name="slow"))
        _start_together([ha, hb], start)
        _wait_for(lambda: len(seen) >= 1, "no gang step ran")
        time.sleep(0.05)  # room for a wrong second step; the barrier must hold it
        assert seen == [0]
        gate.set()
        oa, _ = ha.result(timeout=WAIT)
        ob, _ = hb.result(timeout=WAIT)
    assert torch.equal(oa, _serial(cfg, ga)) and torch.equal(ob, _serial(cfg, gb))


# ---------------------------------------------------------------------------
# An injected executor crash, in both packages.
# ---------------------------------------------------------------------------


def _crash(scheduler_cls, session_cls, plan, cfg, groups, **kw):
    class Faulty(scheduler_cls):
        def _executor_hooks(self):
            return {"faults": plan}

    plan.crash("ex0", at_step=1)
    gate = threading.Event()
    with Faulty(slots_per_executor=2, max_executors=1, **kw) as sched:
        hs = [sched.submit(session_cls(config=cfg, source=_gate(groups, 0, gate), name=f"c{i}"))
              for i in range(2)]
        _start_together(hs, gate)  # both on ex0 before it crashes
        assert plan.wait_crashed("ex0", timeout=WAIT)
        errors = []
        for h in hs:
            with pytest.raises(BaseException) as e:
                h.result(timeout=WAIT)
            errors.append(e.value)
        snap = sched.stats()
    return errors, [h.status for h in hs], snap


def test_injected_crash_fails_the_executors_sessions():
    cfg = _cfg()
    groups = _groups(cfg)
    errors, statuses, snap = _crash(SessionScheduler, Session, FaultPlan(), cfg, groups, **CPU)
    jerrors, jstatuses, jsnap = _crash(JScheduler, JSession, JFaultPlan(),
                                       JConfig(**dataclasses.asdict(cfg)), groups)
    assert all(isinstance(e, InjectedExecutorFailure) for e in errors)
    assert all(isinstance(e, JInjected) for e in jerrors)
    assert [str(e) for e in errors] == [str(e) for e in jerrors]
    assert statuses == jstatuses == ["failed", "failed"]
    assert snap["executors"][0]["alive"] is jsnap["executors"][0]["alive"] is False
    assert snap["completed"] == jsnap["completed"] == 2
