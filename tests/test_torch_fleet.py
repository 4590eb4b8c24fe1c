"""Port parity of the fault-tolerant fleet (``repro_torch.serve.fleet``)
against the reference's (``repro.serve.fleet``), on ``device="cpu"``:
the counterparts of ``tests/test_fleet_recovery.py``, and of the fleet's
own pool and ladder calls in ``tests/test_autoscale.py`` (without the
``Autoscaler`` and the load generator, ROADMAP queue A item 10(c)).

Every scenario runs in both packages under the same scripted
``FaultPlan`` (and ``FakeClock`` where supervision time matters), on the
same numpy frames made by ``PrismSource`` from a seed, with
``backend="xla"`` in both (as the reference's own fleet tests run). Each
port output is held against the reference fleet's output in the same
scenario (a host copy, ``np.asarray``), against the reference's serial
oracle and against the port's own undisturbed ``run_pipelined`` on the
same chunks; the fleet's ``events`` strings, the kinds of its
``timeline`` marks and the reports' ``restarts``/``checkpoints`` equal
the reference fleet's (in order, or as a multiset where two sessions
recover on their own threads). The gang path over
``BankMesh(("cpu", "cpu"))`` is held against the port's undisturbed runs
and the reference's oracle only: the reference's bank meshes fail on
this JAX (ROADMAP queue C).

Tolerance: bitwise, except ``spatial_box`` (bilateral by default), held
within ``denoise_spatial.BILATERAL_RTOL`` (ROADMAP queue C: the CPU's
plain bilateral is not bitwise reproducible from call to call). No
wall-clock sleep: every wait is a bounded event wait, so a hang fails.
"""

import collections
import dataclasses
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as J
import repro_torch.serve as T
from repro.core.denoise import DenoiseConfig as JConfig
from repro.core.denoise import StreamingDenoiser as JDenoiser
from repro.serve.scheduler import _Active as JActive
from repro_torch.core.banks import BankMesh
from repro_torch.core.denoise import DenoiseConfig
from repro_torch.core.streaming import run_pipelined
from repro_torch.data.prism import PrismSource
from repro_torch.denoise.base import tree_leaves
from repro_torch.kernels import denoise_spatial
from repro_torch.serve.scheduler import _Active

FILTERS = ["ema_variance", "pair_average", "spatial_box", "temporal_median"]
WAIT = 60  # every wait is bounded; a CPU run of a scenario takes well under 1 s


@dataclasses.dataclass(frozen=True)
class Pkg:
    """The names a scenario takes from one package."""

    name: str
    serve: object
    config: type
    fleet_kw: dict

    def cfg(self, cfg: DenoiseConfig):
        return self.config(**dataclasses.asdict(cfg))


REF = Pkg("ref", J, JConfig, {})
PORT = Pkg("port", T, DenoiseConfig, {"device": "cpu"})


def _cfg(**kw):
    base = dict(num_groups=6, frames_per_group=20, height=16, width=64, backend="xla",
                median_window=3)
    return DenoiseConfig(**{**base, **kw})


def _groups(cfg, seed=3):
    return list(PrismSource(cfg, seed=seed).groups())


def _np(out):
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _j_serial(cfg, groups):
    """The reference's serial oracle: its direct filter calls."""
    den = JDenoiser(JConfig(**dataclasses.asdict(cfg)))
    state = den.init()
    for k, g in enumerate(groups):
        state = den.ingest(state, jnp.asarray(g), step=k)
    return np.asarray(den.finalize(state))


def _close(cfg, got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if cfg.filter_name == "spatial_box" and cfg.spatial_mode == "bilateral":
        np.testing.assert_allclose(got, want, rtol=denoise_spatial.BILATERAL_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def _held(cfg, out, groups, ref_out=None):
    """A port output against the reference fleet's output in the same
    scenario, the reference's oracle and the port's own undisturbed
    ``run_pipelined`` on the same chunks."""
    if ref_out is not None:
        _close(cfg, out, np.asarray(ref_out))
    _close(cfg, out, _j_serial(cfg, groups))
    _close(cfg, out, run_pipelined(cfg, iter(groups), device="cpu")[0])


def _kinds(fleet):
    return [kind for kind, _, _ in fleet.timeline]


@pytest.fixture
def fleets(tmp_path):
    """``make(pkg, **kw)`` builds a ``FleetScheduler`` of ``pkg`` (or of
    ``cls``, a subclass) with a checkpoint directory of its own; every
    fleet built is torn down, its scripted stalls poisoned free, even when
    the test fails."""
    created = []

    def make(pkg, cls=None, **kwargs):
        kwargs.setdefault("checkpoint_dir", str(tmp_path / pkg.name / "ckpt"))
        kwargs = {**pkg.fleet_kw, **kwargs}
        fleet = (cls or pkg.serve.FleetScheduler)(**kwargs)
        created.append(fleet)
        return fleet

    yield make
    for fleet in created:
        if fleet.faults is not None:
            for ex in list(fleet._executors):
                fleet.faults.poison(ex.name)
        fleet.shutdown(wait=False)


def _both(scenario, *args, **kw):
    """Run ``scenario(pkg, ...)`` for the reference, then the port."""
    return scenario(REF, *args, **kw), scenario(PORT, *args, **kw)


# ---------------------------------------------------------------------------
# Kill-executor recovery: crash mid-stream, resume bit-identically.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FILTERS)
def test_kill_executor_recovery_bit_identical(name, fleets):
    cfg = _cfg(filter_name=name)
    groups = _groups(cfg)

    def run(pkg):
        plan = pkg.serve.FaultPlan().crash("ex0", at_step=3)
        fleet = fleets(pkg, slots_per_executor=1, max_executors=2, faults=plan)
        with fleet:
            out, rep = fleet.submit(pkg.serve.Session(
                config=pkg.cfg(cfg), source=iter(groups), name="k0")).result(timeout=WAIT)
        assert plan.crashed("ex0")
        return out, rep, fleet

    (jout, jrep, jfleet), (out, rep, fleet) = _both(run)
    _held(cfg, out, groups, jout)
    assert rep.groups == cfg.num_groups
    assert rep.frames == cfg.num_groups * cfg.frames_per_group
    assert (rep.restarts, rep.checkpoints) == (jrep.restarts, jrep.checkpoints) == (1, 6)
    assert fleet.events == jfleet.events == ["dead@ex0:InjectedExecutorFailure",
                                             "recover@k0->ex1:steps=3+0"]
    assert _kinds(fleet) == _kinds(jfleet) == [
        "executor-dead", "session-replaced", "session-recovered"]
    assert fleet.recovery_latencies_s(), "no kill-to-recovered mark recorded"


def test_kill_executor_recovers_all_cotenants(fleets):
    cfg = _cfg()
    ga, gb = _groups(cfg, seed=1), _groups(cfg, seed=2)

    def run(pkg):
        plan = pkg.serve.FaultPlan().crash("ex0", at_step=4)
        fleet = fleets(pkg, slots_per_executor=2, max_executors=2, faults=plan)
        with fleet:
            ha = fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=iter(ga), name="A"))
            hb = fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=iter(gb), name="B"))
            res = [ha.result(timeout=WAIT), hb.result(timeout=WAIT)]
        return res, fleet

    (jres, jfleet), (res, fleet) = _both(run)
    for (out, rep), (jout, jrep), groups in zip(res, jres, (ga, gb)):
        _held(cfg, out, groups, jout)
        assert rep.restarts == jrep.restarts == 1

    # which co-tenant folded more before the crash is the executor
    # thread's timing, in both packages; the event kinds are not
    def shape(events):
        return sorted(e.split(":steps=")[0] for e in events)

    assert shape(fleet.events) == shape(jfleet.events) == [
        "dead@ex0:InjectedExecutorFailure", "recover@A->ex1", "recover@B->ex1"]
    assert collections.Counter(_kinds(fleet)) == collections.Counter(_kinds(jfleet))


def test_crash_before_first_fold_recovers_fresh(fleets):
    """A session that never folded anything resumes from a fresh init —
    no checkpoint, no replay, still exactly the reference output."""
    cfg = _cfg()
    groups = _groups(cfg)

    def run(pkg):
        plan = pkg.serve.FaultPlan().crash("ex0", at_step=0)
        fleet = fleets(pkg, slots_per_executor=1, max_executors=2, faults=plan)
        with fleet:
            out, rep = fleet.submit(pkg.serve.Session(
                config=pkg.cfg(cfg), source=iter(groups), name="f0")).result(timeout=WAIT)
        return out, rep, fleet

    (jout, jrep, jfleet), (out, rep, fleet) = _both(run)
    _held(cfg, out, groups, jout)
    assert rep.restarts == jrep.restarts == 1 and rep.groups == cfg.num_groups
    assert fleet.events == jfleet.events == ["dead@ex0:InjectedExecutorFailure",
                                             "recover@f0->ex1:steps=0+0"]
    assert _kinds(fleet) == _kinds(jfleet)


@pytest.mark.parametrize("name", ["temporal_median", "ema_variance"])
def test_recovery_replays_past_sparse_checkpoint(name, fleets):
    """``checkpoint_every=3``: the crash lands two folds past the newest
    snapshot, so recovery must restore @3 and re-fold the replay log."""
    cfg = _cfg(filter_name=name, num_groups=7)
    groups = _groups(cfg)

    def run(pkg):
        plan = pkg.serve.FaultPlan().crash("ex0", at_step=5)
        fleet = fleets(pkg, slots_per_executor=1, max_executors=2, faults=plan,
                       checkpoint_every=3)
        with fleet:
            out, rep = fleet.submit(pkg.serve.Session(
                config=pkg.cfg(cfg), source=iter(groups), name="R")).result(timeout=WAIT)
        return out, rep, fleet

    (jout, jrep, jfleet), (out, rep, fleet) = _both(run)
    _held(cfg, out, groups, jout)
    assert rep.restarts == jrep.restarts == 1
    assert rep.checkpoints == jrep.checkpoints
    assert fleet.events == jfleet.events == ["dead@ex0:InjectedExecutorFailure",
                                             "recover@R->ex1:steps=3+2"]
    assert _kinds(fleet) == _kinds(jfleet)


def test_replayed_chunks_are_intact_when_the_source_reuses_its_buffer(fleets):
    """The replay log keeps the staged chunks themselves: it is exact only
    while each staged chunk is a tensor of its own that nothing writes
    again. Here the source hands out ONE numpy buffer, overwritten for
    every group (a camera's DMA ring): at recovery each chunk of the log
    must still hold its own group, land on the target executor's device,
    and the output must equal the undisturbed run."""
    cfg = _cfg(filter_name="temporal_median", num_groups=7)
    groups = _groups(cfg)
    seen = []

    class Recording(T.FleetScheduler):
        def _recover(self, act, src_ex):
            log = [c.clone() for c in act.replay]  # what the replay will re-fold
            restore = self.checkpointer.restore_latest

            def recording(*args, **kwargs):
                state = restore(*args, **kwargs)
                seen.append(state)
                return state

            self.checkpointer.restore_latest = recording
            ok = super()._recover(act, src_ex)
            seen.append((log, act.executor.device))
            return ok

    def reused():
        buf = np.empty_like(groups[0])
        for g in groups:
            buf[...] = g
            yield buf

    plan = T.FaultPlan().crash("ex0", at_step=5)
    fleet = fleets(PORT, cls=Recording, slots_per_executor=1, max_executors=2, faults=plan,
                   checkpoint_every=3)
    with fleet:
        out, rep = fleet.submit(T.Session(config=cfg, source=reused(), num_slots=1,
                                          name="R")).result(timeout=WAIT)
    assert fleet.events == ["dead@ex0:InjectedExecutorFailure", "recover@R->ex1:steps=3+2"]
    (state, steps, _), (replay, device) = seen
    assert steps == 3 and len(replay) == 2
    for k, chunk in enumerate(replay):
        assert torch.equal(chunk, torch.from_numpy(groups[steps + k]))
    assert device == fleet.device
    assert {t.device for t in tree_leaves(state)[0]} == {device}
    _held(cfg, out, groups)
    assert rep.restarts == 1


def _torn(directory, session):
    """Truncate the newest checkpoint's leaves of ``session``."""
    sdir = os.path.join(directory, session)
    newest = sorted(p for p in os.listdir(sdir) if p.startswith("step_"))[-1]
    with open(os.path.join(sdir, newest, "leaves.npz"), "r+b") as f:
        f.truncate(16)


def test_torn_checkpoint_falls_to_replay_only_and_gives_up(fleets, tmp_path):
    """A checkpoint that cannot be read falls to the replay-only restore;
    the log holds only the folds since that checkpoint, so the session
    gives up (its handle fails) instead of resuming with a gap."""
    cfg = _cfg(num_groups=7)
    groups = _groups(cfg)

    def run(pkg):
        ckdir = str(tmp_path / pkg.name / "torn")
        plan, clock = pkg.serve.FaultPlan().stall("ex0", at_step=4), pkg.serve.FakeClock()
        fleet = fleets(pkg, checkpoint_dir=ckdir, checkpoint_every=3, slots_per_executor=1,
                       max_executors=2, faults=plan, clock=clock)
        with fleet:
            h = fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=iter(groups),
                                               name="T"))
            assert plan.wait_stalled("ex0", timeout=WAIT)
            _torn(ckdir, "T")
            clock.advance(61.0)
            res = fleet.check_faults(probe=False)
            with pytest.raises(RuntimeError, match="evicted"):
                h.result(timeout=WAIT)
        return res, fleet

    (jres, jfleet), (res, fleet) = _both(run)
    assert res == jres == {"dead": ["ex0"], "stragglers": [], "evicted": ["ex0"],
                           "recovered": [], "failed": ["T"]}
    assert fleet.events == jfleet.events == ["evict@ex0:heartbeat", "give-up@T:unrecoverable"]


def test_mismatched_checkpoint_falls_to_a_full_replay(fleets, tmp_path):
    """A checkpoint of the session's name written under another
    ``stream_key`` is not resumed: while the replay log still covers the
    whole history (no checkpoint of its own was due yet), the session
    re-folds it from a fresh init, bit-identically."""
    cfg = _cfg(num_groups=6)
    groups = _groups(cfg)
    other = _cfg(width=32)

    def run(pkg):
        ckdir = str(tmp_path / pkg.name / "mismatch")
        from_pkg = {"ref": "repro", "port": "repro_torch"}[pkg.name]
        banks = __import__(f"{from_pkg}.core.banks", fromlist=["banked_filter_init"])
        recovery = __import__(f"{from_pkg}.serve.recovery", fromlist=["SessionCheckpointer"])
        kw = {} if pkg is REF else {"device": "cpu"}
        filt, state = banks.banked_filter_init(pkg.cfg(other), None, banks=1, **kw)
        recovery.SessionCheckpointer(ckdir).save("M", filt, filt.slot_extract(state, 0),
                                                 steps=2, frames=40)
        plan = pkg.serve.FaultPlan().crash("ex0", at_step=3)
        fleet = fleets(pkg, checkpoint_dir=ckdir, checkpoint_every=10, slots_per_executor=1,
                       max_executors=2, faults=plan)
        with fleet:
            out, rep = fleet.submit(pkg.serve.Session(
                config=pkg.cfg(cfg), source=iter(groups), name="M")).result(timeout=WAIT)
        return out, rep, fleet

    (jout, jrep, jfleet), (out, rep, fleet) = _both(run)
    _held(cfg, out, groups, jout)
    assert rep.restarts == jrep.restarts == 1
    assert fleet.events == jfleet.events == ["dead@ex0:InjectedExecutorFailure",
                                             "recover@M->ex1:steps=0+3"]


# ---------------------------------------------------------------------------
# Live migration at a group boundary, mid-stream, with staged load.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pair_average", "temporal_median"])
def test_migrate_under_load_bit_identical(name, fleets):
    cfg = _cfg(filter_name=name)
    groups, gb = _groups(cfg), _groups(cfg, seed=11)

    def run(pkg):
        gate, fed = threading.Event(), threading.Event()

        def src():
            yield groups[0]
            yield groups[1]
            fed.set()
            assert gate.wait(WAIT)
            yield from groups[2:]

        fleet = fleets(pkg, slots_per_executor=2, max_executors=2)
        with fleet:
            h = fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=src(), name="m0"))
            hb = fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=iter(gb),
                                                name="m1"))
            assert fed.wait(WAIT), "source never staged its pre-gate chunks"
            assert fleet.migrate(h, timeout=WAIT) == "ex1"
            gate.set()
            res = [h.result(timeout=WAIT), hb.result(timeout=WAIT)]
        return res, fleet

    (jres, jfleet), (res, fleet) = _both(run)
    (out, rep), (ob, rb) = res
    _held(cfg, out, groups, jres[0][0])
    _held(cfg, ob, gb, jres[1][0])
    assert rep.migrations == 1 and rep.restarts == 0
    assert rb.migrations == 0  # the co-tenant never noticed
    assert fleet.events == jfleet.events == ["migrate@m0:ex0->ex1"]
    assert _kinds(fleet) == _kinds(jfleet) == ["session-migrated"]


def test_migrate_finished_session_returns_none(fleets):
    cfg = _cfg()
    groups = _groups(cfg)

    def run(pkg):
        fleet = fleets(pkg, slots_per_executor=1, max_executors=2)
        with fleet:
            h = fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=iter(groups)))
            out, _ = h.result(timeout=WAIT)
            assert fleet.migrate(h, timeout=WAIT) is None
        return out, fleet

    (jout, jfleet), (out, fleet) = _both(run)
    _held(cfg, out, groups, jout)
    assert fleet.events == jfleet.events == []


# ---------------------------------------------------------------------------
# Supervision: straggler eviction and heartbeat death, virtual time only.
# ---------------------------------------------------------------------------


def _counting_consumer(event, at):
    """Set ``event`` once fold index ``at`` has completed."""

    def consumer(step, _partial):
        if step >= at:
            event.set()

    return consumer


def test_straggler_evicted_and_session_recovers(fleets):
    """Two 1-slot executors with scripted *virtual* step durations: the
    5x-slower one is flagged against the fleet median and evicted; its
    session resumes elsewhere and the output is untouched."""
    cfg = _cfg()
    ga, gb = _groups(cfg, seed=1), _groups(cfg, seed=2)

    def run(pkg):
        plan = (pkg.serve.FaultPlan().slow("ex0", extra_s=0.1, from_step=0)
                .slow("ex1", extra_s=0.5, from_step=0))
        fleet = fleets(pkg, slots_per_executor=1, max_executors=3, faults=plan,
                       clock=pkg.serve.FakeClock(), straggler_threshold=1.5,
                       straggler_warmup=3)
        gates = [threading.Event(), threading.Event()]
        warm = [threading.Event(), threading.Event()]

        def gated(groups, gate):
            yield from groups[:4]
            assert gate.wait(WAIT)
            yield from groups[4:]

        with fleet:
            hs = [fleet.submit(pkg.serve.Session(
                config=pkg.cfg(cfg), source=gated(g, gates[i]), name=n,
                consumer=_counting_consumer(warm[i], 3)))
                for i, (n, g) in enumerate((("A", ga), ("B", gb)))]
            # fold index 3 completing guarantees folds 0..2 recorded their
            # EWMA samples: past warmup on both executors
            assert warm[0].wait(WAIT) and warm[1].wait(WAIT)
            res = fleet.check_faults(probe=False)
            for g in gates:
                g.set()
            outs = [h.result(timeout=WAIT) for h in hs]
        return res, outs, fleet

    (jres, jouts, jfleet), (res, outs, fleet) = _both(run)
    assert res == jres == {"dead": [], "stragglers": ["ex1"], "evicted": ["ex1"],
                           "recovered": ["B"], "failed": []}
    (oa, ra), (ob, rb) = outs
    _held(cfg, oa, ga, jouts[0][0])
    _held(cfg, ob, gb, jouts[1][0])
    assert ra.restarts == 0 and rb.restarts == 1
    assert fleet.events == jfleet.events == ["evict@ex1:straggler", "recover@B->ex2:steps=4+0"]
    assert _kinds(fleet) == _kinds(jfleet)


def test_stalled_executor_evicted_by_heartbeat(fleets):
    """A stalled executor stops beating; advancing the fake clock past
    the heartbeat timeout gets it evicted and its session recovered."""
    cfg = _cfg()
    groups = _groups(cfg)

    def run(pkg):
        plan, clock = pkg.serve.FaultPlan().stall("ex0", at_step=2), pkg.serve.FakeClock()
        fleet = fleets(pkg, slots_per_executor=1, max_executors=2, faults=plan, clock=clock,
                       heartbeat_timeout_s=60.0)
        with fleet:
            h = fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=iter(groups),
                                               name="S"))
            assert plan.wait_stalled("ex0", timeout=WAIT)
            clock.advance(61.0)
            res = fleet.check_faults(probe=False)
            out, rep = h.result(timeout=WAIT)
        # the zombie thread raised on release instead of folding anything
        ex0 = fleet._executors[0]
        ex0.thread.join(WAIT)
        assert not ex0.thread.is_alive()
        return res, out, rep, fleet

    (jres, jout, _, jfleet), (res, out, rep, fleet) = _both(run)
    assert res == jres == {"dead": ["ex0"], "stragglers": [], "evicted": ["ex0"],
                           "recovered": ["S"], "failed": []}
    _held(cfg, out, groups, jout)
    assert rep.restarts == 1 and rep.groups == cfg.num_groups
    assert fleet.events == jfleet.events == ["evict@ex0:heartbeat", "recover@S->ex1:steps=2+0"]
    assert _kinds(fleet) == _kinds(jfleet)
    assert fleet.recovery_latencies_s() == jfleet.recovery_latencies_s() == [0.0]


# ---------------------------------------------------------------------------
# Double faults vs the restart budget.
# ---------------------------------------------------------------------------


def test_double_fault_recovers_within_budget(fleets):
    cfg = _cfg(num_groups=8)
    groups = _groups(cfg)

    def run(pkg):
        plan = pkg.serve.FaultPlan().crash("ex0", at_step=2).crash("ex1", at_step=2)
        fleet = fleets(pkg, slots_per_executor=1, max_executors=3, faults=plan,
                       max_session_restarts=2)
        with fleet:
            out, rep = fleet.submit(pkg.serve.Session(
                config=pkg.cfg(cfg), source=iter(groups), name="D")).result(timeout=WAIT)
        return out, rep, fleet

    (jout, jrep, jfleet), (out, rep, fleet) = _both(run)
    _held(cfg, out, groups, jout)
    assert rep.restarts == jrep.restarts == 2
    assert rep.checkpoints == jrep.checkpoints
    assert fleet.events == jfleet.events == [
        "dead@ex0:InjectedExecutorFailure", "recover@D->ex1:steps=2+0",
        "dead@ex1:InjectedExecutorFailure", "recover@D->ex2:steps=4+0"]
    assert _kinds(fleet) == _kinds(jfleet)


def test_double_fault_exhausts_restart_budget(fleets):
    cfg = _cfg(num_groups=8)
    groups = _groups(cfg)

    def run(pkg):
        plan = pkg.serve.FaultPlan().crash("ex0", at_step=2).crash("ex1", at_step=2)
        fleet = fleets(pkg, slots_per_executor=1, max_executors=3, faults=plan,
                       max_session_restarts=1)
        with fleet:
            h = fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=iter(groups),
                                               name="D"))
            with pytest.raises(pkg.serve.InjectedExecutorFailure):
                h.result(timeout=WAIT)
        return fleet

    jfleet, fleet = _both(run)
    assert fleet.events == jfleet.events
    assert fleet.events[-1] == "give-up@D:restarts=1"
    assert _kinds(fleet) == _kinds(jfleet)


# ---------------------------------------------------------------------------
# Regression: abort racing a held fold must drain queued sessions.
# ---------------------------------------------------------------------------


def test_abort_with_held_fold_drains_queued_sessions(fleets):
    """``stop(abort=True)`` while the executor thread is held inside a fold
    must still fail both the seated and the *queued* session; a dead
    executor then refuses new sessions instead of parking them."""
    cfg = _cfg(num_groups=4)
    ga, gb = _groups(cfg, seed=1), _groups(cfg, seed=2)

    def run(pkg):
        plan = pkg.serve.FaultPlan().stall("ex0", at_step=1)
        fleet = fleets(pkg, slots_per_executor=1, max_executors=1, faults=plan,
                       max_session_restarts=0)
        ha = fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=iter(ga), name="A"))
        hb = fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=iter(gb), name="B"))
        assert plan.wait_stalled("ex0", timeout=WAIT)
        ex0 = fleet._executors[0]
        ex0.stop(abort=True)  # abort lands while the fold is still held
        plan.poison("ex0")    # release the thread: it must raise, not fold
        ex0.thread.join(WAIT)
        assert not ex0.thread.is_alive()
        for h in (ha, hb):
            with pytest.raises(RuntimeError):
                h.result(timeout=WAIT)
        handle = pkg.serve.SessionHandle(pkg.serve.Session(config=pkg.cfg(cfg),
                                                           source=iter(gb)))
        if pkg is PORT:
            spare = _Active(handle, 99, notify_hook=lambda: None, device=fleet.device)
        else:
            spare = JActive(handle, 99, notify_hook=lambda: None)
        assert ex0.enqueue(spare) is False
        return fleet

    jfleet, fleet = _both(run)
    assert fleet.events == jfleet.events


# ---------------------------------------------------------------------------
# The elastic pool: scale_down drains through migration, scale_up's ceiling.
# ---------------------------------------------------------------------------


def _drain(pkg, fleets, cfg, sources, **kw):
    """Two sessions in flight on two executors (``ex0``, ``ex1``), each
    gated after 2 groups; once both folded those, scale the pool down
    (the victim's session migrates), then open the gates."""
    gate = threading.Event()
    mid = [threading.Event() for _ in sources]

    def gated(groups):
        yield from groups[:2]
        assert gate.wait(WAIT)
        yield from groups[2:]

    fleet = fleets(pkg, clock=pkg.serve.FakeClock(), max_executors=2, max_sessions=4,
                   max_waiting=64, coalesce_ms=0.0, **kw)
    with fleet:
        hs = [fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=gated(g),
                                             name=f"s{i}",
                                             consumer=_counting_consumer(mid[i], 1)))
              for i, g in enumerate(sources)]
        assert all(m.wait(WAIT) for m in mid)
        hosts = sorted(r["executor"] for r in fleet.health(evaluate_slos=False).sessions)
        drained = fleet.scale_down(reason="test")
        caps = (fleet.target_executors, fleet.max_sessions)
        gate.set()
        outs = [h.result(timeout=WAIT) for h in hs]
        report = fleet.health(evaluate_slos=False)
    return hosts, drained, caps, outs, report, fleet


@pytest.mark.parametrize("name", ["pair_average", "temporal_median"])
def test_scale_down_drains_the_victim_through_migration(fleets, name):
    cfg = _cfg(filter_name=name, num_groups=5)
    sources = [_groups(cfg, seed=s) for s in (21, 22)]
    (jhosts, jdrained, jcaps, jouts, jreport, jfleet), \
        (hosts, drained, caps, outs, report, fleet) = _both(
            _drain, fleets, cfg, sources, slots_per_executor=1)
    assert hosts == jhosts == ["ex0", "ex1"]
    assert drained == jdrained == "ex0"
    assert caps == jcaps == (1, 3)  # the admission cap shrank with the pool
    for (out, rep), (jout, _), groups in zip(outs, jouts, sources):
        _held(cfg, out, groups, jout)
        assert rep.groups == cfg.num_groups and rep.drops == 0
    assert [rep.migrations for _, rep in outs] == [1, 0]
    assert fleet.events == jfleet.events == ["migrate@s0:ex0->ex1", "scale-down:ex0:test"]
    assert _kinds(fleet) == _kinds(jfleet) == ["session-migrated", "scale-down"]
    # a deliberate drain is never a fault
    assert report.status == jreport.status == "ok"
    assert {e.name: e.heartbeat for e in report.executors}["ex0"] == "drained"
    assert report.fleet["drained"] == ["ex0"] and report.fleet["evicted"] == []
    assert fleet.autoscale_state()["scale_downs"] == 1


@pytest.mark.parametrize("name", ["pair_average", "temporal_median"])
def test_scale_down_over_a_bank_mesh_drains_bitwise(fleets, name):
    """The gang path: each executor holds one slot per shard of
    ``BankMesh(("cpu", "cpu"))``. ``s0`` and ``s1`` fill ``ex0`` (their
    sources wait on the gate before their first group, so they gang-step
    in phase), ``s2`` runs alone on ``ex1``; draining ``ex1`` lifts
    ``s2``'s slot out of its shard, re-places it with ``elastic_reshard``
    on the mesh's first device, and queues it on ``ex0``, where it joins
    once the shards free."""
    cfg = _cfg(filter_name=name, num_groups=5)
    sources = [_groups(cfg, seed=s) for s in (31, 32, 33)]
    landed = []

    class Recording(T.FleetScheduler):
        def _on_migrate(self, ex, act):
            super()._on_migrate(ex, act)
            devices = {t.device for t in tree_leaves(act.resume_state)[0]}
            landed.append((ex.name, act.executor.name, devices))

    gate, mid = threading.Event(), threading.Event()

    def gated(groups, early):
        yield from groups[:early]
        assert gate.wait(WAIT)
        yield from groups[early:]

    fleet = fleets(PORT, cls=Recording, clock=T.FakeClock(), max_executors=2,
                   mesh=BankMesh(("cpu", "cpu")), device=None, coalesce_ms=0.0)
    with fleet:
        hs = [fleet.submit(T.Session(config=cfg, source=gated(g, 2 if i == 2 else 0),
                                     name=f"s{i}",
                                     consumer=_counting_consumer(mid, 1) if i == 2 else None))
              for i, g in enumerate(sources)]
        assert mid.wait(WAIT)
        # a beat from every executor after its next join pass: s0 and s1
        # hold ex0's shards before any of their groups exists
        assert fleet.check_faults(probe_timeout_s=WAIT)["evicted"] == []
        hosts = [r["executor"] for r in fleet.health(evaluate_slos=False).sessions]
        assert hosts == ["ex0", "ex0", "ex1"]
        assert fleet.scale_down(reason="test") == "ex1"
        gate.set()
        outs = [h.result(timeout=WAIT) for h in hs]
    for (out, rep), groups in zip(outs, sources):
        _held(cfg, out, groups)
        assert rep.groups == cfg.num_groups and rep.drops == 0
    assert [rep.migrations for _, rep in outs] == [0, 0, 1]
    assert landed == [("ex1", "ex0", {torch.device("cpu")})]
    assert fleet.events == ["migrate@s2:ex1->ex0", "scale-down:ex1:test"]


def test_scale_down_refuses_to_empty_the_pool(fleets):
    def run(pkg):
        fleet = fleets(pkg, clock=pkg.serve.FakeClock(), max_executors=1, max_sessions=2)
        with fleet:
            return fleet.scale_down(reason="nope"), fleet.target_executors, fleet.events

    assert _both(run) == ((None, 1, []), (None, 1, []))


def test_scale_up_is_bounded_by_max_executors(fleets):
    cfg = _cfg()

    def run(pkg):
        fleet = fleets(pkg, clock=pkg.serve.FakeClock(), max_executors=3, max_sessions=4,
                       slots_per_executor=1)
        with fleet:
            fleet.scale_down(reason="none-live")  # no live executor yet: a no-op
            out = [fleet.target_executors]
            fleet.target_executors = 1
            fleet.submit(pkg.serve.Session(config=pkg.cfg(cfg), source=iter(_groups(cfg)),
                                           name="u")).result(timeout=WAIT)
            out += [fleet.scale_up(5), fleet.scale_up(1), fleet.max_sessions,
                    [ex.name for ex in fleet._executors]]
            return out, list(fleet.events), fleet.autoscale_state()

    (jout, jevents, jstate), (out, events, state) = _both(run)
    # from 1 to the hard cap of 3, spawning 2 executors eagerly; then a no-op
    assert out == jout == [3, 3, 3, 6, ["ex0", "ex1", "ex2"]]
    assert events == jevents == ["scale-up:+2"]
    assert state == jstate and state["scale_ups"] == 2


def test_scale_up_over_a_bank_mesh_counts_its_shards(fleets):
    fleet = fleets(PORT, clock=T.FakeClock(), max_executors=3, mesh=BankMesh(("cpu", "cpu")),
                   device=None)
    with fleet:
        fleet.target_executors = 1
        assert fleet.scale_up(1) == 2  # both shards present: the pool may grow
        assert fleet.events == ["scale-up:+1"]


# ---------------------------------------------------------------------------
# The graceful-degradation ladder (set_degradation, shed_sessions).
# ---------------------------------------------------------------------------


def test_degradation_ladder_and_shedding_match_reference(fleets):
    cfg = _cfg(num_groups=4)
    groups = _groups(cfg)

    def run(pkg):
        gate = threading.Event()
        started = [threading.Event(), threading.Event()]

        def gated():
            yield groups[0]
            assert gate.wait(WAIT)
            yield from groups[1:]

        fleet = fleets(pkg, clock=pkg.serve.FakeClock(), slots_per_executor=2,
                       max_executors=1, coalesce_ms=0.0)
        with fleet:
            hs = [fleet.submit(pkg.serve.Session(
                config=pkg.cfg(cfg), source=gated(), name=n, priority=p,
                consumer=_counting_consumer(started[i], 0)))
                for i, (n, p) in enumerate((("gold", 10), ("best-effort", 0)))]
            assert all(s.wait(WAIT) for s in started)
            levels = [fleet.set_degradation(lv) for lv in (1, 2, 3, 9)]
            shed = fleet.shed_sessions(1)
            levels += [fleet.set_degradation(lv) for lv in (1, 0, -4)]
            gate.set()
            outs = [h.result(timeout=WAIT) for h in hs]
        return levels, shed, outs, list(fleet.events), _kinds(fleet), fleet.autoscale_state()

    (jl, jshed, jouts, jev, jkinds, jst), (levels, shed, outs, events, kinds, st) = _both(run)
    assert levels == jl == [1, 2, 3, 3, 1, 0, 0]
    assert shed == jshed == ["best-effort"]
    assert events == jev and kinds == jkinds and st == jst
    (gold, grep), (be, berep) = outs
    _held(cfg, gold, groups, jouts[0][0])  # restored before its stream went on: exact
    assert grep.groups == cfg.num_groups and grep.drops == 0
    assert berep.groups == jouts[1][1].groups
    _close(cfg, be, jouts[1][0])
