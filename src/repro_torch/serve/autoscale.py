"""SLO-driven autoscaler for the fleet's elastic executor pool
(counterpart of ``repro.serve.autoscale``, copied, not imported; it drives
the port's :class:`~repro_torch.serve.fleet.FleetScheduler`).

One control loop closes the robustness story: the
:class:`~repro_torch.obs.slo.SloEngine` says *whether* the fleet is keeping
its promises (multi-window burn rates over metric snapshots), the
paper-§6 capacity model (:func:`repro_torch.core.latency_model.capacity_plan`)
says *how many* executors the offered load needs, and the
:class:`Autoscaler` turns both into pool actions:

* **Scale up** when SLOs burn and the pool is below its ceiling —
  ``FleetScheduler.scale_up`` raises the target, lifts the admission
  cap, and eager-spawns an executor so reaction time is one control
  tick, not one lazy placement.
* **Degrade** when SLOs burn and the pool *cannot* grow (device or
  ``max_executors`` ceiling): climb the graceful-degradation ladder one
  rung per breached evaluation — admission backoff, then in-place
  downshift of lossless sessions to ``drop_oldest`` rings, then
  shedding the lowest-priority sessions.
* **Restore / scale down** when the breach clears: descend the ladder
  one rung per clean evaluation first (full fidelity comes back before
  any capacity leaves), then — after a longer cooldown, and only while
  the capacity plan says the pool is oversized — drain one executor,
  live-migrating its sessions off through the elastic reshard path.

Hysteresis is explicit: a breach must persist ``breach_streak``
consecutive evaluations before the first action, a recovery must
persist ``clear_streak`` before any restore, and scale-ups/-downs have
independent clock cooldowns (read from the fleet's injectable clock, so
tests drive the whole loop from a ``FakeClock`` without a single
wall-clock sleep). Evaluations where every SLO is still ``no-data``
advance neither streak — silence is not evidence in either direction.

The autoscaler never spawns threads; call :meth:`Autoscaler.evaluate`
from the operator's pump loop (or a test/benchmark) at whatever cadence
suits the deployment.
"""

from __future__ import annotations

import dataclasses

from repro_torch import obs
from repro_torch.core.latency_model import capacity_plan
from repro_torch.obs.slo import SloSpec
from repro_torch.serve.retry import BackoffPolicy

__all__ = ["Autoscaler", "AutoscaleDecision", "admission_pressure_slo"]

#: verdict statuses that count as an active breach
_BREACH = ("breach", "exhausted")


def admission_pressure_slo(
    *, budget: float = 0.25, window_s: float = 2.0, name: str = "admission_pressure"
) -> SloSpec:
    """The overload signal the autoscaler closes its loop on: the
    fraction of ``submit`` attempts admission control rejected, judged
    over one window (short = long = budget window, so the verdict
    clears after a single clean window — the controller's own hysteresis
    provides the damping). Deterministic under gated sources because the
    in-flight session cap depends only on session *counts*, never on
    executor-thread timing."""
    return SloSpec(
        name=name,
        kind="admission_reject_rate",
        target=budget,
        window_s=window_s,
        long_window_s=window_s,
        budget_window_s=window_s,
        bad_metric="serve.admission_rejected",
        total_metric="serve.submit_attempts",
    )


@dataclasses.dataclass
class AutoscaleDecision:
    """What one :meth:`Autoscaler.evaluate` tick decided and why."""

    at: float
    action: str  # hold | scale-up | scale-down | degrade | restore | shed
    reason: str
    breached: bool
    breach_streak: int
    clear_streak: int
    target_executors: int
    degradation_level: int
    planned_executors: int
    shed: list[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Autoscaler:
    """Close the loop between SLO verdicts and the elastic pool.

    ``fleet`` must be a :class:`~repro_torch.serve.fleet.FleetScheduler`
    constructed with SLO specs (it owns the engine and the clock).
    ``min_executors``/``max_executors`` bound the target this controller
    will ever set (``max_executors`` defaults to the fleet's own hard
    cap). ``planner_headroom`` over-provisions the capacity plan by that
    factor — the safety margin between "mathematically enough" and
    "enough under jitter".
    """

    def __init__(
        self,
        fleet,
        *,
        min_executors: int = 1,
        max_executors: int | None = None,
        initial_executors: int | None = None,
        breach_streak: int = 1,
        clear_streak: int = 2,
        cooldown_up_s: float = 0.0,
        cooldown_down_s: float = 30.0,
        planner_headroom: float = 1.25,
        shed_batch: int = 1,
    ):
        if fleet.slo_engine is None:
            raise ValueError(
                "Autoscaler needs a fleet built with SLO specs (slos=[...]); "
                "burn-rate verdicts are its only breach signal"
            )
        if min_executors < 1:
            raise ValueError(f"min_executors must be >= 1, got {min_executors}")
        self.fleet = fleet
        self.min_executors = min_executors
        self.max_executors = (
            min(max_executors, fleet.max_executors)
            if max_executors is not None
            else fleet.max_executors
        )
        if self.max_executors < self.min_executors:
            raise ValueError(
                f"max_executors={self.max_executors} < "
                f"min_executors={self.min_executors}"
            )
        if breach_streak < 1 or clear_streak < 1:
            raise ValueError("breach_streak and clear_streak must be >= 1")
        self.breach_streak = breach_streak
        self.clear_streak = clear_streak
        self.cooldown_up_s = cooldown_up_s
        self.cooldown_down_s = cooldown_down_s
        self.planner_headroom = planner_headroom
        self.shed_batch = shed_batch
        self.clock = fleet.clock
        self._breach_run = 0
        self._clear_run = 0
        self._last_up_t = float("-inf")
        self._last_down_t = float("-inf")
        self._last_decision: AutoscaleDecision | None = None
        # pin the initial target inside this controller's band; an
        # explicit initial_executors starts the pool small (scale-to-fit
        # deployments) and moves the admission cap with it — growing it
        # back is exactly what scale_up does later
        want = (
            initial_executors
            if initial_executors is not None
            else fleet.target_executors
        )
        want = max(self.min_executors, min(want, self.max_executors))
        delta = want - fleet.target_executors
        fleet.target_executors = want
        if delta:
            fleet.max_sessions = max(
                1, fleet.max_sessions + delta * fleet.slots_per_executor
            )

    # -- capacity planning ---------------------------------------------------
    def plan(self) -> dict:
        """Paper-§6 capacity plan for the *current* inflight load,
        clamped to this controller's band. The planner is the forward
        model (how many executors the demand needs); the SLO verdicts
        are the feedback signal — scale-downs require both to agree."""
        snap = self.fleet.stats()
        sessions = int(snap.get("in_flight", 0))
        p = capacity_plan(
            sessions=sessions,
            slots_per_executor=self.fleet.slots_per_executor,
            target_headroom=self.planner_headroom,
        )
        p["clamped_executors"] = max(
            self.min_executors, min(p["executors"], self.max_executors)
        )
        return p

    # -- degraded-admission helpers ------------------------------------------
    def backoff_policy(self) -> BackoffPolicy:
        """Admission backoff sized to the current ladder rung: at L0 the
        normal jittered-exponential defaults; from L1 up, wider budgets
        (more retries, longer base) so joins survive longer overload
        without hammering admission."""
        level = self.fleet.degradation_level
        if level < 1:
            return BackoffPolicy()
        return BackoffPolicy(
            retries=5 + 3 * level,
            base_s=0.05 * (2**level),
            max_s=2.0 * level,
        )

    def admission_config(self, config):
        """The cheaper config variant rung >= 2 admits *new* arrivals
        under: u8 wire quantization (half the ingest bandwidth),
        ``drop_oldest`` overflow, and the ``xla`` backend when the
        original asked for the pallas path (which has no u8 ingest for
        the alg1/2 baselines). Below rung 2, the config is returned
        unchanged."""
        if self.fleet.degradation_level < 2:
            return config
        return dataclasses.replace(
            config,
            stream_dtype="u8",
            overflow_policy="drop_oldest",
            backend="xla" if config.backend == "pallas" else config.backend,
        )

    # -- the control tick ----------------------------------------------------
    def evaluate(self) -> AutoscaleDecision:
        """One control tick: read SLO verdicts, update hysteresis
        streaks, and take at most one pool action. Deterministic given
        the fleet's clock and metric state."""
        now = self.clock.now()
        verdicts = self.fleet.slo_engine.evaluate()
        breached = any(v.status in _BREACH for v in verdicts)
        all_silent = bool(verdicts) and all(
            v.status == "no-data" for v in verdicts
        )
        if breached:
            self._breach_run += 1
            self._clear_run = 0
        elif all_silent or not verdicts:
            pass  # no evidence either way: freeze both streaks
        else:
            self._clear_run += 1
            self._breach_run = 0
        plan = self.plan()
        decision = self._act(now, breached, plan)
        self._last_decision = decision
        obs.instant(
            "autoscale.decision", "fleet", action=decision.action,
            reason=decision.reason, breached=breached,
            target=decision.target_executors,
            level=decision.degradation_level,
        )
        return decision

    def _act(self, now: float, breached: bool, plan: dict) -> AutoscaleDecision:
        fleet = self.fleet

        def decide(action: str, reason: str, shed=()) -> AutoscaleDecision:
            return AutoscaleDecision(
                at=now,
                action=action,
                reason=reason,
                breached=breached,
                breach_streak=self._breach_run,
                clear_streak=self._clear_run,
                target_executors=fleet.target_executors,
                degradation_level=fleet.degradation_level,
                planned_executors=plan["clamped_executors"],
                shed=list(shed),
            )

        if breached and self._breach_run >= self.breach_streak:
            if now - self._last_up_t < self.cooldown_up_s:
                return decide("hold", "scale-up cooldown")
            before = fleet.target_executors
            if before < self.max_executors:
                want = max(before + 1, plan["clamped_executors"])
                got = fleet.scale_up(
                    min(want, self.max_executors) - before,
                    reason="slo-breach",
                )
                if got > before:
                    self._last_up_t = now
                    return decide("scale-up", f"slo breach, target {got}")
                # the fleet refused (device ceiling): fall through to the
                # ladder — capacity cannot come from hardware that isn't
                # there, so it must come from fidelity
            level = fleet.degradation_level
            if level < 3:
                fleet.set_degradation(level + 1)
                return decide(
                    "degrade", f"pool at ceiling, ladder -> L{level + 1}"
                )
            shed = fleet.shed_sessions(self.shed_batch)
            return decide(
                "shed" if shed else "hold",
                "ladder exhausted: shedding lowest-priority sessions"
                if shed
                else "ladder exhausted, nothing left to shed",
                shed=shed,
            )
        if not breached and self._clear_run >= self.clear_streak:
            level = fleet.degradation_level
            if level > 0:
                fleet.set_degradation(level - 1)
                return decide(
                    "restore", f"breach clear, ladder -> L{level - 1}"
                )
            if (
                fleet.target_executors > max(
                    self.min_executors, plan["clamped_executors"]
                )
                and now - self._last_down_t >= self.cooldown_down_s
            ):
                drained = fleet.scale_down(reason="over-provisioned")
                if drained is not None:
                    self._last_down_t = now
                    return decide(
                        "scale-down", f"plan says shrink, drained {drained}"
                    )
            return decide("hold", "healthy")
        return decide("hold", "within hysteresis")

    # -- introspection -------------------------------------------------------
    def state(self) -> dict:
        """Controller + fleet elastic state, one dict (the healthz
        surface)."""
        s = self.fleet.autoscale_state()
        s.update(
            min_executors=self.min_executors,
            autoscaler_max_executors=self.max_executors,
            breach_streak=self._breach_run,
            clear_streak=self._clear_run,
            last_action=(
                self._last_decision.action if self._last_decision else None
            ),
            last_reason=(
                self._last_decision.reason if self._last_decision else None
            ),
        )
        return s
