"""Fleet health introspection — fold telemetry into one ``HealthReport``.

``FleetScheduler`` already *has* everything an operator asks ("is the
fleet ok?"): heartbeat ages, straggler EWMAs, queue depths, ring
occupancy, SLO verdicts, the fault timeline. This module folds those
into a single structured :class:`HealthReport` with three renderings —
``to_dict()`` for machines, :meth:`HealthReport.prometheus_text` for
scrapers, :meth:`HealthReport.render` for terminals — surfaced via
``FleetScheduler.health()`` and the ``scripts/healthz.py`` entry point.

The capacity reference is the paper's §6 analytic model
(``repro_torch.core.latency_model``, a copy of the reference's): for an executor's config shape,
:func:`capacity_reference` computes the camera-gated per-group floor the
FPGA pipeline would sustain (effective-II floor → model fps), and
``headroom = model group floor / achieved EWMA group time`` says how far
each executor is from that reference (≥ 1.0: keeping up with the
camera; ≪ 1.0 on a host CPU, which is expected and *informational* —
status rollup is driven by heartbeats, stragglers and SLO verdicts, not
by distance from FPGA-grade silicon).

A copy of the reference's ``repro.obs.health``. Module-level imports are
stdlib-only (the ``repro_torch.obs`` contract); ``latency_model`` is
imported lazily inside :func:`capacity_reference` because
``repro_torch.core``'s package init pulls in torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.obs.metrics import MetricsRegistry

__all__ = [
    "ExecutorHealth",
    "HealthReport",
    "capacity_reference",
    "rollup_status",
    "HEARTBEAT_STATES",
]

#: per-executor heartbeat classification, in increasing severity
#: ("drained" is terminal but healthy: a deliberate scale-down exit)
HEARTBEAT_STATES = ("healthy", "unknown", "missed", "evicted", "drained")

#: numeric encoding of report status for the prometheus rendering
STATUS_LEVELS = {"ok": 0, "degraded": 1, "critical": 2}


def capacity_reference(
    *,
    height: int,
    width: int,
    num_groups: int,
    frames_per_group: int,
    algorithm: str = "alg3",
    inter_frame_us: float = 57.0,
) -> dict:
    """Paper-§6 capacity model for one config shape.

    Returns the modeled acquisition time, frames/s, mean per-frame
    interval and the camera-gated per-group floor (the time one group of
    ``frames_per_group`` frames takes when every frame meets the
    camera's inter-frame interval) — the "expected effective-II floor"
    the headroom figure compares achieved throughput against.
    """
    from repro_torch.core import latency_model  # lazy: repro_torch.core init pulls torch

    c = latency_model.PaperConstants(
        height=height,
        width=width,
        groups=num_groups,
        frames_per_group=frames_per_group,
        inter_frame_us=inter_frame_us,
    )
    total_s = latency_model.total_time_s(algorithm, c)
    frames = num_groups * frames_per_group
    frame_interval_s = total_s / frames if frames else 0.0
    return {
        "algorithm": algorithm,
        "model_total_s": total_s,
        "model_fps": frames / total_s if total_s else 0.0,
        "frame_interval_us": frame_interval_s * 1e6,
        "group_floor_s": frames_per_group * frame_interval_s,
        "camera_fps": 1e6 / inter_frame_us if inter_frame_us else 0.0,
    }


@dataclasses.dataclass
class ExecutorHealth:
    """One executor's folded state."""

    name: str
    alive: bool
    heartbeat: str  # one of HEARTBEAT_STATES
    last_beat_age_s: float | None
    sessions: int
    queue_depth: int
    cohort_steps: int
    step_ewma_s: float | None
    straggler: bool
    #: model group floor / achieved EWMA group time (None before any step)
    headroom: float | None
    capacity: dict

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class HealthReport:
    """The whole fleet's health at one instant."""

    at: float
    status: str  # ok | degraded | critical
    executors: list[ExecutorHealth]
    sessions: list[dict]
    slos: list[dict]  # SloVerdict.to_dict() rows
    fleet: dict  # events tail, awaiting_recovery, evicted, workers
    #: elastic-tier state (``FleetScheduler.autoscale_state()``): pool
    #: size vs target, draining count, ladder rung, last scale event.
    #: Empty for schedulers without an elastic pool.
    autoscale: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "at": self.at,
            "status": self.status,
            "executors": [e.to_dict() for e in self.executors],
            "sessions": self.sessions,
            "slos": self.slos,
            "fleet": self.fleet,
            "autoscale": self.autoscale,
        }

    def prometheus_text(self) -> str:
        """Health gauges in exposition format (reuses the registry's
        escaping/HELP machinery rather than formatting by hand)."""
        reg = MetricsRegistry()
        reg.describe("health.status", "fleet status (0 ok, 1 degraded, 2 critical)")
        reg.gauge("health.status").set(STATUS_LEVELS.get(self.status, 2))
        reg.describe("health.executor.up", "executor liveness (1 alive)")
        reg.describe("health.executor.heartbeat_age_s", "seconds since last heartbeat")
        reg.describe("health.executor.queue_depth", "staged cohorts waiting")
        reg.describe("health.executor.sessions", "sessions hosted")
        reg.describe(
            "health.executor.headroom",
            "model group floor / achieved group time (>=1 keeps camera pace)",
        )
        for ex in self.executors:
            labels = {"executor": ex.name}
            reg.gauge("health.executor.up", **labels).set(1.0 if ex.alive else 0.0)
            if ex.last_beat_age_s is not None:
                reg.gauge("health.executor.heartbeat_age_s", **labels).set(
                    ex.last_beat_age_s
                )
            reg.gauge("health.executor.queue_depth", **labels).set(ex.queue_depth)
            reg.gauge("health.executor.sessions", **labels).set(ex.sessions)
            if ex.headroom is not None:
                reg.gauge("health.executor.headroom", **labels).set(ex.headroom)
        reg.describe("health.session.ring_occupancy", "frames resident in ring")
        for s in self.sessions:
            if s.get("ring_occupancy") is not None:
                reg.gauge(
                    "health.session.ring_occupancy", session=s["name"]
                ).set(s["ring_occupancy"])
        reg.describe("health.slo.ok", "SLO verdict (1 ok, 0 breach/exhausted)")
        for v in self.slos:
            reg.gauge("health.slo.ok", slo=v["spec"]).set(1.0 if v["ok"] else 0.0)
        if self.autoscale:
            a = self.autoscale
            reg.describe("health.autoscale.pool_size", "live executors")
            reg.describe("health.autoscale.pool_target", "autoscaler target")
            reg.describe("health.autoscale.draining", "executors draining out")
            reg.describe(
                "health.autoscale.degradation_level",
                "graceful-degradation ladder rung (0 normal .. 3 shed)",
            )
            reg.gauge("health.autoscale.pool_size").set(a.get("pool_size", 0))
            reg.gauge("health.autoscale.pool_target").set(
                a.get("target_executors", 0)
            )
            reg.gauge("health.autoscale.draining").set(a.get("draining", 0))
            reg.gauge("health.autoscale.degradation_level").set(
                a.get("degradation_level", 0)
            )
        return reg.prometheus_text()

    def render(self) -> str:
        """Human-readable terminal rendering."""
        lines = [f"fleet health: {self.status.upper()}  (t={self.at:.3f})"]
        lines.append(
            f"  executors ({len(self.executors)}):"
        )
        for ex in self.executors:
            beat = (
                f"beat {ex.last_beat_age_s:.1f}s ago"
                if ex.last_beat_age_s is not None
                else "no beat"
            )
            head = f"headroom {ex.headroom:.3g}" if ex.headroom is not None else "headroom n/a"
            flags = []
            if ex.straggler:
                flags.append("STRAGGLER")
            if not ex.alive:
                flags.append("DOWN")
            lines.append(
                f"    {ex.name:<8} {ex.heartbeat:<8} {beat:<18} "
                f"sessions={ex.sessions} queue={ex.queue_depth} "
                f"steps={ex.cohort_steps} {head}"
                + (" [" + ",".join(flags) + "]" if flags else "")
            )
        if self.sessions:
            lines.append(f"  sessions ({len(self.sessions)}):")
            for s in self.sessions:
                ring = (
                    f" ring={s['ring_occupancy']}"
                    if s.get("ring_occupancy") is not None
                    else ""
                )
                lines.append(
                    f"    {s['name']:<12} on {s.get('executor', '?'):<8}"
                    f" steps={s.get('steps', 0)}{ring}"
                )
        if self.slos:
            lines.append(f"  slos ({len(self.slos)}):")
            for v in self.slos:
                lines.append(
                    f"    {v['spec']:<28} {v['status']:<10}"
                    f" value={v['value']:.4g} target={v['target']:.4g}"
                    f" budget={v['budget_remaining']:+.2f}"
                )
        if self.autoscale:
            a = self.autoscale
            last = a.get("last_scale_event") or "none"
            lines.append(
                "  autoscale: "
                f"pool={a.get('pool_size', 0)}/"
                f"{a.get('target_executors', 0)} "
                f"(max {a.get('max_executors', 0)}) "
                f"draining={a.get('draining', 0)} "
                f"ladder={a.get('degradation', 'normal')}"
                f"({a.get('degradation_level', 0)}) "
                f"last-scale={last}"
            )
        fl = self.fleet
        lines.append(
            "  fleet: "
            f"evicted={fl.get('evicted', [])} "
            f"awaiting_recovery={fl.get('awaiting_recovery', [])}"
        )
        for ev in fl.get("events", []):
            lines.append(f"    event: {ev}")
        return "\n".join(lines)


def rollup_status(
    executors: Sequence[ExecutorHealth], slos: Sequence[dict]
) -> str:
    """Fold per-part states into one status.

    critical: a missed heartbeat, a dead-but-not-evicted executor, or a
    breached/exhausted SLO. degraded: stragglers, low error budget
    (< 25% remaining), or SLOs still without data — except
    ``recovery_time`` specs, where no data means no failures have
    happened yet (silence is the healthy state, not missing telemetry).
    Headroom is deliberately informational (see module docstring).
    """
    critical = False
    degraded = False
    for ex in executors:
        if ex.heartbeat == "missed" or (
            not ex.alive and ex.heartbeat not in ("evicted", "drained")
        ):
            critical = True
        if ex.straggler or ex.heartbeat == "unknown":
            degraded = True
    for v in slos:
        if v.get("status") in ("breach", "exhausted"):
            critical = True
        elif v.get("status") == "no-data":
            if v.get("kind") != "recovery_time":
                degraded = True
        elif v.get("budget_remaining", 1.0) < 0.25:
            degraded = True
    if critical:
        return "critical"
    return "degraded" if degraded else "ok"


def classify_heartbeat(
    name: str,
    *,
    evicted: set,
    dead: set,
    beats: dict,
    drained: set = frozenset(),
) -> tuple[str, float | None]:
    """(state, age_s) for one executor given the monitor's folded view.

    ``beats`` maps worker -> seconds since its last heartbeat. Severity
    order is drained > evicted > missed > healthy > unknown (an evicted
    worker stays evicted even though the monitor no longer tracks it;
    ``drained`` — a deliberate scale-down exit — takes precedence so a
    shrink never reads as a fault).
    """
    age = beats.get(name)
    if name in drained:
        return "drained", age
    if name in evicted:
        return "evicted", age
    if name in dead:
        return "missed", age
    if age is not None:
        return "healthy", age
    return "unknown", None
