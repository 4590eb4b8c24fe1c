"""Declarative SLOs + multi-window burn-rate evaluation — the judgement
tier of ``repro_torch.obs`` (a copy of the reference's ``repro.obs.slo``).

The paper's contract *is* an SLO: every frame must clear the device
inside the 57 µs inter-frame interval or it is lost. The telemetry layer
records what happened; this module decides whether what happened is
*acceptable*. Four objective kinds, all declared as :class:`SloSpec`
values:

* ``deadline_miss_rate`` — ceiling on ``bad/total`` counter deltas
  (e.g. ``serve.deadline_misses`` over folded groups).
* ``frame_drop_rate`` — same shape over drop/discard counters
  (ring-overwrite drops, leave-policy discards).
* ``latency_percentile`` — percentile of a histogram must stay below a
  target (p99 service latency vs the inter-frame budget).
* ``recovery_time`` — percentile bound over observed fault-recovery
  latencies (``fleet.recovery_s``), the serving-tier availability SLO.

Evaluation follows the SRE multi-window burn-rate recipe: a *burn rate*
is how fast the error budget is being consumed relative to the allowed
rate (burn 1.0 = exactly on budget), and a breach requires the burn to
clear ``burn_threshold`` on **both** a short window (``window_s``,
responsiveness) and a long window (``long_window_s``, noise rejection).
Rates are computed from **deltas between retained
``MetricsRegistry.snapshot()``s** — the engine keeps a timestamped
snapshot history and never re-reads instrument internals.

Determinism is inherited from the tracer's design: the clock is
injectable (duck-typed ``.now() -> float``, FakeClock-compatible), so
every alerting path is testable with zero wall-clock sleeps. Breach and
budget-exhaustion transitions are edge-triggered ``slo_breach`` /
``budget_exhausted`` instants in a :class:`~repro_torch.obs.trace.Tracer`,
carrying the spec's session/executor attribution labels.

Stdlib-only, like the rest of ``repro_torch.obs``: importable before torch,
cheap enough to tick from the serve hot path (``SloEngine.maybe_evaluate``
is a clock read + float compare until ``eval_every_s`` elapses).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Any, Iterable, Sequence

from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import MetricsRegistry, _format_key, _label_key

__all__ = [
    "SLO_KINDS",
    "SloSpec",
    "SloVerdict",
    "SloEngine",
    "default_serve_slos",
]

#: objective kinds understood by the evaluator
SLO_KINDS = (
    "latency_percentile",
    "deadline_miss_rate",
    "frame_drop_rate",
    "admission_reject_rate",
    "recovery_time",
)

#: kinds evaluated as bad/total counter-delta ratios
RATE_KINDS = frozenset(
    {"deadline_miss_rate", "frame_drop_rate", "admission_reject_rate"}
)

#: kinds evaluated as a histogram percentile against a ceiling
PERCENTILE_KINDS = frozenset({"latency_percentile", "recovery_time"})


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative objective.

    ``target`` is the objective itself: for rate kinds the allowed bad
    fraction (the error budget, e.g. ``0.01`` = 99% of groups meet their
    deadline); for percentile kinds the ceiling in the metric's own unit
    (seconds). ``window_s`` is the short evaluation window;
    ``long_window_s`` defaults to 12x (the classic 5m/1h pairing scaled);
    ``budget_window_s`` (default 30x) is the horizon over which the error
    budget is accounted for ``budget_exhausted``.

    ``labels`` scope the spec to one metric series (``session=...`` /
    ``executor=...`` — these become the breach instant's attribution);
    ``aggregate=True`` instead sums counters (and merges histogram
    reservoirs) across *all* label sets of the metric, for fleet-wide
    objectives.
    """

    name: str
    kind: str
    target: float
    window_s: float
    # rate kinds: numerator / denominator metric names (denominator may be
    # a histogram — its observation count is the event total)
    bad_metric: str = ""
    total_metric: str = ""
    # percentile kinds: histogram name + percentile (100 = max)
    metric: str = ""
    percentile: float = 99.0
    long_window_s: float = 0.0
    budget_window_s: float = 0.0
    burn_threshold: float = 1.0
    #: percentile kinds only: allowed fraction of evaluations in breach
    #: over the budget window before the budget counts as exhausted
    budget: float = 0.1
    labels: Any = ()
    aggregate: bool = False

    def __post_init__(self):
        if self.kind not in SLO_KINDS:
            raise ValueError(f"kind must be one of {SLO_KINDS}, got {self.kind!r}")
        if not self.name:
            raise ValueError("spec name must be non-empty")
        if not self.window_s > 0:
            raise ValueError(f"window_s must be > 0, got {self.window_s!r}")
        if not self.target > 0:
            raise ValueError(f"target must be > 0, got {self.target!r}")
        if self.kind in RATE_KINDS:
            if self.target >= 1.0:
                raise ValueError(
                    f"rate targets are fractions in (0, 1), got {self.target!r}"
                )
            if not self.bad_metric or not self.total_metric:
                raise ValueError(f"{self.kind} needs bad_metric and total_metric")
        else:
            if not self.metric:
                raise ValueError(f"{self.kind} needs metric")
            if not 0.0 <= self.percentile <= 100.0:
                raise ValueError(f"percentile must be in [0, 100], got {self.percentile!r}")
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"budget must be in (0, 1], got {self.budget!r}")
        # normalize labels to the registry's frozen form so the spec stays
        # hashable and key formatting is shared with MetricsRegistry
        object.__setattr__(self, "labels", _label_key(dict(self.labels)))

    @property
    def effective_long_window_s(self) -> float:
        return self.long_window_s if self.long_window_s > 0 else 12.0 * self.window_s

    @property
    def effective_budget_window_s(self) -> float:
        return (
            self.budget_window_s
            if self.budget_window_s > 0
            else 30.0 * self.window_s
        )

    def labels_dict(self) -> dict:
        return dict(self.labels)


@dataclasses.dataclass
class SloVerdict:
    """One spec's judgement at one evaluation instant."""

    spec: str
    kind: str
    breached: bool
    exhausted: bool
    insufficient_data: bool
    value: float  # rate kinds: short-window bad fraction; else percentile
    target: float
    burn_short: float
    burn_long: float
    budget_remaining: float  # fraction of error budget left (can go < 0)
    events: float  # event total in the short window (0 for no data)
    window_s: float
    at: float  # engine clock time of the evaluation
    labels: dict

    @property
    def ok(self) -> bool:
        return not (self.breached or self.exhausted or self.insufficient_data)

    @property
    def status(self) -> str:
        if self.insufficient_data:
            return "no-data"
        if self.exhausted:
            return "exhausted"
        if self.breached:
            return "breach"
        return "ok"

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["status"] = self.status
        out["ok"] = self.ok
        return out


class SloEngine:
    """Evaluates a fixed set of specs over one registry's snapshots.

    Thread-safe: ``maybe_evaluate`` is called from executor threads after
    every cohort fold; the cadence check is a lock-free clock compare and
    the evaluation itself runs under one lock. ``evaluate()`` forces an
    evaluation regardless of cadence (tests and ``health()`` use this).
    """

    def __init__(
        self,
        specs: Sequence[SloSpec],
        registry: MetricsRegistry,
        *,
        tracer: Any | None = None,
        clock: Any | None = None,
        eval_every_s: float = 1.0,
    ):
        specs = list(specs)
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate spec names: {names}")
        self.specs = specs
        self.registry = registry
        self.tracer = tracer  # None -> the process-default tracer at emit time
        self.clock = clock if clock is not None else _trace._MonotonicClock()
        self.eval_every_s = eval_every_s
        self._lock = threading.Lock()
        self._last_eval = -math.inf
        self._history: deque[tuple[float, dict]] = deque()
        # per-spec edge-trigger state + percentile-kind evaluation marks
        self._breached: dict[str, bool] = {s.name: False for s in specs}
        self._exhausted: dict[str, bool] = {s.name: False for s in specs}
        self._marks: dict[str, deque[tuple[float, bool]]] = {
            s.name: deque() for s in specs
        }
        self.last_verdicts: list[SloVerdict] = []
        # self-accounting (wall time, not the injected clock) for the
        # evaluator-overhead cell in benchmarks/table16_slo.py
        self.evaluations = 0
        self.eval_time_s = 0.0
        horizon = 0.0
        for s in specs:
            horizon = max(
                horizon, s.effective_long_window_s, s.effective_budget_window_s
            )
        self._horizon_s = 1.5 * horizon

    # -- cadence --------------------------------------------------------------
    def maybe_evaluate(self) -> list[SloVerdict] | None:
        """Evaluate iff ``eval_every_s`` elapsed since the last evaluation.

        The fast path (cadence not due) is one clock read and one float
        compare — cheap enough to call per cohort fold on the serve hot
        path. Returns ``None`` when skipped.
        """
        if self.clock.now() - self._last_eval < self.eval_every_s:
            return None
        with self._lock:
            if self.clock.now() - self._last_eval < self.eval_every_s:
                return None
            return self._evaluate_locked()

    def evaluate(self) -> list[SloVerdict]:
        """Force an evaluation now (ignores cadence)."""
        with self._lock:
            return self._evaluate_locked()

    # -- core -----------------------------------------------------------------
    def _evaluate_locked(self) -> list[SloVerdict]:
        wall0 = time.perf_counter()
        now = self.clock.now()
        snap = self.registry.snapshot()
        self._history.append((now, snap))
        while self._history and now - self._history[0][0] > self._horizon_s:
            self._history.popleft()
        verdicts = [self._eval_spec(spec, now, snap) for spec in self.specs]
        for v in verdicts:
            self._emit_transitions(v)
        self.last_verdicts = verdicts
        self._last_eval = now
        self.evaluations += 1
        self.eval_time_s += time.perf_counter() - wall0
        return verdicts

    def _eval_spec(self, spec: SloSpec, now: float, snap: dict) -> SloVerdict:
        if spec.kind in RATE_KINDS:
            return self._eval_rate(spec, now, snap)
        return self._eval_percentile(spec, now, snap)

    def _eval_rate(self, spec: SloSpec, now: float, snap: dict) -> SloVerdict:
        bad_s, tot_s = self._delta(spec, now, spec.window_s, snap)
        bad_l, tot_l = self._delta(spec, now, spec.effective_long_window_s, snap)
        bad_b, tot_b = self._delta(spec, now, spec.effective_budget_window_s, snap)
        frac_s = bad_s / tot_s if tot_s > 0 else 0.0
        frac_l = bad_l / tot_l if tot_l > 0 else 0.0
        frac_b = bad_b / tot_b if tot_b > 0 else 0.0
        burn_s = frac_s / spec.target
        burn_l = frac_l / spec.target
        insufficient = tot_s <= 0 and tot_l <= 0
        breached = (
            not insufficient
            and burn_s >= spec.burn_threshold
            and burn_l >= spec.burn_threshold
        )
        remaining = 1.0 - frac_b / spec.target
        exhausted = tot_b > 0 and remaining <= 0.0
        return SloVerdict(
            spec=spec.name,
            kind=spec.kind,
            breached=breached,
            exhausted=exhausted,
            insufficient_data=insufficient,
            value=frac_s,
            target=spec.target,
            burn_short=burn_s,
            burn_long=burn_l,
            budget_remaining=remaining,
            events=tot_s,
            window_s=spec.window_s,
            at=now,
            labels=spec.labels_dict(),
        )

    def _eval_percentile(self, spec: SloSpec, now: float, snap: dict) -> SloVerdict:
        if spec.aggregate:
            value = self.registry.percentile_all(spec.metric, spec.percentile)
        else:
            value = self.registry.percentile(
                spec.metric, spec.percentile, **spec.labels_dict()
            )
        count = self._lookup(snap, spec.metric, spec.labels, spec.aggregate)
        insufficient = count <= 0
        burn = value / spec.target
        breached = not insufficient and burn > spec.burn_threshold
        # budget = fraction of evaluation marks in breach over the window
        marks = self._marks[spec.name]
        marks.append((now, breached))
        while marks and now - marks[0][0] > spec.effective_budget_window_s:
            marks.popleft()
        bad = sum(1 for _, b in marks if b)
        frac = bad / len(marks) if marks else 0.0
        remaining = 1.0 - frac / spec.budget
        exhausted = not insufficient and remaining <= 0.0
        return SloVerdict(
            spec=spec.name,
            kind=spec.kind,
            breached=breached,
            exhausted=exhausted,
            insufficient_data=insufficient,
            value=value,
            target=spec.target,
            burn_short=burn,
            burn_long=burn,
            budget_remaining=remaining,
            events=count,
            window_s=spec.window_s,
            at=now,
            labels=spec.labels_dict(),
        )

    # -- snapshot plumbing ----------------------------------------------------
    @staticmethod
    def _lookup(snap: dict, metric: str, labels: tuple, aggregate: bool) -> float:
        """Counter value / gauge value / histogram count for one metric.

        ``aggregate=True`` sums across every label set of ``metric``.
        """

        def entry_value(entry: dict) -> float:
            return entry["count"] if entry["type"] == "histogram" else entry["value"]

        if aggregate:
            total = 0.0
            prefix = metric + "{"
            for key, entry in snap.items():
                if key == metric or key.startswith(prefix):
                    total += entry_value(entry)
            return total
        entry = snap.get(_format_key(metric, labels))
        return entry_value(entry) if entry is not None else 0.0

    def _base_snapshot(self, now: float, window_s: float) -> tuple[float, dict] | None:
        """Newest retained snapshot at least ``window_s`` old.

        Falls back to the oldest retained snapshot when the engine is
        younger than the window (a partial window — deltas are still
        meaningful, just over a shorter span). Returns ``None`` when the
        only retained snapshot is the current one.
        """
        base = None
        for t, snap in self._history:
            if t <= now - window_s:
                base = (t, snap)
            else:
                break
        if base is None and len(self._history) > 1:
            base = (self._history[0][0], self._history[0][1])
        return base

    def _delta(
        self, spec: SloSpec, now: float, window_s: float, snap: dict
    ) -> tuple[float, float]:
        """(bad, total) counter deltas over ``window_s`` ending now."""
        base = self._base_snapshot(now, window_s)
        cur_bad = self._lookup(snap, spec.bad_metric, spec.labels, spec.aggregate)
        cur_tot = self._lookup(snap, spec.total_metric, spec.labels, spec.aggregate)
        if base is None:
            # first evaluation: everything observed so far is the window
            return cur_bad, cur_tot
        _, bsnap = base
        bad = cur_bad - self._lookup(bsnap, spec.bad_metric, spec.labels, spec.aggregate)
        tot = cur_tot - self._lookup(
            bsnap, spec.total_metric, spec.labels, spec.aggregate
        )
        return max(bad, 0.0), max(tot, 0.0)

    # -- instants -------------------------------------------------------------
    def _emit_transitions(self, v: SloVerdict) -> None:
        tracer = self.tracer if self.tracer is not None else _trace.get_tracer()
        was_breached = self._breached[v.spec]
        if v.breached and not was_breached:
            tracer.instant(
                "slo_breach",
                "slo",
                slo=v.spec,
                kind=v.kind,
                value=v.value,
                target=v.target,
                burn_short=v.burn_short,
                burn_long=v.burn_long,
                **v.labels,
            )
        elif was_breached and not v.breached and not v.insufficient_data:
            tracer.instant("slo_recovered", "slo", slo=v.spec, kind=v.kind, **v.labels)
        if not v.insufficient_data:
            self._breached[v.spec] = v.breached
        if v.exhausted and not self._exhausted[v.spec]:
            tracer.instant(
                "budget_exhausted",
                "slo",
                slo=v.spec,
                kind=v.kind,
                budget_remaining=v.budget_remaining,
                **v.labels,
            )
        self._exhausted[v.spec] = v.exhausted

    # -- reads ----------------------------------------------------------------
    def verdicts_dict(self) -> list[dict]:
        return [v.to_dict() for v in self.last_verdicts]


def default_serve_slos(
    *,
    deadline_miss_budget: float = 0.01,
    drop_budget: float = 0.01,
    p99_latency_s: float = 0.5,
    recovery_s: float = 60.0,
    window_s: float = 60.0,
    sessions: Iterable[str] = (),
) -> list[SloSpec]:
    """A standard serve-tier spec set over the scheduler's metric names.

    Fleet-wide by default (``aggregate=True`` over per-session series);
    pass ``sessions`` to additionally scope per-session deadline SLOs.
    The paper's own deadline is the 57 µs inter-frame interval — on a
    host CPU that is aspirational, so the latency default is a plainly
    achievable 500 ms; benchmarks and tests pass explicit targets.
    """
    specs = [
        SloSpec(
            name="serve-deadline-miss-rate",
            kind="deadline_miss_rate",
            target=deadline_miss_budget,
            window_s=window_s,
            bad_metric="serve.deadline_misses",
            total_metric="serve.latency_s",
            aggregate=True,
        ),
        SloSpec(
            name="serve-drop-rate",
            kind="frame_drop_rate",
            target=drop_budget,
            window_s=window_s,
            bad_metric="serve.discarded",
            total_metric="serve.latency_s",
            aggregate=True,
        ),
        SloSpec(
            name="serve-p99-latency",
            kind="latency_percentile",
            target=p99_latency_s,
            window_s=window_s,
            metric="serve.latency_s",
            percentile=99.0,
            aggregate=True,
        ),
        SloSpec(
            name="fleet-recovery-time",
            kind="recovery_time",
            target=recovery_s,
            window_s=window_s,
            metric="fleet.recovery_s",
            percentile=100.0,
            aggregate=True,
        ),
    ]
    for s in sessions:
        specs.append(
            SloSpec(
                name=f"deadline-miss-rate[{s}]",
                kind="deadline_miss_rate",
                target=deadline_miss_budget,
                window_s=window_s,
                bad_metric="serve.deadline_misses",
                total_metric="serve.latency_s",
                labels={"session": s},
            )
        )
    return specs
