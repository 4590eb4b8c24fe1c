"""Trace-driven load generator for the serving tier (counterpart of
``repro.serve.loadgen``, copied, not imported: every draw comes from the
caller's ``numpy.random.Generator`` in the reference's order, so one seed
gives the reference's floats bit for bit).

Overload behaviour is only trustworthy when the *load* is reproducible,
so this module separates the three layers that usually get tangled in
ad-hoc benchmark loops:

1. **Arrival schedules** — pure functions from an explicit
   ``numpy.random.Generator`` to sorted arrival times:
   :func:`poisson_schedule` (open-loop Poisson, exponential gaps),
   :func:`diurnal_schedule` (Poisson thinned by a sinusoidal day curve),
   and :func:`flash_crowd_schedule` (steady base load plus a burst
   window — the autoscaler's canonical stress input).
2. **Session shapes** — :func:`heavy_tail_groups` draws bounded-Pareto
   stream lengths (most sessions short, a heavy tail of long-running
   ones), and :class:`TenantProfile` describes one tenant class: its
   ``DenoiseConfig`` (filter/shape mix), relative traffic ``weight``,
   and shedding ``priority``.
3. **The trace** — :func:`build_trace` folds schedules + profiles +
   lengths into a flat list of :class:`ArrivalEvent`, and
   :func:`replay_trace` drives it against any submit callback,
   advancing the injected clock to each arrival instant. Under a
   ``FakeClock`` the whole replay is virtual-time deterministic — zero
   wall-clock sleeps — which is how the autoscale tests and
   ``chip_smoke.py``'s elastic phase replay identical overloads run after
   run.

Everything downstream (what a "submit" does, whether sources are gated,
how results are judged) stays with the caller; the generator owns only
*when* and *what kind* of work arrives.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.denoise import DenoiseConfig

__all__ = [
    "ArrivalEvent",
    "TenantProfile",
    "build_trace",
    "diurnal_schedule",
    "flash_crowd_schedule",
    "heavy_tail_groups",
    "poisson_schedule",
    "replay_trace",
]


@dataclasses.dataclass(frozen=True)
class TenantProfile:
    """One tenant class in a mixed workload.

    ``weight`` sets its share of arrivals (relative to the other
    profiles in the mix); ``priority`` is carried onto each generated
    session so the degradation ladder sheds the right tenants first.
    """

    name: str
    config: DenoiseConfig
    weight: float = 1.0
    priority: int = 0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One scheduled session arrival: when, who, and how much work."""

    t: float
    session: str
    profile: str
    groups: int
    priority: int = 0


# -- arrival schedules -------------------------------------------------------
def poisson_schedule(
    rate_hz: float, duration_s: float, *, rng: np.random.Generator
) -> list[float]:
    """Open-loop Poisson arrivals: exponential inter-arrival gaps at
    ``rate_hz``, truncated to ``[0, duration_s)``."""
    if rate_hz < 0:
        raise ValueError(f"rate_hz must be >= 0, got {rate_hz}")
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    if rate_hz == 0:
        return []
    out: list[float] = []
    t = float(rng.exponential(1.0 / rate_hz))
    while t < duration_s:
        out.append(t)
        t += float(rng.exponential(1.0 / rate_hz))
    return out


def diurnal_schedule(
    peak_hz: float,
    duration_s: float,
    *,
    period_s: float | None = None,
    floor: float = 0.1,
    rng: np.random.Generator,
) -> list[float]:
    """Poisson arrivals thinned by a raised-cosine "day" curve.

    The instantaneous rate swings between ``floor * peak_hz`` (trough)
    and ``peak_hz`` (peak) over ``period_s`` (default: one period spans
    the whole duration). Implemented by thinning a ``peak_hz`` Poisson
    stream — each candidate survives with probability rate(t)/peak — so
    the output is itself a non-homogeneous Poisson process.
    """
    if not 0 <= floor <= 1:
        raise ValueError(f"floor must be in [0, 1], got {floor}")
    period = period_s if period_s is not None else duration_s
    if period <= 0:
        raise ValueError(f"period_s must be > 0, got {period}")
    lo = floor
    out: list[float] = []
    for t in poisson_schedule(peak_hz, duration_s, rng=rng):
        phase = 2.0 * math.pi * (t / period)
        accept = lo + (1.0 - lo) * 0.5 * (1.0 - math.cos(phase))
        if rng.random() < accept:
            out.append(t)
    return out


def flash_crowd_schedule(
    base_hz: float,
    burst_hz: float,
    *,
    burst_at_s: float,
    burst_s: float,
    duration_s: float,
    rng: np.random.Generator,
) -> list[float]:
    """Steady ``base_hz`` Poisson load plus a ``burst_hz`` Poisson burst
    inside ``[burst_at_s, burst_at_s + burst_s)`` — the flash crowd the
    autoscaler must absorb. Returns the merged, sorted arrival times."""
    if burst_at_s < 0 or burst_s <= 0:
        raise ValueError(
            f"need burst_at_s >= 0 and burst_s > 0, got "
            f"{burst_at_s}/{burst_s}"
        )
    base = poisson_schedule(base_hz, duration_s, rng=rng)
    burst_len = min(burst_s, max(0.0, duration_s - burst_at_s))
    burst = (
        [burst_at_s + t for t in poisson_schedule(burst_hz, burst_len, rng=rng)]
        if burst_len > 0
        else []
    )
    for t in burst:
        bisect.insort(base, t)
    return base


# -- session shapes ----------------------------------------------------------
def heavy_tail_groups(
    n: int,
    *,
    alpha: float = 1.4,
    min_groups: int = 1,
    max_groups: int = 64,
    rng: np.random.Generator,
) -> list[int]:
    """Bounded-Pareto session lengths, in groups: mass near
    ``min_groups`` with a heavy tail toward ``max_groups`` (tail index
    ``alpha`` — smaller is heavier). The bound keeps a single draw from
    dominating a deterministic benchmark run."""
    if min_groups < 1 or max_groups < min_groups:
        raise ValueError(
            f"need 1 <= min_groups <= max_groups, got "
            f"{min_groups}/{max_groups}"
        )
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    out: list[int] = []
    for _ in range(n):
        u = float(rng.random())
        raw = min_groups * (1.0 - u) ** (-1.0 / alpha)
        out.append(int(min(max_groups, max(min_groups, math.floor(raw)))))
    return out


# -- trace assembly + replay -------------------------------------------------
def build_trace(
    profiles: Sequence[TenantProfile],
    arrival_times: Sequence[float],
    *,
    rng: np.random.Generator,
    alpha: float = 1.4,
    min_groups: int = 1,
    max_groups: int = 64,
    name_prefix: str = "lg",
) -> list[ArrivalEvent]:
    """Fold arrival times + a tenant mix + heavy-tailed lengths into a
    replayable trace. Profile assignment is a weighted draw per arrival;
    session names are ``{prefix}{i}-{profile}`` so traces stay
    greppable in exported Chrome traces."""
    if not profiles:
        raise ValueError("need at least one TenantProfile")
    weights = np.asarray([p.weight for p in profiles], dtype=np.float64)
    weights = weights / weights.sum()
    picks = rng.choice(len(profiles), size=len(arrival_times), p=weights)
    lengths = heavy_tail_groups(
        len(arrival_times),
        alpha=alpha,
        min_groups=min_groups,
        max_groups=max_groups,
        rng=rng,
    )
    trace = []
    for i, (t, pick, groups) in enumerate(
        zip(sorted(arrival_times), picks, lengths)
    ):
        p = profiles[int(pick)]
        trace.append(
            ArrivalEvent(
                t=float(t),
                session=f"{name_prefix}{i}-{p.name}",
                profile=p.name,
                groups=groups,
                priority=p.priority,
            )
        )
    return trace


def replay_trace(
    trace: Sequence[ArrivalEvent],
    *,
    clock,
    submit: Callable[[ArrivalEvent], object],
    on_tick: Callable[[float], None] | None = None,
) -> list[object]:
    """Drive a trace against ``submit(event)`` in arrival order.

    The clock is advanced to each event's instant before its submit —
    virtually when it exposes ``advance`` (``FakeClock``), by sleeping
    the gap otherwise. ``on_tick(now)`` fires after each advance (the
    place to pump ``Autoscaler.evaluate`` at arrival granularity).
    Returns whatever ``submit`` returned, one entry per event, in order;
    a submit that raises propagates (wrap it if rejection is data, not
    failure)."""
    advance = getattr(clock, "advance", None)
    results: list[object] = []
    for ev in sorted(trace, key=lambda e: e.t):
        gap = ev.t - clock.now()
        if gap > 0:
            if callable(advance):
                advance(gap)
            else:
                time.sleep(gap)
        if on_tick is not None:
            on_tick(clock.now())
        results.append(submit(ev))
    return results
