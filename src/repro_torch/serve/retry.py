"""Jittered-exponential retry — the admission-pressure absorber (a copy of
the reference's ``repro.serve.retry``).

Rung 1 of the serve tier's graceful-degradation ladder: a tenant whose
``submit`` is refused by admission control does not give up, it backs
off and retries — absorbing short overload spikes without shedding any
session. The helper is deliberately generic (any callable, any
retryable exception set) so the fleet, the load generator and tests all
share one backoff implementation instead of three ad-hoc loops.

Determinism contract (matches ``repro_torch.serve.faults``):

* the delay schedule is *jittered exponential* —
  ``delay_k = min(max_s, base_s * 2**k) * (1 - jitter + jitter * u_k)``
  with ``u_k`` drawn from an **injectable** ``random.Random``; a seeded
  rng gives a bit-identical schedule on every run;
* time is an injectable :class:`~repro_torch.serve.faults.Clock`; when it is
  a ``FakeClock`` (anything with ``advance``), waiting *is*
  ``clock.advance(delay)`` — zero wall-clock sleeps, so a scripted
  flash crowd's retry traffic replays exactly in virtual time;
* ``on_retry(attempt, delay_s, error)`` fires before each wait — the
  scheduler hooks its ``serve.admission_retry`` counter here, which is
  the numerator of the autoscaler's admission-pressure SLO.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Sequence

from repro_torch.serve.faults import Clock
from repro_torch.serve.session import AdmissionError

__all__ = ["BackoffPolicy", "retry_with_backoff"]


class BackoffPolicy:
    """The delay schedule, separated from the retry loop so the
    autoscaler's ladder can widen it (higher base) without touching the
    loop. ``jitter`` in [0, 1] is the *spread*: 0 is deterministic full
    delay, 1 lets a draw land anywhere in (0, delay]."""

    def __init__(
        self,
        *,
        retries: int = 5,
        base_s: float = 0.05,
        max_s: float = 2.0,
        jitter: float = 0.5,
        rng: random.Random | None = None,
    ):
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if base_s <= 0:
            raise ValueError(f"base_s must be > 0, got {base_s}")
        if max_s < base_s:
            raise ValueError(f"max_s must be >= base_s, got {max_s}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.retries = retries
        self.base_s = base_s
        self.max_s = max_s
        self.jitter = jitter
        self.rng = rng if rng is not None else random.Random()

    def delay_s(self, attempt: int) -> float:
        """Jittered delay before retry ``attempt`` (0-based)."""
        full = min(self.max_s, self.base_s * (2.0 ** attempt))
        if self.jitter == 0.0:
            return full
        return full * (1.0 - self.jitter + self.jitter * self.rng.random())


def retry_with_backoff(
    fn: Callable[[], Any],
    *,
    retries: int = 5,
    base_s: float = 0.05,
    max_s: float = 2.0,
    jitter: float = 0.5,
    rng: random.Random | None = None,
    clock: Clock | None = None,
    retry_on: Sequence[type] = (AdmissionError,),
    on_retry: Callable[[int, float, BaseException], None] | None = None,
    policy: BackoffPolicy | None = None,
):
    """Call ``fn`` until it succeeds or the retry budget is spent.

    Only exceptions in ``retry_on`` are retried — anything else
    propagates immediately (a failed source is not admission pressure).
    After the last refused attempt the *original* exception is re-raised
    unchanged, so callers keep their existing ``except AdmissionError``
    handling. Pass ``policy`` to reuse a prepared schedule (the ladder
    does); otherwise one is built from the keyword knobs.
    """
    pol = policy if policy is not None else BackoffPolicy(
        retries=retries, base_s=base_s, max_s=max_s, jitter=jitter, rng=rng
    )
    clk = clock if clock is not None else Clock()
    retry_on = tuple(retry_on)
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if attempt >= pol.retries:
                raise
            delay = pol.delay_s(attempt)
            if on_retry is not None:
                on_retry(attempt, delay, e)
            _wait(clk, delay)
            attempt += 1


def _wait(clock: Clock, delay_s: float) -> None:
    """Advance virtual time when the clock supports it, else sleep.

    A ``FakeClock`` makes the whole backoff schedule virtual — the
    scripted-overload tests and ``benchmarks/table17_autoscale.py``
    replay retry storms with zero wall-clock waits.
    """
    advance = getattr(clock, "advance", None)
    if callable(advance):
        advance(delay_s)
    else:
        time.sleep(delay_s)
