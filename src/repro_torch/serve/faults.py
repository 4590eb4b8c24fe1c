"""Deterministic fault injection for the fleet serving layer (a copy of
the reference's ``repro.serve.faults``).

The fleet's failure modes (executor crash, stall, slow-step) are scripted
here so tests and benchmarks can reproduce them *exactly*: every fault is
keyed by an executor's **cohort step index** — the count of device steps
that executor has issued — never by wall-clock time. There are no sleeps
anywhere in the harness; a "stall" is a ``threading.Event`` the test
releases, and a "slow step" adds *virtual* seconds to the duration the
executor reports to the straggler detector (and to the injectable clock).

Pieces:

* :class:`Clock` / :class:`FakeClock` — the time source the fleet's
  heartbeat/straggler machinery reads. Executors call ``clock.now()``
  around each cohort fold; tests drive a :class:`FakeClock` with
  ``advance`` so "60 s of heartbeat silence" is one method call, not a
  real minute.
* :class:`FaultPlan` — the script. ``crash(ex, at_step=k)`` raises
  :class:`InjectedExecutorFailure` inside executor ``ex`` just before its
  ``k``-th cohort fold; ``stall(ex, at_step=k)`` blocks the executor
  thread there until the test calls ``release(ex)`` (or ``poison(ex)``
  first, in which case release raises — the eviction handshake);
  ``slow(ex, extra_s=..., from_step=k)`` adds virtual seconds to every
  reported step duration from ``k`` on.
* The executor side calls exactly one method, ``apply(name, step)``,
  at the top of each cohort fold — before any ring item is consumed, so
  a crashed or stalled step never half-eats a session's staged chunk.

The contract tests rely on: faults fire at step boundaries only, a
stalled executor has consumed nothing, ``wait_stalled``/``wait_crashed``
are bounded event waits (no polling), and a released stall on a poisoned
executor terminates the thread cleanly instead of letting it touch
sessions the fleet already re-placed.
"""

from __future__ import annotations

import threading
import time

__all__ = [
    "Clock",
    "FakeClock",
    "FaultPlan",
    "InjectedExecutorFailure",
]


class InjectedExecutorFailure(RuntimeError):
    """Raised inside an executor thread by a scripted crash (or by a
    released stall on a poisoned executor)."""


class Clock:
    """Real time source (monotonic). The fleet reads only ``now()``."""

    def now(self) -> float:
        return time.monotonic()


class FakeClock(Clock):
    """Test-controlled virtual time: ``now()`` only moves via ``advance``."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"advance needs dt >= 0, got {dt}")
        with self._lock:
            self._now += dt
            return self._now


class _Stall:
    """One scripted stall: the executor blocks on ``released``; the test
    observes ``entered`` (set the moment the executor arrives)."""

    def __init__(self):
        self.entered = threading.Event()
        self.released = threading.Event()


class FaultPlan:
    """Scripted faults keyed by ``(executor name, cohort step index)``.

    Thread-safe; builder methods return ``self`` so scripts chain::

        plan = FaultPlan().crash("ex0", at_step=2).slow("ex1", extra_s=0.5)
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._crash: dict[str, set[int]] = {}
        self._stall: dict[str, dict[int, _Stall]] = {}
        self._slow: list[tuple[str, int, int | None, float]] = []
        self._poisoned: set[str] = set()
        self._crashed: dict[str, threading.Event] = {}
        #: applied faults, for assertions: (kind, executor, step)
        self.log: list[tuple[str, str, int]] = []

    # -- script side ---------------------------------------------------------
    def crash(self, executor: str, *, at_step: int) -> "FaultPlan":
        """Raise :class:`InjectedExecutorFailure` before cohort ``at_step``."""
        with self._lock:
            self._crash.setdefault(executor, set()).add(at_step)
            self._crashed.setdefault(executor, threading.Event())
        return self

    def stall(self, executor: str, *, at_step: int) -> "FaultPlan":
        """Block the executor thread before cohort ``at_step`` until
        ``release(executor)``; heartbeats stop while it is held."""
        with self._lock:
            self._stall.setdefault(executor, {})[at_step] = _Stall()
        return self

    def slow(
        self,
        executor: str,
        *,
        extra_s: float,
        at_step: int | None = None,
        from_step: int = 0,
    ) -> "FaultPlan":
        """Add ``extra_s`` *virtual* seconds to the reported duration of
        one step (``at_step``) or every step from ``from_step`` on."""
        if extra_s < 0:
            raise ValueError(f"extra_s must be >= 0, got {extra_s}")
        with self._lock:
            if at_step is not None:
                self._slow.append((executor, at_step, at_step, extra_s))
            else:
                self._slow.append((executor, from_step, None, extra_s))
        return self

    # -- test orchestration side ---------------------------------------------
    def wait_stalled(self, executor: str, timeout: float = 30.0) -> bool:
        """Bounded wait until the executor is actually held in a stall."""
        stalls = self._stall.get(executor, {})
        for s in list(stalls.values()):
            if s.entered.wait(timeout):
                return True
        return False

    def wait_crashed(self, executor: str, timeout: float = 30.0) -> bool:
        """Bounded wait until a scripted crash has fired in the executor."""
        ev = self._crashed.get(executor)
        return bool(ev and ev.wait(timeout))

    def release(self, executor: str) -> None:
        """Let a stalled executor continue (it raises instead if the
        executor was poisoned — the post-eviction handshake)."""
        for s in self._stall.get(executor, {}).values():
            s.released.set()

    def poison(self, executor: str) -> None:
        """Mark an executor evicted: any current or future ``apply`` on it
        raises once released, so a zombie thread can never step sessions
        the fleet already re-placed elsewhere."""
        with self._lock:
            self._poisoned.add(executor)
        self.release(executor)

    def crashed(self, executor: str) -> bool:
        ev = self._crashed.get(executor)
        return bool(ev and ev.is_set())

    # -- executor side -------------------------------------------------------
    def apply(self, executor: str, step: int) -> float:
        """Called by the executor before cohort ``step``. May raise
        (crash / poisoned), may block (stall), and returns the virtual
        extra seconds this step should report (slow)."""
        with self._lock:
            poisoned = executor in self._poisoned
            crash_now = not poisoned and step in self._crash.get(executor, ())
            stall_now = (
                None if poisoned else self._stall.get(executor, {}).get(step)
            )
        if poisoned:
            raise InjectedExecutorFailure(
                f"executor {executor} was evicted while faulted"
            )
        if crash_now:
            with self._lock:
                self.log.append(("crash", executor, step))
            self._crashed[executor].set()
            raise InjectedExecutorFailure(
                f"scripted crash of {executor} at cohort step {step}"
            )
        if stall_now is not None:
            with self._lock:
                self.log.append(("stall", executor, step))
            stall_now.entered.set()
            stall_now.released.wait()
            with self._lock:
                poisoned = executor in self._poisoned
            if poisoned:
                raise InjectedExecutorFailure(
                    f"executor {executor} was evicted during a stall at "
                    f"cohort step {step}"
                )
        extra = 0.0
        with self._lock:
            for name, lo, hi, extra_s in self._slow:
                if name == executor and step >= lo and (hi is None or step <= hi):
                    extra += extra_s
            if extra:
                self.log.append(("slow", executor, step))
        return extra
