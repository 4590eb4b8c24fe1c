"""Session abstraction for the multi-tenant streaming service (counterpart
of ``repro.serve.session``).

A :class:`Session` is one tenant's PRISM stream: its own chunk source
(camera / replay iterator), its own ``DenoiseConfig`` + filter, its own
bounded staging ring with its own overflow policy, and its own QoS class:

* ``mode="block"`` — lossless: the acquisition thread blocks on a full
  ring (backpressure), every group reaches the filter. This is the mode
  whose output is bit-identical to ``run_pipelined`` on the same chunks.
* ``mode="drop_oldest"`` — real-time: a full ring sheds its oldest staged
  group (counted in the report) so the session always folds the freshest
  window; ``finalize`` then averages only the surviving groups, exactly
  like ``run_pipelined(policy="drop_oldest")``.
* ``deadline_ms`` — soft per-group deadline: a group whose service
  latency (staged → device step done) exceeds it counts as a
  ``deadline_misses`` in the report. Accounting only — the scheduler
  never preempts a step.

Submitting a session to a :class:`~repro_torch.serve.scheduler.SessionScheduler`
returns a :class:`SessionHandle`; ``handle.result()`` blocks until the
session's stream is finalized and yields ``(output, SessionReport)``.
``handle.leave()`` detaches the session at the next group boundary,
finalizing whatever it ingested — the mid-stream *leave* of the service
contract (mid-stream *join* is just submitting while others run).

:class:`SessionReport` extends the executor-wide ``StreamReport`` with the
per-session columns: which session, its QoS mode/deadline, deadline
misses, admission-queue wait, and groups folded. The latency percentile
columns inherited from ``StreamReport`` carry *full service latency*
here — staged chunk → banked device step complete — not just queue
pickup.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np

from repro_torch.core.denoise import DenoiseConfig
from repro_torch.core.ringbuf import POLICIES
from repro_torch.core.streaming import StreamReport

__all__ = ["AdmissionError", "Session", "SessionHandle", "SessionReport"]


class AdmissionError(RuntimeError):
    """Raised by ``SessionScheduler.submit`` when admission control
    rejects a session (max in-flight sessions reached, or the matching
    executor's join queue is already at its depth limit)."""


@dataclasses.dataclass
class Session:
    """One tenant stream: source + config + QoS (see module docstring).

    ``source`` yields (N, H, W) chunks like any executor source;
    ``config`` must be single-bank (``num_banks == 1``) — the scheduler
    owns the bank axis as its session-slot axis. ``mode`` / ``num_slots``
    default to the config's ``overflow_policy`` / ``num_slots``.
    ``consumer`` is the per-step partial hook, same contract as
    ``run_pipelined``'s (called ``consumer(step, partial)`` after each
    folded group, on the executor thread — keep it light).
    """

    config: DenoiseConfig
    source: Iterable[np.ndarray]
    name: str = ""
    mode: str | None = None
    deadline_ms: float | None = None
    num_slots: int | None = None
    consumer: Callable[[int, Any], None] | None = None
    #: QoS rank for overload shedding: when the degradation ladder must
    #: shed, the *lowest* priority sessions go first (ties: newest
    #: first). Purely relative — any ints work; default 0.
    priority: int = 0

    def __post_init__(self):
        if self.config.num_banks != 1:
            raise ValueError(
                "sessions are single-bank streams (the scheduler owns the "
                f"bank axis); got num_banks={self.config.num_banks}"
            )
        if self.mode is not None and self.mode not in POLICIES:
            raise ValueError(
                f"mode must be one of {POLICIES} (or None for the config "
                f"default), got {self.mode!r}"
            )
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {self.deadline_ms}")
        if self.num_slots is not None and self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")

    @property
    def qos_mode(self) -> str:
        return self.mode or self.config.overflow_policy

    @property
    def ring_slots(self) -> int:
        return self.num_slots or self.config.num_slots

    def chunks(self) -> Iterator[np.ndarray]:
        return iter(self.source)


@dataclasses.dataclass
class SessionReport(StreamReport):
    """``StreamReport`` plus the per-session service columns.

    The inherited latency percentiles are *service* latency (staged →
    step complete) rather than queue pickup; ``drops`` counts both
    ``drop_oldest`` ring evictions and groups discarded by an early
    ``leave()``.
    """

    session: str = ""
    mode: str = "block"
    deadline_ms: float = 0.0  # 0.0 = no deadline configured
    deadline_misses: int = 0
    queue_wait_s: float = 0.0  # submit -> slot join (admission queueing)
    groups: int = 0            # groups folded into the final output
    # fleet columns (zero outside a FleetScheduler): live migrations,
    # crash/eviction re-placements, and checkpoints written
    migrations: int = 0
    restarts: int = 0
    checkpoints: int = 0

    @staticmethod
    def header() -> str:
        """CSV header; the ``StreamReport`` columns come first, so rows
        stay parseable by anything that reads the executor CSVs."""
        return (
            StreamReport.header()
            + ",session,mode,deadline_ms,deadline_misses,queue_wait_s,groups"
            + ",migrations,restarts,checkpoints"
        )

    def row(self, name: str) -> str:
        return (
            super().row(name)
            + f",{self.session},{self.mode},{self.deadline_ms:.1f},"
            f"{self.deadline_misses},{self.queue_wait_s:.4f},{self.groups}"
            + f",{self.migrations},{self.restarts},{self.checkpoints}"
        )


class SessionHandle:
    """Future-like view of a submitted session.

    ``status`` walks ``queued -> active -> done|failed``; ``result()``
    blocks for the terminal state and either returns ``(output,
    SessionReport)`` or re-raises the session's error.
    """

    def __init__(self, session: Session):
        self.session = session
        self._done = threading.Event()
        self._out = None
        self._report: SessionReport | None = None
        self._error: BaseException | None = None
        self._leave = threading.Event()
        self._leave_hook: Callable[[], None] | None = None  # executor wake-up
        # fleet-side migration request; picked up at the next group
        # boundary by the hosting executor (FleetScheduler.migrate sets it)
        self._migrate = threading.Event()
        self.status = "queued"

    # -- caller side --------------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def leave(self) -> None:
        """Detach at the next group boundary: stop ingesting, finalize the
        groups folded so far (staged-but-unfolded chunks count as drops)."""
        self._leave.set()
        if self._leave_hook is not None:
            self._leave_hook()

    def result(self, timeout: float | None = None):
        """Block until the session finalizes; ``(output, SessionReport)``."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"session {self.session.name or '<unnamed>'} not done "
                f"after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._out, self._report

    @property
    def report(self) -> SessionReport | None:
        """The report once done (None while running)."""
        return self._report

    # -- scheduler side -----------------------------------------------------
    def _finish(self, out, report: SessionReport) -> None:
        self._out, self._report = out, report
        self.status = "done"
        self._done.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self.status = "failed"
        self._done.set()
