"""Fault-tolerance runtime: heartbeats, straggler detection, supervised
restart (a copy of the reference's ``repro.runtime.fault_tolerance``).

At 1000+-node scale the failure model is: (a) hard node loss (heartbeat
stops), (b) stragglers (node alive but slow — bad HBM, thermal throttle,
network congestion), (c) transient step failures (preemption, OOM). The
pieces here are host-side and framework-agnostic:

* ``HeartbeatMonitor``  — workers check in; ``dead(now)`` lists silent ones.
* ``StragglerDetector`` — per-worker EWMA of step times; flags workers
  slower than ``threshold ×`` the fleet median. Mitigation at the launcher
  level: evict + elastic re-shard (``repro_torch.runtime.elastic``), matching the
  paper's multi-bank philosophy — work is re-partitioned, state (the
  running sums / optimizer state) survives via mesh-agnostic checkpoints.
* ``Supervisor``        — run a step loop with checkpoint/restart on
  failure, bounded restarts, resumable from the latest checkpoint.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

__all__ = ["HeartbeatMonitor", "StragglerDetector", "Supervisor"]


class HeartbeatMonitor:
    def __init__(self, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self._last: dict[str, float] = {}

    def beat(self, worker: str, now: float | None = None) -> None:
        self._last[worker] = time.monotonic() if now is None else now

    def workers(self) -> list[str]:
        return sorted(self._last)

    def dead(self, now: float | None = None) -> list[str]:
        t = time.monotonic() if now is None else now
        return sorted(
            w for w, last in self._last.items() if t - last > self.timeout_s
        )

    def last_beats(self, now: float | None = None) -> dict[str, float]:
        """worker -> seconds since its last beat (the health report's
        heartbeat-age column; ``_last`` itself stays private)."""
        t = time.monotonic() if now is None else now
        return {w: t - last for w, last in self._last.items()}

    def evict(self, worker: str) -> None:
        self._last.pop(worker, None)


class StragglerDetector:
    """EWMA step-time tracking with median-relative flagging."""

    def __init__(self, *, alpha: float = 0.2, threshold: float = 1.5,
                 warmup_steps: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup_steps = warmup_steps
        self._ewma: dict[str, float] = {}
        self._count: dict[str, int] = {}

    def record(self, worker: str, step_time_s: float) -> None:
        prev = self._ewma.get(worker)
        self._ewma[worker] = (
            step_time_s if prev is None
            else self.alpha * step_time_s + (1 - self.alpha) * prev
        )
        self._count[worker] = self._count.get(worker, 0) + 1

    def _median(self) -> float:
        vals = sorted(self._ewma.values())
        if not vals:
            return 0.0
        n = len(vals)
        return vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2])

    def stragglers(self) -> list[str]:
        med = self._median()
        if med <= 0:
            return []
        return sorted(
            w
            for w, v in self._ewma.items()
            if self._count.get(w, 0) >= self.warmup_steps
            and v > self.threshold * med
        )

    def ewma(self, worker: str) -> float | None:
        return self._ewma.get(worker)

    def forget(self, worker: str) -> None:
        """Drop a worker's history (evicted workers must stop skewing the
        fleet median their replacements are judged against)."""
        self._ewma.pop(worker, None)
        self._count.pop(worker, None)


@dataclasses.dataclass
class Supervisor:
    """Checkpointed step-loop with bounded restarts.

    ``step_fn(state, step) -> state`` may raise; on failure the supervisor
    restores the latest checkpoint and resumes. ``save_every`` controls the
    checkpoint cadence (async writes via CheckpointManager).
    """

    manager: "object"              # CheckpointManager
    max_restarts: int = 3
    save_every: int = 10

    def run(
        self,
        state,
        step_fn: Callable,
        *,
        num_steps: int,
        on_restart: Callable | None = None,
    ):
        restarts = 0
        history: list[str] = []
        saved_step, ckpt_state = self.manager.latest_step(), None
        step = 0
        if saved_step is not None:
            ckpt_state, step = self.manager.restore()
            state = ckpt_state
            step = (step or 0) + 1
            history.append(f"resume@{step}")
        while step < num_steps:
            try:
                state = step_fn(state, step)
            except Exception as e:
                restarts += 1
                history.append(f"fail@{step}:{type(e).__name__}")
                if restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts; history={history}"
                    ) from e
                restored, ck_step = self.manager.restore()
                if restored is None:
                    step = 0  # no checkpoint yet: restart from scratch
                    history.append("restart@scratch")
                else:
                    state = restored
                    step = (ck_step or 0) + 1
                    history.append(f"restore@{step}")
                if on_restart is not None:
                    state = on_restart(state)
                continue
            if step % self.save_every == 0:
                self.manager.save(step, state)
            step += 1
        self.manager.wait()
        return state, history
