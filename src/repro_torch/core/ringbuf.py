"""Bounded ring buffer with backpressure — paper §5 generalized past depth 2.

The paper's DRAM pipeline hides acquisition latency behind compute with two
ping-pong banks: the camera writes bank A while the kernel reads bank B,
then they swap. ``RingBuffer`` is the software analogue with configurable
depth: ``num_slots`` device- (or host-) resident slots, a producer cursor
and a consumer cursor chasing each other around the ring, and *backpressure*
closing the loop — the producer blocks when every slot is occupied, the
consumer blocks when none is. ``num_slots=2`` is exactly the paper's
ping-pong pair; deeper rings absorb rate jitter (bursty camera readout,
compile/GC pauses in the consumer) that a depth-2 ring surfaces as stalls.

Contract (relied on by ``repro_torch.core.streaming.run_pipelined``):

* **FIFO, exactly-once** under the default ``policy="block"``: every item
  ``put`` is ``get`` exactly once, in order. The producer blocks while the
  ring is full — no frame is ever lost to overflow.
* **drop-oldest** under ``policy="drop_oldest"``: ``put`` never blocks;
  when the ring is full the *oldest* undelivered item is discarded (and
  counted in ``stats.drops``) to make room. This is the real-time camera
  mode — the consumer always sees the freshest window of the stream.
* **close semantics**: ``close()`` marks the stream finished. Blocked
  waiters wake immediately; ``get`` keeps draining buffered items and
  raises ``RingClosed`` only once the ring is empty; ``put`` after close
  raises ``RingClosed``. Iterating a ring (``for item in ring``) yields
  until that point.
* **timing**: the ring timestamps every slot. ``stats.put_wait_s`` is
  producer time blocked on a full ring (backpressure engaged),
  ``stats.get_wait_s`` consumer time blocked on an empty ring (starvation),
  ``stats.dwell_s`` total put→get slot residency, and the occupancy
  counters sample queue depth at each ``put``. Per-item dwell times are
  additionally kept in the bounded ``stats.dwell_samples`` (the newest
  ``MAX_DWELL_SAMPLES`` items, round-robin) so per-stream latency
  *percentiles* — the p50/p95/p99 columns of ``StreamReport`` and the
  per-session QoS accounting of the reference's ``repro.serve`` — can be computed without
  unbounded memory; ``stats.dwell_percentile_s(q)`` is the nearest-rank
  helper (dependency-free, like the rest of this module).
* **notify hook**: an optional zero-arg ``notify_hook`` callable fires
  after every successful ``put`` and after ``close()`` — *outside* the
  ring lock, so the hook may take other locks freely. The session
  scheduler uses it to wake one executor multiplexing many rings without
  polling; single-ring executors leave it unset.

The ring stores whatever the producer puts — ``run_pipelined`` puts
device-resident tensors so that, like the paper's DRAM banks,
the slots hold data already resident where the kernel can read it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Iterator

from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

__all__ = [
    "RingBuffer",
    "RingStats",
    "RingClosed",
    "POLICIES",
    "MAX_DWELL_SAMPLES",
    "nearest_rank_s",
]

POLICIES = ("block", "drop_oldest")

#: bound on per-ring dwell-sample retention (oldest overwritten first)
MAX_DWELL_SAMPLES = 4096


class RingClosed(Exception):
    """Raised by ``get`` on a drained closed ring, or ``put`` after close."""


@dataclasses.dataclass
class RingStats:
    """Counters and timers accumulated over the life of one ring."""

    puts: int = 0            # items accepted (includes later-dropped ones)
    gets: int = 0            # items delivered to the consumer
    drops: int = 0           # oldest items discarded (drop_oldest only)
    put_wait_s: float = 0.0  # producer blocked on full ring (backpressure)
    get_wait_s: float = 0.0  # consumer blocked on empty ring (starvation)
    dwell_s: float = 0.0     # total put->get residency of delivered items
    occupancy_sum: int = 0   # depth sampled just after each put ...
    occupancy_max: int = 0   # ... and its running maximum
    last_dwell_s: float = 0.0  # dwell of the most recently delivered item
    #: per-item dwell times, newest MAX_DWELL_SAMPLES kept (round-robin)
    dwell_samples: list[float] = dataclasses.field(default_factory=list)

    @property
    def occupancy_mean(self) -> float:
        """Mean queue depth seen by the producer (1.0 = no overlap ahead)."""
        return self.occupancy_sum / self.puts if self.puts else 0.0

    @property
    def dwell_mean_s(self) -> float:
        return self.dwell_s / self.gets if self.gets else 0.0

    def dwell_percentile_s(self, q: float) -> float:
        """Nearest-rank percentile of the retained dwell samples.

        ``q`` in [0, 100] (``ValueError`` otherwise); well-defined on
        every buffer state — 0.0 with no samples yet, the sample itself
        for a single-sample buffer, never NaN (non-finite samples are
        filtered) and never IndexError. Dependency-free (this module
        deliberately imports neither numpy nor torch), which is why
        nearest-rank, not interpolation — ample for the p50/p95/p99
        telemetry columns.
        """
        return nearest_rank_s(self.dwell_samples, q)


def nearest_rank_s(samples: list[float], q: float) -> float:
    """Nearest-rank percentile over raw (unsorted) seconds samples.

    Thin alias of :func:`repro_torch.obs.metrics.nearest_rank` (kept for the
    many existing call sites in the serve/banks layers): validates ``q``,
    drops non-finite samples, returns 0.0 on empty input.
    """
    return _obs_metrics.nearest_rank(samples, q)


class RingBuffer:
    """Bounded FIFO of ``num_slots`` slots with blocking backpressure.

    Thread-safe for any number of producers/consumers (the executors use
    one of each per ring). See the module docstring for the contract.
    """

    def __init__(
        self,
        num_slots: int,
        *,
        policy: str = "block",
        notify_hook: Callable[[], None] | None = None,
        name: str = "",
    ):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        self._slots: list[Any] = [None] * num_slots
        self._t_put: list[float] = [0.0] * num_slots
        self._head = 0  # consumer cursor: absolute index of next get
        self._tail = 0  # producer cursor: absolute index of next put
        self._policy = policy
        self._closed = False
        self._cond = threading.Condition()
        self._notify_hook = notify_hook
        self.name = name  # trace attribution: which ring blocked, not just that one did
        self.stats = RingStats()

    # -- introspection ------------------------------------------------------
    @property
    def num_slots(self) -> int:
        return len(self._slots)

    @property
    def policy(self) -> str:
        return self._policy

    @property
    def closed(self) -> bool:
        return self._closed

    def set_notify_hook(self, hook: Callable[[], None] | None) -> None:
        """Re-target the consumer-wake hook. The fleet layer moves a live
        session's ring between executors (migration, crash recovery); the
        new consumer must be the one woken by subsequent puts."""
        with self._cond:
            self._notify_hook = hook

    def set_policy(self, policy: str) -> None:
        """Switch the overflow policy mid-stream.

        The fleet's degradation ladder downshifts a live ``block``
        session to ``drop_oldest`` under overload (and restores it once
        the breach clears) without touching buffered items. A producer
        currently blocked on a full ring is woken: under the new
        ``drop_oldest`` policy its pending ``put`` sheds the oldest
        staged item and lands instead of waiting.
        """
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        with self._cond:
            self._policy = policy
            self._cond.notify_all()

    def __len__(self) -> int:
        """Occupied slots (racy outside the lock; exact for single threads)."""
        return self._tail - self._head

    # -- producer side ------------------------------------------------------
    def put(self, item: Any, timeout: float | None = None) -> None:
        """Enqueue ``item``; block while full under ``policy='block'``.

        Under ``drop_oldest`` a full ring discards its oldest undelivered
        item instead (counted in ``stats.drops``) and never blocks.
        Raises ``RingClosed`` if the ring was closed, ``TimeoutError`` if
        ``timeout`` (seconds) elapses while blocked.
        """
        n = len(self._slots)
        with self._cond:
            if self._closed:
                # checked before any eviction: a put racing close() must
                # not shed a buffered item the consumer is promised
                raise RingClosed("put on closed ring")
            if self._policy == "drop_oldest" and self._tail - self._head == n:
                self._slots[self._head % n] = None
                self._head += 1
                self.stats.drops += 1
            if self._tail - self._head == n:  # only time actual blocking:
                # an always-on timer/span would smear epsilon over every call
                # and make "did backpressure engage?" (put_wait_s > 0) vacuous
                with _obs_trace.span("ring.put_wait", "ring", ring=self.name):
                    t0 = time.perf_counter()
                    deadline = None if timeout is None else t0 + timeout
                    while (
                        not self._closed
                        and self._policy == "block"
                        and self._tail - self._head == n
                    ):
                        # single deadline across wakeups (notify_all means a
                        # losing waiter would otherwise re-arm a fresh timeout
                        # forever), and time out only with the ring still full
                        # at the loop top — a slot freed concurrently with the
                        # deadline must win, as in queue.Queue. A mid-wait
                        # set_policy("drop_oldest") also ends the wait: the
                        # put then sheds the oldest item below and lands.
                        left = None if deadline is None else deadline - time.perf_counter()
                        if left is not None and left <= 0:
                            self.stats.put_wait_s += time.perf_counter() - t0
                            raise TimeoutError(
                                f"put timed out after {timeout}s (ring full, "
                                f"backpressure held for the whole wait)"
                            )
                        self._cond.wait(left)
                    self.stats.put_wait_s += time.perf_counter() - t0
                    if (
                        not self._closed
                        and self._policy == "drop_oldest"
                        and self._tail - self._head == n
                    ):
                        self._slots[self._head % n] = None
                        self._head += 1
                        self.stats.drops += 1
            if self._closed:
                raise RingClosed("put on closed ring")
            slot = self._tail % n
            self._slots[slot] = item
            self._t_put[slot] = time.perf_counter()
            self._tail += 1
            self.stats.puts += 1
            depth = self._tail - self._head
            self.stats.occupancy_sum += depth
            self.stats.occupancy_max = max(self.stats.occupancy_max, depth)
            self._cond.notify_all()
        # outside the ring lock: the hook may take the caller's own lock
        # (executor wake-up) without nesting against this ring's
        if self._notify_hook is not None:
            self._notify_hook()

    # -- consumer side ------------------------------------------------------
    def get(self, timeout: float | None = None) -> Any:
        """Dequeue the oldest item; block while empty.

        Raises ``RingClosed`` once the ring is closed *and* drained,
        ``TimeoutError`` if ``timeout`` (seconds) elapses while blocked.
        """
        n = len(self._slots)
        with self._cond:
            if not self._closed and self._tail == self._head:
                with _obs_trace.span("ring.get_wait", "ring", ring=self.name):
                    t0 = time.perf_counter()
                    deadline = None if timeout is None else t0 + timeout
                    while not self._closed and self._tail == self._head:
                        left = None if deadline is None else deadline - time.perf_counter()
                        if left is not None and left <= 0:
                            self.stats.get_wait_s += time.perf_counter() - t0
                            raise TimeoutError(
                                f"get timed out after {timeout}s (ring empty)"
                            )
                        self._cond.wait(left)
                    self.stats.get_wait_s += time.perf_counter() - t0
            if self._tail == self._head:  # closed and drained
                raise RingClosed("get on closed, drained ring")
            slot = self._head % n
            item = self._slots[slot]
            self._slots[slot] = None  # drop the reference: slot is free DRAM
            dwell = time.perf_counter() - self._t_put[slot]
            self.stats.dwell_s += dwell
            self.stats.last_dwell_s = dwell
            if len(self.stats.dwell_samples) < MAX_DWELL_SAMPLES:
                self.stats.dwell_samples.append(dwell)
            else:  # overwrite oldest: gets counts delivered items so far
                self.stats.dwell_samples[self.stats.gets % MAX_DWELL_SAMPLES] = dwell
            self._head += 1
            self.stats.gets += 1
            self._cond.notify_all()
            return item

    def close(self) -> None:
        """Mark the stream finished and wake all blocked waiters.

        Idempotent. Buffered items remain readable; see the close
        semantics in the module docstring.
        """
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._notify_hook is not None:
            self._notify_hook()

    def __iter__(self) -> Iterator[Any]:
        """Drain the ring until it is closed and empty."""
        while True:
            try:
                yield self.get()
            except RingClosed:
                return
