"""SessionScheduler: multiplex many PRISM sessions over shared executors
(counterpart of ``repro.serve.scheduler``).

The executors in ``repro_torch.core`` serve exactly one stream per call.
This module turns them into a *service*: N tenants submit
:class:`Session`\\ s and a shared pool of slot executors co-schedules them
on the device.

Topology (one ``_SlotExecutor`` shown; the scheduler pools several)::

    tenant sources (one acquisition thread each)
      s0 ──RingBuffer(block)───────┐
      s1 ──RingBuffer(drop_oldest)─┤        batched banked filter state
      s2 ──RingBuffer(block)───────┼──▶  ┌─────────────────────────────┐
      s3 ──(slot vacant: join q)───┘     │ slot0 slot1 slot2 slot3     │
                                         │  one filter state per slot  │
             executor thread: gather ──▶ │  stacked along the bank axis│
             ready chunks, one banked    └─────────────────────────────┘
             ``filt.step`` per cohort            │ leave: slot_extract
                                                 ▼        + finalize
                                         (output, SessionReport)

* **Device.** ``SessionScheduler(device=None)`` runs on CUDA unless the
  caller names another device, and raises ``RuntimeError`` when CUDA is
  absent; the tests pass ``device="cpu"``. Each session's acquisition
  thread lands its chunks through its own ``_Stager`` (a pinned host
  copy and a ``non_blocking`` copy on the session's side stream); the
  executor thread ``adopt``\\ s each chunk before stepping it, so the
  compute stream waits on the copy and the caching allocator cannot hand
  the chunk's memory to a later copy early.
* **Slot hosting.** Each executor owns one *banked* filter state of
  fixed ``capacity`` slots (``banks.banked_filter_init(config, mesh=None,
  banks=capacity)``) — the same state the bank executor steps, reused as
  a *session-slot array*. Joining writes a fresh single-bank ``init()``
  state into a vacant slot in place (``StreamingFilter.slot_insert``);
  leaving extracts the slot (``slot_extract``) and finalizes it. Shapes
  never change across joins and leaves.
* **Cohort stepping.** Each round the executor folds every slot with a
  staged chunk: a lone ready slot takes the *single-bank* step path
  (the calls ``run_pipelined`` makes — this is why a 1-session run equals
  the single-stream executor bit for bit, for every filter); several
  ready slots go through ONE banked step (``slot_gather`` → banked
  ``step`` → ``slot_scatter``, or in place when the whole capacity is
  ready). Phase-sensitive filters (``phase_invariant = False``) are
  cohorted by group index; the pair-average family batches slots at any
  phase. A bounded coalescing window (``coalesce_ms``, default 5) lets
  co-pacing tenants form *full* cohorts, which skip the gather/scatter:
  the resident state steps in place, and the chunks are copied into one
  persistent ``(capacity, N, H, W)`` staging buffer instead of a fresh
  stack per group.
* **Compatibility.** Sessions share an executor iff their configs'
  ``DenoiseConfig.stream_key()`` match (same filter, shapes, parameters —
  scheduling-only fields excluded). Unlike keys get their own executor
  from the pool.
* **Admission control.** ``max_sessions`` caps in-flight sessions
  (queued + active); a matching executor whose join queue is already
  ``max_waiting`` deep rejects too. Both raise :class:`AdmissionError`.
* **QoS.** Per session: ``block`` (lossless backpressure) vs
  ``drop_oldest`` (real-time, freshest window, drops counted) staging
  rings, plus a soft ``deadline_ms`` per group (misses counted in the
  report). Per-group service latency (staged → step done on the device)
  feeds the p50/p95/p99 columns of :class:`SessionReport`.
* **Bank meshes.** Pass a :class:`~repro_torch.core.banks.BankMesh` and
  each executor holds one slot per mesh device, stepped through
  ``banked_filter_step`` (one session per bank shard). Mesh executors
  gang-schedule: a step waits until every occupied slot has a chunk (the
  per-group barrier of ``run_pipelined_banked``); vacant slots ride along
  on a dummy chunk and are re-initialized at join.
* **Fleet hooks** (``clock``, ``faults``, ``on_step``,
  ``on_session_step``, ``on_dead``, ``on_migrate``, ``on_beat``,
  ``on_cohort``, ``seize``, ``draining``, ``resume_state``) are the
  reference's; under the plain scheduler they are ``None`` or inert.
* **Errors are recorded, never re-run.** A failed source, consumer or
  hook fails its session (``act.error``); a failed step fails its
  executor (``failed``) and with it the executor's sessions. Nothing
  falls back to another device or a plain version.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Sequence

import torch

from repro_torch import obs
from repro_torch.core.banks import banked_filter_init, banked_filter_step
from repro_torch.core.denoise import DenoiseConfig
from repro_torch.core.ringbuf import RingBuffer, RingClosed
from repro_torch.core.streaming import _Stager
from repro_torch.kernels import ops
from repro_torch.serve.faults import Clock
from repro_torch.serve.session import (
    AdmissionError,
    Session,
    SessionHandle,
    SessionReport,
)

__all__ = ["SessionScheduler"]


def _wait(devices) -> None:
    """Block until the work this thread queued on ``devices`` is done (the
    reference's ``block_until_ready``): the compute stream that ran the
    step, not the sessions' copy streams still staging later chunks."""
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


class _Active:
    """One submitted session's scheduler-side bookkeeping."""

    def __init__(
        self,
        handle: SessionHandle,
        seq: int,
        notify_hook,
        metrics: obs.MetricsRegistry | None = None,
        *,
        device: torch.device,
    ):
        self.handle = handle
        self.session = handle.session
        self.seq = seq
        self.ring = RingBuffer(
            self.session.ring_slots,
            policy=self.session.qos_mode,
            notify_hook=notify_hook,
            name=self.name,
        )
        self.slot: int | None = None
        # lands this session's chunks on the scheduler's device, on a copy
        # stream of its own (every producer thread stages concurrently)
        self.stager = _Stager(device)
        # steps/frames are *operational state*, not telemetry: crash
        # recovery rewinds them to the checkpointed values (fleet._recover)
        # and replay re-advances them, so they must stay plain fields —
        # monotonic counters could not be rewound.
        self.steps = 0           # groups folded so far (this session's phase)
        self.frames = 0
        # Append-only accounting lives in the scheduler's MetricsRegistry,
        # labeled by session; SessionReport columns derive from it (_report).
        self.metrics = metrics if metrics is not None else obs.MetricsRegistry()
        self.c_transfer = self.metrics.counter("serve.transfer_s", session=self.name)
        self.c_compute = self.metrics.counter("serve.compute_s", session=self.name)
        self.c_misses = self.metrics.counter("serve.deadline_misses", session=self.name)
        self.c_discarded = self.metrics.counter("serve.discarded", session=self.name)
        # per-group service latency samples (staged -> step done), bounded
        # reservoir so endless streams stay O(1)
        self.h_latency = self.metrics.histogram("serve.latency_s", session=self.name)
        self.error: BaseException | None = None
        # -- fleet bookkeeping (inert under the plain scheduler) ------------
        self.executor = None          # the _SlotExecutor currently hosting us
        self.resume_state = None      # slot state to seat instead of init()
        self.pending_replay: list = []  # chunks to re-fold at (re)admission
        self.replay: list = []        # chunks folded since the last checkpoint
        self.migrations = 0
        self.restarts = 0
        self.checkpoints = 0
        # overload-ladder state: sticky once the session was ever
        # downshifted to a drop_oldest ring — finalize must then average
        # only the surviving groups (finalize(steps=G) with zero actual
        # drops is bit-identical to finalize(), so the restored
        # full-fidelity output is exact)
        self.downshifted = False
        self.shed = False
        self.migrate_done = threading.Event()  # set when a migrate() lands
        self.migrate_target: str | None = None  # executor that took us
        self.t_submit = time.perf_counter()
        self.t_joined: float | None = None
        self.producer = threading.Thread(
            target=self._produce,
            name=f"serve-src-{self.name}",
            daemon=True,
        )

    @property
    def name(self) -> str:
        return self.session.name or f"s{self.seq}"

    def _produce(self) -> None:
        """Acquisition thread: pull + land chunks on device, stage them.

        Runs from submit time — a queued session prefills its ring while
        waiting for a slot (under its own overflow policy, so a queued
        real-time session sheds stale groups exactly like a running one).
        ``_Stager.stage`` returns once the copy has landed, so the
        transfer time is the landed time; the executor ``adopt``\\ s the
        chunk before stepping it.
        """
        src = self.session.chunks()
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    chunk = next(src)
                except StopIteration:
                    break
                staged = self.stager.stage(chunk)
                # staged-time bookkeeping lives in the ring itself (its
                # per-slot put timestamps are taken post-backpressure), so
                # the item carries only the transfer cost
                self.ring.put((staged, time.perf_counter() - t0))
        except RingClosed:
            pass  # executor detached us (leave/shutdown/error)
        except BaseException as e:  # source failure -> fail the session
            self.error = e
        finally:
            self.ring.close()

    def record_latency(self, lat: float) -> None:
        self.h_latency.observe(lat)

    def finished_stream(self) -> bool:
        return self.ring.closed and len(self.ring) == 0


class _SlotExecutor:
    """One batched filter state of ``capacity`` slots + its step thread.

    Without a mesh the state is one banked state of ``capacity`` slots on
    ``device``; with a :class:`BankMesh` it is the bank executor's list of
    per-shard states, one slot on each mesh device (``capacity`` equals
    the mesh's bank count).
    """

    def __init__(
        self, key, config: DenoiseConfig, capacity, mesh, name, on_done,
        coalesce_s: float = 0.005, *, clock: Clock | None = None, faults=None,
        on_step=None, on_session_step=None, on_dead=None, on_migrate=None,
        on_beat=None, on_cohort=None, metrics: obs.MetricsRegistry | None = None,
        device: torch.device,
    ):
        self.key = key
        self.config = config
        self.capacity = capacity
        self.mesh = mesh
        self.name = name
        self.coalesce_s = coalesce_s
        self.on_done = on_done  # scheduler callback, called lock-free
        # -- fleet hooks (all optional; None under the plain scheduler) -----
        self.clock = clock or Clock()
        self.faults = faults              # FaultPlan.apply(name, step) source
        self.on_step = on_step            # (executor, duration_s) per cohort
        self.on_session_step = on_session_step  # (ex, act, slot, chunk)
        self.on_dead = on_dead            # (ex, acts, err) -> acts taken over
        self.on_migrate = on_migrate      # (ex, act) after slot extraction
        self.on_beat = on_beat            # (name, clock.now()) liveness beat
        self.on_cohort = on_cohort        # () after each cohort fold (SLO tick)
        self.metrics = metrics if metrics is not None else obs.MetricsRegistry()
        self.device = device
        #: the devices a step runs on: the mesh's shards, or ``device``
        self.devices = tuple(mesh.devices) if mesh is not None else (device,)
        self.filt, self.state = banked_filter_init(
            config, mesh, banks=capacity, device=None if mesh is not None else device
        )
        self._chunk_buf = None  # persistent staging buffer, filled in place
        self.slots: list[_Active | None] = [None] * capacity
        self.pending: collections.deque[_Active] = collections.deque()
        self.cond = threading.Condition()
        self.failed: BaseException | None = None
        self._shutdown = False
        self._abort = False
        #: elastic scale-down: a draining executor keeps stepping its
        #: remaining sessions but ``_place`` never seats new ones on it
        self.draining = False
        self._dead = False     # set (under cond) once this executor will
        self._folding = False  # never drain pending again / is mid-fold
        self._seized = False   # a fleet evictor owns the drain, not us
        self.cohort_steps = 0  # device steps issued (cohorts, not groups)
        self.thread = threading.Thread(
            target=self._loop, name=f"serve-{name}", daemon=True
        )
        self.thread.start()

    @property
    def alive(self) -> bool:
        return self.failed is None and not self._shutdown

    def notify(self) -> None:
        with self.cond:
            self.cond.notify_all()

    # -- scheduler side ------------------------------------------------------
    def enqueue(self, act: _Active) -> bool:
        """Queue a session for a slot; ``False`` when this executor can no
        longer host it. The dead-check and the append are one atomic
        section: an executor that failed *after* placement chose it (but
        before the enqueue landed) refuses the session instead of parking
        it in a queue nobody will ever drain again — the caller re-places.
        """
        with self.cond:
            if self._dead or self.failed is not None or self._abort:
                return False
            act.executor = self
            self.pending.append(act)
            self.cond.notify_all()
            return True

    def has_room(self) -> bool:
        """A vacant slot not already promised to a queued session."""
        with self.cond:
            free = sum(a is None for a in self.slots)
            return len(self.pending) < free

    def queue_depth(self) -> int:
        """Sessions that cannot be seated even once the executor catches
        up on joins — the depth admission control limits. Queued sessions
        that a vacant slot is already waiting for don't count (otherwise
        admission would depend on executor-thread timing)."""
        with self.cond:
            free = sum(a is None for a in self.slots)
            return max(0, len(self.pending) - free)

    def session_count(self) -> int:
        with self.cond:
            return len(self.pending) + sum(a is not None for a in self.slots)

    def stop(self, abort: bool = False) -> None:
        with self.cond:
            self._shutdown = True
            self._abort = self._abort or abort
            self.cond.notify_all()

    # -- executor thread -----------------------------------------------------
    def _wake_needed(self) -> bool:
        if self._shutdown or self.pending:
            return True
        return any(
            a is not None
            and (
                len(a.ring) > 0
                or a.finished_stream()
                or a.handle._leave.is_set()
                or a.handle._migrate.is_set()
                or a.error is not None
            )
            for a in self.slots
        )

    def _loop(self) -> None:
        while True:
            if self.on_beat is not None:
                self.on_beat(self.name, self.clock.now())
            with self.cond:
                # hooks (ring put/close, enqueue, leave) wake us; the
                # timeout is a safety net against a lost edge, not a poll
                self.cond.wait_for(self._wake_needed, timeout=0.05)
                if self._abort:
                    break
                if self._shutdown and not self.pending and not any(self.slots):
                    break
            try:
                self._admit()
                self._retire()
                self._step_ready()
            except BaseException as e:
                self.failed = e
                break
        self._drain_failed()

    def _drain_failed(self) -> None:
        """Terminal cleanup: offer survivors to the fleet, fail the rest.

        Marks the executor dead FIRST (under the cond, in the same
        critical section that empties the queues) so a concurrently
        racing ``enqueue`` can never land a session after the final
        drain — the enqueue-after-death hang this ordering exists to
        prevent. ``on_dead`` fires only on *failure* (not graceful or
        aborted shutdown) and returns the sessions it re-placed; everyone
        else gets a terminal error so joins/``result()`` never hang.
        """
        err = self.failed or RuntimeError(f"executor {self.name} shut down")
        done = []
        with self.cond:
            self._dead = True
            if self._seized:
                # a fleet evictor claimed the drain (seize may still be
                # waiting on our in-flight fold): the sessions are its to
                # recover — racing it here would fail them first
                return
            for idx, act in enumerate(self.slots):
                if act is not None:
                    self.slots[idx] = None
                    done.append(act)
            while self.pending:
                done.append(self.pending.popleft())
        recovered: list = []
        if self.on_dead is not None and self.failed is not None and done:
            recovered = list(self.on_dead(self, done, err))
        for act in done:
            if any(act is r for r in recovered):
                continue
            act.ring.close()
            self.on_done(act)  # counted before the caller can see the end
            act.handle._fail(act.error or err)

    def seize(self, timeout: float = 5.0) -> list[_Active]:
        """Forcibly detach every hosted session (fleet eviction of a
        stalled or straggling executor) and mark the executor dead.

        Waits briefly for an in-flight cohort fold to finish so no
        session is taken mid-step. A thread held inside the fault hook
        holds no staged chunks yet (faults fire before any ring item is
        consumed), so eviction during an injected stall is always clean;
        the evictor must poison the fault plan so a later release
        terminates the zombie thread instead of letting it touch
        sessions that now live elsewhere.
        """
        with self.cond:
            self._shutdown = True
            self._abort = True
            self._dead = True
            self._seized = True
            self.cond.notify_all()
            self.cond.wait_for(lambda: not self._folding, timeout=timeout)
            acts = []
            for idx, act in enumerate(self.slots):
                if act is not None:
                    self.slots[idx] = None
                    acts.append(act)
            while self.pending:
                acts.append(self.pending.popleft())
        return acts

    def _can_join(self) -> bool:
        """Mesh executors gang-schedule, so a phase-sensitive filter can
        only accept a newcomer whose phase matches every occupied slot
        (a fresh join is phase 0; a fleet-resumed session carries its
        checkpointed phase); single-device executors cohort by phase and
        accept joins at any group boundary."""
        if self.mesh is None or self.filt.phase_invariant:
            return True
        phase = self.pending[0].steps if self.pending else 0
        return all(a is None or a.steps == phase for a in self.slots)

    def _admit(self) -> None:
        joins = []
        with self.cond:
            while self.pending and None in self.slots and self._can_join():
                act = self.pending.popleft()
                idx = self.slots.index(None)
                act.slot = idx
                self.slots[idx] = act
                joins.append((idx, act))
        for idx, act in joins:
            # fresh single-bank state into the vacant slot — or, for a
            # fleet-resumed/migrated session, its checkpointed slot state.
            # Either way the banked shapes are unchanged.
            seed = act.resume_state
            act.resume_state = None
            self.state = self._insert_slot(
                self.state, seed if seed is not None else self.filt.init(), idx
            )
            # re-fold the chunks the crash lost between the last
            # checkpoint and the failure — same chunks, same order, same
            # step indices, so the resumed state is bit-identical to the
            # pre-crash one before any new chunk is touched
            if act.pending_replay:
                obs.instant(
                    "serve.replay",
                    "serve",
                    session=act.name,
                    executor=self.name,
                    chunks=len(act.pending_replay),
                    from_step=act.steps,
                )
            while act.pending_replay:
                chunk = act.pending_replay.pop(0)
                sub = self._extract_slot(idx)
                new = self.filt.step(sub, chunk, step_index=act.steps)
                self.state = self._insert_slot(self.state, new, idx)
                act.steps += 1
                act.frames += math.prod(chunk.shape[:-2])
            if act.t_joined is None:
                act.t_joined = time.perf_counter()
            act.handle.status = "active"
            obs.instant(
                "serve.join", "serve", session=act.name, executor=self.name,
                slot=idx,
            )

    def _insert_slot(self, state, slot_state, index: int):
        """``StreamingFilter.slot_insert``, which writes the slot in place
        (the executor owns ``state`` exclusively, so no copy of the other
        slots is made). On a mesh, slot ``index`` is the one bank of shard
        ``index``."""
        if self.mesh is not None:
            self.filt.slot_insert(state[index], slot_state, 0)
            return state
        return self.filt.slot_insert(state, slot_state, index)

    def _extract_slot(self, index: int):
        """Slot ``index`` as a single-bank state (a copy, see
        ``StreamingFilter.slot_extract``), on the device that holds it."""
        if self.mesh is not None:
            return self.filt.slot_extract(self.state[index], 0)
        return self.filt.slot_extract(self.state, index)

    def _retire(self) -> None:
        for idx, act in enumerate(self.slots):
            if act is None:
                continue
            if (
                act.handle._migrate.is_set()
                and self.on_migrate is not None
                and act.error is None
                and not act.handle._leave.is_set()
                and not act.finished_stream()
            ):
                # live migration: lift the slot state out at this group
                # boundary and hand the session (state + intact ring +
                # counters) to the fleet for re-placement. slot_extract
                # is non-destructive; clearing the slot frees it here.
                sub = self._extract_slot(idx)
                with self.cond:
                    self.slots[idx] = None
                act.slot = None
                act.resume_state = sub
                act.handle._migrate.clear()
                act.migrations += 1
                self.on_migrate(self, act)
                continue
            if act.error is not None:
                act.ring.close()
                with self.cond:
                    self.slots[idx] = None
                self.on_done(act)
                act.handle._fail(act.error)
                continue
            leaving = act.handle._leave.is_set()
            if leaving and not act.finished_stream():
                act.ring.close()
                while len(act.ring):  # staged but never folded -> drops
                    try:
                        act.ring.get(timeout=0)
                    except (RingClosed, TimeoutError):
                        break
                    act.c_discarded.inc()
            if not act.finished_stream():
                continue
            sub = self._extract_slot(idx)
            if (
                act.session.qos_mode == "drop_oldest"
                or act.downshifted
                or leaving
            ) and act.steps:
                # average only the surviving groups — mirrors
                # run_pipelined's drop_oldest finalize exactly
                out = self.filt.finalize(sub, steps=act.steps)
            else:
                out = self.filt.finalize(sub)
            _wait([out.device])
            report = self._report(act)
            with self.cond:
                self.slots[idx] = None
            obs.instant(
                "serve.retire", "serve", session=act.name, executor=self.name,
                groups=act.steps, leave=leaving,
            )
            self.on_done(act)  # counted before the caller can see the result
            act.handle._finish(out, report)

    def _steppable(self) -> list[tuple[int, _Active]]:
        """Slots that can still produce work: occupied, healthy, not
        leaving, and their stream not yet exhausted."""
        return [
            (i, a)
            for i, a in enumerate(self.slots)
            if a is not None
            and a.error is None
            and not a.handle._leave.is_set()
            and not a.finished_stream()
        ]

    def _ready(self, active):
        return [(i, a) for i, a in active if len(a.ring) > 0]

    def _coalesce(self, active, ready):
        """Briefly wait for straggler slots before stepping a partial
        cohort. A full cohort steps the resident state in place (no
        copies of the state); a partial cohort pays a gather + scatter of
        the whole slot array — worth a few ms of batching window when the
        co-tenants are pacing together. Bounded: after ``coalesce_s`` the
        partial cohort goes ahead, so one stalled tenant can only add the
        window, never block the others."""
        if len(ready) == len(active) or self.coalesce_s <= 0:
            return ready
        deadline = time.perf_counter() + self.coalesce_s
        with obs.span(
            "serve.coalesce", "serve", executor=self.name, ready=len(ready),
            active=len(active),
        ) as sp:
            with self.cond:
                while True:
                    left = deadline - time.perf_counter()
                    active = self._steppable()  # a stream may end mid-window
                    ready = self._ready(active)
                    if len(ready) == len(active) or left <= 0 or self._shutdown:
                        sp.set(ready_after=len(ready))
                        return ready
                    self.cond.wait(left)

    def _step_ready(self) -> None:
        active = self._steppable()
        ready = self._ready(active)
        if not ready:
            return
        if self.mesh is not None:
            # gang scheduling: the sharded step needs every occupied slot
            # (the per-group gather barrier of run_pipelined_banked)
            if len(ready) != len(active):
                return
            self._fold_cohort(ready, gang=True)
            return
        ready = self._coalesce(active, ready)
        if not ready:
            return
        if self.filt.phase_invariant:
            self._fold_cohort(ready)
            return
        cohorts: dict[int, list[tuple[int, _Active]]] = {}
        for i, a in ready:
            cohorts.setdefault(a.steps, []).append((i, a))
        for phase in sorted(cohorts):
            self._fold_cohort(cohorts[phase])

    def _stage_chunks(self, idxs, items):
        """Assemble a full cohort's (capacity, N, H, W) chunk batch.

        A stack would allocate and fill the whole batch every group; the
        persistent ``_chunk_buf`` instead takes one in-place slice copy
        per chunk (O(chunk) bytes each), ordered on the compute stream
        after the step that last read it. Falls back to a plain stack if
        the sessions' chunk dtypes/shapes disagree (possible: chunk dtype
        comes from the source, not the config)."""
        first = items[0][0]
        if any(
            it[0].dtype != first.dtype or it[0].shape != first.shape
            for it in items[1:]
        ):
            return torch.stack([it[0] for it in items])
        buf = self._chunk_buf
        shape = (self.capacity,) + tuple(first.shape)
        if (
            buf is None or buf.dtype != first.dtype
            or tuple(buf.shape) != shape or buf.device != first.device
        ):
            buf = self._chunk_buf = torch.empty(shape, dtype=first.dtype, device=first.device)
        for i, (dev, _, _) in zip(idxs, items):
            buf.select(0, i).copy_(dev)
        return buf

    def _fold_cohort(self, group: Sequence[tuple[int, _Active]], gang=False) -> None:
        """One device step folding one staged chunk per cohort member."""
        if self.faults is not None:
            # scripted faults fire HERE, before any ring item is consumed:
            # a crash or stall at cohort step k never half-eats a staged
            # chunk, which is what makes eviction + replay exact. May
            # raise (crash/poison), may block (stall), returns the
            # virtual slow-down to add to this step's reported duration.
            fault_extra_s = self.faults.apply(self.name, self.cohort_steps)
        else:
            fault_extra_s = 0.0
        with self.cond:
            # revalidate under the lock: a fleet seize() may have detached
            # these sessions while the fault hook held us — their chunks
            # now belong to another executor, so touch nothing
            if any(self.slots[i] is not a for i, a in group):
                return
            self._folding = True
        try:
            self._fold_cohort_inner(group, gang, fault_extra_s)
        finally:
            with self.cond:
                self._folding = False
                self.cond.notify_all()

    def _fold_cohort_inner(
        self, group: Sequence[tuple[int, _Active]], gang: bool,
        fault_extra_s: float,
    ) -> None:
        t_clock0 = self.clock.now()
        items = []  # (dev, transfer_dt, dwell_s): len>0 held, never blocks
        for _, a in group:
            dwell0 = a.ring.stats.dwell_s
            staged, dt = a.ring.get()
            # this item's staged->pickup wait, from the ring's own put
            # timestamp (taken post-backpressure, i.e. actual insertion) —
            # exact because this thread is the ring's only consumer
            items.append((a.stager.adopt(staged), dt, a.ring.stats.dwell_s - dwell0))
        t_fetch = time.perf_counter()
        idxs = [i for i, _ in group]
        phase = group[0][1].steps
        if not self.filt.phase_invariant and any(
            a.steps != phase for _, a in group
        ):
            raise RuntimeError("phase-mixed cohort for a phase-sensitive filter")
        t0 = time.perf_counter()
        with obs.span(
            "serve.cohort", "serve", executor=self.name, size=len(group),
            gang=gang, phase=phase,
        ):
            if len(group) == 1 and not gang:
                # lone slot: the SINGLE-BANK step path — a 1-session
                # scheduler run makes exactly the calls run_pipelined
                # makes, which is what keeps it bit-identical for every
                # filter
                i = idxs[0]
                sub = self._extract_slot(i)
                new = self.filt.step(sub, items[0][0], step_index=phase)
                self.state = self._insert_slot(self.state, new, i)
            elif gang:
                # full-capacity step over the mesh, one (1, N, H, W) chunk
                # per bank shard; vacant slots ride along on a dummy chunk
                # (their junk state is re-initialized at join)
                by_slot = dict(zip(idxs, items))
                dummy = items[0][0]
                chunks = [
                    (by_slot[i][0] if i in by_slot else dummy).unsqueeze(0)
                    for i in range(self.capacity)
                ]
                self.state = banked_filter_step(
                    self.state,
                    chunks,
                    self.mesh,
                    config=self.config,
                    step_index=phase,
                    filt=self.filt,
                )
            elif len(group) == self.capacity:
                # whole slot array ready: fill the persistent staging
                # buffer with in-place slice copies and step the resident
                # state in place — zero whole-array copies on the
                # full-cohort fast path
                self.state = banked_filter_step(
                    self.state,
                    self._stage_chunks(idxs, items),
                    None,
                    config=self.config,
                    step_index=phase,
                    filt=self.filt,
                )
            else:
                sub = self.filt.slot_gather(self.state, idxs)
                stacked = torch.stack([it[0] for it in items])
                new = self.filt.step(sub, stacked, step_index=phase)
                self.state = self.filt.slot_scatter(self.state, new, idxs)
            # block per cohort: per-group service latency must be the time
            # the result actually exists, not the time the launch returned
            _wait(self.devices)
        t_done = time.perf_counter()
        share = (t_done - t0) / len(group)
        self.cohort_steps += 1
        for (i, act), (dev, dt, dwell) in zip(group, items):
            act.steps += 1
            act.frames += math.prod(dev.shape[:-2])
            act.c_transfer.inc(dt)
            act.c_compute.inc(share)
            # service latency: in-ring wait (from actual insertion) plus
            # this cohort's fetch-to-step-done span
            lat = dwell + (t_done - t_fetch)
            act.record_latency(lat)
            d = act.session.deadline_ms
            if d is not None and lat * 1e3 > d:
                act.c_misses.inc()
                obs.instant(
                    "serve.deadline_miss", "serve", session=act.name,
                    executor=self.name, lat_ms=lat * 1e3, deadline_ms=d,
                )
            if act.session.consumer is not None:
                try:
                    partial = self.filt.partial(
                        self._extract_slot(i),
                        step_index=act.steps - 1,
                    )
                    act.session.consumer(act.steps - 1, partial)
                except BaseException as e:  # consumer failure fails the session
                    act.error = e
            if self.on_session_step is not None:
                # fleet checkpoint/replay bookkeeping; a failure (disk
                # full, mismatched state) fails this session, not the
                # executor and its co-tenants
                try:
                    self.on_session_step(self, act, i, dev)
                except BaseException as e:
                    act.error = e
        if self.on_step is not None:
            self.on_step(
                self, (self.clock.now() - t_clock0) + fault_extra_s
            )
        if self.on_cohort is not None:
            self.on_cohort()

    def _report(self, act: _Active) -> SessionReport:
        """Build the session's report from its metric instruments.

        Everything time/latency-shaped reads back out of the session's
        ``serve.*`` instruments in the scheduler registry (the same values
        ``SessionScheduler.metrics.snapshot()`` exposes) — the report is a
        *view* over the metrics, not a second accounting path. Only
        operational state (steps/frames, which crash recovery rewinds) and
        identity fields come from the ``_Active`` itself.
        """
        now = time.perf_counter()
        s = act.ring.stats
        c = act.session.config
        reg = act.metrics
        sn = dict(session=act.name)
        return SessionReport(
            elapsed_s=now - (act.t_joined or now),
            buffering_s=0.0,
            compute_s=reg.value("serve.compute_s", **sn),
            frames=act.frames,
            bytes_in=act.frames * c.bytes_per_frame,
            transfer_s=reg.value("serve.transfer_s", **sn),
            stall_s=s.get_wait_s,
            num_slots=act.session.ring_slots,
            produce_wait_s=s.put_wait_s,
            drops=s.drops + int(reg.value("serve.discarded", **sn)),
            ring_occupancy_mean=s.occupancy_mean,
            ring_occupancy_max=s.occupancy_max,
            latency_p50_ms=reg.percentile("serve.latency_s", 50, **sn) * 1e3,
            latency_p95_ms=reg.percentile("serve.latency_s", 95, **sn) * 1e3,
            latency_p99_ms=reg.percentile("serve.latency_s", 99, **sn) * 1e3,
            session=act.name,
            mode=act.session.qos_mode,
            deadline_ms=act.session.deadline_ms or 0.0,
            deadline_misses=int(reg.value("serve.deadline_misses", **sn)),
            queue_wait_s=(act.t_joined - act.t_submit) if act.t_joined else 0.0,
            groups=act.steps,
            migrations=act.migrations,
            restarts=act.restarts,
            checkpoints=act.checkpoints,
        )


class SessionScheduler:
    """Admission control + executor pool for concurrent PRISM sessions.

    See the module docstring for the architecture. Typical use::

        with SessionScheduler(slots_per_executor=4) as sched:
            handles = [sched.submit(Session(cfg, src)) for src in sources]
            results = [h.result(timeout=300) for h in handles]

    ``slots_per_executor`` is each executor's fixed slot capacity (with a
    ``mesh`` it is pinned to the mesh's bank axis), ``max_executors`` the
    pool size, ``max_sessions``/``max_waiting`` the admission limits, and
    ``coalesce_ms`` the bounded wait for straggler slots before a partial
    cohort steps (0 disables batching windows entirely). ``device`` is
    where the slot states live and the sessions' chunks land: CUDA unless
    the caller names another (``RuntimeError`` when CUDA is absent); with
    a ``mesh`` the devices are the mesh's, and chunks land on its first.
    """

    def __init__(
        self,
        *,
        slots_per_executor: int | None = None,
        max_executors: int = 2,
        max_sessions: int | None = None,
        max_waiting: int = 4,
        mesh=None,
        coalesce_ms: float = 5.0,
        slos: Sequence = (),
        slo_eval_every_s: float = 1.0,
        device=None,
    ):
        if mesh is not None:
            banks = mesh.shape["bank"]
            if slots_per_executor is not None and slots_per_executor != banks:
                raise ValueError(
                    f"slots_per_executor={slots_per_executor} conflicts with "
                    f"the mesh bank axis ({banks}); omit it when passing a mesh"
                )
            slots_per_executor = banks
        elif slots_per_executor is None:
            slots_per_executor = 2
        if slots_per_executor < 1:
            raise ValueError(
                f"slots_per_executor must be >= 1, got {slots_per_executor}"
            )
        if max_executors < 1:
            raise ValueError(f"max_executors must be >= 1, got {max_executors}")
        if max_waiting < 0:
            raise ValueError(f"max_waiting must be >= 0, got {max_waiting}")
        if coalesce_ms < 0:
            raise ValueError(f"coalesce_ms must be >= 0, got {coalesce_ms}")
        self.coalesce_ms = coalesce_ms
        self.slots_per_executor = slots_per_executor
        self.max_executors = max_executors
        #: dynamic pool-growth ceiling, ``<= max_executors`` (the hard
        #: cap). ``_place`` spawns executors only up to the target; the
        #: fleet's autoscaler moves it (``scale_up``/``scale_down``) so
        #: the pool can start small and grow under load. Static (full)
        #: under the plain scheduler.
        self.target_executors = max_executors
        self.max_waiting = max_waiting
        self.max_sessions = (
            max_sessions
            if max_sessions is not None
            else slots_per_executor * max_executors + max_waiting
        )
        if self.max_sessions < 1:
            raise ValueError(f"max_sessions must be >= 1, got {self.max_sessions}")
        if mesh is not None:
            if device is not None:
                raise ValueError("pass a device or a mesh, not both")
            for dev in mesh.devices:
                ops.resolve_device(dev)  # RuntimeError before any thread starts
            device = mesh.devices[0]
        #: where slot states live and sessions' chunks land (a gang step
        #: moves each chunk on to its bank shard's device)
        self.device = ops.resolve_device(device)
        self.mesh = mesh
        #: service-wide metrics registry: per-session ``serve.*`` series
        #: (labeled ``session=``) land here, and ``SessionReport``s are
        #: derived from it. Scrape via ``self.metrics.prometheus_text()``.
        self.metrics = obs.MetricsRegistry()
        self.metrics.describe(
            "serve.latency_s", "per-group service latency, staged -> step done (s)"
        )
        self.metrics.describe("serve.transfer_s", "host->device transfer time (s)")
        self.metrics.describe("serve.compute_s", "per-session share of cohort compute (s)")
        self.metrics.describe("serve.deadline_misses", "groups over their soft deadline")
        self.metrics.describe("serve.discarded", "staged groups dropped at leave")
        # admission-pressure counters: the autoscaler's overload signal is
        # the rejected/attempts ratio (deterministic — admission depends
        # on session counts, never on timing), judged as a rate-kind SLO
        self.metrics.describe(
            "serve.submit_attempts", "submit calls, admitted or refused"
        )
        self.metrics.describe(
            "serve.admission_rejected", "submit calls refused by admission control"
        )
        self.metrics.describe(
            "serve.admission_retry", "backoff retries after an admission refusal"
        )
        self.metrics.describe(
            "serve.shed", "sessions shed by the overload ladder"
        )
        #: SLO judgement tier: when specs are given, every executor ticks
        #: the engine after each cohort fold (``maybe_evaluate`` — a clock
        #: compare until ``slo_eval_every_s`` elapses) and verdicts land
        #: in ``slo_engine.last_verdicts`` + breach instants in the tracer.
        self.slo_engine = (
            obs.SloEngine(
                list(slos), self.metrics, eval_every_s=slo_eval_every_s
            )
            if slos
            else None
        )
        self._executors: list[_SlotExecutor] = []
        self._lock = threading.Condition()
        self._inflight = 0
        self._completed = 0
        self._seq = 0
        self._ex_seq = 0  # monotonically unique executor names
        self._closed = False

    # -- public API ----------------------------------------------------------
    def submit(self, session: Session) -> SessionHandle:
        """Admit a session (or raise :class:`AdmissionError`) and start
        its acquisition immediately; returns the future-like handle."""
        try:
            return self._submit(session)
        except AdmissionError:
            self.metrics.counter("serve.admission_rejected").inc()
            raise

    def submit_with_retry(
        self,
        session: Session,
        *,
        retries: int = 5,
        base_s: float = 0.05,
        max_s: float = 2.0,
        jitter: float = 0.5,
        rng=None,
        policy=None,
    ) -> SessionHandle:
        """``submit`` routed through :func:`repro_torch.serve.retry
        .retry_with_backoff`: an :class:`AdmissionError` waits out a
        jittered-exponential delay and tries again instead of giving up —
        rung 1 of the degradation ladder. Waits run on the scheduler's
        clock (virtual under a ``FakeClock``); retries land in the
        ``serve.admission_retry`` counter for the pressure SLO.
        """
        from repro_torch.serve.retry import retry_with_backoff

        retry_counter = self.metrics.counter("serve.admission_retry")

        def on_retry(attempt: int, delay_s: float, err: BaseException) -> None:
            retry_counter.inc()
            obs.instant(
                "serve.admission_retry", "serve", session=session.name,
                attempt=attempt, delay_s=delay_s,
            )

        return retry_with_backoff(
            lambda: self.submit(session),
            retries=retries,
            base_s=base_s,
            max_s=max_s,
            jitter=jitter,
            rng=rng,
            clock=getattr(self, "clock", None),
            retry_on=(AdmissionError,),
            on_retry=on_retry,
            policy=policy,
        )

    def _submit(self, session: Session) -> SessionHandle:
        handle = SessionHandle(session)
        key = session.config.stream_key()
        self.metrics.counter("serve.submit_attempts").inc()
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is shut down")
            if self._inflight >= self.max_sessions:
                raise AdmissionError(
                    f"{self._inflight} sessions in flight >= "
                    f"max_sessions={self.max_sessions}"
                )
            ex = self._place(key, session.config)
            # enqueue under the scheduler lock: placement decided against
            # pending counts that a concurrent submit cannot invalidate
            # (the executor thread only ever *drains* pending, which moves
            # admission in the permissive direction)
            act = _Active(
                handle, self._seq, notify_hook=ex.notify, metrics=self.metrics,
                device=self.device,
            )
            handle._leave_hook = ex.notify
            # an executor can fail between placement and enqueue; a dead
            # one refuses the session, so re-place until one accepts (a
            # fresh _place never returns the refuser — it is not alive)
            while not ex.enqueue(act):
                ex = self._place(key, session.config)
                act.ring.set_notify_hook(ex.notify)
                handle._leave_hook = ex.notify
            self._seq += 1
            self._inflight += 1
            self._on_submitted(handle, act, ex)
        obs.instant("serve.submit", "serve", session=act.name, executor=ex.name)
        act.producer.start()
        return handle

    def _on_submitted(self, handle, act, ex) -> None:
        """Post-admission hook (fleet bookkeeping); base: no-op."""

    def _slo_tick(self) -> None:
        """Per-cohort SLO cadence tick, called from executor threads.

        Evaluation failures never fail an executor (and with it every
        co-tenant session): they are counted and the tick swallowed —
        judging the service must not be able to take the service down.
        """
        try:
            self.slo_engine.maybe_evaluate()
        except Exception:
            self.metrics.counter("slo.eval_errors").inc()

    def stats(self) -> dict:
        """Live telemetry snapshot (sessions in flight, per-executor load)."""
        with self._lock:
            executors = list(self._executors)
            snap = {
                "in_flight": self._inflight,
                "completed": self._completed,
                "max_sessions": self.max_sessions,
                "target_executors": self.target_executors,
            }
        snap["executors"] = [
            {
                "name": ex.name,
                "filter": ex.config.filter_name,
                "capacity": ex.capacity,
                "sessions": ex.session_count(),
                "waiting": ex.queue_depth(),
                "cohort_steps": ex.cohort_steps,
                "alive": ex.alive,
                "draining": ex.draining,
            }
            for ex in executors
        ]
        return snap

    def shutdown(self, wait: bool = True, timeout: float | None = None) -> None:
        """Stop the service. ``wait=True`` drains every in-flight session
        first; ``wait=False`` aborts them (their handles fail)."""
        with self._lock:
            self._closed = True
            if wait:
                if not self._lock.wait_for(
                    lambda: self._inflight == 0, timeout
                ):
                    raise TimeoutError(
                        f"{self._inflight} sessions still in flight after "
                        f"{timeout}s"
                    )
            executors = list(self._executors)
        for ex in executors:
            ex.stop(abort=not wait)
        for ex in executors:
            ex.thread.join(timeout=60)

    def __enter__(self) -> "SessionScheduler":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(wait=exc_type is None)

    # -- placement (under self._lock) ----------------------------------------
    def _new_executor(self, key, config: DenoiseConfig) -> _SlotExecutor:
        """Construct one pool executor (fleet subclasses add hooks)."""
        ex = _SlotExecutor(
            key,
            config,
            capacity=self.slots_per_executor,
            mesh=self.mesh,
            name=f"ex{self._ex_seq}",
            on_done=self._session_done,
            coalesce_s=self.coalesce_ms * 1e-3,
            metrics=self.metrics,
            on_cohort=self._slo_tick if self.slo_engine is not None else None,
            device=self.device,
            **self._executor_hooks(),
        )
        self._ex_seq += 1
        return ex

    def _executor_hooks(self) -> dict:
        """Extra ``_SlotExecutor`` kwargs (clock/faults/fleet callbacks)."""
        return {}

    def _place(
        self, key, config: DenoiseConfig, exclude: Sequence = ()
    ) -> _SlotExecutor:
        # draining executors (elastic scale-down in progress) still host
        # their remaining sessions but accept no new placements
        all_alive = [
            ex for ex in self._executors if ex.alive and not ex.draining
        ]
        alive = [
            ex for ex in all_alive if not any(ex is e for e in exclude)
        ]
        matching = [ex for ex in alive if ex.key == key]
        with_room = [ex for ex in matching if ex.has_room()]
        if with_room:
            # least-loaded placement: fewest hosted+queued sessions wins,
            # ties broken by pool order (stable, deterministic)
            return min(with_room, key=lambda e: e.session_count())
        # pool headroom counts every live executor, including excluded
        # ones — an exclusion (migration source) must not let the pool
        # exceed the (autoscaler-movable) target
        if len(all_alive) < min(self.target_executors, self.max_executors):
            ex = self._new_executor(key, config)
            self._executors.append(ex)
            return ex
        if not matching:
            raise AdmissionError(
                f"executor pool is full ({len(all_alive)}/{self.max_executors}) "
                "and none matches this session's stream_key"
            )
        ex = min(matching, key=lambda e: e.queue_depth())
        depth = ex.queue_depth()
        if depth >= self.max_waiting:
            raise AdmissionError(
                f"join queue depth {depth} >= max_waiting={self.max_waiting} "
                f"on executor {ex.name}"
            )
        return ex

    def _session_done(self, act: _Active) -> None:
        with self._lock:
            self._inflight -= 1
            self._completed += 1
            self._lock.notify_all()
