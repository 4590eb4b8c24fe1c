"""FleetScheduler: fault-tolerant session serving over an executor pool
(counterpart of ``repro.serve.fleet``).

The plain :class:`~repro_torch.serve.scheduler.SessionScheduler` treats an
executor failure as fatal for every session it hosts. This subclass wires
the fault-tolerance runtime (``repro_torch.runtime.fault_tolerance``)
into the serving layer and turns executor death into a *recoverable*
event:

* **Heartbeats.** Every executor beats the :class:`HeartbeatMonitor` at
  the top of each scheduling iteration and after each cohort fold, with
  timestamps read from the injectable :class:`~repro_torch.serve.faults.Clock`
  (tests drive a ``FakeClock``; nothing here sleeps on wall time).
  :meth:`check_faults` — the supervision pass, called by the operator's
  pump loop or a test — first *probes* (bounded event-wait for each live
  executor to beat at the current clock reading, so a fake-clock advance
  cannot race a beat that simply had not happened yet), then evicts
  anything ``monitor.dead(now)`` lists.
* **Stragglers.** Per-cohort durations (including scripted *virtual*
  slow-downs from a :class:`~repro_torch.serve.faults.FaultPlan`) feed the
  :class:`StragglerDetector` EWMA; ``check_faults`` evicts flagged
  executors the same way it evicts silent ones. Evicted executors are
  ``forget``-ten so they stop skewing the fleet median.
* **Eviction.** ``FaultPlan.poison`` first (a zombie thread released from
  a stall later raises instead of stepping sessions that moved), then
  ``seize()`` lifts every hosted session off the executor atomically at
  a fold boundary, then each is re-placed via :meth:`_recover`.
* **Crash recovery.** An executor whose thread dies (scripted
  ``InjectedExecutorFailure`` or a real exception) offers its sessions to
  :meth:`_on_dead` from its own drain path — recovery is *synchronous*
  with the failure, no supervision pass needed. Each session restores its
  newest :class:`~repro_torch.serve.recovery.SessionCheckpointer` snapshot
  (slot state at fold ``k``) and re-folds its replay log — the chunks
  folded since that snapshot, retained on the scheduler side — with the
  original step indices at re-admission. Restore + replay reconstructs
  the pre-crash state **bit-identically** for the exact filters, so the
  resumed stream's final output equals the undisturbed run's.
* **Live migration.** :meth:`migrate` asks the hosting executor to lift
  the session's slot state out at the next group boundary
  (``slot_extract``) and hands state + intact staging ring + counters to
  the least-loaded compatible executor (``slot_insert`` on arrival).
  The producer thread never notices: the ring merely re-targets its
  consumer-wake hook.
* **Bounded restarts.** A session is re-placed at most
  ``max_session_restarts`` times (the :class:`Supervisor` contract);
  after that — or when neither checkpoint nor replay can reconstruct its
  state — its handle fails with the executor's error. Give-ups,
  evictions, recoveries and migrations are appended to the supervisor-
  style ``events`` history; ``timeline`` carries the clock-stamped marks
  ``recovery_latencies_s`` turns into kill-to-recovered latency.

Everything observable is deterministic under a scripted
:class:`FaultPlan` + ``FakeClock``: faults fire at cohort-step indices,
stalls are events the test releases, and the only real-time waits are
bounded event waits (see ``tests/test_torch_fleet.py``).

On the device (``FleetScheduler(device=None)`` is CUDA, as
``SessionScheduler``; ``RuntimeError`` without it):

* a checkpoint is taken on the executor thread after the cohort's
  ``_wait``, so its device-to-host copy reads the state the step wrote;
* every executor of the pool holds its slots on the fleet's ``device``
  (with a mesh, on the mesh's shards, whose first device is ``device``),
  so a restored or migrated slot state is landed there before the target
  executor is picked, and that executor's ``slot_insert`` copies it into
  the slot (a mesh's shard) that seats it; it never stays on the device
  of the executor that lost it unless that is the fleet's own;
* a torn or mismatched checkpoint falls back to the reference's
  replay-only restore; nothing runs on the CPU or through a plain version
  in place of what failed.
"""

from __future__ import annotations

import threading

from repro_torch import obs
from repro_torch.runtime import elastic as _elastic
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, StragglerDetector
from repro_torch.serve.faults import Clock, FaultPlan
from repro_torch.serve.recovery import SessionCheckpointer
from repro_torch.serve.scheduler import SessionScheduler
from repro_torch.serve.session import AdmissionError, SessionHandle

__all__ = ["DEGRADE_LEVELS", "FleetScheduler"]

#: graceful-degradation ladder, in escalation order: 0 nothing, 1 admit
#: through jittered backoff, 2 downshift live sessions to cheaper modes
#: (drop_oldest rings; u8 ingest for new arrivals), 3 shed lowest-QoS
#: sessions. The reference's ``Autoscaler`` (not ported yet: ROADMAP.md
#: queue A item 10(c)) climbs one rung per breached evaluation once the
#: pool cannot grow, and restores (rung by rung) once the breach clears.
DEGRADE_LEVELS = ("normal", "backoff", "downshift", "shed")


class FleetScheduler(SessionScheduler):
    """``SessionScheduler`` + heartbeats, eviction, checkpointed recovery
    and live migration. See the module docstring for the architecture.

    Typical use::

        plan = FaultPlan().crash("ex0", at_step=3)
        with FleetScheduler(
            checkpoint_dir=ckpt, faults=plan, max_executors=3
        ) as fleet:
            h = fleet.submit(Session(cfg, src))
            out, report = h.result(timeout=300)   # survives the crash
            assert report.restarts == 1

    ``checkpoint_dir=None`` disables snapshots; sessions then recover
    only while their replay log still covers their whole history (i.e.
    never, once a checkpoint would have been due) — pass a directory for
    real fault tolerance. ``faults``/``clock`` default to no injected
    faults and real monotonic time. ``device`` and every other keyword
    are :class:`SessionScheduler`'s (CUDA unless the caller names
    another).
    """

    def __init__(
        self,
        *,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 1,
        checkpoint_keep: int = 2,
        clock: Clock | None = None,
        faults: FaultPlan | None = None,
        heartbeat_timeout_s: float = 60.0,
        straggler_threshold: float = 2.5,
        straggler_alpha: float = 0.2,
        straggler_warmup: int = 3,
        max_session_restarts: int = 2,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if max_session_restarts < 0:
            raise ValueError(
                f"max_session_restarts must be >= 0, got {max_session_restarts}"
            )
        self.clock = clock or Clock()
        self.faults = faults
        self.checkpointer = (
            SessionCheckpointer(
                checkpoint_dir, every=checkpoint_every, keep=checkpoint_keep
            )
            if checkpoint_dir is not None
            else None
        )
        self.monitor = HeartbeatMonitor(timeout_s=heartbeat_timeout_s)
        self.stragglers = StragglerDetector(
            alpha=straggler_alpha,
            threshold=straggler_threshold,
            warmup_steps=straggler_warmup,
        )
        self.max_session_restarts = max_session_restarts
        # the SLO engine (built by the base ctor when specs were passed)
        # must judge time on the SAME clock the fleet's fault machinery
        # uses, or FakeClock tests would mix virtual and wall time
        if self.slo_engine is not None:
            self.slo_engine.clock = self.clock
        self.metrics.describe(
            "fleet.recovery_s", "kill-to-recovered latency per recovered session (s)"
        )
        self.metrics.describe("fleet.queue_depth", "unseatable queued sessions")
        self.metrics.describe("fleet.sessions", "sessions hosted per executor")
        self.metrics.describe(
            "fleet.headroom", "model group floor / achieved EWMA group time"
        )
        self.metrics.describe("fleet.ring_occupancy", "staged groups in ring")
        # fault-tolerance state shares one small lock; never held while
        # taking the scheduler lock or an executor cond (no nesting out)
        self._ft_lock = threading.Lock()
        self._acts: dict[int, object] = {}  # id(handle) -> _Active
        self._awaiting_recovery: set[str] = set()
        self._evicted_names: set[str] = set()
        self._drained_names: set[str] = set()  # deliberate scale-down exits
        self._beat_flags: dict[str, threading.Event] = {}
        #: supervisor-style history strings (evict@…, recover@…, …)
        self.events: list[str] = []
        #: clock-stamped marks: (kind, name, t) — kinds are
        #: executor-dead, session-replaced, session-recovered,
        #: session-migrated, scale-up, scale-down, degrade, restore,
        #: session-shed. Feeds recovery_latencies_s() and the autoscaler's
        #: reaction-time measurement.
        self.timeline: list[tuple[str, str, float]] = []
        # -- elastic pool / degradation-ladder state (autoscaler-driven) ------
        #: current ladder rung, 0..len(DEGRADE_LEVELS)-1
        self.degradation_level = 0
        self._last_scale_event: str | None = None
        self._scale_ups = 0
        self._scale_downs = 0
        self._shed_total = 0
        self._downshifted_ids: set[int] = set()  # id(act) with ring flipped
        self.metrics.describe("fleet.pool_size", "live executors in the pool")
        self.metrics.describe("fleet.pool_target", "autoscaler pool target")
        self.metrics.describe(
            "fleet.degradation_level", "graceful-degradation ladder rung"
        )

    # -- executor wiring -----------------------------------------------------
    def _executor_hooks(self) -> dict:
        return dict(
            clock=self.clock,
            faults=self.faults,
            on_beat=self._on_beat,
            on_step=self._on_step,
            on_session_step=self._on_session_step,
            on_dead=self._on_dead,
            on_migrate=self._on_migrate,
        )

    def _on_submitted(self, handle, act, ex) -> None:
        self._acts[id(handle)] = act  # under self._lock (submit holds it)

    def _session_done(self, act) -> None:
        act.migrate_done.set()  # wake migrate() waiters; target stays None
        with self._lock:
            self._acts.pop(id(act.handle), None)
            self._downshifted_ids.discard(id(act))
        super()._session_done(act)

    # -- executor-thread callbacks -------------------------------------------
    def _on_beat(self, name: str, now: float) -> None:
        with self._ft_lock:
            if name in self._evicted_names:
                return  # a zombie's last gasp must not resurrect it
            self.monitor.beat(name, now)
            ev = self._beat_flags.get(name)
            if ev is not None:
                ev.set()

    def _on_step(self, ex, duration_s: float) -> None:
        with self._ft_lock:
            if ex.name in self._evicted_names:
                return
            self.monitor.beat(ex.name, self.clock.now())
            self.stragglers.record(ex.name, duration_s)

    def _on_session_step(self, ex, act, slot: int, chunk) -> None:
        """Post-fold bookkeeping: replay log + cadenced checkpoint.

        ``act.steps`` already counts this fold; the replay log holds the
        chunks folded since the last snapshot, so snapshot + replay always
        reconstructs the current state exactly. Runs on the executor
        thread after the cohort's ``_wait``: the slot copy and its
        device-to-host copy queue on that thread's stream behind the step.
        """
        if self.checkpointer is not None:
            # the log holds the staged device chunk itself, not a copy: the
            # session's _Stager lands every group in a fresh device tensor
            # and never writes one again, so the reference stays the folded
            # data (a stager that reused a staging slot would need a copy
            # here). It costs up to `every` chunks of device memory per
            # session.
            act.replay.append(chunk)
            if act.steps % self.checkpointer.every == 0:
                self.checkpointer.save(
                    act.name,
                    ex.filt,
                    ex._extract_slot(slot),
                    steps=act.steps,
                    frames=act.frames,
                )
                act.checkpoints += 1
                act.replay.clear()
                obs.instant(
                    "fleet.checkpoint", "fleet", session=act.name,
                    executor=ex.name, steps=act.steps,
                )
        recovered = False
        recovery_lat: float | None = None
        with self._ft_lock:
            if act.name in self._awaiting_recovery:
                self._awaiting_recovery.discard(act.name)
                now = self.clock.now()
                # kill-to-recovered latency: this mark minus the latest
                # executor-dead before it (same pairing as
                # recovery_latencies_s) — observed into the registry so
                # recovery_time SLOs judge it from snapshots
                last_dead = None
                for kind, _, t in reversed(self.timeline):
                    if kind == "executor-dead":
                        last_dead = t
                        break
                self.timeline.append(("session-recovered", act.name, now))
                if last_dead is not None:
                    recovery_lat = now - last_dead
                recovered = True
        if recovered:
            if recovery_lat is not None:
                self.metrics.histogram(
                    "fleet.recovery_s", session=act.name
                ).observe(recovery_lat)
            obs.instant(
                "fleet.recovered", "fleet", session=act.name, executor=ex.name,
                steps=act.steps,
            )

    def _on_dead(self, ex, acts, err) -> list:
        """Crash path: the dying executor offers its sessions from its own
        drain; everything re-placed here is skipped by its terminal fail
        loop. Synchronous — no supervision pass involved."""
        t = self.clock.now()
        with self._ft_lock:
            self._evicted_names.add(ex.name)
            self.monitor.evict(ex.name)
            self.stragglers.forget(ex.name)
            self._beat_flags.pop(ex.name, None)
            self.events.append(f"dead@{ex.name}:{type(err).__name__}")
            self.timeline.append(("executor-dead", ex.name, t))
        obs.instant(
            "fleet.executor_dead", "fleet", executor=ex.name,
            error=type(err).__name__, sessions=len(acts),
        )
        return [act for act in acts if self._recover(act, ex)]

    def _on_migrate(self, ex, act) -> None:
        """Migration path: ``_retire`` already lifted the slot state into
        ``act.resume_state``; place the session elsewhere (or re-seat it
        at home when the pool has nowhere better)."""
        if ex.draining and act.resume_state is not None:
            # scale-down path: the extracted slot state is still placed
            # wherever the leaving executor held it; re-land it for the
            # device set that remains before the target's slot_insert
            # picks it up (all-None spec = plain re-placement on the
            # mesh's first device; a single-device pool's "mesh" is the
            # fleet's own device, never another one)
            act.resume_state = _elastic.elastic_reshard(
                act.resume_state,
                _elastic.state_spec_tree(act.resume_state),
                self.mesh
                if self.mesh is not None
                else _elastic.available_mesh(("bank",), devices=[self.device]),
            )
        cfg = act.session.config
        key = cfg.stream_key()
        target = None
        with self._lock:
            try:
                cand = self._place(key, cfg, exclude=[ex])
            except AdmissionError:
                cand = ex  # nowhere else to go: home is still a clean seat
            if cand.enqueue(act):
                target = cand
            elif cand is not ex and ex.enqueue(act):
                target = ex
            if target is not None:
                act.ring.set_notify_hook(target.notify)
                act.handle._leave_hook = target.notify
        if target is None:
            err = RuntimeError(
                f"migration of {act.name} found no live executor"
            )
            with self._ft_lock:
                self.events.append(f"give-up@{act.name}:migration-stranded")
            obs.instant(
                "fleet.give_up", "fleet", session=act.name,
                reason="migration-stranded",
            )
            act.ring.close()
            act.handle._fail(act.error or err)
            self._session_done(act)
            return
        with self._ft_lock:
            self.events.append(f"migrate@{act.name}:{ex.name}->{target.name}")
            self.timeline.append(
                ("session-migrated", act.name, self.clock.now())
            )
        obs.instant(
            "fleet.migrate", "fleet", session=act.name, source=ex.name,
            target=target.name,
        )
        act.migrate_target = target.name
        act.migrate_done.set()

    # -- recovery ------------------------------------------------------------
    def _recover(self, act, src_ex) -> bool:
        """Reconstruct a detached session's resume state and re-place it.

        True when the session was taken over (its handle stays pending);
        False when the caller must fail it. Resume state priority: an
        in-flight migration state (already exact) > newest checkpoint +
        replay log > fresh init (never folded anything). The replay
        coverage check makes silent data loss impossible — a session
        whose history cannot be reconstructed fails loudly instead of
        resuming with a gap.
        """
        handle = act.handle
        if act.error is not None or handle._leave.is_set() or handle.done():
            return False
        if act.restarts >= self.max_session_restarts:
            with self._ft_lock:
                self.events.append(
                    f"give-up@{act.name}:restarts={act.restarts}"
                )
            obs.instant(
                "fleet.give_up", "fleet", session=act.name,
                reason=f"restarts={act.restarts}",
            )
            return False
        if act.resume_state is None and act.steps > 0:
            state, steps, frames = None, 0, 0
            if self.checkpointer is not None:
                try:
                    # on the fleet's device: every executor's (a mesh's
                    # first, from which slot_insert copies into the shard)
                    state, steps, frames = self.checkpointer.restore_latest(
                        act.name, src_ex.filt, device=self.device
                    )
                except Exception:  # torn/mismatched checkpoint: replay-only
                    state, steps, frames = None, 0, 0
            if steps + len(act.replay) < act.steps:
                with self._ft_lock:
                    self.events.append(f"give-up@{act.name}:unrecoverable")
                obs.instant(
                    "fleet.give_up", "fleet", session=act.name,
                    reason="unrecoverable",
                )
                return False
            act.resume_state = state
            act.pending_replay = list(act.replay)
            act.steps = steps
            act.frames = frames
            obs.instant(
                "fleet.restore", "fleet", session=act.name,
                checkpoint_steps=steps, replay_chunks=len(act.pending_replay),
            )
        act.slot = None
        act.restarts += 1
        cfg = act.session.config
        key = cfg.stream_key()
        with self._lock:
            if self._closed:
                return False
            try:
                ex2 = self._place(key, cfg, exclude=[src_ex])
                while not ex2.enqueue(act):
                    ex2 = self._place(key, cfg, exclude=[src_ex, ex2])
            except AdmissionError:
                with self._ft_lock:
                    self.events.append(f"give-up@{act.name}:no-placement")
                return False
            act.ring.set_notify_hook(ex2.notify)
            handle._leave_hook = ex2.notify
        with self._ft_lock:
            self._awaiting_recovery.add(act.name)
            self.events.append(
                f"recover@{act.name}->{ex2.name}:"
                f"steps={act.steps}+{len(act.pending_replay)}"
            )
            self.timeline.append(
                ("session-replaced", act.name, self.clock.now())
            )
        return True

    # -- supervision ---------------------------------------------------------
    def _probe(self, executors, timeout_s: float) -> None:
        """Bounded chance for each live executor to beat at the current
        clock reading before silence is judged: clear its beat flag, wake
        it, event-wait. A healthy executor beats within milliseconds; a
        held one times out (the wait is bounded, and a spurious timeout
        only triggers an eviction recovery handles — never a hang)."""
        flagged = []
        with self._ft_lock:
            for ex in executors:
                ev = self._beat_flags.setdefault(ex.name, threading.Event())
                ev.clear()
                flagged.append((ex, ev))
        for ex, _ in flagged:
            ex.notify()
        for _, ev in flagged:
            ev.wait(timeout_s)

    def check_faults(
        self, *, probe: bool = True, probe_timeout_s: float = 5.0
    ) -> dict:
        """One supervision pass: probe beats, evict the silent and the
        straggling, recover their sessions. Returns what happened::

            {"dead": [...], "stragglers": [...], "evicted": [...],
             "recovered": [session, ...], "failed": [session, ...]}

        Idempotent when healthy. ``probe=False`` skips the beat probe —
        straggler-only checks need no clock coordination at all.
        """
        with self._lock:
            executors = [ex for ex in self._executors if ex.alive]
        if probe and executors:
            self._probe(executors, probe_timeout_s)
        now = self.clock.now()
        with self._ft_lock:
            dead = list(self.monitor.dead(now))
            slow = list(self.stragglers.stragglers())
        evicted: list[str] = []
        recovered: list[str] = []
        failed: list[str] = []
        for ex in executors:
            if ex.name in dead or ex.name in slow:
                reason = "heartbeat" if ex.name in dead else "straggler"
                obs.instant(
                    "fleet.heartbeat_miss" if ex.name in dead
                    else "fleet.straggler",
                    "fleet",
                    executor=ex.name,
                )
                r, f = self._evict(ex, reason)
                evicted.append(ex.name)
                recovered += r
                failed += f
        return {
            "dead": dead,
            "stragglers": slow,
            "evicted": evicted,
            "recovered": recovered,
            "failed": failed,
        }

    def _evict(self, ex, reason: str) -> tuple[list[str], list[str]]:
        """Poison → seize → recover each seized session (fail the rest)."""
        t = self.clock.now()
        if self.faults is not None:
            self.faults.poison(ex.name)
        acts = ex.seize()
        with self._ft_lock:
            self._evicted_names.add(ex.name)
            self.monitor.evict(ex.name)
            self.stragglers.forget(ex.name)
            self._beat_flags.pop(ex.name, None)
            self.events.append(f"evict@{ex.name}:{reason}")
            self.timeline.append(("executor-dead", ex.name, t))
        obs.instant(
            "fleet.evict", "fleet", executor=ex.name, reason=reason,
            sessions=len(acts),
        )
        err = RuntimeError(f"executor {ex.name} evicted ({reason})")
        recovered: list[str] = []
        failed: list[str] = []
        for act in acts:
            if self._recover(act, ex):
                recovered.append(act.name)
            else:
                act.ring.close()
                act.handle._fail(act.error or err)
                self._session_done(act)
                failed.append(act.name)
        return recovered, failed

    # -- migration -----------------------------------------------------------
    def migrate(
        self, handle: SessionHandle, *, timeout: float | None = 60.0
    ) -> str | None:
        """Live-migrate a session at its next group boundary.

        Blocks (bounded event wait) until the session is re-enqueued and
        returns the target executor's name — or ``None`` if the session
        finished/failed before the boundary arrived. ``timeout=None``
        returns immediately (fire-and-forget)."""
        with self._lock:
            act = self._acts.get(id(handle))
        if act is None or handle.done():
            return None
        act.migrate_done.clear()
        act.migrate_target = None
        handle._migrate.set()
        ex = act.executor
        if ex is not None:
            ex.notify()
        if timeout is not None:
            act.migrate_done.wait(timeout)
        return act.migrate_target

    # -- elastic pool (autoscaler-driven) ------------------------------------
    def scale_up(self, count: int = 1, *, reason: str = "") -> int:
        """Grow the pool target by ``count`` executors and raise
        ``max_sessions`` to match the added slot capacity.

        The target never exceeds ``max_executors``, nor — for a
        mesh-backed pool — what the surviving device set can still back
        (:func:`repro_torch.runtime.elastic.available_mesh` is the ceiling
        check; a single-device pool has no device ceiling). The port's
        counterpart of the reference's ``jax.devices()`` count is the pool
        mesh's own shard list, a device named twice counting twice (as
        ``BankMesh`` names two shards on one card, the port's counterpart
        of a forced host device count), each device required to be
        present: a ``BankMesh(("cuda:0", "cuda:0"))`` pool grows exactly
        as the reference's pool on a 2-device host does, where counting
        distinct devices would freeze it. For reaction time an
        executor is spawned *eagerly* for the busiest live stream key,
        so queued admissions land on it immediately instead of waiting
        for ``_place`` to grow the pool lazily. Returns the new target
        (unchanged when already at the ceiling)."""
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        now = self.clock.now()
        spawned: list[str] = []
        with self._lock:
            ceiling = self.max_executors
            if self.mesh is not None:
                avail = _elastic.available_mesh(
                    tuple(self.mesh.axis_names), devices=self.mesh.devices
                )
                if avail.size < self.mesh.size:
                    # the devices left cannot back the bank mesh every
                    # executor shares: freeze growth at the current pool
                    ceiling = min(
                        ceiling,
                        sum(1 for ex in self._executors if ex.alive),
                    )
            new_target = min(ceiling, self.target_executors + count)
            added = new_target - self.target_executors
            if added <= 0:
                return self.target_executors
            self.target_executors = new_target
            self.max_sessions += added * self.slots_per_executor
            live = [
                ex for ex in self._executors if ex.alive and not ex.draining
            ]
            if live:
                busiest = max(
                    live, key=lambda e: (e.queue_depth(), e.session_count())
                )
                room = new_target - len(live)
                for _ in range(min(added, max(0, room))):
                    ex = self._new_executor(busiest.key, busiest.config)
                    self._executors.append(ex)
                    spawned.append(ex.name)
        with self._ft_lock:
            self._scale_ups += added
            self._last_scale_event = f"scale-up+{added}@t={now:.3f}"
            self.events.append(
                f"scale-up:+{added}" + (f":{reason}" if reason else "")
            )
            self.timeline.append(
                ("scale-up", ",".join(spawned) or f"target={new_target}", now)
            )
        obs.instant(
            "fleet.scale_up", "fleet", added=added, target=new_target,
            spawned=",".join(spawned), reason=reason,
        )
        return new_target

    def scale_down(
        self, *, reason: str = "", migrate_timeout: float = 30.0
    ) -> str | None:
        """Shrink the pool by one executor, with checkpointed slot
        migration off the leaver.

        The least-loaded live executor is marked *draining* (``_place``
        stops routing new sessions to it), the target and session cap
        drop, and every hosted session is live-migrated away: each lifts
        its slot state out at its next group boundary and
        :meth:`_on_migrate` re-shards it for the surviving device set
        before the new host's ``slot_insert``. The drained executor then
        stops gracefully. Returns its name, or ``None`` when the pool is
        already at the one-executor floor."""
        now = self.clock.now()
        with self._lock:
            live = [
                ex for ex in self._executors if ex.alive and not ex.draining
            ]
            if len(live) <= 1 or self.target_executors <= 1:
                return None
            victim = min(live, key=lambda e: (e.session_count(), e.name))
            victim.draining = True
            self.target_executors -= 1
            self.max_sessions = max(
                1, self.max_sessions - self.slots_per_executor
            )
            handles = [
                act.handle
                for act in self._acts.values()
                if act.executor is victim and not act.handle.done()
            ]
        obs.instant(
            "fleet.scale_down", "fleet", executor=victim.name,
            sessions=len(handles), reason=reason,
        )
        for h in handles:
            self.migrate(h, timeout=migrate_timeout)
        victim.stop()
        with self._ft_lock:
            # retire the leaver from the fault machinery: its silence is
            # a deliberate exit, never a missed heartbeat, and a last
            # zombie beat must not re-register it with the monitor
            # (_on_beat filters on _evicted_names); _drained_names keeps
            # health classifying it "drained", not "evicted"
            self._drained_names.add(victim.name)
            self._evicted_names.add(victim.name)
            self.monitor.evict(victim.name)
            self.stragglers.forget(victim.name)
            self._beat_flags.pop(victim.name, None)
            self._scale_downs += 1
            self._last_scale_event = f"scale-down:{victim.name}@t={now:.3f}"
            self.events.append(
                f"scale-down:{victim.name}" + (f":{reason}" if reason else "")
            )
            self.timeline.append(("scale-down", victim.name, now))
        return victim.name

    # -- graceful degradation ladder -----------------------------------------
    def set_degradation(self, level: int) -> int:
        """Move the ladder to ``level`` (clamped to the
        :data:`DEGRADE_LEVELS` range) and apply/undo what that rung
        implies for live sessions.

        Rung 2 (*downshift*) flips every live lossless session's staging
        ring to ``drop_oldest`` **in place** — producers stop blocking
        and overload sheds the oldest staged group instead of building
        latency — and marks the session ``downshifted`` so its finalize
        averages only surviving groups. Stepping back below 2 restores
        each ring to its session's own QoS mode; a session that never
        actually dropped a group finalizes **bit-identically** to an
        undisturbed run (``finalize(steps=G)`` ≡ ``finalize()``). Rungs
        1 (admission backoff) and 3 (shed) gate caller behaviour —
        ``submit_with_retry`` and :meth:`shed_sessions` — so this method
        only records them. Every transition emits ``degrade`` /
        ``restore`` trace instants and a timeline mark."""
        level = max(0, min(int(level), len(DEGRADE_LEVELS) - 1))
        with self._lock:
            old = self.degradation_level
            if level == old:
                return level
            self.degradation_level = level
            acts = [a for a in self._acts.values() if not a.handle.done()]
        now = self.clock.now()
        name = "degrade" if level > old else "restore"
        touched: list[str] = []
        if level >= 2 and old < 2:
            for act in acts:
                if id(act) in self._downshifted_ids:
                    continue
                if act.session.qos_mode != "block":
                    continue  # already running a lossy/cheap ring
                self._downshifted_ids.add(id(act))
                act.downshifted = True
                act.ring.set_policy("drop_oldest")
                touched.append(act.name)
        elif level < 2 <= old:
            for act in acts:
                if id(act) not in self._downshifted_ids:
                    continue
                self._downshifted_ids.discard(id(act))
                act.ring.set_policy(act.session.qos_mode)
                touched.append(act.name)
        for nm in touched:
            obs.instant(
                name, "fleet", session=nm, level=level,
                rung=DEGRADE_LEVELS[level], action="ring",
            )
        obs.instant(
            name, "fleet", level=level, rung=DEGRADE_LEVELS[level],
            previous=old, sessions=len(touched),
        )
        self.metrics.gauge("fleet.degradation_level").set(level)
        with self._ft_lock:
            self.events.append(f"{name}:L{old}->L{level}")
            self.timeline.append((name, DEGRADE_LEVELS[level], now))
        return level

    def shed_sessions(self, count: int = 1) -> list[str]:
        """Shed up to ``count`` live sessions — ladder rung 3.

        Victims are the lowest :attr:`Session.priority` first, newest
        first within a priority tier; each is asked to ``leave()`` at
        its next group boundary, finalizing whatever it already folded —
        shedding is graceful, never a kill. Returns the shed names."""
        if count < 1:
            return []
        with self._lock:
            live = [
                a
                for a in self._acts.values()
                if not a.handle.done() and not a.shed
            ]
            live.sort(key=lambda a: (a.session.priority, -a.seq))
            victims = live[:count]
            for act in victims:
                act.shed = True
        now = self.clock.now()
        names: list[str] = []
        for act in victims:
            names.append(act.name)
            self.metrics.counter("serve.shed").inc()
            obs.instant(
                "fleet.shed", "fleet", session=act.name,
                priority=act.session.priority,
            )
            act.handle.leave()
        with self._ft_lock:
            self._shed_total += len(names)
            for nm in names:
                self.events.append(f"shed@{nm}")
                self.timeline.append(("session-shed", nm, now))
        return names

    def autoscale_state(self) -> dict:
        """The elastic tier's introspection dict (health/healthz surface):
        pool size vs target, draining count, ladder rung, last scale
        event, and cumulative scale/shed counters."""
        with self._lock:
            alive = [ex for ex in self._executors if ex.alive]
            pool = len(alive)
            draining = sum(1 for ex in alive if ex.draining)
            target = self.target_executors
            level = self.degradation_level
            max_sessions = self.max_sessions
        with self._ft_lock:
            last = self._last_scale_event
            ups, downs = self._scale_ups, self._scale_downs
            shed = self._shed_total
        self.metrics.gauge("fleet.pool_size").set(pool)
        self.metrics.gauge("fleet.pool_target").set(target)
        self.metrics.gauge("fleet.degradation_level").set(level)
        return {
            "pool_size": pool,
            "draining": draining,
            "target_executors": target,
            "max_executors": self.max_executors,
            "max_sessions": max_sessions,
            "degradation_level": level,
            "degradation": DEGRADE_LEVELS[level],
            "last_scale_event": last,
            "scale_ups": ups,
            "scale_downs": downs,
            "shed": shed,
        }

    # -- telemetry -----------------------------------------------------------
    def health(self, *, evaluate_slos: bool = True):
        """Fold the fleet's state into one
        :class:`repro_torch.obs.health.HealthReport`.

        Heartbeat ages/classification come from the monitor, queue depth
        and session counts from the executors, ring occupancy from each
        session's staging ring, per-executor headroom from the paper-§6
        capacity model vs the straggler EWMA, and SLO verdicts from a
        fresh ``slo_engine.evaluate()`` (skippable — ``health()`` in a
        tight poll loop shouldn't consume evaluation-mark budget). Ring
        and queue gauges are also written into ``self.metrics`` so the
        scrape endpoint carries what the report shows.
        """
        from repro_torch.obs import health as _health

        now = self.clock.now()
        with self._lock:
            executors = list(self._executors)
            acts = list(self._acts.values())
        with self._ft_lock:
            beats = self.monitor.last_beats(now)
            dead = set(self.monitor.dead(now))
            evicted = set(self._evicted_names)
            drained = set(self._drained_names)
            slow = set(self.stragglers.stragglers())
            ewmas = {ex.name: self.stragglers.ewma(ex.name) for ex in executors}
            fleet_info = {
                "events": list(self.events[-8:]),
                "awaiting_recovery": sorted(self._awaiting_recovery),
                "evicted": sorted(evicted - drained),
                "drained": sorted(drained),
                "workers": self.monitor.workers(),
            }
        verdicts: list[dict] = []
        if self.slo_engine is not None and evaluate_slos:
            verdicts = [v.to_dict() for v in self.slo_engine.evaluate()]
        ex_rows = []
        cap_cache: dict = {}
        for ex in executors:
            state, age = _health.classify_heartbeat(
                ex.name, evicted=evicted, dead=dead, beats=beats,
                drained=drained,
            )
            cfg = ex.config
            cap_key = (cfg.height, cfg.width, cfg.num_groups, cfg.frames_per_group)
            cap = cap_cache.get(cap_key)
            if cap is None:
                cap = _health.capacity_reference(
                    height=cfg.height,
                    width=cfg.width,
                    num_groups=cfg.num_groups,
                    frames_per_group=cfg.frames_per_group,
                )
                cap_cache[cap_key] = cap
            ewma = ewmas.get(ex.name)
            headroom = (
                cap["group_floor_s"] / ewma if ewma and ewma > 0 else None
            )
            queue = ex.queue_depth()
            sessions = ex.session_count()
            self.metrics.gauge("fleet.queue_depth", executor=ex.name).set(queue)
            self.metrics.gauge("fleet.sessions", executor=ex.name).set(sessions)
            if headroom is not None:
                self.metrics.gauge("fleet.headroom", executor=ex.name).set(headroom)
            ex_rows.append(
                _health.ExecutorHealth(
                    name=ex.name,
                    alive=ex.alive,
                    heartbeat=state,
                    last_beat_age_s=age,
                    sessions=sessions,
                    queue_depth=queue,
                    cohort_steps=ex.cohort_steps,
                    step_ewma_s=ewma,
                    straggler=ex.name in slow,
                    headroom=headroom,
                    capacity=cap,
                )
            )
        sess_rows = []
        for act in acts:
            occupancy = len(act.ring)
            self.metrics.gauge("fleet.ring_occupancy", session=act.name).set(
                occupancy
            )
            sess_rows.append(
                {
                    "name": act.name,
                    "executor": act.executor.name if act.executor else None,
                    "steps": act.steps,
                    "ring_occupancy": occupancy,
                    "restarts": act.restarts,
                    "migrations": act.migrations,
                }
            )
        return _health.HealthReport(
            at=now,
            status=_health.rollup_status(ex_rows, verdicts),
            executors=ex_rows,
            sessions=sorted(sess_rows, key=lambda s: s["name"]),
            slos=verdicts,
            fleet=fleet_info,
            autoscale=self.autoscale_state(),
        )

    def recovery_latencies_s(self) -> list[float]:
        """Kill-to-recovered spans: each ``session-recovered`` mark minus
        the latest ``executor-dead`` before it (clock units — virtual
        under a ``FakeClock``, real seconds on the real clock)."""
        with self._ft_lock:
            marks = list(self.timeline)
        out: list[float] = []
        last_dead: float | None = None
        for kind, _, t in marks:
            if kind == "executor-dead":
                last_dead = t
            elif kind == "session-recovered" and last_dead is not None:
                out.append(t - last_dead)
        return out

    def stats(self) -> dict:
        snap = super().stats()
        with self._ft_lock:
            snap["fleet"] = {
                "events": list(self.events),
                "awaiting_recovery": sorted(self._awaiting_recovery),
                "evicted": sorted(self._evicted_names),
                "workers": self.monitor.workers(),
            }
        snap["autoscale"] = self.autoscale_state()
        return snap
