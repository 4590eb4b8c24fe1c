"""Multi-tenant streaming session service (counterpart of ``repro.serve``).

Schedules many concurrent PRISM streams over a shared pool of executors
on one device: each :class:`Session` brings its own source, config and
filter, staging ring and QoS class; the :class:`SessionScheduler`
co-batches compatible sessions through one banked device step per group
(stacking them along the filter state's bank axis), with admission
control and per-session latency/drop telemetry (:class:`SessionReport`).
``SessionScheduler(device=None)`` and ``FleetScheduler(device=None)`` run
on CUDA unless told otherwise.

:class:`FleetScheduler` adds the fault-tolerance tier: heartbeat and
straggler supervision over the pool, checkpointed crash recovery
(:class:`SessionCheckpointer`) with exact replay, live session
migration, ``scale_up``/``scale_down`` of the pool and the
graceful-degradation ladder (:data:`DEGRADE_LEVELS`).
:func:`retry_with_backoff` (``submit_with_retry``) absorbs admission
refusals, and :class:`FaultPlan` / :class:`FakeClock` script executor
faults by cohort step index with no wall-clock sleeps.

The elastic tier drives the fleet: :class:`Autoscaler` turns the
``admission_pressure_slo`` burn-rate verdicts into ``scale_up``, ladder
and ``scale_down`` actions (no threads: the operator's loop calls
``evaluate``), and the load generator (:func:`build_trace`,
:func:`replay_trace` over the Poisson, diurnal and flash-crowd schedules,
:class:`TenantProfile`) replays a seeded overload on a ``FakeClock``.

A 1-session run is bit-identical to ``repro_torch.core.streaming
.run_pipelined`` for every registered filter.
"""

from repro_torch.serve.autoscale import (
    AutoscaleDecision,
    Autoscaler,
    admission_pressure_slo,
)
from repro_torch.serve.faults import (
    Clock,
    FakeClock,
    FaultPlan,
    InjectedExecutorFailure,
)
from repro_torch.serve.fleet import DEGRADE_LEVELS, FleetScheduler
from repro_torch.serve.loadgen import (
    ArrivalEvent,
    TenantProfile,
    build_trace,
    diurnal_schedule,
    flash_crowd_schedule,
    heavy_tail_groups,
    poisson_schedule,
    replay_trace,
)
from repro_torch.serve.recovery import CheckpointMismatch, SessionCheckpointer
from repro_torch.serve.retry import BackoffPolicy, retry_with_backoff
from repro_torch.serve.scheduler import SessionScheduler
from repro_torch.serve.session import (
    AdmissionError,
    Session,
    SessionHandle,
    SessionReport,
)

__all__ = [
    "AdmissionError",
    "ArrivalEvent",
    "AutoscaleDecision",
    "Autoscaler",
    "BackoffPolicy",
    "CheckpointMismatch",
    "Clock",
    "DEGRADE_LEVELS",
    "FakeClock",
    "FaultPlan",
    "FleetScheduler",
    "InjectedExecutorFailure",
    "Session",
    "SessionCheckpointer",
    "SessionHandle",
    "SessionReport",
    "SessionScheduler",
    "TenantProfile",
    "admission_pressure_slo",
    "build_trace",
    "diurnal_schedule",
    "flash_crowd_schedule",
    "heavy_tail_groups",
    "poisson_schedule",
    "replay_trace",
    "retry_with_backoff",
]
