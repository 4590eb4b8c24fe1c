"""Fault-tolerance and elastic runtime (counterpart of ``repro.runtime``)."""

from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    HeartbeatMonitor,
    StragglerDetector,
    Supervisor,
)
from repro_torch.runtime.elastic import elastic_reshard  # noqa: F401
