"""repro_torch.obs — span tracing + metrics registry (copies of the
reference's ``repro.obs.trace`` and ``repro.obs.metrics``).

Stdlib-only by construction (no torch, no numpy), so the executors can
instrument against it on hot loops:

* :mod:`repro_torch.obs.trace` — bounded-ring span/instant tracer with an
  injectable clock and Chrome-trace export. Disabled unless
  ``REPRO_OBS=1`` (or ``configure``); the disabled path is a preallocated
  no-op. ``annotate=True`` mirrors spans into ``torch.profiler``.
* :mod:`repro_torch.obs.metrics` — labelled counter/gauge/histogram
  registry whose ``snapshot()`` the ``StreamReport`` columns derive from.

The reference's judgement tier (``slo``, ``health``, ``regress``) is not
ported yet (ROADMAP.md queue A item 11).
"""

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    nearest_rank,
)
from repro_torch.obs.trace import (
    Span,
    Tracer,
    configure,
    export_chrome,
    get_tracer,
    instant,
    span,
    validate_chrome_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "nearest_rank",
    "Span",
    "Tracer",
    "configure",
    "export_chrome",
    "get_tracer",
    "instant",
    "span",
    "validate_chrome_trace",
]
