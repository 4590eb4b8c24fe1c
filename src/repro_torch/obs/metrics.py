"""Counter/gauge/histogram registry with labels — the metrics half of
``repro_torch.obs`` (a copy of ``repro.obs.metrics``).

Dependency-free (stdlib only, like ``repro_torch.core.ringbuf``): the registry
sits on executor hot paths, so it must be importable before torch and cost
almost nothing to update. Three instrument types:

* :class:`Counter` — monotonically increasing float (frames folded, bytes
  staged, deadline misses). ``inc`` writes a *per-thread cell* (plain dict
  slot keyed by thread id, no lock on the hot path — each thread only ever
  touches its own cell); ``value``/``snapshot`` sum the cells.
* :class:`Gauge` — last-write-wins scalar (ring occupancy, pool size).
* :class:`Histogram` — bounded reservoir of raw observations plus exact
  count/sum/min/max, accumulated per thread and merged at snapshot time.
  Retention mirrors ``RingBuffer``'s dwell samples: the first
  ``reservoir`` observations fill the buffer, later ones overwrite
  round-robin (newest-window semantics), so endless streams stay O(1).
  Percentiles are nearest-rank over the merged reservoirs —
  :func:`nearest_rank` is the one shared implementation (``ringbuf`` and
  the serve layer delegate here).

Instruments are identified by ``(name, labels)``: ``registry.counter(
"serve.frames", session="s0")`` returns the same object every call.
``snapshot()`` renders the whole registry as a plain dict (the *source*
``StreamReport``/``SessionReport`` columns are derived from — see
``repro_torch.core.streaming``), and :meth:`MetricsRegistry.prometheus_text`
emits Prometheus-style text exposition for scrapers.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "nearest_rank",
    "DEFAULT_RESERVOIR",
]

#: default per-histogram raw-sample retention (matches the ring buffers'
#: MAX_DWELL_SAMPLES so percentile columns keep their windowed semantics)
DEFAULT_RESERVOIR = 4096

#: histogram quantiles materialized by ``snapshot()`` (percent units)
SNAPSHOT_QUANTILES = (50.0, 95.0, 99.0)


def nearest_rank(samples: Iterable[float], q: float) -> float:
    """Nearest-rank percentile over raw (unsorted) samples.

    Well-defined for every input the telemetry paths can produce:
    an empty iterable returns 0.0 (never an IndexError), a single sample
    is every percentile of itself, and non-finite samples (NaN/inf from a
    torn reading) are dropped rather than poisoning the sort. ``q``
    outside [0, 100] is a caller bug and raises ``ValueError``.
    """
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q!r}")
    ordered = sorted(s for s in samples if math.isfinite(s))
    if not ordered:
        return 0.0
    rank = min(len(ordered), max(1, math.ceil(q / 100.0 * len(ordered))))
    return ordered[rank - 1]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _format_key(name: str, label_key: tuple) -> str:
    if not label_key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in label_key)
    return f"{name}{{{inner}}}"


class _Instrument:
    """Shared identity bits: name + frozen labels."""

    kind = "instrument"

    def __init__(self, name: str, label_key: tuple):
        self.name = name
        self.label_key = label_key

    @property
    def key(self) -> str:
        return _format_key(self.name, self.label_key)


class Counter(_Instrument):
    """Monotonic accumulator with per-thread cells (lock-free ``inc``)."""

    kind = "counter"

    def __init__(self, name: str, label_key: tuple):
        super().__init__(name, label_key)
        self._cells: dict[int, list[float]] = {}
        self._lock = threading.Lock()

    def _cell(self) -> list[float]:
        ident = threading.get_ident()
        cell = self._cells.get(ident)
        if cell is None:
            with self._lock:
                cell = self._cells.setdefault(ident, [0.0])
        return cell

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counters only go up; got inc({v})")
        self._cell()[0] += v

    @property
    def value(self) -> float:
        with self._lock:
            cells = list(self._cells.values())
        return sum(c[0] for c in cells)


class Gauge(_Instrument):
    """Last-write-wins scalar (``set``) with an ``add`` convenience."""

    kind = "gauge"

    def __init__(self, name: str, label_key: tuple):
        super().__init__(name, label_key)
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, v: float) -> None:
        with self._lock:
            self._value += float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _Reservoir:
    """One thread's bounded sample window + exact running stats."""

    __slots__ = ("samples", "count", "total", "min", "max", "bound")

    def __init__(self, bound: int):
        self.samples: list[float] = []
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.bound = bound

    def observe(self, v: float) -> None:
        if len(self.samples) < self.bound:
            self.samples.append(v)
        else:  # overwrite oldest: count tracks observations so far
            self.samples[self.count % self.bound] = v
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v


class Histogram(_Instrument):
    """Bounded-reservoir histogram with per-thread accumulation."""

    kind = "histogram"

    def __init__(self, name: str, label_key: tuple, reservoir: int = DEFAULT_RESERVOIR):
        super().__init__(name, label_key)
        if reservoir < 1:
            raise ValueError(f"reservoir must be >= 1, got {reservoir}")
        self.reservoir = reservoir
        self._cells: dict[int, _Reservoir] = {}
        self._lock = threading.Lock()

    def _cell(self) -> _Reservoir:
        ident = threading.get_ident()
        cell = self._cells.get(ident)
        if cell is None:
            with self._lock:
                cell = self._cells.setdefault(ident, _Reservoir(self.reservoir))
        return cell

    def observe(self, v: float) -> None:
        self._cell().observe(float(v))

    def observe_many(self, vs: Iterable[float]) -> None:
        cell = self._cell()
        for v in vs:
            cell.observe(float(v))

    def _merged(self) -> tuple[list[float], int, float, float, float]:
        with self._lock:
            cells = list(self._cells.values())
        samples: list[float] = []
        count, total = 0, 0.0
        lo, hi = math.inf, -math.inf
        for c in cells:
            samples.extend(c.samples)
            count += c.count
            total += c.total
            lo = min(lo, c.min)
            hi = max(hi, c.max)
        return samples, count, total, lo, hi

    @property
    def count(self) -> int:
        return self._merged()[1]

    @property
    def sum(self) -> float:
        return self._merged()[2]

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the merged retained samples."""
        return nearest_rank(self._merged()[0], q)

    def stats(self) -> dict:
        samples, count, total, lo, hi = self._merged()
        out = {
            "count": count,
            "sum": total,
            "min": lo if count else 0.0,
            "max": hi if count else 0.0,
        }
        for q in SNAPSHOT_QUANTILES:
            out[f"p{q:g}"] = nearest_rank(samples, q)
        return out


class MetricsRegistry:
    """Get-or-create registry of labelled instruments.

    Thread-safe: instrument creation takes the registry lock once per
    ``(name, labels)``; the returned instruments are cached by callers (or
    re-fetched — the lookup is one dict get) and do their own per-thread
    accumulation. A registry is cheap enough to create per executor run:
    ``run_pipelined`` builds one per stream and derives its
    ``StreamReport`` from ``snapshot()``; the serve scheduler owns one for
    the life of the service (per-session columns are label-scoped).
    """

    def __init__(self, *, reservoir: int = DEFAULT_RESERVOIR):
        self.reservoir = reservoir
        self._instruments: dict[tuple, _Instrument] = {}
        self._help: dict[str, str] = {}
        self._lock = threading.Lock()

    def describe(self, name: str, text: str) -> None:
        """Attach help text to a metric name (all label sets share it).

        Emitted as the ``# HELP`` line in :meth:`prometheus_text`;
        undescribed metrics fall back to ``"<kind> <name>"``.
        """
        with self._lock:
            self._help[name] = text

    def _get(self, cls, name: str, labels: dict, **kw) -> Any:
        key = (cls.kind, name, _label_key(labels))
        inst = self._instruments.get(key)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(key)
                if inst is None:
                    inst = cls(name, key[2], **kw)
                    self._instruments[key] = inst
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, reservoir: int | None = None, **labels) -> Histogram:
        return self._get(
            Histogram, name, labels, reservoir=reservoir or self.reservoir
        )

    def instruments(self) -> list[_Instrument]:
        with self._lock:
            return list(self._instruments.values())

    # -- read side -----------------------------------------------------------
    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Current value of a counter/gauge (``default`` when absent)."""
        for kind in ("counter", "gauge"):
            inst = self._instruments.get((kind, name, _label_key(labels)))
            if inst is not None:
                return inst.value
        return default

    def percentile(self, name: str, q: float, **labels) -> float:
        """Histogram percentile (0.0 when the histogram does not exist)."""
        inst = self._instruments.get(("histogram", name, _label_key(labels)))
        return inst.percentile(q) if inst is not None else 0.0

    def percentile_all(self, name: str, q: float) -> float:
        """Percentile over the merged reservoirs of *every* label set of
        ``name`` — the fleet-wide view (e.g. p99 across all sessions).
        0.0 when no such histogram exists."""
        samples: list[float] = []
        for inst in self.instruments():
            if isinstance(inst, Histogram) and inst.name == name:
                samples.extend(inst._merged()[0])
        return nearest_rank(samples, q)

    def snapshot(self) -> dict:
        """The whole registry as one plain dict, keyed ``name{k=v,...}``.

        Counters/gauges map to ``{"type", "value"}``; histograms to
        ``{"type", "count", "sum", "min", "max", "p50", "p95", "p99"}``.
        This is the canonical read API: report columns and tests derive
        from a snapshot, never from instrument internals.
        """
        out: dict[str, dict] = {}
        for inst in self.instruments():
            if isinstance(inst, Histogram):
                entry: dict = {"type": inst.kind, **inst.stats()}
            else:
                entry = {"type": inst.kind, "value": inst.value}
            out[inst.key] = entry
        return out

    def prometheus_text(self) -> str:
        """Prometheus-style text exposition of the registry.

        Counters get the ``_total`` suffix, histograms are exposed
        summary-style (``_count``/``_sum`` plus ``quantile`` series).
        Metric names are sanitized (``.`` -> ``_``); label values are
        escaped per the exposition format (``\\``, ``"``, newline), and
        every family gets a ``# HELP`` line (help text escapes ``\\``
        and newline only, per the spec) before its ``# TYPE``.
        """
        by_name: dict[tuple[str, str], list[_Instrument]] = {}
        for inst in self.instruments():
            by_name.setdefault((inst.name, inst.kind), []).append(inst)
        with self._lock:
            help_texts = dict(self._help)
        lines: list[str] = []
        for (name, kind), insts in sorted(by_name.items()):
            pname = _prom_name(name)
            ptype = {"counter": "counter", "gauge": "gauge", "histogram": "summary"}[
                kind
            ]
            help_text = help_texts.get(name, f"{kind} {name}")
            lines.append(f"# HELP {pname} {_prom_escape_help(help_text)}")
            lines.append(f"# TYPE {pname} {ptype}")
            for inst in sorted(insts, key=lambda i: i.label_key):
                labels = dict(inst.label_key)
                if isinstance(inst, Histogram):
                    s = inst.stats()
                    for q in SNAPSHOT_QUANTILES:
                        lines.append(
                            _prom_line(
                                pname,
                                {**labels, "quantile": f"{q / 100.0:g}"},
                                s[f"p{q:g}"],
                            )
                        )
                    lines.append(_prom_line(f"{pname}_sum", labels, s["sum"]))
                    lines.append(_prom_line(f"{pname}_count", labels, s["count"]))
                elif isinstance(inst, Counter):
                    lines.append(_prom_line(f"{pname}_total", labels, inst.value))
                else:
                    lines.append(_prom_line(pname, labels, inst.value))
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return out if not out or not out[0].isdigit() else f"_{out}"


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_escape_help(v: str) -> str:
    # HELP lines escape backslash and newline but NOT quotes (text format)
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_line(name: str, labels: dict, value) -> str:
    if labels:
        inner = ",".join(
            f'{_prom_name(k)}="{_prom_escape(str(v))}"'
            for k, v in sorted(labels.items())
        )
        return f"{name}{{{inner}}} {value}"
    return f"{name} {value}"
