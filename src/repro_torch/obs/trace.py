"""Span tracing with Chrome-trace/Perfetto export — the trace half of
``repro_torch.obs`` (a copy of ``repro.obs.trace``).

A :class:`Tracer` records *spans* (named durations with thread/session/
executor attribution) and *instants* (point events: an eviction, a
deadline miss) into one bounded ring (``collections.deque(maxlen=...)``),
so a long-lived service keeps the newest window and never grows without
bound. ``export_chrome()`` renders the ring as Chrome trace-event JSON —
load the file at ``chrome://tracing`` or https://ui.perfetto.dev.

Determinism is a design input, not an afterthought: the clock is
injectable (any object with a ``.now() -> float`` method, duck-type
compatible with the reference's ``repro.serve.faults.FakeClock`` — deliberately *not*
imported here, so ``repro_torch.obs`` stays stdlib-only), and B/E ordering is
tie-broken by a global sequence number drawn at span entry *and* exit, so
traces taken under a frozen fake clock still nest correctly.

The disabled path is the hot path. ``Tracer(enabled=False).span(...)``
returns one preallocated no-op context manager and touches no lock, no
clock, and no ring — ``run_pipelined`` and the serve scheduler call it
per frame.

Optional ``annotate=True`` additionally wraps every span in
``torch.profiler.record_function`` so obs spans line up with CUDA kernels
in a ``torch.profiler`` trace; torch is imported lazily.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from functools import wraps
from typing import Any, Callable, Iterable

__all__ = [
    "Tracer",
    "Span",
    "configure",
    "get_tracer",
    "span",
    "instant",
    "export_chrome",
    "validate_chrome_trace",
    "DEFAULT_MAX_EVENTS",
]

#: default bounded-ring capacity (completed spans + instants retained)
DEFAULT_MAX_EVENTS = 65536

_seq = itertools.count()  # global tie-breaker for equal timestamps


class _MonotonicClock:
    """Default wall clock; same shape as ``serve.faults.Clock``."""

    def now(self) -> float:
        return time.monotonic()


class _NullSpan:
    """Shared no-op span: the entire disabled-mode cost of ``span()``."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:  # parity with Span.set
        pass


_NULL_SPAN = _NullSpan()


class Span:
    """A live span; records itself into the tracer ring on ``__exit__``."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_seq0", "_annotation")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._seq0 = 0
        self._annotation = None

    def set(self, **args) -> None:
        """Attach/overwrite args mid-span (e.g. a result computed inside)."""
        self.args.update(args)

    def __enter__(self):
        # Draw the B-side sequence number *now*: under a frozen FakeClock
        # an outer span must still sort before the inner span it contains.
        self._seq0 = next(_seq)
        self._t0 = self._tracer.clock.now()
        ann = self._tracer._annotation_cls
        if ann is not None:
            self._annotation = ann(self.name)
            self._annotation.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        t1 = self._tracer.clock.now()
        self._tracer._record(
            {
                "kind": "span",
                "name": self.name,
                "cat": self.cat,
                "t0": self._t0,
                "t1": t1,
                "seq0": self._seq0,
                "seq1": next(_seq),
                "tid": threading.get_ident(),
                "thread": threading.current_thread().name,
                "args": self.args,
            }
        )
        return False


class Tracer:
    """Bounded-ring span/instant recorder with Chrome-trace export."""

    def __init__(
        self,
        clock: Any | None = None,
        *,
        max_events: int = DEFAULT_MAX_EVENTS,
        enabled: bool = True,
        annotate: bool = False,
    ):
        self.clock = clock if clock is not None else _MonotonicClock()
        self.enabled = enabled
        self._events: collections.deque = collections.deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._annotation_cls = _load_annotation_cls() if annotate else None

    # -- write side ----------------------------------------------------------
    def span(self, name: str, cat: str = "", **args) -> Any:
        """Context manager timing a block. No-op singleton when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Record a point event (eviction, deadline miss, restore...)."""
        if not self.enabled:
            return
        self._record(
            {
                "kind": "instant",
                "name": name,
                "cat": cat,
                "t0": self.clock.now(),
                "seq0": next(_seq),
                "tid": threading.get_ident(),
                "thread": threading.current_thread().name,
                "args": args,
            }
        )

    def trace(self, name: str | None = None, cat: str = "") -> Callable:
        """Decorator form: ``@tracer.trace()`` spans every call."""

        def deco(fn: Callable) -> Callable:
            label = name or getattr(fn, "__qualname__", fn.__name__)

            @wraps(fn)
            def wrapper(*a, **kw):
                with self.span(label, cat):
                    return fn(*a, **kw)

            return wrapper

        return deco

    def _record(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    # -- read side -----------------------------------------------------------
    def events(self) -> list[dict]:
        """Snapshot of retained raw events (oldest first)."""
        with self._lock:
            return list(self._events)

    def names(self, kind: str | None = None) -> list[str]:
        """Event names in record order (optionally one kind) — for
        sequence assertions in tests."""
        return [
            e["name"] for e in self.events() if kind is None or e["kind"] == kind
        ]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def export_chrome(self, path: str | None = None) -> dict:
        """Render retained events as a Chrome trace-event JSON object.

        Timestamps are microseconds relative to the earliest retained
        event (Chrome's viewer prefers small positive ts). Threads get
        stable small integer ``tid``s in order of first appearance plus
        ``thread_name`` metadata events. Events sort by ``(ts, seq)`` so
        B precedes its nested children and E events close inner-first
        even when a fake clock never advances. If ``path`` is given the
        JSON is also written there (parent dirs created).
        """
        events = self.events()
        pid = os.getpid()
        epoch = min((e["t0"] for e in events), default=0.0)
        tids: dict[int, int] = {}
        out: list[tuple[float, int, dict]] = []

        def tid_of(ev: dict) -> int:
            ident = ev["tid"]
            if ident not in tids:
                tids[ident] = len(tids)
            return tids[ident]

        thread_names: dict[int, str] = {}
        for ev in events:
            tid = tid_of(ev)
            thread_names.setdefault(tid, ev["thread"])
            base = {"pid": pid, "tid": tid, "cat": ev["cat"] or "repro_torch"}
            args = ev["args"]
            if ev["kind"] == "span":
                ts0 = (ev["t0"] - epoch) * 1e6
                ts1 = (ev["t1"] - epoch) * 1e6
                out.append(
                    (ts0, ev["seq0"], {**base, "name": ev["name"], "ph": "B", "ts": ts0, "args": args})
                )
                out.append(
                    (ts1, ev["seq1"], {**base, "name": ev["name"], "ph": "E", "ts": ts1})
                )
            else:
                ts0 = (ev["t0"] - epoch) * 1e6
                out.append(
                    (
                        ts0,
                        ev["seq0"],
                        {**base, "name": ev["name"], "ph": "i", "ts": ts0, "s": "t", "args": args},
                    )
                )
        out.sort(key=lambda e: (e[0], e[1]))
        trace_events = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": tname},
            }
            for tid, tname in sorted(thread_names.items())
        ]
        trace_events.extend(e for _, _, e in out)
        doc = {"displayTimeUnit": "ms", "traceEvents": trace_events}
        if path is not None:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def _load_annotation_cls():
    try:
        from torch.profiler import record_function

        return record_function
    except Exception:
        return None


def validate_chrome_trace(doc: dict) -> list[dict]:
    """Assert ``doc`` is well-formed Chrome trace JSON; return its events.

    Checks the containers and required per-event keys, that timestamps
    are non-negative and non-decreasing in stream order, and that B/E
    events pair up properly nested per (pid, tid). Raises ``ValueError``
    with a specific message on the first violation — shared by the test
    suite and any trace artifact.
    """
    if not isinstance(doc, dict):
        raise ValueError("trace must be a JSON object")
    if "traceEvents" not in doc or not isinstance(doc["traceEvents"], list):
        raise ValueError("trace must contain a traceEvents list")
    events = doc["traceEvents"]
    stacks: dict[tuple, list[str]] = {}
    last_ts = -1.0
    for i, ev in enumerate(events):
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing required key {key!r}")
        ph = ev["ph"]
        if ph == "M":
            continue
        if ph not in ("B", "E", "i", "X"):
            raise ValueError(f"event {i} has unsupported phase {ph!r}")
        if "ts" not in ev:
            raise ValueError(f"event {i} ({ph}) missing ts")
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i} ts must be a non-negative number, got {ts!r}")
        if ts < last_ts:
            raise ValueError(f"event {i} ts {ts} decreases (prev {last_ts})")
        last_ts = ts
        key = (ev["pid"], ev["tid"])
        stack = stacks.setdefault(key, [])
        if ph == "B":
            stack.append(ev["name"])
        elif ph == "E":
            if not stack:
                raise ValueError(f"event {i}: E with no open B on {key}")
            stack.pop()
    for key, stack in stacks.items():
        if stack:
            raise ValueError(f"unclosed B events on {key}: {stack}")
    return events


# -- module-level default tracer ---------------------------------------------
# Library code calls ``obs.span(...)``/``obs.instant(...)``; by default the
# tracer is disabled so the whole stack pays only the no-op path. Enable
# programmatically with ``configure(enabled=True)`` or via environment:
# REPRO_OBS=1 enables tracing at import, REPRO_OBS_TRACE_PATH=<file>
# additionally dumps the Chrome trace at interpreter exit.

_default_tracer = Tracer(
    enabled=os.environ.get("REPRO_OBS", "") not in ("", "0"),
    annotate=os.environ.get("REPRO_OBS_ANNOTATE", "") not in ("", "0"),
)


def get_tracer() -> Tracer:
    """The process-default tracer used by the module-level helpers."""
    return _default_tracer


def configure(
    *,
    enabled: bool | None = None,
    clock: Any | None = None,
    max_events: int | None = None,
    annotate: bool | None = None,
) -> Tracer:
    """Reconfigure the default tracer in place; returns it.

    ``max_events`` rebuilds the ring (retained events carry over up to
    the new bound); other arguments update fields directly. Passing
    ``None`` leaves a setting untouched.
    """
    t = _default_tracer
    if enabled is not None:
        t.enabled = enabled
    if clock is not None:
        t.clock = clock
    if annotate is not None:
        t._annotation_cls = _load_annotation_cls() if annotate else None
    if max_events is not None:
        with t._lock:
            t._events = collections.deque(t._events, maxlen=max_events)
    return t


def span(name: str, cat: str = "", **args) -> Any:
    return _default_tracer.span(name, cat, **args)


def instant(name: str, cat: str = "", **args) -> None:
    _default_tracer.instant(name, cat, **args)


def export_chrome(path: str | None = None) -> dict:
    return _default_tracer.export_chrome(path)


_trace_path = os.environ.get("REPRO_OBS_TRACE_PATH", "")
if _trace_path:
    import atexit

    atexit.register(export_chrome, _trace_path)
