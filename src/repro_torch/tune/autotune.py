"""Measured autotuner: search launch geometry and executor knobs by timing
(counterpart of ``repro.tune.autotune``).

The paper's burst lengths and buffer geometry are design-space-exploration
outputs, not constants. This module is that exploration loop for the
CUDA kernels:

* **Kernel geometry** — for each kernel family a config uses, a small
  candidate set of (row_tile, pair_tile) launches is generated around the
  Hopper launch model's point (:func:`repro_torch.tune.budget.model_candidates`):
  the kernel's default layout (the heuristic, always first), the model's
  point, its half- and double-work neighbours, its work laid along pairs,
  and the fewest-blocks launch whose last wave is mostly full. The model
  rejects, before any launch and with its reason, a geometry that cannot
  or should not run (:func:`~repro_torch.tune.budget.reject_reason`), so
  every candidate is timed, and any error raised while timing one
  propagates: on CUDA a failed launch can leave the context unusable, and
  nothing here runs another candidate in its place. Each candidate is
  timed on the real ``repro_torch.kernels.ops`` entry point at the
  config's shape, in two round-robin passes (the minimum per candidate),
  and it displaces the heuristic only by a 5 % margin. On the card the
  timer reads CUDA events behind a device sleep, as ``chip_smoke.py``'s
  ``time_ms`` does, so the wrappers' host time does not count; on a CPU
  device it reads ``perf_counter`` around the plain versions.
* **Executor knobs** — ring depth (``num_slots``) is timed through short
  ``run_pipelined`` replays of chunks already on the device under a small
  injected readout burst, and ``frames_per_chunk`` records the staging
  chunk length whose per-frame step cost measured lowest (advisory).

Results are memoized in-process and persisted through
``repro_torch.tune.cache.PlanCache``; a cache hit performs no
measurement. Tile search runs only where the kernels run: backend
``pallas``, or ``auto`` on a CUDA device (the reference's ``auto`` picks
its Pallas kernels on the TPU alone). ``xla`` has no launch geometry, so
its plans carry executor knobs only. Three families have one geometry
(``median_combine``, ``spatial``, and ``ema``, whose ``pair_tile`` stays
at the reference's pinned pick because it changes the bits): their
search times that one candidate and records it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import ops, quant
from repro_torch.kernels.ref import as_torch_dtype
from repro_torch.tune import budget
from repro_torch.tune.cache import PlanCache
from repro_torch.tune.plan import Plan, TileGeom, exec_key, family_key

__all__ = [
    "candidate_label",
    "family_step",
    "family_timer",
    "filter_families",
    "plan_from_file",
    "resolved_backend",
    "tile_candidates",
    "tune_exec_knobs",
    "tune_plan",
    "vector_path",
]

_WARMUP_STEPS = 1
_TIMED_STEPS = 3
_EXEC_CHUNKS = 5
_EXEC_DEPTHS = (1, 2, 3)
_BURST_COMPUTE_MULT = 2.5
#: a tile candidate must beat the heuristic by this fraction to displace
#: it; a ring depth must beat the ping-pong default by _DEPTH_MARGIN
#: (the reference's margins: below them a difference is noise)
_TILE_MARGIN = 0.05
_DEPTH_MARGIN = 0.10
#: device clock cycles of the sleep that heads each timed chain (about 1 ms
#: at the H100's 1.98 GHz boost clock), doubled up to 16 times while the
#: host had not queued the chain before the sleep ended
_QUEUE_CYCLES = 2_000_000


def _stream_dtype(config) -> str:
    return quant.validate_stream_dtype(str(getattr(config, "stream_dtype", "u16")))


def _in_dtype(config) -> str:
    """Plan-cache spelling of the config's wire format (``uint16`` for u16)."""
    return quant.container_name(_stream_dtype(config))


def filter_families(config) -> list[tuple[str, int]]:
    """(kernel family, window length) pairs the config's filter dispatches to."""
    name = getattr(config, "filter_name", "pair_average")
    k = int(getattr(config, "median_window", 1) or 1)
    return {
        "pair_average": [("stream", 1)],
        "temporal_median": [("median_insert", 1), ("median_combine", k)],
        "ema_variance": [("ema", 1)],
        "spatial_box": [("stream", 1), ("spatial", 1)],
    }.get(name, [("stream", 1)])


def vector_path(config) -> bool:
    """Whether the step's timed launches take its vector path
    (``denoise_stream.step_path``: u16/u8 wire, a float32 sum, H·W a
    multiple of 8; the timer's fresh tensors are aligned)."""
    return (
        _stream_dtype(config) != "p12"
        and str(getattr(config, "accum_dtype", "float32")) == "float32"
        and int(config.height) * int(config.width) % 8 == 0
    )


def tile_candidates(
    family: str,
    p: int,
    h: int,
    w: int,
    *,
    stream_dtype: str = "u16",
    vector: bool = True,
    limits: budget.DeviceLimits | None = None,
) -> list[tuple]:
    """The measured search's candidates around the launch model's point,
    the heuristic (the kernel's default layout) first."""
    return budget.model_candidates(
        family, p, h, w, stream_dtype=stream_dtype, vector=vector, limits=limits
    )


# ---------------------------------------------------------------------------
# Per-family timers: chained real steps through the ops dispatch boundary.
# ---------------------------------------------------------------------------


def _time_chain(step: Callable, state, device: torch.device,
                warmup=_WARMUP_STEPS, iters=_TIMED_STEPS) -> float:
    """Seconds per step of a chain of ``iters`` steps threading ``state``.

    On a CUDA device: CUDA events around the chain, behind a device sleep
    that the host's queuing of the chain must not outlast (the sample is
    taken again behind a longer sleep when it did, and a chain the host
    cannot queue within 16 sleeps raises). Elsewhere: ``perf_counter``."""
    for _ in range(warmup):
        state = step(state)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            state = step(state)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        cycles = _QUEUE_CYCLES
        while True:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(iters):
                state = step(state)
            covered = not start.query()
            end.record()
            end.synchronize()
            if covered:
                return start.elapsed_time(end) / 1e3 / iters
            if cycles >= 16 * _QUEUE_CYCLES:
                raise RuntimeError(
                    f"the host queued {iters} steps for longer than a {cycles}-cycle "
                    "device sleep"
                )
            cycles *= 2


def _chunk(n: int, h: int, w: int, stream_dtype: str, device) -> torch.Tensor:
    """A wire-format chunk on ``device``: mono12 values in the stream container."""
    rng = np.random.default_rng(0)
    mono12 = rng.integers(0, 4096, (n, h, w)).astype(np.uint16)
    return torch.from_numpy(np.ascontiguousarray(quant.encode(mono12, stream_dtype))).to(device)


def family_step(family: str, config, backend: str, device) -> tuple[Callable, Callable]:
    """One kernel family's timed entry point at the config's shape, on
    ``device``: ``(step, init)``, where ``step(state, row_tile, pair_tile,
    placement=None)`` makes one ``repro_torch.kernels.ops`` call on the
    state ``init()`` makes and returns the state to thread into the next."""
    device = torch.device(device)
    n = int(config.frames_per_group)
    p, h, w = n // 2, int(config.height), int(config.width)
    acc = as_torch_dtype(getattr(config, "accum_dtype", "float32"))
    offset = float(getattr(config, "offset", 4096.0))
    sd = _stream_dtype(config)
    chunk = _chunk(n, h, w, sd, device)
    k = int(getattr(config, "median_window", 5))

    def planes(seed, shape):
        host = np.random.default_rng(seed).uniform(0, 4096, shape)
        return torch.from_numpy(host).to(device=device, dtype=acc)

    if family == "stream":
        g = int(getattr(config, "num_groups", 8))
        return (lambda state, th, tp, placement=None: ops.stream_step(
                    state, chunk, num_groups=g, offset=offset, backend=backend, row_tile=th,
                    pair_tile=tp, stream_dtype=sd, placement=placement),
                lambda: ops.stream_init(n, h, w, acc, device=device))
    if family == "median_insert":
        return (lambda window, th, tp, placement=None: ops.median_window_insert(
                    window, chunk, slot=0, offset=offset, backend=backend, row_tile=th,
                    pair_tile=tp, stream_dtype=sd, placement=placement),
                lambda: torch.zeros((k, p, h, w), dtype=acc, device=device))
    if family == "median_combine":
        window = planes(1, (k, p, h, w))
        return (lambda _, th, tp, placement=None: ops.median_combine(
                    window, backend=backend, row_tile=th, pair_tile=tp, placement=placement),
                lambda: None)
    if family == "ema":
        alpha = float(getattr(config, "ema_alpha", 0.25))
        return (lambda state, th, tp, placement=None: ops.ema_welford_step(
                    *state, chunk, alpha=alpha, offset=offset, prior_count=p, backend=backend,
                    row_tile=th, pair_tile=tp, stream_dtype=sd, placement=placement),
                lambda: tuple(torch.zeros(s, dtype=acc, device=device)
                              for s in ((p, h, w), (h, w), (h, w))))
    if family == "spatial":
        mode = getattr(config, "spatial_mode", "bilateral")
        sigma = float(getattr(config, "spatial_range_sigma", 60.0))
        frames = planes(2, (p, h, w))
        return (lambda _, th, tp, placement=None: ops.spatial_filter(
                    frames, mode=mode, range_sigma=sigma, backend=backend, row_tile=th,
                    pair_tile=tp, placement=placement),
                lambda: None)
    raise ValueError(
        f"kernel family must be one of {budget.KERNEL_FAMILIES}, got {family!r}"
    )


def family_timer(family: str, config, backend: str, device) -> Callable[..., float]:
    """Seconds-per-step timer for one kernel family at the config's shape,
    on ``device``: ``timer(row_tile, pair_tile, placement=None)``."""
    device = torch.device(device)
    step, init = family_step(family, config, backend, device)

    def timer(th, tp, placement=None):
        return _time_chain(lambda state: step(state, th, tp, placement), init(), device)

    return timer


# ---------------------------------------------------------------------------
# Executor-knob search (ring depth + advisory staging chunk length).
# ---------------------------------------------------------------------------


def _bursty(chunks: list, burst_s: float, every: int = 3) -> Iterator:
    for i, chunk in enumerate(chunks):
        if i % every == every - 1:
            time.sleep(burst_s)
        yield chunk


def tune_exec_knobs(config, device) -> dict:
    """Measure ring depth and per-frame-optimal chunk length for ``config``
    on ``device``.

    Only called for real ``DenoiseConfig``-style dataclasses (the replica
    it times through ``run_pipelined`` is built with ``dataclasses.replace``
    pinned to ``tile_plan='heuristic'``, which also breaks the resolve ->
    tune -> executor -> resolve recursion).
    """
    with obs.span("tune.exec_knobs", "tune", filter=getattr(config, "filter_name", "?")):
        return _tune_exec_knobs(config, torch.device(device))


def _tune_exec_knobs(config, device: torch.device) -> dict:
    from repro_torch.core.streaming import run_pipelined  # lazy: avoids cycle

    base = dataclasses.replace(config, tile_plan="heuristic", num_banks=1)
    n, h, w = base.frames_per_group, base.height, base.width
    sd = _stream_dtype(base)
    # the chunks are on the device before the replays, as the reference's
    # device_put: the replays time the ring, not the host-to-device copy
    chunks = [_chunk(n, h, w, sd, device) for _ in range(_EXEC_CHUNKS)]
    replay = dataclasses.replace(base, num_groups=len(chunks))
    run = dict(device=device)

    run_pipelined(replay, iter(chunks[:2]), num_slots=1, **run)  # warm up
    t0 = time.perf_counter()
    run_pipelined(replay, iter(chunks), num_slots=1, **run)  # calibrate the burst
    burst_s = max(_BURST_COMPUTE_MULT * (time.perf_counter() - t0) / len(chunks), 0.002)
    # two round-robined passes per depth (pooled): interleaving exposes
    # every depth to the same transient host load
    depth_s = {d: 0.0 for d in _EXEC_DEPTHS}
    for _ in range(2):
        for depth in _EXEC_DEPTHS:
            _, rep = run_pipelined(
                replay, _bursty(chunks, burst_s), num_slots=depth, policy="block", **run
            )
            depth_s[depth] += rep.elapsed_s
    best = min(depth_s, key=depth_s.get)
    # conservative selection (see _DEPTH_MARGIN)
    if 2 in depth_s and depth_s[best] > depth_s[2] * (1.0 - _DEPTH_MARGIN):
        best = 2

    # advisory staging chunk length: per-frame cost of this filter's own
    # per-group step at even sub-chunk lengths of N, at its default layout
    fam, _ = filter_families(base)[0]
    backend = resolved_backend(base, device)
    per_frame = {}
    for c in sorted({n} | {n // k for k in (2, 5) if n % k == 0 and (n // k) % 2 == 0}):
        sub = dataclasses.replace(replay, frames_per_group=c)
        timer = family_timer(fam, sub, backend, device)
        th, tp = budget.model_candidates(
            fam, c // 2, h, w, stream_dtype=sd, vector=vector_path(sub),
            limits=budget.device_limits(device),
        )[0]
        per_frame[c] = timer(th, tp) / c
    return {
        "num_slots": best,
        "frames_per_chunk": min(per_frame, key=per_frame.get),
        "depth_s": {str(k): round(v, 5) for k, v in depth_s.items()},
        "per_frame_us": {str(k): round(v * 1e6, 3) for k, v in per_frame.items()},
    }


# ---------------------------------------------------------------------------
# Plan assembly: tune-or-cache-hit ("auto") and pre-built file (path mode).
# ---------------------------------------------------------------------------


def resolved_backend(config, device) -> str:
    """``pallas`` where the kernels run (backend ``pallas``, or ``auto`` on
    a CUDA device), else ``xla``, as the reference's ``ops._resolve``."""
    backend = getattr(config, "backend", "auto")
    if backend == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    if backend not in ops.BACKENDS:
        raise ValueError(f"backend must be one of {ops.BACKENDS}, got {backend}")
    return backend


def _geom(entry: dict) -> TileGeom:
    """A cached geometry as a plan holds it. ``None`` tiles (the default
    layout, which a tuned entry may name) stay ``None``; the placement is
    always the compiler's, whatever the entry names."""
    return TileGeom(entry["row_tile"], entry["pair_tile"], budget.PLACEMENT)


def _geom_valid(entry: dict, p: int, h: int) -> bool:
    """A cached geometry this shape can launch: exact divisors of H and
    N/2 (the reference's rule), or the default layout (both ``None``, as a
    tuned entry names it when the heuristic won)."""
    th, tp = entry.get("row_tile"), entry.get("pair_tile")
    if th is None and tp is None:
        return "row_tile" in entry and "pair_tile" in entry
    return (
        isinstance(th, int) and isinstance(tp, int)
        and th > 0 and tp > 0 and h % th == 0 and p % tp == 0
    )


def _exec_valid(entry: dict) -> dict:
    """Sanitize a cached/replayed executor-knob entry: a stale, hand-edited
    or future-schema entry degrades to the config defaults, never crashes
    ``run_pipelined``. Returns only the knobs that validate."""
    out = {}
    slots = entry.get("num_slots")
    if isinstance(slots, int) and 1 <= slots <= 64:
        out["num_slots"] = slots
    fpc = entry.get("frames_per_chunk")
    if isinstance(fpc, int) and fpc >= 2 and fpc % 2 == 0:
        out["frames_per_chunk"] = fpc
    return out


def _pick(timed: dict, heur) -> tuple:
    """The fastest candidate, unless it beats the heuristic by less than
    the margin (then the heuristic): measurement noise is never cached as
    a win."""
    best = min(timed, key=timed.get)
    if timed[best] > timed[heur] * (1.0 - _TILE_MARGIN):
        best = heur
    return best


def candidate_label(geom: tuple) -> str:
    """A candidate's name in a cache entry: ``rowsxpairs``, or ``default``."""
    return "default" if geom == (None, None) else f"{geom[0]}x{geom[1]}"


def tune_plan(config, device, cache: PlanCache | None = None) -> Plan:
    """Tune-or-cache-hit on ``device``: the ``tile_plan='auto'`` path."""
    with obs.span("tune.search", "tune", filter=getattr(config, "filter_name", "?")) as sp:
        plan = _tune_plan(config, torch.device(device), cache)
        sp.set(source=plan.source)
        return plan


def _acc_name(config) -> str:
    return str(as_torch_dtype(getattr(config, "accum_dtype", "float32"))).replace("torch.", "")


def _tune_plan(config, device: torch.device, cache: PlanCache | None) -> Plan:
    cache = cache or PlanCache()
    backend = resolved_backend(config, device)
    n = int(config.frames_per_group)
    p, h, w = n // 2, int(config.height), int(config.width)
    acc = _acc_name(config)
    in_dtype = _in_dtype(config)
    sd = _stream_dtype(config)
    measured = False
    hits = 0

    tiles = []
    if backend == "pallas":  # the plain composite has no launch geometry
        limits = budget.device_limits(device)
        for family, window in filter_families(config):
            key = family_key(family, p, h, w, in_dtype=in_dtype, acc_dtype=acc,
                             backend=backend, device=device, window=window)
            entry = cache.get(key)
            if entry is not None and _geom_valid(entry, p, h):
                hits += 1
            else:
                timer = family_timer(family, config, backend, device)
                cands = tile_candidates(family, p, h, w, stream_dtype=sd,
                                        vector=vector_path(config), limits=limits)
                heur = cands[0]  # the kernel's default layout, always first
                # two round-robined passes, min per candidate: transient
                # host load hits every candidate instead of biasing one.
                # Every candidate passed the launch model; an error while
                # timing one propagates.
                timed = {geom: float("inf") for geom in cands}
                with obs.span("tune.measure", "tune", family=family, candidates=len(cands)):
                    for _ in range(2):
                        for geom in timed:
                            timed[geom] = min(timed[geom], timer(*geom))
                best = _pick(timed, heur)
                entry = {
                    "row_tile": best[0],
                    "pair_tile": best[1],
                    "placement": budget.PLACEMENT,
                    "measured_s": round(timed[best], 9),
                    "heuristic_s": round(timed[heur], 9),
                    "candidates": {candidate_label(g): round(s, 9) for g, s in timed.items()},
                    "timestamp": time.time(),
                }
                cache.put(key, entry)
                measured = True
            tiles.append((family, _geom(entry)))

    ek = exec_key(getattr(config, "filter_name", "pair_average"),
                  int(getattr(config, "num_groups", 8)), n, h, w, backend=backend,
                  device=device)
    exec_entry = cache.get(ek)
    if exec_entry is not None:
        hits += 1
    elif dataclasses.is_dataclass(config):
        exec_entry = tune_exec_knobs(config, device)
        exec_entry["timestamp"] = time.time()
        cache.put(ek, exec_entry)
        measured = True
    knobs = _exec_valid(exec_entry or {})
    # provenance: "tuned" if anything was measured this resolution,
    # "cache" only if the persistent store served something, else
    # "heuristic" (nothing to search for this backend/config shape)
    source = "tuned" if measured else ("cache" if hits else "heuristic")
    return Plan(
        mode="auto",
        tiles=tuple(tiles),
        num_slots=knobs.get("num_slots"),
        frames_per_chunk=knobs.get("frames_per_chunk"),
        source=source,
    )


def plan_from_file(config, path: str, device) -> Plan:
    """Explicit-path mode: replay a pre-built plan file, never measure.

    A missing file is a caller error (``ValueError``); a malformed or
    stale file falls back to the heuristic plan (never crashes), matching
    the cache contract. Entries are looked up under ``device``'s keys.
    """
    cache = PlanCache(path)
    if not cache.path.exists():
        raise ValueError(
            f"tile_plan plan file {path!r} does not exist (tile_plan must "
            "be 'heuristic', 'auto', or a path to a plan-cache JSON file)"
        )
    cache._load()
    if cache.stale:
        import warnings

        warnings.warn(
            f"plan file {path!r} is malformed or from another schema "
            "version; falling back to the heuristic plan",
            RuntimeWarning,
            stacklevel=2,
        )
        return Plan(mode=path, source="heuristic")
    device = torch.device(device)
    backend = resolved_backend(config, device)
    n = int(config.frames_per_group)
    p, h, w = n // 2, int(config.height), int(config.width)
    acc = _acc_name(config)
    in_dtype = _in_dtype(config)
    tiles = []
    for family, window in filter_families(config):
        entry = cache.get(family_key(family, p, h, w, in_dtype=in_dtype, acc_dtype=acc,
                                     backend=backend, device=device, window=window))
        if entry is not None and _geom_valid(entry, p, h):
            tiles.append((family, _geom(entry)))
    knobs = _exec_valid(cache.get(
        exec_key(getattr(config, "filter_name", "pair_average"),
                 int(getattr(config, "num_groups", 8)), n, h, w, backend=backend,
                 device=device)
    ) or {})
    return Plan(
        mode=path,
        tiles=tuple(tiles),
        num_slots=knobs.get("num_slots"),
        frames_per_chunk=knobs.get("frames_per_chunk"),
        source=path,
    )
