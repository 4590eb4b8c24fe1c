"""Streaming executors: inline, ring-pipelined, and buffer-then-process
(counterpart of ``repro.core.streaming``).

Reproduces the systems argument of paper §7: when preprocessing runs
*inline* with acquisition, the buffering step of CPU/GPU workflows
disappears.

* ``run_pipelined`` — acquisition/staging, denoise and an optional
  consumer run as three stages joined by bounded ``RingBuffer``s with
  backpressure (``num_slots`` = ring depth, 2 = the paper's ping-pong;
  ``policy`` ``"block"`` or ``"drop_oldest"``).
* ``run_inline`` — ``prefetch=True`` delegates to
  ``run_pipelined(num_slots=2)``; ``prefetch=False`` stages and computes
  serially on one thread.
* ``run_buffered`` — stage everything on the host first, then denoise
  the whole array with the one-shot kernel.

The numeric stream is bit-identical across all of them. Every executor
runs on CUDA unless the caller passes ``device=`` (``RuntimeError`` when
CUDA is absent). Staging on CUDA is the port's ``device_put``: the host
chunk is pinned and copied ``non_blocking`` on a side CUDA stream that
records an event; the compute stream waits on that event, and
``record_stream`` keeps the caching allocator from reusing the slot
before the compute stream is done with it. Consumers receive a fresh
partial estimate, never the running sum that the next step overwrites in
place.

``StreamReport`` columns are the reference's: ``transfer_s`` is total
staging time (source next + host->device copy), ``stall_s`` the part the
compute loop waited on, ``overlap_s = transfer_s - stall_s`` staging
hidden under compute, and so on (see the reference module).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser
from repro_torch.core.ringbuf import RingBuffer, RingClosed

__all__ = [
    "StreamReport",
    "run_pipelined",
    "run_inline",
    "run_buffered",
    "rate_limited",
    "DownloadConsumer",
]

#: the config's default ring depth; a plan's depth replaces only this one
_DEFAULT_NUM_SLOTS = DenoiseConfig.__dataclass_fields__["num_slots"].default


@dataclasses.dataclass
class StreamReport:
    """Wall-clock breakdown of one executor run (the reference's columns)."""

    elapsed_s: float
    buffering_s: float
    compute_s: float
    frames: int
    bytes_in: int
    transfer_s: float = 0.0   # total staging time (source + host->device)
    stall_s: float = 0.0      # staging time NOT hidden under compute
    # -- pipeline stage breakdown (run_pipelined only) ----------------------
    num_slots: int = 0        # stage-ring depth; 0 = not a ring pipeline
    produce_wait_s: float = 0.0  # producer blocked on full ring (backpressure)
    consume_wait_s: float = 0.0  # consumer stage blocked waiting for results
    consume_s: float = 0.0       # time spent inside the consumer callable
    deliver_wait_s: float = 0.0  # compute blocked on a full consumer ring
    drops: int = 0               # chunks lost to the drop_oldest policy
    ring_occupancy_mean: float = 0.0  # staged-chunk queue depth, mean ...
    ring_occupancy_max: int = 0       # ... and max (<= num_slots)
    # -- per-group latency percentiles (nearest-rank, milliseconds) ---------
    latency_p50_ms: float = 0.0
    latency_p95_ms: float = 0.0
    latency_p99_ms: float = 0.0

    @property
    def overlap_s(self) -> float:
        """Staging time hidden under compute by the ring/double-buffering."""
        return max(0.0, self.transfer_s - self.stall_s)

    @property
    def overlap_frac(self) -> float:
        return self.overlap_s / self.transfer_s if self.transfer_s else 0.0

    @property
    def fps(self) -> float:
        return self.frames / self.elapsed_s if self.elapsed_s else float("inf")

    @property
    def mb_per_s(self) -> float:
        return self.bytes_in / 1e6 / self.elapsed_s if self.elapsed_s else 0.0

    @staticmethod
    def header() -> str:
        """CSV header matching ``row()`` (leading ``name`` column)."""
        return (
            "name,elapsed_s,buffering_s,compute_s,fps,mb_per_s,"
            "transfer_s,stall_s,overlap_frac,num_slots,produce_wait_s,"
            "consume_wait_s,deliver_wait_s,drops,ring_occupancy_mean,"
            "latency_p50_ms,latency_p95_ms,latency_p99_ms"
        )

    def row(self, name: str) -> str:
        """One CSV row; includes the transfer/stall and per-stage fields."""
        return (
            f"{name},{self.elapsed_s:.4f},{self.buffering_s:.4f},"
            f"{self.compute_s:.4f},{self.fps:.0f},{self.mb_per_s:.1f},"
            f"{self.transfer_s:.4f},{self.stall_s:.4f},"
            f"{self.overlap_frac:.3f},{self.num_slots},"
            f"{self.produce_wait_s:.4f},{self.consume_wait_s:.4f},"
            f"{self.deliver_wait_s:.4f},"
            f"{self.drops},{self.ring_occupancy_mean:.2f},"
            f"{self.latency_p50_ms:.3f},{self.latency_p95_ms:.3f},"
            f"{self.latency_p99_ms:.3f}"
        )


def _stream_report(
    reg: obs.MetricsRegistry, elapsed_s: float, *, buffering_s: float = 0.0
) -> StreamReport:
    """Derive a :class:`StreamReport` from the run's metrics registry."""
    v = reg.value
    stall_s = v("stream.stall_s")
    deliver_wait_s = v("stream.deliver_wait_s")
    return StreamReport(
        elapsed_s=elapsed_s,
        buffering_s=buffering_s,
        compute_s=elapsed_s - stall_s - deliver_wait_s,
        frames=int(v("stream.frames")),
        bytes_in=int(v("stream.bytes_in")),
        transfer_s=v("stream.transfer_s"),
        stall_s=stall_s,
        num_slots=int(v("stream.num_slots")),
        produce_wait_s=v("stream.produce_wait_s"),
        consume_wait_s=v("stream.consume_wait_s"),
        consume_s=v("stream.consume_s"),
        deliver_wait_s=deliver_wait_s,
        drops=int(v("stream.drops")),
        ring_occupancy_mean=v("stream.ring_occupancy_mean"),
        ring_occupancy_max=int(v("stream.ring_occupancy_max")),
        latency_p50_ms=reg.percentile("stream.latency_s", 50) * 1e3,
        latency_p95_ms=reg.percentile("stream.latency_s", 95) * 1e3,
        latency_p99_ms=reg.percentile("stream.latency_s", 99) * 1e3,
    )


def _ingest_ring_stats(reg: obs.MetricsRegistry, stage_ring, out_ring) -> None:
    """Fold end-of-run ring counters into the run registry."""
    reg.counter("stream.stall_s").inc(stage_ring.stats.get_wait_s)
    reg.counter("stream.produce_wait_s").inc(stage_ring.stats.put_wait_s)
    reg.counter("stream.drops").inc(stage_ring.stats.drops)
    reg.gauge("stream.ring_occupancy_mean").set(stage_ring.stats.occupancy_mean)
    reg.gauge("stream.ring_occupancy_max").set(stage_ring.stats.occupancy_max)
    if out_ring is not None:
        reg.counter("stream.deliver_wait_s").inc(out_ring.stats.put_wait_s)
        reg.counter("stream.consume_wait_s").inc(out_ring.stats.get_wait_s)


def rate_limited(
    source: Iterator[np.ndarray], interval_us: float, frames_per_chunk: int
) -> Iterator[np.ndarray]:
    """Throttle a chunk source to the camera inter-frame interval
    (``interval_us=57``: the camera's maximum rate)."""
    chunk_s = interval_us * 1e-6 * frames_per_chunk
    t_next = time.perf_counter()
    for chunk in source:
        t_next += chunk_s
        yield chunk
        now = time.perf_counter()
        if now < t_next:
            time.sleep(t_next - now)


_DONE = object()


class _Stager:
    """Lands host chunks on the executor's device (the port's ``device_put``).

    On CUDA the chunk is pinned and copied ``non_blocking`` on a side
    stream, which records an event; ``stage`` waits for that event on the
    staging thread, so the transfer time it reports is the landed time (as
    the reference's ``block_until_ready``). ``adopt`` then orders the
    compute stream after the copy and marks the tensor as used there, so
    the caching allocator cannot hand its memory to a later copy early.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.copy_stream = (
            torch.cuda.Stream(device=device) if device.type == "cuda" else None
        )

    def stage(self, chunk: np.ndarray):
        if isinstance(chunk, torch.Tensor) and _on(chunk, self.device):
            return chunk, None  # already landed: the reference's device_put of a device array
        host = torch.from_numpy(np.ascontiguousarray(chunk))
        if self.copy_stream is None:
            return host.clone(), None
        host = host.pin_memory()
        with torch.cuda.stream(self.copy_stream):
            dev = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            dev.copy_(host, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(self.copy_stream)
        landed.synchronize()
        return dev, landed

    def adopt(self, staged) -> torch.Tensor:
        dev, landed = staged
        if landed is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(landed)
            dev.record_stream(compute)
        return dev


def _on(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` lies on ``device`` (``cuda`` names the current card)."""
    if t.device.type != device.type:
        return False
    if device.type != "cuda" or device.index is None:
        return device.type != "cuda" or t.device.index == torch.cuda.current_device()
    return t.device.index == device.index


def _stage_next(source: Iterator, stager: _Stager) -> object:
    """Pull one chunk from the source and land it on the device. Runs on
    the staging stage: the pull (camera wait / frame synthesis) and the
    host->device copy both happen off the compute thread."""
    t0 = time.perf_counter()
    try:
        chunk = next(source)
    except StopIteration:
        return _DONE
    staged = stager.stage(chunk)
    return staged, time.perf_counter() - t0


def _wait(out: torch.Tensor) -> None:
    """Block until ``out`` is computed (the reference's block_until_ready)."""
    if out.is_cuda:
        torch.cuda.synchronize(out.device)


class DownloadConsumer:
    """Averaging-reduction download stage: lands each per-step partial
    average on the host. ``partials[k]`` is the host copy of the estimate
    after groups ``0..k``; ``partials[-1]`` equals the final output.

    numpy has no bfloat16 without ``ml_dtypes``, so a bfloat16 partial
    lands as its exact float32 widening: every value equals the bfloat16
    one (the reference's partial, widened). Every other dtype is kept."""

    def __init__(self):
        self.partials: list[np.ndarray] = []

    def __call__(self, step: int, partial: torch.Tensor) -> None:
        host = partial.cpu()
        if host.dtype == torch.bfloat16:
            host = host.float()
        self.partials.append(host.numpy())


def run_pipelined(
    config: DenoiseConfig,
    source: Iterator[np.ndarray],
    *,
    interval_us: float | None = None,
    num_slots: int | None = None,
    policy: str | None = None,
    consumer: Callable[[int, torch.Tensor], None] | None = None,
    consumer_slots: int | None = None,
    metrics: obs.MetricsRegistry | None = None,
    device=None,
) -> tuple[torch.Tensor, StreamReport]:
    """Three-stage ring-pipelined executor (paper §5 generalized)::

        acquire/stage ──ring(num_slots)──> denoise ──ring──> consumer

    ``num_slots``/``policy`` default to ``config.num_slots`` /
    ``config.overflow_policy``, except under a resolved tile plan
    (``tile_plan`` ``"auto"`` or a plan-file path) whose executor knobs
    carry a ring depth: then, when the config leaves the depth at its
    dataclass default, the plan's ``num_slots`` applies. An explicit
    ``num_slots=`` beats the plan, and the plan beats ``config.num_slots``
    only at its default, as in the reference. Under ``drop_oldest`` the
    output averages the surviving groups (``drops`` in the report counts
    the loss). Output is bit-identical for any depth and consumer under
    ``block``. Telemetry accumulates into ``metrics`` (or a run-local
    registry) and the report is derived from it; stage spans go to
    ``repro_torch.obs``.
    """
    den = StreamingDenoiser(config, device=device)  # resolves the plan, once
    if num_slots is None:
        num_slots = config.num_slots
        if config.tile_plan != "heuristic" and num_slots == _DEFAULT_NUM_SLOTS:
            num_slots = den.plan.num_slots or num_slots
    policy = config.overflow_policy if policy is None else policy
    stager = _Stager(den.device)
    if interval_us is not None:
        source = rate_limited(source, interval_us, config.frames_per_group)
    source = iter(source)

    reg = metrics if metrics is not None else obs.MetricsRegistry()
    c_frames = reg.counter("stream.frames")
    c_bytes = reg.counter("stream.bytes_in")
    c_transfer = reg.counter("stream.transfer_s")
    c_consume = reg.counter("stream.consume_s")
    h_latency = reg.histogram("stream.latency_s")
    reg.gauge("stream.num_slots").set(num_slots)

    stage_ring = RingBuffer(num_slots, policy=policy, name="stage")
    out_ring = (
        RingBuffer(consumer_slots or num_slots, name="deliver")
        if consumer is not None
        else None
    )
    errors: list[BaseException] = []

    def _produce() -> None:
        try:
            while True:
                with obs.span("stream.stage", "stream"):
                    item = _stage_next(source, stager)
                if item is _DONE:
                    break
                stage_ring.put(item)
        except RingClosed:
            pass  # compute side shut down early (error path)
        except BaseException as e:  # propagate source failures to the caller
            errors.append(e)
        finally:
            stage_ring.close()

    def _consume() -> None:
        try:
            for step, partial in out_ring:
                t0 = time.perf_counter()
                with obs.span("stream.consume", "stream", step=step):
                    consumer(step, partial)
                c_consume.inc(time.perf_counter() - t0)
        except BaseException as e:
            errors.append(e)
            out_ring.close()  # unblock the compute stage's put

    t0 = time.perf_counter()
    state = den.init()
    step = 0

    producer = threading.Thread(target=_produce, name="prism-stage", daemon=True)
    producer.start()
    consumer_thread = None
    if out_ring is not None:
        consumer_thread = threading.Thread(
            target=_consume, name="prism-consume", daemon=True
        )
        consumer_thread.start()

    try:
        while True:
            try:
                staged, dt = stage_ring.get()
            except RingClosed:
                break
            c_transfer.inc(dt)
            h_latency.observe(stage_ring.stats.last_dwell_s)
            dev = stager.adopt(staged)
            with obs.span("stream.ingest", "stream", step=step):
                state = den.ingest(state, dev, step=step)
            c_frames.inc(math.prod(dev.shape[:-2]))
            if out_ring is not None:
                try:
                    out_ring.put((step, den.partial(state, step)))
                except RingClosed:
                    break  # consumer died; its error surfaces below
            step += 1
    finally:
        stage_ring.close()
        if out_ring is not None:
            out_ring.close()
        producer.join()
        if consumer_thread is not None:
            consumer_thread.join()

    if errors:
        raise errors[0]

    with obs.span("stream.finalize", "stream", steps=step):
        if policy == "drop_oldest" and step:
            out = den.finalize(state, steps=step)
        else:
            out = den.finalize(state)
        _wait(out)
    elapsed = time.perf_counter() - t0
    c_bytes.inc(int(c_frames.value) * config.bytes_per_frame)
    _ingest_ring_stats(reg, stage_ring, out_ring)
    return out, _stream_report(reg, elapsed)


def run_inline(
    config: DenoiseConfig,
    source: Iterator[np.ndarray],
    *,
    interval_us: float | None = None,
    prefetch: bool = True,
    metrics: obs.MetricsRegistry | None = None,
    device=None,
) -> tuple[torch.Tensor, StreamReport]:
    """Denoise inline with acquisition (the paper's FPGA workflow).

    ``prefetch=True`` delegates to ``run_pipelined(num_slots=2)``;
    ``prefetch=False`` runs the serial stage-then-compute schedule on one
    thread. Output is bit-identical either way.
    """
    if prefetch:
        return run_pipelined(
            config,
            source,
            interval_us=interval_us,
            num_slots=2,
            policy="block",
            consumer=None,
            metrics=metrics,
            device=device,
        )

    den = StreamingDenoiser(config, device=device)
    stager = _Stager(den.device)
    if interval_us is not None:
        source = rate_limited(source, interval_us, config.frames_per_group)
    source = iter(source)

    reg = metrics if metrics is not None else obs.MetricsRegistry()
    c_frames = reg.counter("stream.frames")
    c_transfer = reg.counter("stream.transfer_s")
    c_stall = reg.counter("stream.stall_s")

    t0 = time.perf_counter()
    state = den.init()
    step = 0
    while True:
        t_wait = time.perf_counter()
        with obs.span("stream.stage", "stream"):
            item = _stage_next(source, stager)
        dt = time.perf_counter() - t_wait
        c_stall.inc(dt)
        if item is _DONE:
            break
        dev = stager.adopt(item[0])
        c_transfer.inc(dt)
        with obs.span("stream.ingest", "stream", step=step):
            state = den.ingest(state, dev, step=step)
        step += 1
        c_frames.inc(math.prod(dev.shape[:-2]))

    with obs.span("stream.finalize", "stream", steps=step):
        out = den.finalize(state)
        _wait(out)
    elapsed = time.perf_counter() - t0
    reg.counter("stream.bytes_in").inc(int(c_frames.value) * config.bytes_per_frame)
    return out, _stream_report(reg, elapsed)


def run_buffered(
    config: DenoiseConfig,
    source: Iterator[np.ndarray],
    *,
    interval_us: float | None = None,
    process: Callable[[torch.Tensor], torch.Tensor] | None = None,
    device=None,
) -> tuple[torch.Tensor, StreamReport]:
    """Stage everything first, then process (the CPU/GPU workflow)."""
    den = StreamingDenoiser(config, device=device)
    if interval_us is not None:
        source = rate_limited(source, interval_us, config.frames_per_group)
    t0 = time.perf_counter()
    staged = [np.asarray(chunk) for chunk in source]  # acquisition / buffering
    buffer = np.stack(staged)  # (G, N, H, W) host buffer
    t1 = time.perf_counter()
    fn = process or den
    out = fn(torch.from_numpy(buffer).to(den.device))  # includes host->device
    _wait(out)
    t2 = time.perf_counter()
    frames = buffer.shape[0] * buffer.shape[1]
    reg = obs.MetricsRegistry()
    reg.counter("stream.frames").inc(frames)
    reg.counter("stream.bytes_in").inc(frames * config.bytes_per_frame)
    reg.counter("stream.transfer_s").inc(t1 - t0)
    reg.counter("stream.stall_s").inc(t1 - t0)
    return out, _stream_report(reg, t2 - t0, buffering_s=t1 - t0)

