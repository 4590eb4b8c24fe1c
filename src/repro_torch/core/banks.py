"""Multi-bank scaling (paper Table 5): one independent pipeline per bank
(counterpart of ``repro.core.banks``).

The paper partitions the camera stream into banks of 256×80 pixels and
runs one FPGA per bank, observing flat latency from 1 to 2 banks. Here a
1-D :class:`BankMesh` names one device per bank shard. Each shard's state
lives on its own device and is stepped there through the filter's own
banked ``step``, which reaches the multi-bank kernels through
``repro_torch.kernels.ops``; nothing crosses devices until one final
gather puts the ``(B, N/2, H, W)`` result on the mesh's first device, the
reference's "optional final gather". There is no ``shard_map``: a
bank-sharded state is a list holding one shard's banked state per mesh
device, and :func:`banked_filter_finalize` gathers it.

With ``mesh=None`` and ``banks=B`` (the session scheduler's topology:
many slots on one device) the state is one plain banked state on the
filter's device, stepped directly, as in the reference.

``run_pipelined_banked`` gives every bank its own bounded ring and
producer thread, staged through the executors' ``_Stager`` (a pinned
buffer and a ``non_blocking`` copy on a side stream, ordered by events,
one per shard device). Each compute step gathers one chunk per bank (a
per-group barrier) and folds the shards with ``banked_filter_step``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import ClassVar, Iterator, Sequence

import numpy as np
import torch

from repro_torch import obs, tune
from repro_torch.core.denoise import DenoiseConfig, as_device_tensor
from repro_torch.core.ringbuf import RingBuffer, RingClosed
from repro_torch.core.streaming import _DONE, _stage_next, _Stager, _stream_report
from repro_torch.denoise import get_filter
from repro_torch.denoise.base import tree_leaves
from repro_torch.kernels import ops

__all__ = [
    "BankMesh",
    "make_bank_mesh",
    "banked_subtract_average",
    "banked_stream_step",
    "banked_filter_init",
    "banked_filter_step",
    "banked_filter_finalize",
    "run_pipelined_banked",
]


@dataclasses.dataclass(frozen=True)
class BankMesh:
    """A 1-D ``bank`` mesh: an ordered tuple of devices, one per shard.

    ``shape == {"bank": n}``, so code that reads ``mesh.shape["bank"]``
    ports as it is. PyTorch has no ``Mesh``, and a mesh with one axis and
    no collectives needs none.

    A mesh built by hand may name one device more than once:
    ``BankMesh(("cuda:0", "cuda:0"))`` runs two bank shards on one card,
    each with its own state, staging stream and kernel launches, and
    ``("cpu", "cpu")`` does the same on the host. This is the port's
    counterpart of ``XLA_FLAGS=--xla_force_host_platform_device_count``:
    it exercises the sharded path where there is one device.
    :func:`make_bank_mesh` names distinct CUDA devices only.
    """

    devices: tuple
    #: the one axis, as a ``Mesh``'s ``axis_names``
    axis_names: ClassVar[tuple[str, ...]] = ("bank",)

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a bank mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def shape(self) -> dict[str, int]:
        return {"bank": len(self.devices)}

    @property
    def size(self) -> int:
        """The number of bank shards (a ``Mesh``'s ``size``)."""
        return len(self.devices)


def make_bank_mesh(num_banks: int | None = None) -> BankMesh:
    """A mesh of the first ``num_banks`` CUDA devices (all by default);
    ``ValueError`` when there are fewer."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = num_banks or max(count, 1)
    if count < n:
        raise ValueError(f"need {n} devices for {n} banks, have {count}")
    return BankMesh(tuple(torch.device("cuda", i) for i in range(n)))


def _shards(x, mesh: BankMesh) -> list[torch.Tensor]:
    """Split a bank-leading array or tensor evenly over the mesh, each
    shard on its device; a list of per-shard tensors passes through."""
    n = mesh.shape["bank"]
    if isinstance(x, (list, tuple)):
        if len(x) != n:
            raise ValueError(f"mesh has {n} bank shards but got {len(x)} chunks")
        return [as_device_tensor(c, d) for c, d in zip(x, mesh.devices)]
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} banks do not split evenly over {n} mesh devices")
    per = x.shape[0] // n
    return [x[i * per:(i + 1) * per].to(d) for i, d in enumerate(mesh.devices)]


def _gather(outs: list[torch.Tensor], mesh: BankMesh) -> torch.Tensor:
    """The one cross-device step: shard outputs joined on the bank axis,
    on the mesh's first device."""
    return torch.cat([o.to(mesh.devices[0]) for o in outs])


def banked_subtract_average(frames, mesh: BankMesh, *, config: DenoiseConfig) -> torch.Tensor:
    """frames (B, G, N, H, W) -> (B, N/2, H, W) on ``mesh.devices[0]``.

    Pure data parallelism over banks: each shard runs the fused
    multi-bank kernel over its own banks, then one gather.
    """
    tiles = tune.tile_args(config, "stream", device=mesh.devices[0])
    outs = [
        ops.multibank_subtract_average(
            local, offset=config.offset, algorithm=config.algorithm,
            backend=config.backend, **tiles,
        )
        for local in _shards(frames, mesh)
    ]
    return _gather(outs, mesh)


def banked_stream_step(sum_frames: list, group_frames, mesh: BankMesh, *, config: DenoiseConfig):
    """Streaming variant: one group per bank, shards in parallel.

    ``sum_frames`` holds one (B/n, N/2, H, W) running sum per mesh device,
    each updated in place; ``group_frames`` is (B, N, H, W) or a list of
    per-shard chunks. Returns ``sum_frames``.
    """
    tiles = tune.tile_args(config, "stream", device=mesh.devices[0])
    for s, f in zip(sum_frames, _shards(group_frames, mesh)):
        ops.multibank_stream_step(
            s, f, num_groups=config.num_groups, offset=config.offset,
            variant=config.variant, backend=config.backend, **tiles,
        )
    return sum_frames


# ---------------------------------------------------------------------------
# Filter-generic banked stepping: the same topology for any registered
# filter, each shard stepped through the filter's own banked ``step``.
# ---------------------------------------------------------------------------


def banked_filter_init(
    config: DenoiseConfig, mesh: BankMesh | None = None, *, banks: int | None = None,
    device=None,
):
    """Create the filter's banked state. Returns ``(filter, state)``.

    With a ``mesh``, the bank count is ``mesh.shape["bank"]`` and the
    state is a list with one single-bank banked state on each mesh
    device. With ``mesh=None``, ``banks`` sets the bank-axis length and
    the state is one banked state on ``device`` (CUDA unless the caller
    names another).
    """
    cls = get_filter(config.filter_name)
    if mesh is None:
        if banks is None:
            raise ValueError("banked_filter_init needs a mesh or banks=")
        filt = cls(config, device=device)
        return filt, filt.init(banks=banks)
    if banks is not None and banks != mesh.shape["bank"]:
        raise ValueError(
            f"banks={banks} does not match mesh bank axis "
            f"{mesh.shape['bank']}"
        )
    state = [cls(config, device=d).init(banks=1) for d in mesh.devices]
    return cls(config, device=mesh.devices[0]), state


def _state_device(state) -> torch.device:
    return tree_leaves(state)[0][0].device


def banked_filter_step(
    state, group_frames, mesh: BankMesh | None = None, *, config: DenoiseConfig,
    step_index: int, filt=None,
):
    """One filter step, banks in parallel; the state is updated in place
    and returned. ``group_frames`` is (B, N, H, W), or with a mesh a list
    of per-shard chunks already on their devices.

    With ``mesh=None`` the step runs the filter's banked path directly on
    the state's device (the batched session-scheduler step).
    """
    if mesh is None:
        dev = _state_device(state)
        filt = filt or get_filter(config.filter_name)(config, device=dev)
        return filt.step(state, as_device_tensor(group_frames, dev), step_index=step_index)
    filt = filt or get_filter(config.filter_name)(config, device=mesh.devices[0])
    return [
        filt.step(s, chunk, step_index=step_index)
        for s, chunk in zip(state, _shards(group_frames, mesh))
    ]


def banked_filter_finalize(filt, state, mesh: BankMesh | None = None, *, steps: int | None = None):
    """The filter's banked output (B, N/2, H, W): with a mesh, each shard
    finalized on its device and gathered on ``mesh.devices[0]``."""
    if mesh is None:
        return filt.finalize(state, steps=steps)
    return _gather([filt.finalize(s, steps=steps) for s in state], mesh)


def _wait(mesh: BankMesh) -> None:
    """Block until every shard device is done (block_until_ready)."""
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def run_pipelined_banked(
    config: DenoiseConfig,
    sources: Sequence[Iterator[np.ndarray]],
    mesh: BankMesh,
    *,
    num_slots: int | None = None,
    policy: str | None = None,
):
    """Ring-pipelined multi-bank ingest: one bounded ring per bank shard.

    ``sources`` holds one chunk iterator per bank (e.g.
    ``PrismSource.bank_sources``), each yielding (N, H, W) groups. Every
    bank gets its own producer thread, ``RingBuffer`` and stager on its
    shard's device: cameras stage independently, with per-bank
    backpressure, like the paper's one-DRAM-pipeline-per-FPGA topology.
    Each compute step takes one chunk from every ring (a per-group
    barrier across banks) and folds the shards with
    :func:`banked_filter_step`. Only the lossless ``"block"`` policy is
    accepted: per-bank drops would misalign groups at the barrier.

    Returns ``(out, report)`` like ``run_pipelined``; ``out`` is the
    (B, N/2, H, W) result on ``mesh.devices[0]``. In the report,
    ``transfer_s`` / ``produce_wait_s`` / ``drops`` are summed over the
    per-bank rings (bank staging overlaps, so ``transfer_s`` can exceed
    ``elapsed_s``), ``stall_s`` is the compute thread's total wait on the
    gather, and the occupancy fields aggregate mean/max depth across rings.
    """
    banks = mesh.shape["bank"]
    if len(sources) != banks:
        raise ValueError(f"mesh has {banks} banks but got {len(sources)} sources")
    num_slots = config.num_slots if num_slots is None else num_slots
    policy = config.overflow_policy if policy is None else policy
    if policy != "block":
        # asymmetric per-bank drops would silently fold bank i's group k
        # with bank j's group k+1 at the gather barrier
        raise ValueError(
            "run_pipelined_banked requires policy='block': the per-group "
            f"gather barrier cannot tolerate per-bank loss (got {policy!r})"
        )
    for dev in mesh.devices:
        ops.resolve_device(dev)  # RuntimeError before any thread starts
    t_start = time.perf_counter()
    filt, state = banked_filter_init(config, mesh)
    stagers = [_Stager(dev) for dev in mesh.devices]
    rings = [
        RingBuffer(num_slots, policy=policy, name=f"bank{i}") for i in range(banks)
    ]
    errors: list[BaseException] = []

    def _produce(ring: RingBuffer, source, stager: _Stager) -> None:
        source = iter(source)
        try:
            while True:
                # the pull (camera) and the host->device copy, timed together
                with obs.span("stream.stage", "banks", ring=ring.name):
                    item = _stage_next(source, stager)
                if item is _DONE:
                    break
                ring.put(item)
        except RingClosed:
            pass  # compute side shut down early (error path)
        except BaseException as e:
            errors.append(e)
        finally:
            ring.close()

    threads = [
        threading.Thread(
            target=_produce, args=(ring, src, stager), name=f"prism-bank{i}", daemon=True
        )
        for i, (ring, src, stager) in enumerate(zip(rings, sources, stagers))
    ]

    reg = obs.MetricsRegistry()
    c_frames = reg.counter("stream.frames")
    c_transfer = reg.counter("stream.transfer_s")
    c_stall = reg.counter("stream.stall_s")
    h_latency = reg.histogram("stream.latency_s")
    reg.gauge("stream.num_slots").set(num_slots)

    for t in threads:
        t.start()
    step = 0
    try:
        while True:
            t_wait = time.perf_counter()
            try:
                items = [ring.get() for ring in rings]
            except RingClosed:
                break  # sources drained (or an error closed the rings)
            c_stall.inc(time.perf_counter() - t_wait)
            c_transfer.inc(sum(dt for _, dt in items))
            # each chunk's wait from staged to the gather barrier picking
            # it up, pooled across the per-bank rings
            h_latency.observe_many(r.stats.last_dwell_s for r in rings)
            with obs.span("banks.step", "banks", step=step, banks=banks):
                chunks = [
                    stager.adopt(staged).unsqueeze(0)
                    for stager, (staged, _) in zip(stagers, items)
                ]
                state = banked_filter_step(
                    state, chunks, mesh, config=config, step_index=step, filt=filt
                )
            step += 1
            c_frames.inc(banks * chunks[0].shape[1])
    finally:
        for ring in rings:
            ring.close()
        for t in threads:
            t.join()

    if errors:
        raise errors[0]
    gets = {ring.stats.gets for ring in rings}
    if len(gets) > 1 or any(len(ring) for ring in rings):
        raise ValueError(
            "bank sources yielded unequal chunk counts: a per-group barrier "
            "needs one chunk per bank per step"
        )

    with obs.span("stream.finalize", "banks", steps=step):
        out = banked_filter_finalize(filt, state, mesh)
        _wait(mesh)
    elapsed = time.perf_counter() - t_start
    stats = [ring.stats for ring in rings]
    reg.counter("stream.bytes_in").inc(int(c_frames.value) * config.bytes_per_frame)
    reg.counter("stream.produce_wait_s").inc(sum(s.put_wait_s for s in stats))
    reg.counter("stream.drops").inc(sum(s.drops for s in stats))
    reg.gauge("stream.ring_occupancy_mean").set(
        sum(s.occupancy_mean for s in stats) / banks
    )
    reg.gauge("stream.ring_occupancy_max").set(max(s.occupancy_max for s in stats))
    return out, _stream_report(reg, elapsed)
