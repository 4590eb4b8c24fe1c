#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(nvcc, one process per source, into ``src/repro_torch/kernels/build``),
then:

1. holds every kernel against its plain PyTorch version run on the CPU:
   B2-B5 bitwise for u16/u8/p12 wire formats, both variants (Alg 3 and
   Alg 3 v2) and G in {5, 8}, the steps (B2/B4) on their vector path
   (u16, u8), also on a 40 x 136 plane whose last block and warp are
   partial, and on a ragged 7 x 130 plane and an unaligned 80 x 256 view,
   where each step launch (and every p12 one) must take the scalar path;
   B2-B5 (Alg 3 and Alg 3 v2) and B10 (Alg 1 and Alg 2) bitwise with int32
   and uint16 sums at G = 10, offset 0 and 4096, on frames whose uint16
   divide-last sums wrap (the paper's u16-container overflow), each integer
   step on the scalar path;
   B6 (median insert) and B8 (EMA step) bitwise for u16/u8/p12 and G in
   {5, 8}, B8 also at N = 1000 with the main path's 100 merge chunks, with
   500 chunks (63 rounds of 8, the last one short), with one chunk of 32
   pairs (above the register cap), on a ragged 7 x 130 plane and with
   pair_tile 2, 3, 6, 7 and 8 (each its own kernel); B7 (median combine)
   bitwise for K in {1, 4, 5} and, on its selection path, K in {65, 100};
   B9 (3x3 spatial) bitwise in box mode and within its declared tolerance
   in bilateral mode, on the main path's planes and on planes that take
   each tile path at its edges (partial row and column tiles, H = 1 and 2
   on the float4 path; W % 4 != 0, an unaligned view and W = 1 on the
   scalar path). Then (1b) runs the executors on
   the card at G = 5, where 1/G is inexact, for ``pair_average`` and the
   three other filters, so the eager true divisions (finalize, a
   consumer's partials, a ``drop_oldest`` stream made to drop one group
   whatever the thread timing), the one-shot call and the banked path
   are held bitwise against the same runs on the CPU; and the
   ``pair_average`` executors with a uint16 sum at G = 10 (Alg 3, Alg 3 v2,
   Alg 1), whose plain steps (init, the floor division of finalize and of
   the partials) run on a CUDA uint16 tensor;
2. drives the main path at the paper's size (G = 8, N = 1000, 80 x 256,
   u16): ``PrismSource`` -> ``run_pipelined`` (ring depth 2 and 3),
   ``run_inline(prefetch=False)`` and the one-shot ``StreamingDenoiser``
   call, all bitwise equal to each other and to the CPU plain stream,
   with every step launch on the vector path;
3. drives the banked path on one card (two banks): ``ingest_many`` and
   the 5-D one-shot call;
4. times each kernel at the paper's shape with CUDA events (device time:
   each sample waits behind a device sleep that outlasts the host's
   queuing of its calls, so the host's launch rate does not count)
   against the least time the card needs for its bytes or operations,
   times its plain version and, where one PyTorch call computes the same
   function, that call (B2 and B4 also on their scalar path, u16 and u8,
   in the same run, B2-B5 and B10 with int32 and uint16 sums, and the host
   time per call of the B2, B4 and B8 wrappers); and times the pipelined
   executor per group against the
   camera's 57 ms inter-group interval;
5. drives the other filters at the paper's size (``temporal_median``
   with its 5-slot window, ``ema_variance``, ``spatial_box`` in box and
   bilateral mode): ``run_pipelined`` (depth 2),
   ``run_inline(prefetch=False)`` and the one-shot call, each equal to
   the CPU plain stream, and prints each filter's SNR against the
   noise-free signal;
6. runs the paper's Alg 1 and Alg 2 baselines at the paper's size
   through the one-shot ``StreamingDenoiser`` call (B10: the tmpFrame
   written to HBM and read back), each bitwise equal to the CPU plain
   result and to the Alg 3 one-shot of the same frames;
7. drives the bank executor on one card: ``run_pipelined_banked`` over
   ``BankMesh(("cuda:0", "cuda:0"))`` for every filter and
   ``banked_subtract_average``, from two pre-generated bank sources at
   the paper's size, each equal to the same run on the CPU (on a machine
   with two cards, again over ``make_bank_mesh(2)``), and times the
   executor per group at 1 and at 2 banks;
8. drives the session service (``repro_torch.serve.SessionScheduler``) at
   the paper's size, each tenant folding phase 2's groups plus 16 times
   its index: (8a) 4 ``pair_average`` sessions on one 4-slot executor,
   every group one full cohort (B4 at B = 4), then 1 session alone (B2
   only); (8b) 2 ``pair_average`` and 2 ``temporal_median`` sessions on
   two executors at once; (8c) 2 sessions over ``BankMesh(("cuda:0",
   "cuda:0"))``, the gang path; (8d) a ``CompressedEgress`` int8 and a
   top-k consumer. Every output is bitwise equal to the session's own
   ``run_pipelined`` (or ``run_pipelined_banked``) on the card, and every
   packet to the CPU compressor run on a host copy of the same partial.
   (8e) times the 4 sessions co-scheduled against 4 sequential
   ``run_pipelined`` runs, reports each session's transfer and compute
   share and latency, and times B4 at B = 4 against its bound;
9. drives the fault-tolerant fleet (``repro_torch.serve.FleetScheduler``)
   at the paper's size on the tenants of phase 8, checkpointing into a
   ``tempfile.mkdtemp()`` directory removed at the end: (9a) for every
   filter (``spatial_box`` bilateral), two sessions in full cohorts on a
   2-slot executor killed before its 6th cohort, at
   ``checkpoint_every=1`` (restore) and 3 (restore + replay), the restored
   state on the card; (9b) live migration under a co-tenant's load,
   ``pair_average`` and ``temporal_median``; (9c) straggler and heartbeat
   evictions on a ``FakeClock``; (9d) ``scale_down`` draining its victim
   through live migration, over two 1-slot executors and over
   ``BankMesh(("cuda:0", "cuda:0"))``. Every output is bitwise equal to
   that stream's undisturbed ``run_pipelined`` on the card. (9e) times,
   beside the card's name and power limit, each filter's checkpoint (the
   slot's device-to-host copy, the write and fsync, its size) and
   ``restore_latest``; one session's ms/group with no checkpoint and at
   ``checkpoint_every`` 1, 2 and 4 against the camera's 57 ms, with the
   executor thread's wall time per cohort split into the device wait,
   the fold and the checkpoint; kill-to-recovered ms on the real clock
   (9a); and 4 ``pair_average`` sessions on two 4-slot executors with and
   without checkpoints, beside phase 8e's ``SessionScheduler``;
10. drives the elastic tier at the paper's size: a seeded
   ``flash_crowd_schedule`` trace of ``pair_average`` and
   ``temporal_median`` tenants (``TenantProfile``) replayed on a
   ``FakeClock`` against ``FleetScheduler(device="cuda")`` with an
   ``Autoscaler``, which scales up, climbs a rung of the degradation
   ladder, restores and scales down; the decisions, states, admissions
   and events equal those of the same trace on the CPU at a small shape,
   and every session's output is bitwise equal to its tenant's
   undisturbed ``run_pipelined`` on the card; it prints the crowd's
   aggregate ms/group and the host time of one ``evaluate``;
11. resolves ``tile_plan="auto"`` for every filter at the paper's shape
   into a fresh plan cache (the launch model's candidates timed on the
   card with CUDA events), resolves each again from the cache without a
   single measurement, and runs ``run_pipelined`` under each tuned plan,
   bitwise equal to the heuristic's; it prints each family's candidates'
   device time, the heuristic's, the winner (timed again beside the
   heuristic with ``time_ms`` when it differs) and the tuned ``num_slots``.

Phases 2-3 are the ``pair_average`` path (B2-B5), phase 5 the other
filters' path (B6-B9), phase 6 the baselines' path (B10), phase 7 the
banked path (B4-B9), phase 8 (8a-8d) the service's path (B2, B4, B6,
B7), phase 9 (9a-9d) the fleet's path (B2, B4, B6-B9), phase 10 the
elastic tier's (B2, B4, B6, B7) and phase 11 the tuned runs' (B2,
B6-B9): every launch counter is set to 0 just before each and read just
after; a kernel of the path launched no time there fails the run. A kernel's ``launches`` in the ``{"kernels": [...]}`` line is
its sum over those phases. The script prints the card's ``nvidia-smi`` name and power
limit, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
It exits with code 2, printing no result, when no CUDA device is present.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CSRC = "src/repro_torch/kernels/csrc/"
#: (match in the card's name, HBM bytes/s, float32 non-tensor FLOP/s):
#: NVIDIA data sheets, dense, at the full power limit
PEAKS = (
    ("H200", 4.8e12, 67e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", 3.35e12, 67e12),  # SXM5 (named "H100 80GB HBM3" or "H100 SXM")
)
CAMERA_GROUP_MS = 57e-3 * 1000  # 57 us per frame x 1000 frames per group
#: device clock cycles of the sleep that heads each timing sample (about
#: 1 ms at the H100's 1.98 GHz boost clock)
QUEUE_CYCLES = 2_000_000
#: kernel -> (CUDA source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "alg3_stream_step": ("denoise_stream.cu", "src/repro/kernels/denoise_stream.py:252"),
    "alg3_subtract_average": ("denoise_stream.cu", "src/repro/kernels/denoise_stream.py:160"),
    "multibank_stream_step": ("denoise_stream.cu", "src/repro/kernels/denoise_multibank.py:201"),
    "multibank_subtract_average": ("denoise_stream.cu", "src/repro/kernels/denoise_multibank.py:113"),
    "median_window_insert": ("denoise_median.cu", "src/repro/kernels/denoise_median.py:104"),
    "median_combine": ("denoise_median.cu", "src/repro/kernels/denoise_median.py:170"),
    "ema_welford_step": ("denoise_ema.cu", "src/repro/kernels/denoise_ema.py:141"),
    "spatial_filter_3x3": ("denoise_spatial.cu", "src/repro/kernels/denoise_spatial.py:126"),
    "alg1_subtract_average": ("denoise_tmpframe.cu", "src/repro/kernels/denoise_tmpframe.py:75,93"),
    "alg2_subtract_average": ("denoise_tmpframe.cu", "src/repro/kernels/denoise_tmpframe.py:75,93"),
}
PAIR_AVERAGE_PATH = ("alg3_stream_step", "alg3_subtract_average", "multibank_stream_step",
                     "multibank_subtract_average")
FILTER_PATH = ("median_window_insert", "median_combine", "ema_welford_step", "spatial_filter_3x3")
BASELINE_PATH = ("alg1_subtract_average", "alg2_subtract_average")
BANKED_PATH = ("multibank_stream_step", "multibank_subtract_average") + FILTER_PATH
#: the session service's path (phase 8): the lone-slot step (B2), the cohort
#: and gang steps (B4) and ``temporal_median``'s window (B6, B7)
SERVE_PATH = ("alg3_stream_step", "multibank_stream_step", "median_window_insert",
              "median_combine")
#: the fleet's path (phase 9): every filter's sessions through the lone-slot
#: and cohort steps, killed and restored, replayed, migrated and drained
FLEET_PATH = ("alg3_stream_step", "multibank_stream_step", "median_window_insert",
              "median_combine", "ema_welford_step", "spatial_filter_3x3")
#: phase 9's filters at their defaults (spatial_box: bilateral)
FLEET_FILTERS = {
    "pair_average": {},
    "temporal_median": dict(filter_name="temporal_median"),
    "ema_variance": dict(filter_name="ema_variance"),
    "spatial_box": dict(filter_name="spatial_box"),
}
#: a coalescing window long enough that co-paced sessions always form full
#: cohorts (8a, 9a); the service's default is 5 ms
FULL_COHORT_MS = 60_000.0
SESSION_TIMEOUT_S = 120  # every session's result() is bounded


def card_peaks(name: str) -> tuple[float, float]:
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no peak rates known for {name!r}; add it to PEAKS")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *, reps: int = 15, inner: int = 10, warmup: int = 3,
            strict: bool = True) -> float:
    """Median CUDA-event time of one ``fn()`` call: ``inner`` back-to-back
    calls between two events, ``reps`` times, after ``warmup`` calls. Each
    sample starts behind a device sleep, so the host has queued the calls
    before the first one runs and the events read the device's time, not
    the host's rate of launching: a kernel wrapper takes tens of
    microseconds of host time a call (``host_us``), as long as the fastest
    kernels themselves. A sample whose start event the device passed
    before the host had queued its last call is taken again behind a sleep
    twice as long, up to 16 times ``QUEUE_CYCLES``; past that a ``strict``
    timing raises, and any other (a plain version's, which may wait on the
    device itself) keeps the sample."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles, samples = QUEUE_CYCLES, []
    while len(samples) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        covered = not start.query()  # the sleep still ran when the last call was queued
        end.record()
        end.synchronize()
        if covered or (cycles >= 16 * QUEUE_CYCLES and not strict):
            samples.append(start.elapsed_time(end) / inner)
        elif cycles >= 16 * QUEUE_CYCLES:
            raise AssertionError(f"the host queued {inner} calls for longer than a "
                                 f"{cycles}-cycle device sleep")
        else:
            cycles *= 2
    return statistics.median(samples)


def plain_ms(fn, **kw) -> float:
    """``time_ms`` of a plain version or a library call, not strict."""
    return time_ms(fn, strict=False, **kw)


def host_us(fn, *, calls: int = 200) -> float:
    """Host time of one ``fn()`` call, in microseconds, while the device
    runs the calls queued before it (the median of five runs of ``calls``)."""
    samples = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        samples.append((time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(samples)


def serve_phase(cfg, groups, wrappers, reset_counters, read_counters, one_card, bound, time_ms):
    """Phase 8: the session service at the paper's size. Returns the
    launches of 8a-8d (counters zeroed just before 8a, read just after 8d)
    and a record of what was held and timed."""
    from repro_torch.core import streaming
    from repro_torch.core.banks import run_pipelined_banked
    from repro_torch.core.denoise import DenoiseConfig
    from repro_torch.core.egress import CompressedEgress
    from repro_torch.optim.compress import int8_compress, topk_compress
    from repro_torch.serve import Session, SessionScheduler

    t8 = time.perf_counter()
    G, N, H, W, P = cfg.num_groups, cfg.frames_per_group, cfg.height, cfg.width, cfg.pairs_per_group
    # session s folds phase 2's groups plus 16 s (u16): no two slots hold the same data
    tenants = [[g + np.uint16(16 * s) for g in groups] for s in range(4)]
    cfg_tm = DenoiseConfig(filter_name="temporal_median")  # K = 5
    b2, b4 = wrappers["alg3_stream_step"], wrappers["multibank_stream_step"]

    def counts():
        torch.cuda.synchronize()
        return {k: wrappers[k].launches for k in SERVE_PATH}

    def gated(chunks, gate):
        if not gate.wait(60):
            raise TimeoutError("the sessions never all joined")
        yield from chunks

    def serve(sched_kw, sessions):
        """Submit every (config, groups, consumer) session, open their
        sources once all of them hold a slot (so the first chunk of one is
        never stepped before the others have joined), and return each
        ``(output, SessionReport)``, the seconds from the gate to the last
        result, and the scheduler's stats."""
        gate = threading.Event()
        with SessionScheduler(**sched_kw) as sched:
            hs = [sched.submit(Session(config=c, source=gated(g, gate), name=f"tenant{i}",
                                       consumer=consumer))
                  for i, (c, g, consumer) in enumerate(sessions)]
            deadline = time.monotonic() + 60
            while not all(h.status == "active" for h in hs):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"sessions never joined: {[h.status for h in hs]}")
                time.sleep(1e-3)
            t = time.perf_counter()
            gate.set()
            res = [h.result(timeout=SESSION_TIMEOUT_S) for h in hs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            stats = sched.stats()
        return res, wall, stats

    def held(what, got: torch.Tensor, want: torch.Tensor) -> None:
        if got.shape != (P, H, W) or not torch.equal(got.to(want.device), want):
            raise AssertionError(f"{what}: not bitwise equal to its reference run on the card")

    def pair(s, consumer=None):
        return (cfg, tenants[s], consumer)

    # each session's reference run on the card, before the counters are zeroed
    refs = [streaming.run_pipelined(cfg, iter(t))[0] for t in tenants]
    tm_refs = {s: streaming.run_pipelined(cfg_tm, iter(tenants[s]))[0] for s in (2, 3)}
    gang = {"pair_average": cfg, "temporal_median": cfg_tm}
    gang_refs = {label: run_pipelined_banked(dataclasses.replace(c, num_banks=2),
                                             [iter(tenants[0]), iter(tenants[1])], one_card)[0].cpu()
                 for label, c in gang.items()}
    record: dict = {}

    # 8a: four co-paced pair_average tenants on one 4-slot executor, every
    # group one full cohort (B4 at B = 4); then one tenant alone (B2 only)
    reset_counters()
    c0 = counts()
    full = dict(slots_per_executor=4, max_executors=2, coalesce_ms=FULL_COHORT_MS)
    res, _, _ = serve(full, [pair(s) for s in range(4)])
    for s, (out, rep) in enumerate(res):
        held(f"8a tenant{s}", out, refs[s])
        if rep.groups != G:
            raise AssertionError(f"8a tenant{s}: {rep.groups} groups folded, want {G}")
    c1 = counts()
    steps_8a = (c1["multibank_stream_step"] - c0["multibank_stream_step"],
                c1["alg3_stream_step"] - c0["alg3_stream_step"])
    if steps_8a != (G, 0):
        raise AssertionError(f"8a: (B4, B2) launches {steps_8a}, want ({G}, 0): every group "
                             "one full cohort at B = 4")
    res, _, _ = serve(dict(slots_per_executor=1, max_executors=1), [pair(0)])
    held("8a one session", res[0][0], refs[0])
    c2 = counts()
    steps_1 = (c2["multibank_stream_step"] - c1["multibank_stream_step"],
               c2["alg3_stream_step"] - c1["alg3_stream_step"])
    if steps_1 != (0, G):
        raise AssertionError(f"8a one session: (B4, B2) launches {steps_1}, want (0, {G})")
    print(f"phase 8a: 4 pair_average sessions on SessionScheduler(slots_per_executor=4) at "
          f"G=8 N=1000 80x256 u16 bitwise equal to their run_pipelined on the card, {G} B4 "
          f"launches at B=4 and no B2; 1 session (slots_per_executor=1) bitwise equal, {G} B2 "
          f"launches and no B4")

    # 8b: two executors' threads on one card at once
    res, _, stats = serve(dict(slots_per_executor=4, max_executors=2),
                          [pair(0), pair(1), (cfg_tm, tenants[2], None), (cfg_tm, tenants[3], None)])
    for s in (0, 1):
        held(f"8b pair_average tenant{s}", res[s][0], refs[s])
    for s in (2, 3):
        held(f"8b temporal_median tenant{s}", res[s][0], tm_refs[s])
    if sorted(e["filter"] for e in stats["executors"]) != ["pair_average", "temporal_median"]:
        raise AssertionError(f"8b: executors {stats['executors']}")
    c3 = counts()
    tm_launches = {k: c3[k] - c2[k] for k in ("median_window_insert", "median_combine")}
    if not all(tm_launches.values()):
        raise AssertionError(f"8b: temporal_median kernels not launched: {tm_launches}")
    print(f"phase 8b: 2 pair_average + 2 temporal_median (K=5) sessions on two executors at once, "
          f"each bitwise equal to its own run on the card; launches {json.dumps(tm_launches)}")

    # 8c: the gang path, one session per bank shard of a two-shard mesh on one card
    for label, c in gang.items():
        res, _, _ = serve(dict(mesh=one_card, max_executors=1),
                          [(c, tenants[0], None), (c, tenants[1], None)])
        for b, (out, _) in enumerate(res):
            held(f"8c gang {label} shard {b}", out.cpu(), gang_refs[label][b])
    print("phase 8c: 2 sessions over BankMesh(cuda:0, cuda:0) (gang path), pair_average and "
          "temporal_median, bitwise equal to run_pipelined_banked over the same mesh (host copies)")

    # 8d: compressed egress as a session consumer
    class Tapped:
        """Keeps a host copy of each partial, then egresses it."""

        def __init__(self, egress):
            self.egress, self.partials = egress, []

        def __call__(self, step, partial):
            self.partials.append(partial.cpu())
            self.egress(step, partial)

    taps = {kind: Tapped(CompressedEgress(kind, center=cfg.offset)) for kind in ("int8", "topk")}
    res, _, _ = serve(dict(slots_per_executor=2, max_executors=1),
                      [pair(0, taps["int8"]), pair(1, taps["topk"])])
    held("8d int8 egress session", res[0][0], refs[0])
    held("8d topk egress session", res[1][0], refs[1])
    center = torch.tensor(cfg.offset, dtype=torch.float32)
    for i, (kind, tap) in enumerate(taps.items()):
        packets = tap.egress.packets
        if len(packets) != G or not torch.equal(tap.partials[-1], res[i][0].cpu()):
            raise AssertionError(f"8d {kind}: {len(packets)} packets, or the last partial is "
                                 "not the output")
        for step, (pkt, host) in enumerate(zip(packets, tap.partials)):
            x = host - center
            if kind == "int8":
                q, scale = int8_compress(x)
                want, same_scale = (q.numpy(),), pkt.scale == float(scale)
            else:
                vals, idx = topk_compress(x.reshape(-1), max(1, int(x.numel() * tap.egress.k_fraction)))
                want, same_scale = (vals.numpy(), idx.numpy()), True
            if pkt.step != step or not same_scale or len(pkt.payload) != len(want) or not all(
                    a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(pkt.payload, want)):
                raise AssertionError(f"8d {kind} packet {step}: not bitwise the CPU compressor's")
    egress = {kind: dict(packets=len(t.egress.packets), wire_bytes=t.egress.wire_bytes,
                         raw_bytes=t.egress.raw_bytes, reduction=t.egress.reduction)
              for kind, t in taps.items()}
    del taps, res
    serve_launches = read_counters(SERVE_PATH, "session service's path")
    print(f"phase 8d: CompressedEgress int8 and topk as session consumers, all {2 * G} packets "
          f"bitwise equal to int8_compress/topk_compress on the CPU of a host copy of the same "
          f"partial; reduction int8 {egress['int8']['reduction']:.2f}x, topk "
          f"{egress['topk']['reduction']:.2f}x")
    print(f"phase 8 launches (8a-8d): {json.dumps(serve_launches)}")

    # 8e: timing, pre-generated groups: 4 sequential run_pipelined against the
    # 4 co-scheduled sessions (default 5 ms coalescing window, and a window
    # long enough that every group is one full cohort), in the order
    # sequential, co, full, full, co, sequential
    timing: dict = {"sequential": [], "co_scheduled": [], "co_scheduled_full_cohort": []}
    for mode in ("sequential", "co_scheduled", "co_scheduled_full_cohort",
                 "co_scheduled_full_cohort", "co_scheduled", "sequential"):
        if mode == "sequential":
            torch.cuda.synchronize()
            t = time.perf_counter()
            reps = [streaming.run_pipelined(cfg, iter(tenants[s]))[1] for s in range(4)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            row = dict(ms_per_group=wall / (4 * G) * 1e3, per_session=[dict(
                transfer_ms_per_group=r.transfer_s / G * 1e3, ms_per_group=r.elapsed_s / G * 1e3,
                latency_p50_ms=r.latency_p50_ms, latency_p99_ms=r.latency_p99_ms) for r in reps])
        else:
            kw = dict(slots_per_executor=4, max_executors=2)
            if mode == "co_scheduled_full_cohort":
                kw["coalesce_ms"] = FULL_COHORT_MS
            before = (b4.launches, b2.launches)
            res, wall, _ = serve(kw, [pair(s) for s in range(4)])
            row = dict(ms_per_group=wall / (4 * G) * 1e3,
                       b4_b2_launches=(b4.launches - before[0], b2.launches - before[1]),
                       per_session=[dict(
                           transfer_ms_per_group=r.transfer_s / r.groups * 1e3,
                           compute_ms_per_group=r.compute_s / r.groups * 1e3,
                           latency_p50_ms=r.latency_p50_ms, latency_p99_ms=r.latency_p99_ms)
                           for _, r in res])
            del res
        timing[mode].append(row)
    for mode, rows in timing.items():
        for row in rows:
            sessions = row["per_session"]
            extra = f", (B4, B2) launches {row['b4_b2_launches']}" if "b4_b2_launches" in row else ""
            comp = ("compute " + ", ".join(f"{p['compute_ms_per_group']:.3f}" for p in sessions)
                    + " ms/group, " if "compute_ms_per_group" in sessions[0] else "")
            print(f"  serve {mode:26s} aggregate {row['ms_per_group']:7.3f} ms/group over 4 x {G} "
                  f"groups; per session transfer "
                  + ", ".join(f"{p['transfer_ms_per_group']:.2f}" for p in sessions)
                  + f" ms/group, {comp}latency p50/p99 "
                  + ", ".join(f"{p['latency_p50_ms']:.2f}/{p['latency_p99_ms']:.2f}" for p in sessions)
                  + f" ms{extra}")
    dev = torch.device("cuda")
    frames4 = torch.from_numpy(np.stack([t[0] for t in tenants])).to(dev)
    sum4 = torch.zeros(4, P, H, W, device=dev)
    b4_ms = time_ms(lambda: b4(frames4, sum4, num_groups=G, offset=cfg.offset))
    nbytes = 4 * (N * H * W * 2 + 2 * P * H * W * 4)
    b4_bound, b4_by = bound(nbytes, 4 * P * H * W * 3)
    print(f"  multibank_stream_step B=4 u16 v1 (the full cohort's step): {b4_ms * 1e3:.2f} us, "
          f"bound {b4_bound * 1e3:.2f} us ({nbytes / 1e6:.2f} MB, {b4_by}), "
          f"{b4_bound / b4_ms:.1%} of peak")
    del frames4, sum4, refs, tm_refs
    record.update(steps_8a=steps_8a, steps_one_session=steps_1, temporal_median_launches=tm_launches,
                  egress=egress, launches=serve_launches, timing=timing,
                  b4_at_b4=dict(ms=b4_ms, bound_ms=b4_bound, bound_by=b4_by, bytes=nbytes),
                  seconds=time.perf_counter() - t8)
    print(f"phase 8: {time.perf_counter() - t8:.1f} s")
    return serve_launches, record


def fleet_phase(cfg, groups, reset_counters, read_counters, one_card, smi, serve_timing,
                device="cuda"):
    """Phase 9: the fault-tolerant fleet at the paper's size. Returns the
    launches of 9a-9d (counters zeroed just before 9a, read just after 9d)
    and a record of what was held and timed. Checkpoints go to a
    ``tempfile.mkdtemp()`` directory, removed at the end."""
    import contextlib
    import os
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import streaming
    from repro_torch.core.banks import banked_filter_init
    from repro_torch.denoise.base import tree_leaves
    from repro_torch.serve import (
        FakeClock,
        FaultPlan,
        FleetScheduler,
        Session,
        SessionCheckpointer,
    )
    from repro_torch.serve import scheduler as sched_mod

    t9 = time.perf_counter()
    G, P, H, W = cfg.num_groups, cfg.pairs_per_group, cfg.height, cfg.width
    dev = torch.empty(0, device=device).device  # with its index: cuda:0
    on = dict(device=device)
    # tenant s folds phase 2's groups plus 16 s (u16), as in phase 8
    tenants = [[g + np.uint16(16 * s) for g in groups] for s in range(4)]
    cfgs = {label: dataclasses.replace(cfg, **extra) for label, extra in FLEET_FILTERS.items()}
    root = tempfile.mkdtemp(prefix="fleet-checkpoints-")
    record: dict = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def held(what, got, want):
        if tuple(got.shape) != (P, H, W) or got.device.type != dev.type or not torch.equal(
                got, want):
            raise AssertionError(f"{what}: not bitwise equal to its undisturbed run_pipelined")

    def gated(chunks, gate, first=0):
        yield from chunks[:first]
        if not gate.wait(SESSION_TIMEOUT_S):
            raise TimeoutError("a gated source was never opened")
        yield from chunks[first:]

    def seated(fleet):
        """Every executor beats once after its next join pass (the fleet's
        own probe), so each submitted session holds its slot before any
        gated group exists and co-tenants fold in full cohorts."""
        res = fleet.check_faults(probe_timeout_s=60)
        if res["evicted"]:
            raise AssertionError(f"a probe evicted {res['evicted']}")

    def folded(event, at):
        def consumer(step, _partial):
            if step >= at:
                event.set()
        return consumer

    def ckpt(name):
        """A fresh checkpoint directory; the runs before it are over, so
        their checkpoints are removed first (the temporal_median window
        writes 204.8 MB a group)."""
        for old in os.listdir(root):
            shutil.rmtree(os.path.join(root, old))
        return os.path.join(root, name)

    @contextlib.contextmanager
    def cohort_split():
        """The executor thread's wall time per cohort, split into the wait
        for the device (the fold's ``_wait``), the checkpoint (the fleet's
        ``_on_session_step``) and the rest of the fold (ring pickup, the
        launches, the consumer's partial). Yields the list of
        ``(wait_s, fold_s, checkpoint_s)`` rows it fills."""
        rows, local = [], threading.local()
        wait0, fold0 = sched_mod._wait, sched_mod._SlotExecutor._fold_cohort_inner
        step0 = FleetScheduler._on_session_step

        def wait(devices):
            t = time.perf_counter()
            wait0(devices)
            local.wait += time.perf_counter() - t

        def fold(self, *args):
            local.wait = local.ckpt = 0.0
            t = time.perf_counter()
            fold0(self, *args)
            total = time.perf_counter() - t
            rows.append((local.wait, total - local.wait - local.ckpt, local.ckpt))

        def on_session_step(self, *args):
            t = time.perf_counter()
            step0(self, *args)
            local.ckpt += time.perf_counter() - t

        sched_mod._wait, sched_mod._SlotExecutor._fold_cohort_inner = wait, fold
        FleetScheduler._on_session_step = on_session_step
        try:
            yield rows
        finally:
            sched_mod._wait, sched_mod._SlotExecutor._fold_cohort_inner = wait0, fold0
            FleetScheduler._on_session_step = step0

    try:
        # every session's undisturbed run on the card, before the counters are zeroed
        refs = {label: [streaming.run_pipelined(c, iter(tenants[s]), **on)[0] for s in (0, 1, 2)]
                for label, c in cfgs.items()}
        sync()
        reset_counters()

        # 9a: kill and recover, every filter, two sessions in full cohorts on
        # a 2-slot executor; ex0 dies before its 6th cohort. every=1 restores
        # the checkpoint of group 5, every=3 that of group 3 and replays 2
        kills, latencies = {}, {}
        for label, c in cfgs.items():
            for every in (1, 3):
                gate, restored = threading.Event(), []
                plan = FaultPlan().crash("ex0", at_step=5)
                fleet = FleetScheduler(checkpoint_dir=ckpt(f"9a-{label}-{every}"),
                                       checkpoint_every=every, faults=plan, slots_per_executor=2,
                                       max_executors=2, coalesce_ms=FULL_COHORT_MS, **on)
                restore = fleet.checkpointer.restore_latest

                def recording(*args, _restore=restore, _restored=restored, **kw):
                    out = _restore(*args, **kw)
                    if out[0] is not None:
                        _restored.extend(t.device for t in tree_leaves(out[0])[0])
                    return out

                fleet.checkpointer.restore_latest = recording
                with fleet:
                    hs = [fleet.submit(Session(config=c, source=gated(tenants[s], gate),
                                               name=f"s{s}")) for s in (0, 1)]
                    seated(fleet)
                    gate.set()
                    res = [h.result(timeout=SESSION_TIMEOUT_S) for h in hs]
                what = f"9a {label} every={every}"
                for s, (out, rep) in enumerate(res):
                    held(f"{what} s{s}", out, refs[label][s])
                    if (rep.restarts, rep.groups) != (1, G):
                        raise AssertionError(f"{what} s{s}: restarts {rep.restarts}, groups "
                                             f"{rep.groups}")
                want = "steps=5+0" if every == 1 else "steps=3+2"
                if not plan.crashed("ex0") or sorted(fleet.events) != [
                        "dead@ex0:InjectedExecutorFailure", f"recover@s0->ex1:{want}",
                        f"recover@s1->ex1:{want}"]:
                    raise AssertionError(f"{what}: events {fleet.events}, want two {want}")
                if not restored or any(d != dev for d in restored):
                    raise AssertionError(f"{what}: restored state on {restored}")
                kills[f"{label}/every={every}"] = fleet.events
                latencies[f"{label}/every={every}"] = [x * 1e3 for x in
                                                       fleet.recovery_latencies_s()]
        print(f"phase 9a: FleetScheduler at G=8 N=1000 80x256 u16, 2 sessions in full cohorts, "
              f"ex0 killed before its 6th cohort, for {', '.join(cfgs)} (bilateral) at every=1 "
              f"(restore @5) and every=3 (restore @3 + replay 2): every output bitwise equal to "
              f"its undisturbed run_pipelined, restarts 1, restored state on {dev}")

        # 9b: live migration under a co-tenant's load, mid-stream
        for label in ("pair_average", "temporal_median"):
            gate, fed = threading.Event(), threading.Event()

            def src(chunks=tenants[0]):
                yield chunks[0]
                yield chunks[1]
                fed.set()
                if not gate.wait(SESSION_TIMEOUT_S):
                    raise TimeoutError("9b: source never released")
                yield from chunks[2:]

            with FleetScheduler(slots_per_executor=2, max_executors=2, **on) as fleet:
                h = fleet.submit(Session(config=cfgs[label], source=src(), name="m0"))
                hb = fleet.submit(Session(config=cfgs[label], source=iter(tenants[1]), name="m1"))
                if not fed.wait(60):
                    raise TimeoutError("9b: source never staged its first groups")
                target = fleet.migrate(h, timeout=60)
                gate.set()
                res = [h.result(timeout=SESSION_TIMEOUT_S), hb.result(timeout=SESSION_TIMEOUT_S)]
            if target != "ex1" or fleet.events != ["migrate@m0:ex0->ex1"]:
                raise AssertionError(f"9b {label}: target {target}, events {fleet.events}")
            for s, (out, _) in enumerate(res):
                held(f"9b {label} m{s}", out, refs[label][s])
            if (res[0][1].migrations, res[1][1].migrations) != (1, 0):
                raise AssertionError(f"9b {label}: migrations {[r.migrations for _, r in res]}")
        print("phase 9b: pair_average and temporal_median sessions live-migrated mid-stream "
              "(ex0 -> ex1) under a co-tenant's load, both outputs bitwise equal")

        # 9c: scripted evictions on a FakeClock: a straggler (virtual step
        # times 0.1 s and 0.5 s) and a stalled executor (heartbeat timeout)
        plan = FaultPlan().slow("ex0", extra_s=0.1, from_step=0).slow("ex1", extra_s=0.5,
                                                                      from_step=0)
        gates, warm = [threading.Event(), threading.Event()], [threading.Event(), threading.Event()]
        with FleetScheduler(checkpoint_dir=ckpt("9c-straggler"), faults=plan, clock=FakeClock(),
                            slots_per_executor=1, max_executors=3, straggler_threshold=1.5,
                            straggler_warmup=3, **on) as fleet:
            hs = [fleet.submit(Session(config=cfg, source=gated(tenants[s], gates[s], first=4),
                                       name=n, consumer=folded(warm[s], 3)))
                  for s, n in enumerate(("A", "B"))]
            if not (warm[0].wait(60) and warm[1].wait(60)):
                raise TimeoutError("9c: sessions never warmed up")
            straggle = fleet.check_faults(probe=False)
            for g in gates:
                g.set()
            res = [h.result(timeout=SESSION_TIMEOUT_S) for h in hs]
            events_straggler = list(fleet.events)
        if straggle["evicted"] != ["ex1"] or straggle["recovered"] != ["B"] or \
                events_straggler != ["evict@ex1:straggler", "recover@B->ex2:steps=4+0"]:
            raise AssertionError(f"9c straggler: {straggle}, events {events_straggler}")
        for s, (out, _) in enumerate(res):
            held(f"9c straggler {'AB'[s]}", out, refs["pair_average"][s])
        plan, clock = FaultPlan().stall("ex0", at_step=2), FakeClock()
        try:
            with FleetScheduler(checkpoint_dir=ckpt("9c-heartbeat"), faults=plan, clock=clock,
                                slots_per_executor=1, max_executors=2, heartbeat_timeout_s=60.0,
                                **on) as fleet:
                h = fleet.submit(Session(config=cfg, source=iter(tenants[0]), name="S"))
                if not plan.wait_stalled("ex0", timeout=60):
                    raise TimeoutError("9c: ex0 never stalled")
                clock.advance(61.0)
                silent = fleet.check_faults(probe=False)
                out, rep = h.result(timeout=SESSION_TIMEOUT_S)
                events_heartbeat = list(fleet.events)
        finally:
            plan.poison("ex0")
        if silent["evicted"] != ["ex0"] or events_heartbeat != [
                "evict@ex0:heartbeat", "recover@S->ex1:steps=2+0"]:
            raise AssertionError(f"9c heartbeat: {silent}, events {events_heartbeat}")
        held("9c heartbeat S", out, refs["pair_average"][0])
        print(f"phase 9c: on a FakeClock, straggler ex1 evicted ({events_straggler}) and stalled "
              f"ex0 evicted by heartbeat ({events_heartbeat}), every output bitwise equal")

        # 9d: scale_down drains its victim through live migration: a pool of
        # two 1-slot executors, and over the two-shard mesh on one card (s0
        # and s1 fill ex0's shards, s2 runs on ex1, which is drained)
        drains = {}
        for label in ("pair_average", "temporal_median"):
            for mesh in (None, one_card):
                n = 2 if mesh is None else 3
                first = [2] * n if mesh is None else [0, 0, 2]
                gate, mids = threading.Event(), [threading.Event() for _ in range(n)]
                kw = dict(slots_per_executor=1, **on) if mesh is None else dict(mesh=mesh)
                with FleetScheduler(clock=FakeClock(), max_executors=2, coalesce_ms=0.0,
                                    **kw) as fleet:
                    hs = [fleet.submit(Session(config=cfgs[label],
                                               source=gated(tenants[s], gate, first=first[s]),
                                               name=f"d{s}", consumer=folded(mids[s], 1)))
                          for s in range(n)]
                    if not all(m.wait(60) for m, f in zip(mids, first) if f):
                        raise TimeoutError("9d: the sessions never reached mid-stream")
                    seated(fleet)
                    drained = fleet.scale_down(reason="chip_smoke")
                    gate.set()
                    res = [h.result(timeout=SESSION_TIMEOUT_S) for h in hs]
                victim = "ex0" if mesh is None else "ex1"
                moved = "d0:ex0->ex1" if mesh is None else "d2:ex1->ex0"
                if drained != victim or fleet.events != [f"migrate@{moved}",
                                                         f"scale-down:{victim}:chip_smoke"]:
                    raise AssertionError(f"9d {label} mesh={mesh}: drained {drained}, events "
                                         f"{fleet.events}")
                for s, (out, rep) in enumerate(res):
                    held(f"9d {label} mesh={mesh} d{s}", out, refs[label][s])
                if sum(rep.migrations for _, rep in res) != 1:
                    raise AssertionError(f"9d {label}: {[r.migrations for _, r in res]}")
                drains[f"{label}/{'mesh' if mesh else 'pool'}"] = fleet.events
        del res, out
        launches = read_counters(FLEET_PATH, "fleet's path")
        print("phase 9d: scale_down drained its victim through live migration, pair_average "
              "and temporal_median, over two 1-slot executors and over BankMesh("
              f"{', '.join(str(d) for d in one_card.devices)}): every output bitwise equal")
        print(f"phase 9 launches (9a-9d): {json.dumps(launches)}")

        # 9e: timings. The checkpoint of each filter's slot: the device-to-host
        # copy (slot_to_host) and the write (np.savez, fsync of the manifest,
        # rename), and restore_latest onto the card
        timing: dict = {"smi": smi, "checkpoint": {}, "session_ms_per_group": {},
                        "cohort_split_ms": {}, "recovery_ms": latencies}
        for label, c in cfgs.items():
            filt, state = banked_filter_init(c, None, banks=1, **on)
            sub = filt.slot_extract(state, 0)
            for k in range(2):
                sub = filt.step(sub, torch.from_numpy(tenants[0][k]).to(dev), step_index=k)
            sync()
            mgr = CheckpointManager(ckpt(f"9e-{label}"), keep=2)
            d2h, write = [], []
            for k in range(5):
                t0 = time.perf_counter()
                host = filt.slot_to_host(sub)
                t1 = time.perf_counter()
                mgr.save(k, host, blocking=True, extra={"frames": 0, "stream_key": repr(
                    c.stream_key())})
                write.append(time.perf_counter() - t1)
                d2h.append(t1 - t0)
            sessions = SessionCheckpointer(ckpt(f"9e-restore-{label}"))
            sessions.save("s", filt, sub, steps=2, frames=2 * c.frames_per_group)
            restore = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                got, _, _ = sessions.restore_latest("s", filt, device=dev)
                sync()
                restore.append(time.perf_counter() - t0)
            if not all(torch.equal(a, b) for a, b in zip(tree_leaves(got)[0], tree_leaves(sub)[0])):
                raise AssertionError(f"9e {label}: the restored slot differs")
            nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(sub)[0])
            timing["checkpoint"][label] = dict(
                mb=nbytes / 1e6, d2h_ms=statistics.median(d2h) * 1e3,
                write_ms=statistics.median(write) * 1e3,
                restore_ms=statistics.median(restore) * 1e3)
            del filt, state, sub, got, host

        def timed(fleet_kw, sessions, split=None):
            """Seconds from opening the gate to the last result, the gate
            opened once every session holds its slot; ``split`` (a
            ``cohort_split`` list) is emptied first."""
            gate = threading.Event()
            if split is not None:
                split.clear()
            with FleetScheduler(**fleet_kw, **on) as fleet:
                hs = [fleet.submit(Session(config=c, source=gated(chunks, gate), name=f"t{i}"))
                      for i, (c, chunks) in enumerate(sessions)]
                seated(fleet)
                sync()
                t0 = time.perf_counter()
                gate.set()
                for h in hs:
                    h.result(timeout=SESSION_TIMEOUT_S)
                sync()
                return time.perf_counter() - t0

        # one session through the fleet with no checkpoint and at every 1, 2, 4
        modes = ("off", "every=1", "every=2", "every=4")
        with cohort_split() as split:
            for label, c in cfgs.items():
                per = timing["session_ms_per_group"][label] = {m: [] for m in modes}
                cohorts = timing["cohort_split_ms"][label] = {}
                for mode in modes + modes[::-1]:
                    every = None if mode == "off" else int(mode.split("=")[1])
                    kw = dict(checkpoint_dir=ckpt(f"9e-{label}-{mode}") if every else None,
                              checkpoint_every=every or 1, slots_per_executor=1, max_executors=1)
                    per[mode].append(timed(kw, [(c, tenants[0])], split) / G * 1e3)
                    cohorts.setdefault(mode, []).extend(split)
                for mode, rows in cohorts.items():
                    cohorts[mode] = {part: statistics.fmean(r[i] for r in rows) * 1e3
                                     for i, part in enumerate(("wait", "fold", "checkpoint"))}
        # 4 pair_average sessions on two 4-slot executors (phase 8e's
        # SessionScheduler configuration), without and with checkpoints
        four = timing["four_sessions_ms_per_group"] = {"off": [], "every=1": []}
        four_split = timing["cohort_split_ms"]["four_sessions"] = {"off": [], "every=1": []}
        with cohort_split() as split:
            for mode in ("off", "every=1", "every=1", "off"):
                kw = dict(checkpoint_dir=ckpt(f"9e-four-{mode}") if mode != "off" else None,
                          slots_per_executor=4, max_executors=2)
                four[mode].append(timed(kw, [(cfg, tenants[s]) for s in range(4)], split)
                                  / (4 * G) * 1e3)
                four_split[mode].extend(split)
        for mode, rows in four_split.items():
            four_split[mode] = {part: statistics.fmean(r[i] for r in rows) * 1e3
                                for i, part in enumerate(("wait", "fold", "checkpoint"))}
        four["session_scheduler_8e"] = [r["ms_per_group"] for r in serve_timing["co_scheduled"]]

        for label, v in timing["checkpoint"].items():
            per = timing["session_ms_per_group"][label]
            print(f"  fleet {label:15s} checkpoint {v['mb']:.2f} MB: d2h {v['d2h_ms']:.2f} ms + "
                  f"write/fsync {v['write_ms']:.2f} ms; restore_latest {v['restore_ms']:.2f} ms; "
                  f"1 session ms/group " + ", ".join(
                      f"{m} {[round(x, 2) for x in per[m]]}" for m in modes)
                  + f" (camera {CAMERA_GROUP_MS:.0f}) [{smi}]")
            print(f"  fleet {label:15s} executor ms per cohort (mean) wait/fold/checkpoint: "
                  + ", ".join(f"{m} " + "/".join(f"{x:.2f}" for x in parts.values())
                              for m, parts in timing["cohort_split_ms"][label].items())
                  + f" [{smi}]")
        print("  fleet kill-to-recovered ms (real clock): " + ", ".join(
            f"{k} {[round(x, 2) for x in v]}" for k, v in latencies.items()) + f" [{smi}]")
        print(f"  fleet 4 pair_average sessions / two 4-slot executors aggregate ms/group: off "
              f"{[round(x, 2) for x in four['off']]}, every=1 "
              f"{[round(x, 2) for x in four['every=1']]}; phase 8e SessionScheduler "
              f"{[round(x, 2) for x in four['session_scheduler_8e']]}; executor ms per cohort "
              f"(mean) wait/fold/checkpoint: " + ", ".join(
                  f"{m} " + "/".join(f"{x:.2f}" for x in parts.values())
                  for m, parts in four_split.items()) + f" [{smi}]")
        record.update(kills=kills, straggler=events_straggler, heartbeat=events_heartbeat,
                      drains=drains, launches=launches, timing=timing)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    record["seconds"] = time.perf_counter() - t9
    print(f"phase 9: {record['seconds']:.1f} s")
    return launches, record


#: phase 10's tenants: the paper's average and the median, as the traffic
#: mix of a lab that serves both (TenantProfile priority: the median's
#: cosmic-ray runs are the ones kept under shedding)
ELASTIC_TENANTS = {"pair_average": ({}, 0), "temporal_median": (dict(filter_name="temporal_median"), 10)}
#: the elastic tier's path (phase 10): lone-slot (B2) and cohort (B4)
#: steps, and the median's window (B6, B7)
ELASTIC_PATH = ("alg3_stream_step", "multibank_stream_step", "median_window_insert",
                "median_combine")
#: phase 10's flash crowd: base and burst rates (Hz), the burst window and
#: the trace's length (s) and its seed; the autoscaler evaluates every
#: EVAL_EVERY_S of virtual time
CROWD = dict(base_hz=0.25, burst_hz=2.0, burst_at_s=2.0, burst_s=4.0, duration_s=6.0, seed=5)
EVAL_EVERY_S = 2.0


def elastic_scenario(cfg, groups, device) -> dict:
    """Phase 10's script, on ``device``: a seeded flash crowd of
    ``pair_average`` and ``temporal_median`` sessions replayed on a
    ``FakeClock`` against a 2-executor ``FleetScheduler`` (2 slots each)
    with an ``Autoscaler`` that starts at one executor and evaluates every
    ``EVAL_EVERY_S`` of virtual time. Every admitted session is gated, so
    every decision depends on session counts only and the same trace gives
    the same decisions on any device and at any shape. After the trace the
    gates open (the crowd folds), one clean session runs (the ladder
    restores), then three gated sessions are seated and a clean tick lets
    the capacity plan shrink the pool: the drained executor's session
    migrates. Returns the decisions, states, outcomes, events and every
    completed session's output and report, and each session's tenant."""
    from repro_torch.serve import (
        AdmissionError,
        Autoscaler,
        FakeClock,
        FleetScheduler,
        Session,
        TenantProfile,
        admission_pressure_slo,
        build_trace,
        flash_crowd_schedule,
        replay_trace,
    )

    G = cfg.num_groups
    clock = FakeClock()
    fleet = FleetScheduler(clock=clock, slots_per_executor=2, max_executors=3, max_sessions=6,
                           max_waiting=64, coalesce_ms=0.0, slo_eval_every_s=1e9,
                           slos=[admission_pressure_slo(budget=0.25, window_s=EVAL_EVERY_S)],
                           device=device)
    scaler = Autoscaler(fleet, min_executors=1, initial_executors=2, breach_streak=1,
                        clear_streak=1, cooldown_down_s=0.0, planner_headroom=0.5)
    configs = {name: dataclasses.replace(cfg, **extra)
               for name, (extra, _) in ELASTIC_TENANTS.items()}
    profiles = [TenantProfile(name, configs[name], priority=prio)
                for name, (_, prio) in ELASTIC_TENANTS.items()]
    rng = np.random.default_rng(CROWD["seed"])
    arrivals = flash_crowd_schedule(CROWD["base_hz"], CROWD["burst_hz"],
                                    burst_at_s=CROWD["burst_at_s"], burst_s=CROWD["burst_s"],
                                    duration_s=CROWD["duration_s"], rng=rng)
    trace = build_trace(profiles, arrivals, rng=rng, min_groups=G, max_groups=G,
                        name_prefix="fc")
    handles, tenant, outcome, decisions, states = {}, {}, [], [], []
    next_eval = [EVAL_EVERY_S]

    def evaluate():
        decisions.append(scaler.evaluate().to_dict())
        states.append(scaler.state())

    def gated(chunks, gate):
        if not gate.wait(SESSION_TIMEOUT_S):
            raise TimeoutError("a gated source was never opened")
        yield from chunks

    def submit(name, profile, gate=None):
        source = iter(groups) if gate is None else gated(groups, gate)
        try:
            handles[name] = fleet.submit(Session(config=configs[profile], source=source,
                                                 name=name))
        except AdmissionError:
            outcome.append((name, "rejected"))
            return False
        outcome.append((name, "admitted"))
        tenant[name] = profile
        return True

    def tick(now):
        while now >= next_eval[0]:
            evaluate()
            next_eval[0] += EVAL_EVERY_S

    def seated():
        res = fleet.check_faults(probe_timeout_s=60)
        if res["evicted"]:
            raise AssertionError(f"a probe evicted {res['evicted']}")

    def results(names):
        return {n: handles[n].result(timeout=SESSION_TIMEOUT_S) for n in names if n in handles}

    with fleet:
        evaluate()  # the baseline snapshot at t = 0
        crowd = threading.Event()
        replay_trace(trace, clock=clock, on_tick=tick,
                     submit=lambda ev: submit(ev.session, ev.profile, crowd))
        clock.advance(next_eval[0] - clock.now())
        evaluate()  # the crowd's last window
        admitted = [n for n, what in outcome if what == "admitted"]
        t0 = time.perf_counter()
        crowd.set()
        done = results(admitted)
        crowd_s = time.perf_counter() - t0
        # a clean window: one session alone (the lone-slot step), then
        # restore; it and the tail take the first arrival's tenant, whose
        # executor the pool holds
        first = trace[0].profile
        clock.advance(EVAL_EVERY_S)
        submit("clean0", first)
        done.update(results(["clean0"]))
        evaluate()
        # three seated sessions and a clean window: the plan shrinks the pool
        last = threading.Event()
        for i in range(3):
            submit(f"tail{i}", first, last)
        seated()
        clock.advance(EVAL_EVERY_S)
        evaluate()
        last.set()
        done.update(results([f"tail{i}" for i in range(3)]))
        events, kinds = list(fleet.events), [k for k, _, _ in fleet.timeline]
        clock.advance(4 * EVAL_EVERY_S)  # past every window: no verdict acts
        t_eval = time.perf_counter()
        for _ in range(100):  # the controller's own cost
            scaler.evaluate()
        eval_us = (time.perf_counter() - t_eval) / 100 * 1e6
    return dict(decisions=decisions, states=states, outcome=outcome, events=events,
                kinds=kinds, done=done, crowd_s=crowd_s,
                crowd_groups=sum(rep.groups for n, (_, rep) in done.items()
                                 if n.startswith("fc")),
                evaluate_us=eval_us, tenant=tenant)


def elastic_phase(cfg, groups, reset_counters, read_counters, device="cuda"):
    """Phase 10: the elastic tier at the paper's size. The crowd of
    ``elastic_scenario`` on ``device``, held against the same trace on the
    CPU at a small shape (the decisions depend on session counts only):
    the same decisions, states, admissions and events, with a scale-up, a
    rung of degradation, a restore and a scale-down; every completed
    session bitwise equal to its tenant's undisturbed ``run_pipelined`` on
    ``device``. Returns the launches (counters zeroed just before the crowd
    and read after its last session) and a record."""
    from repro_torch.core import streaming
    from repro_torch.core.denoise import DenoiseConfig
    from repro_torch.data.prism import PrismSource

    t10 = time.perf_counter()
    small = DenoiseConfig(num_groups=cfg.num_groups, frames_per_group=8, height=8, width=32)
    want = elastic_scenario(small, list(PrismSource(small, seed=1).groups()), "cpu")
    refs = {name: streaming.run_pipelined(dataclasses.replace(cfg, **extra), iter(groups),
                                          device=device)[0]
            for name, (extra, _) in ELASTIC_TENANTS.items()}
    reset_counters()
    got = elastic_scenario(cfg, groups, device)
    launches = read_counters(ELASTIC_PATH, "elastic tier's path")
    for key in ("decisions", "states", "outcome", "events", "kinds"):
        if got[key] != want[key]:
            raise AssertionError(f"phase 10: {key} differ from the CPU replay: {got[key]} != "
                                 f"{want[key]}")
    actions = [d["action"] for d in got["decisions"]]
    for needed in ("scale-up", "degrade", "restore", "scale-down"):
        if needed not in actions:
            raise AssertionError(f"phase 10: no {needed} in {actions}")
    for name, (out, rep) in got["done"].items():
        tenant = got["tenant"][name]
        if (rep.groups, rep.drops) != (cfg.num_groups, 0) or not torch.equal(out, refs[tenant]):
            raise AssertionError(f"phase 10: {name} ({tenant}) not bitwise equal to its "
                                 f"undisturbed run_pipelined (groups {rep.groups}, drops "
                                 f"{rep.drops})")
    ms_per_group = got["crowd_s"] / got["crowd_groups"] * 1e3
    admitted = sum(1 for _, what in got["outcome"] if what == "admitted")
    print(f"phase 10: flash crowd of {len(got['outcome']) - 4} arrivals "
          f"({', '.join(ELASTIC_TENANTS)}) on a FakeClock against FleetScheduler(device="
          f"{device!r}) with an Autoscaler at G={cfg.num_groups} N={cfg.frames_per_group} "
          f"{cfg.height}x{cfg.width}: decisions {actions} and events {got['events']} equal to "
          f"the CPU replay; {admitted} sessions admitted, every one bitwise equal to its "
          f"undisturbed run_pipelined; the crowd's {got['crowd_groups']} groups at "
          f"{ms_per_group:.3f} ms/group aggregate; Autoscaler.evaluate {got['evaluate_us']:.1f} "
          f"us of host time; launches {json.dumps(launches)} "
          f"({time.perf_counter() - t10:.1f} s)")
    record = dict(decisions=got["decisions"], events=got["events"], outcome=got["outcome"],
                  crowd_ms_per_group=ms_per_group, crowd_groups=got["crowd_groups"],
                  evaluate_us=got["evaluate_us"], launches=launches)
    return launches, record


#: phase 11's path: each filter's run_pipelined under its tuned plan
TUNED_PATH = ("alg3_stream_step", "median_window_insert", "median_combine", "ema_welford_step",
              "spatial_filter_3x3")


def tune_phase(cfg, groups, reset_counters, read_counters, device="cuda"):
    """Phase 11: ``tile_plan="auto"`` at the paper's shape for every filter
    (``spatial_box`` bilateral), tuned into a fresh cache file: each plan
    resolves again from the cache without one measurement, and
    ``run_pipelined`` under it is bitwise equal to the heuristic's. Each
    family's candidates are timed by the tuner itself (CUDA events behind a
    device sleep); a winner other than the heuristic is timed again beside
    it with ``time_ms``. Returns the launches of the tuned runs (counters
    zeroed before the first, read after the last) and a record."""
    import os
    import shutil
    import tempfile

    from repro_torch import tune
    from repro_torch.core import streaming
    from repro_torch.tune import autotune
    from repro_torch.tune.cache import PlanCache
    from repro_torch.tune.plan import family_key

    t11 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tune-cache-")
    old = os.environ.get("REPRO_TUNE_CACHE_PATH")
    os.environ["REPRO_TUNE_CACHE_PATH"] = os.path.join(root, "plans.json")
    tune.clear_plan_memo()
    cfgs = {label: dataclasses.replace(cfg, **extra) for label, extra in FLEET_FILTERS.items()}
    plans, families, record = {}, {}, {}
    try:
        for label, c in cfgs.items():
            plans[label] = tune.resolve_plan(dataclasses.replace(c, tile_plan="auto"), device)
        tune.clear_plan_memo()  # a fresh process: the cache file alone
        calls = []
        timer0, knobs0 = autotune.family_timer, autotune.tune_exec_knobs
        autotune.family_timer = lambda *a, **k: calls.append(a[0]) or timer0(*a, **k)
        autotune.tune_exec_knobs = lambda *a, **k: calls.append("exec") or knobs0(*a, **k)
        try:
            again = {label: tune.resolve_plan(dataclasses.replace(c, tile_plan="auto"), device)
                     for label, c in cfgs.items()}
        finally:
            autotune.family_timer, autotune.tune_exec_knobs = timer0, knobs0
        if calls or any(p.source != "cache" or p.tiles != plans[k].tiles
                        or p.num_slots != plans[k].num_slots for k, p in again.items()):
            raise AssertionError(f"phase 11: the second resolution measured {calls} or "
                                 f"changed a plan: {again}")
        cache = PlanCache()
        dev = torch.device(device)
        backend = autotune.resolved_backend(cfg, dev)
        p, h, w = cfg.pairs_per_group, cfg.height, cfg.width
        for label, c in cfgs.items():
            for fam, window in autotune.filter_families(c):
                if fam in families:
                    continue
                entry = cache.get(family_key(fam, p, h, w, in_dtype="uint16",
                                             acc_dtype="float32", backend=backend,
                                             device=dev, window=window))
                winner = (entry["row_tile"], entry["pair_tile"])
                row = dict(candidates_us={g: s * 1e6 for g, s in entry["candidates"].items()},
                           heuristic_us=entry["heuristic_s"] * 1e6,
                           winner=autotune.candidate_label(winner),
                           winner_us=entry["measured_s"] * 1e6)
                heur = autotune.tile_candidates(fam, p, h, w, vector=autotune.vector_path(c),
                                                limits=tune.budget.device_limits(dev))[0]
                if winner != heur:  # the gain again, with time_ms, in this call
                    step, init = autotune.family_step(fam, c, backend, dev)
                    for geom, key in ((heur, "heuristic_time_ms_us"), (winner, "winner_time_ms_us"),
                                      (heur, "heuristic_again_time_ms_us")):
                        state = init()
                        row[key] = time_ms(lambda g=geom, s=state: step(s, *g)) * 1e3
                families[fam] = row
        for label, plan in plans.items():
            record[label] = dict(plan=plan.describe(), num_slots=plan.num_slots,
                                 frames_per_chunk=plan.frames_per_chunk)
        heur_out = {label: streaming.run_pipelined(c, iter(groups), device=device)[0]
                    for label, c in cfgs.items()}
        reset_counters()
        tuned_out = {label: streaming.run_pipelined(dataclasses.replace(c, tile_plan="auto"),
                                                    iter(groups), device=device)
                     for label, c in cfgs.items()}
        launches = read_counters(TUNED_PATH, "tuned path")
    finally:
        tune.clear_plan_memo()
        if old is None:
            os.environ.pop("REPRO_TUNE_CACHE_PATH", None)
        else:
            os.environ["REPRO_TUNE_CACHE_PATH"] = old
        shutil.rmtree(root, ignore_errors=True)
    for label, (out, rep) in tuned_out.items():
        if not torch.equal(out, heur_out[label]):
            raise AssertionError(f"phase 11: {label} under its tuned plan is not bitwise equal "
                                 "to the heuristic's")
        if rep.num_slots != (plans[label].num_slots or cfg.num_slots):
            raise AssertionError(f"phase 11: {label} ran at ring depth {rep.num_slots}, its "
                                 f"plan says {plans[label].num_slots}")
    for fam, row in families.items():
        cands = ", ".join(f"{g} {us:.2f}" for g, us in row["candidates_us"].items())
        again = "" if "winner_time_ms_us" not in row else (
            f"; time_ms heuristic {row['heuristic_time_ms_us']:.2f}, winner "
            f"{row['winner_time_ms_us']:.2f}, heuristic {row['heuristic_again_time_ms_us']:.2f}")
        print(f"phase 11: {fam}: candidates (device us a step) {cands}; heuristic "
              f"{row['heuristic_us']:.2f}, winner {row['winner']} {row['winner_us']:.2f}{again}")
    print(f"phase 11: tile_plan='auto' for {', '.join(cfgs)} at G={cfg.num_groups} "
          f"N={cfg.frames_per_group} {cfg.height}x{cfg.width}: tuned num_slots "
          f"{ {k: v['num_slots'] for k, v in record.items()} }, frames_per_chunk "
          f"{ {k: v['frames_per_chunk'] for k, v in record.items()} }; a second resolution from "
          f"the cache measured nothing; run_pipelined under each tuned plan bitwise equal to the "
          f"heuristic's; launches {json.dumps(launches)} ({time.perf_counter() - t11:.1f} s)")
    return launches, dict(plans=record, families=families, launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2

    import torch.nn.functional as F

    from repro_torch import obs
    from repro_torch.core import streaming
    from repro_torch.core.banks import (
        BankMesh,
        banked_subtract_average,
        make_bank_mesh,
        run_pipelined_banked,
    )
    from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser
    from repro_torch.data.prism import PrismSource, snr_db
    from repro_torch.kernels import (
        _build,
        denoise_ema,
        denoise_median,
        denoise_multibank,
        denoise_spatial,
        denoise_stream,
        denoise_tmpframe,
        quant,
        ref,
    )

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi)
    name = torch.cuda.get_device_name(0)
    peak_bw, peak_flops = card_peaks(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.library()
    took = time.perf_counter() - t0
    print(f"build: {', '.join(s.name for s in _build.SOURCES)} built and loaded in {took:.1f} s")
    record: dict = {"card": smi, "device": name, "torch": torch.__version__, "build_s": took}

    wrappers = {
        "alg3_stream_step": denoise_stream.alg3_stream_step,
        "alg3_subtract_average": denoise_stream.alg3_subtract_average,
        "multibank_stream_step": denoise_multibank.multibank_stream_step,
        "multibank_subtract_average": denoise_multibank.multibank_subtract_average,
        "median_window_insert": denoise_median.median_window_insert,
        "median_combine": denoise_median.median_combine,
        "ema_welford_step": denoise_ema.ema_welford_step,
        "spatial_filter_3x3": denoise_spatial.spatial_filter_3x3,
        "alg1_subtract_average": denoise_tmpframe.alg1_subtract_average,
        "alg2_subtract_average": denoise_tmpframe.alg2_subtract_average,
    }
    assert set(wrappers) == set(KERNELS)
    max_err = {k: 0.0 for k in wrappers}

    def diff_max(got: torch.Tensor, want: torch.Tensor) -> float:
        return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0

    def same(kernel: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        got = got.cpu()
        err = diff_max(got, want)
        max_err[kernel] = max(max_err[kernel], err)
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{kernel} {what}: not bitwise equal to its plain version (max |diff| {err})")

    def rel_diff(got: torch.Tensor, want: torch.Tensor) -> float:
        return float(((got.double() - want.double()).abs() / want.double().abs()).max())

    def close(kernel: str, got: torch.Tensor, want: torch.Tensor, rtol: float, what: str) -> float:
        """Hold a result to its plain version within ``rtol`` (relative, no
        absolute slack); returns the largest relative difference."""
        got = got.cpu()
        err = diff_max(got, want)
        max_err[kernel] = max(max_err[kernel], err)
        rel = rel_diff(got, want)
        if got.shape != want.shape or not rel <= rtol:
            raise AssertionError(f"{kernel} {what}: max relative diff {rel:.3g} > {rtol:.3g}")
        return rel

    rng = np.random.default_rng(0)
    offset = 4096.0
    H, W = 80, 256

    def wire(shape, fmt, width=W):
        px = rng.integers(0, 4096, shape + (width,)).astype(np.uint16)
        return torch.from_numpy(np.ascontiguousarray(quant.encode(px, fmt)))

    def shifted(t: torch.Tensor) -> torch.Tensor:
        """``t`` on the card in storage one element into a buffer: a view whose
        planes are not aligned for the step's vector loads."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    steps = (denoise_stream.alg3_stream_step, denoise_multibank.multibank_stream_step)

    def step_paths() -> list[tuple[int, int]]:
        return [(f.vector_launches, f.scalar_launches) for f in steps]

    # -- phase 1: each kernel against its plain version on the CPU -------
    t1 = time.perf_counter()
    cases = [(g, fmt, df, 64) for g in (5, 8) for fmt in quant.STREAM_DTYPES for df in (False, True)]
    cases += [(8, "u16", df, 1000) for df in (False, True)]  # the main path's shape
    for g, fmt, df, n in cases:
        what = f"G={g} N={n} {fmt} {'divide_first' if df else 'divide_last'}"
        kw = dict(offset=offset, divide_first=df, stream_dtype=fmt)
        frames = wire((g, n, H), fmt)
        # B2: fold all groups, the last with the in-kernel final division
        s_gpu = torch.zeros(n // 2, H, W, device=dev)
        s_cpu = torch.zeros(n // 2, H, W)
        for k in range(g):
            fin = k == g - 1
            denoise_stream.alg3_stream_step(frames[k].to(dev), s_gpu, num_groups=g, final=fin, **kw)
            s_cpu = denoise_stream.alg3_stream_step_plain(frames[k], s_cpu, num_groups=g, final=fin, **kw)
        same("alg3_stream_step", s_gpu, s_cpu, what)
        # B3
        same("alg3_subtract_average",
             denoise_stream.alg3_subtract_average(frames.to(dev), **kw),
             denoise_stream.alg3_subtract_average_plain(frames, **kw), what)
        banked = wire((2, g, n, H), fmt)
        # B4
        s_gpu = torch.zeros(2, n // 2, H, W, device=dev)
        s_cpu = torch.zeros(2, n // 2, H, W)
        for k in range(g):
            chunk = banked[:, k].contiguous()
            denoise_multibank.multibank_stream_step(chunk.to(dev), s_gpu, num_groups=g, **kw)
            s_cpu = denoise_multibank.multibank_stream_step_plain(chunk, s_cpu, num_groups=g, **kw)
        same("multibank_stream_step", s_gpu, s_cpu, what)
        # B5
        same("multibank_subtract_average",
             denoise_multibank.multibank_subtract_average(banked.to(dev), **kw),
             denoise_multibank.multibank_subtract_average_plain(banked, **kw), what)
    # B2/B4 on the edges of their paths: on a 40 x 136 plane (680 vectors: a
    # full block and a partial one, a partial warp) each u16/u8 launch must
    # take the vector path; on a ragged 7 x 130 plane and an unaligned view of
    # 80 x 256, and for p12 on every plane, the scalar path
    path_cases = 0
    to_dev = lambda t: t.to(dev)  # noqa: E731
    for fmt in quant.STREAM_DTYPES:
        for df in (False, True):
            for (h, w), place, path in (((40, 136), to_dev, "vector"),
                                        ((7, 130), to_dev, "scalar"), ((H, W), shifted, "scalar")):
                path = "scalar" if fmt == "p12" else path
                what = f"G=3 N=12 {h}x{w} {fmt} {'divide_first' if df else 'divide_last'}"
                kw = dict(offset=offset, divide_first=df, stream_dtype=fmt, num_groups=3)
                frames = wire((2, 3, 12, h), fmt, width=w)
                before = step_paths()
                s1, s2 = place(torch.zeros(6, h, w)), place(torch.zeros(2, 6, h, w))
                c1, c2 = torch.zeros(6, h, w), torch.zeros(2, 6, h, w)
                for k in range(3):
                    chunk = frames[:, k].contiguous()
                    denoise_stream.alg3_stream_step(place(chunk[0]), s1, final=k == 2, **kw)
                    c1 = denoise_stream.alg3_stream_step_plain(chunk[0], c1, final=k == 2, **kw)
                    denoise_multibank.multibank_stream_step(place(chunk), s2, final=k == 2, **kw)
                    c2 = denoise_multibank.multibank_stream_step_plain(chunk, c2, final=k == 2, **kw)
                same("alg3_stream_step", s1, c1, what)
                same("multibank_stream_step", s2, c2, what)
                want = [(3, 0) if path == "vector" else (0, 3)] * 2
                if [(v - v0, c - c0) for (v, c), (v0, c0) in zip(step_paths(), before)] != want:
                    raise AssertionError(f"{what}: the steps did not all take the {path} path")
                path_cases += 1
    # B2-B5 and B10 with integer sums (u16 wire, the scalar layout) at G = 10:
    # half the pairs bright over dark, so that a uint16 divide-last sum wraps
    # past 65535 (the paper's container overflow); with offset 0 the other
    # half's differences are negative, where // and a truncation differ
    def int_wire(shape):
        px = rng.integers(0, 4096, shape + (W,)).astype(np.uint16)
        half = shape[-2] // 2
        px[..., 0:half:2, :, :] //= 4
        px[..., 1:half:2, :, :] = 4095 - px[..., 1:half:2, :, :] // 4
        return torch.from_numpy(px)

    int_cases, oneshots = 0, {}
    for off in (0.0, offset):
        banked = int_wire((2, 10, 64, H))
        for acc in (torch.int32, torch.uint16):
            for df in (False, True):
                what = f"G=10 N=64 u16 {acc} offset={off:g} {'divide_first' if df else 'divide_last'}"
                kw = dict(offset=off, divide_first=df)
                s1 = torch.zeros(32, H, W, dtype=acc, device=dev)
                s2 = torch.zeros(2, 32, H, W, dtype=acc, device=dev)
                c1, c2 = torch.zeros(32, H, W, dtype=acc), torch.zeros(2, 32, H, W, dtype=acc)
                before = step_paths()
                for k in range(10):
                    chunk, fin = banked[:, k].contiguous(), k == 9
                    denoise_stream.alg3_stream_step(chunk[0].to(dev), s1, num_groups=10, final=fin, **kw)
                    c1 = denoise_stream.alg3_stream_step_plain(chunk[0], c1, num_groups=10, final=fin, **kw)
                    denoise_multibank.multibank_stream_step(chunk.to(dev), s2, num_groups=10, final=fin, **kw)
                    c2 = denoise_multibank.multibank_stream_step_plain(chunk, c2, num_groups=10, final=fin, **kw)
                same("alg3_stream_step", s1, c1, what)
                same("multibank_stream_step", s2, c2, what)
                if [(v - v0, c - c0) for (v, c), (v0, c0) in zip(step_paths(), before)] != [(0, 10)] * 2:
                    raise AssertionError(f"{what}: integer steps must take the scalar path")
                kw["accum_dtype"] = acc
                oneshots[acc, off, df] = denoise_stream.alg3_subtract_average_plain(banked[0], **kw)
                same("alg3_subtract_average", denoise_stream.alg3_subtract_average(banked[0].to(dev), **kw),
                     oneshots[acc, off, df], what)
                same("multibank_subtract_average",
                     denoise_multibank.multibank_subtract_average(banked.to(dev), **kw),
                     denoise_multibank.multibank_subtract_average_plain(banked, **kw), what)
                int_cases += 1
            want = denoise_tmpframe.alg1_subtract_average_plain(banked[0], offset=off, accum_dtype=acc)
            for k in BASELINE_PATH:
                same(k, wrappers[k](banked[0].to(dev), offset=off, accum_dtype=acc), want,
                     f"G=10 N=64 u16 {acc} offset={off:g}")
    if torch.equal(oneshots[torch.uint16, offset, False].to(torch.int32), oneshots[torch.int32, offset, False]):
        raise AssertionError("G=10: the uint16 divide-last sums never wrapped")
    torch.cuda.synchronize()
    print(f"phase 1: {len(cases)} cases x 4 kernels (B2-B5) bitwise equal to the CPU plain "
          f"versions, and B2/B4 in {path_cases} cases on a 40x136 plane (vector path; p12 "
          f"scalar), a ragged 7x130 plane and an unaligned 80x256 view (scalar path); "
          f"B2-B5 with int32/uint16 sums in {int_cases} cases and B10 Alg 1/2 in 4 (G=10, "
          f"offset 0 and 4096, the uint16 sums wrapping) ({time.perf_counter() - t1:.1f} s)")

    # B6-B9 against their plain versions on the CPU
    t1 = time.perf_counter()

    def ema_case(frames: torch.Tensor, fmt: str, pair_tile: int, what: str, prior: int = 0,
                 hw: tuple[int, int] = (H, W)) -> None:
        g, n = frames.shape[:2]
        gpu = [torch.zeros(n // 2, *hw, device=dev), torch.zeros(hw, device=dev),
               torch.zeros(hw, device=dev)]
        cpu = [t.cpu() for t in gpu]
        for k in range(g):
            kw = dict(alpha=0.3, offset=offset, prior_count=prior + k * (n // 2),
                      pair_tile=pair_tile, stream_dtype=fmt)
            denoise_ema.ema_welford_step(*gpu, frames[k].to(dev), **kw)
            cpu = list(denoise_ema.ema_welford_step_plain(*cpu, frames[k], **kw))
        for a, b in zip(gpu, cpu):
            same("ema_welford_step", a, b, what)

    new_cases = 0
    for g in (5, 8):
        for fmt in quant.STREAM_DTYPES:
            what = f"G={g} N=64 {fmt}"
            frames = wire((g, 64, H), fmt)
            # B6: G groups into a 5-slot ring (it wraps at G = 8)
            w_gpu, w_cpu = torch.zeros(5, 32, H, W, device=dev), torch.zeros(5, 32, H, W)
            for k in range(g):
                kw = dict(slot=k % 5, offset=offset, stream_dtype=fmt)
                denoise_median.median_window_insert(w_gpu, frames[k].to(dev), **kw)
                denoise_median.median_window_insert_plain(w_cpu, frames[k], **kw)
            same("median_window_insert", w_gpu, w_cpu, what)
            for k in (1, 4, 5):  # B7 over the filled prefix
                same("median_combine", denoise_median.median_combine(w_gpu[:k]),
                     denoise_median.median_combine_plain(w_cpu[:k]), f"{what} K={k}")
            ema_case(frames, fmt, 4, what + " pair_tile=4")  # B8, 8 chunks
            new_cases += 1
    ema_case(wire((8, 1000, H), "u16"), "u16", 5, "G=8 N=1000 u16 pair_tile=5")  # 100 chunks
    for fmt in quant.STREAM_DTYPES:  # the chunk rounds' edges: 8 chunks a round
        g = 2 if fmt == "u16" else 1  # the plain version takes some 3 s a group here
        ema_case(wire((g, 1000, H), fmt), fmt, 1, f"G={g} N=1000 {fmt} pair_tile=1")  # 500 chunks
        ema_case(wire((2, 64, H), fmt), fmt, 32, f"G=2 N=64 {fmt} pair_tile=32")  # one chunk
        ema_case(wire((3, 40, 7), fmt, width=130), fmt, 4, f"G=3 N=40 7x130 {fmt} pair_tile=4",
                 prior=13, hw=(7, 130))  # 5 chunks, a ragged pixel tile, a prior count
        for tp in (2, 3, 6, 7, 8):  # the register tiles no other case launches
            ema_case(wire((2, 336, 16), fmt), fmt, tp, f"G=2 N=336 16x256 {fmt} pair_tile={tp}",
                     hw=(16, W))
        new_cases += 8
    combine = denoise_median.median_combine
    for k in (65, 100):  # B7 above its network's 64 slots: the selection path, even and odd K
        win = rng.integers(4000, 4040, (k, 4, 16, W)) + (rng.random((k, 4, 16, W)) < 0.5) * 0.75
        win = torch.from_numpy(win.astype(np.float32))
        before = combine.select_launches
        same("median_combine", combine(win.to(dev)), denoise_median.median_combine_plain(win),
             f"K={k} 4x16x256")
        if combine.select_launches - before != 1:
            raise AssertionError(f"K={k}: median_combine did not take its selection path")
    bilateral_rel = 0.0
    spatial = denoise_spatial.spatial_filter_3x3
    # B9 on the main path's (P, 80, 256) and a short stack, and on planes that
    # take each tile path at its edges: partial row and column tiles, H = 1 and
    # 2 (float4 path); W % 4 != 0, an unaligned view and W = 1 (scalar path)
    b9_planes = [((32, H, W), to_dev, "vector"), ((500, H, W), to_dev, "vector"),
                 ((4, 20, 132), to_dev, "vector"), ((4, 1, W), to_dev, "vector"),
                 ((4, 2, W), to_dev, "vector"), ((4, 7, 130), to_dev, "scalar"),
                 ((4, H, W), shifted, "scalar"), ((4, 5, 1), to_dev, "scalar")]
    for shape, place, path in b9_planes:
        x = torch.from_numpy((4096 + 40 * rng.standard_normal(shape)).astype(np.float32))
        x[:, min(7, shape[1] - 1), min(11, shape[2] - 1)] += 900.0  # a hot pixel
        x[:, -1, -1] += 900.0  # and one in the last tile's corner
        what = "x".join(map(str, shape)) + (" unaligned" if place is shifted else "")
        before = (spatial.vector_launches, spatial.scalar_launches)
        xd = place(x)
        same("spatial_filter_3x3", spatial(xd, mode="box"),
             denoise_spatial.spatial_filter_3x3_plain(x, mode="box"), f"{what} box")
        kw = dict(mode="bilateral", range_sigma=60.0)
        bilateral_rel = max(bilateral_rel, close(
            "spatial_filter_3x3", spatial(xd, **kw), denoise_spatial.spatial_filter_3x3_plain(x, **kw),
            denoise_spatial.BILATERAL_RTOL, f"{what} bilateral"))
        took = (spatial.vector_launches - before[0], spatial.scalar_launches - before[1])
        if took != ((2, 0) if path == "vector" else (0, 2)):
            raise AssertionError(f"B9 {what}: launches {took} on (vector, scalar), want the {path} path")
    for g in (5, 8):  # B10: a division by G would differ at G = 5
        frames = wire((g, 64, H), "u16")
        want = denoise_tmpframe.alg1_subtract_average_plain(frames, offset=offset)
        got = {k: wrappers[k](frames.to(dev), offset=offset) for k in BASELINE_PATH}
        for k, out in got.items():
            same(k, out, want, f"G={g} N=64 u16")
        if not torch.equal(got["alg1_subtract_average"], got["alg2_subtract_average"]):
            raise AssertionError(f"G={g}: Alg 1 and Alg 2 differ on the card")
    torch.cuda.synchronize()
    print(f"phase 1: B6/B7/B8 bitwise equal to the CPU plain versions in {new_cases} cases "
          f"(u16/u8/p12, G=5/8, K=1/4/5; B8 also with 500 chunks, one chunk of 32 pairs, "
          f"a ragged 7x130 plane and pair_tile 2/3/6/7/8) and B8 at N=1000 with 100 chunks; B7 "
          f"at K=65/100 (selection path); B9 on {len(b9_planes)} planes (both tile paths) box bitwise, "
          f"bilateral max relative diff {bilateral_rel:.3g} (declared "
          f"{denoise_spatial.BILATERAL_RTOL:g}); B10 Alg 1 and Alg 2 (u16, G=5/8) bitwise "
          f"equal to the CPU plain version and to each other ({time.perf_counter() - t1:.1f} s)")
    record["bilateral_max_rel"] = bilateral_rel

    # -- phase 1b: the executors at G = 5, card against CPU ----------------
    def forced_drop(cfg5, groups5, device):
        """``run_pipelined`` under ``drop_oldest`` with one stage slot, made
        to drop group 3 of 5 whatever the thread timing. The source hands
        over each of groups 0-2 only once the compute stage has ingested
        the one before. A consumer that holds step 0 lets its one-slot ring
        fill, so the compute stage stops after group 2; groups 3 and 4 then
        arrive together, and the second sheds the first."""
        reg = obs.MetricsRegistry()
        release = threading.Event()

        def ingested(k):
            deadline = time.monotonic() + 60
            while reg.value("stream.frames") < k * cfg5.frames_per_group:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the compute stage never ingested group {k - 1}")
                time.sleep(1e-3)

        def source():
            for k in range(3):
                yield groups5[k]
                ingested(k + 1)
            yield groups5[3]
            yield groups5[4]
            release.set()

        def hold(step, partial):
            if step == 0 and not release.wait(60):
                raise TimeoutError("the source never delivered its last group")

        out, rep = streaming.run_pipelined(
            cfg5, source(), num_slots=1, policy="drop_oldest", consumer=hold,
            consumer_slots=1, metrics=reg, device=device)
        if rep.drops != 1:
            raise AssertionError(f"forced drop: {rep.drops} groups dropped, want 1")
        return out

    def card_vs_cpu(cfg5, groups5, what, bgroups5=None, drop=True):
        """Each executor run on the card and on the CPU, bitwise; returns
        the CPU ``run_pipelined`` output. With ``bgroups5`` also the banked
        (B = 2) ``ingest_many`` stream; with ``drop`` (G = 5 only) the
        forced ``drop_oldest`` run. Returns the number of runs."""

        def both(label, call):
            got, want = call("cuda"), call("cpu")
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"{what} {label}: card and CPU differ")
            return want

        def piped(device, groups=groups5, **kw):
            return streaming.run_pipelined(cfg5, iter(groups), device=device, **kw)[0]

        def partials(device):
            consumer = streaming.DownloadConsumer()
            piped(device, consumer=consumer)
            return torch.from_numpy(np.stack(consumer.partials))

        def banked(device):
            den = StreamingDenoiser(dataclasses.replace(cfg5, num_banks=2), device=device)
            state = den.init()
            for k, chunk in enumerate(bgroups5):
                state = den.ingest_many(state, chunk, step=k)
            return den.finalize(state)

        def survivors(device):
            """The 4 groups a forced drop keeps, ingested and finalized by hand."""
            den = StreamingDenoiser(cfg5, device=device)
            state = den.init()
            for k, g in enumerate(groups5[:3] + groups5[4:]):
                state = den.ingest(state, g, step=k)
            return den.finalize(state, steps=4)

        want = both("run_pipelined", piped)
        both("run_inline(prefetch=False)", lambda d: streaming.run_inline(
            cfg5, iter(groups5), prefetch=False, device=d)[0])
        both("DownloadConsumer partials", partials)
        if drop:
            dropped = both("drop_oldest, group 3 of 5 dropped", lambda d: forced_drop(
                cfg5, groups5, d))
            if not torch.equal(dropped, survivors("cpu")):
                raise AssertionError(f"{what} drop_oldest: not the finalize of the 4 surviving groups")
        both("one-shot", lambda d: StreamingDenoiser(cfg5, device=d)(np.stack(groups5)))
        if bgroups5 is not None:
            both("banked ingest_many (B=2)", banked)
        return want, 4 + drop + (bgroups5 is not None)

    t1 = time.perf_counter()
    runs, discriminates = 0, False
    for fmt in quant.STREAM_DTYPES:
        for algorithm in ("alg3", "alg3_v2"):
            cfg5 = DenoiseConfig(num_groups=5, frames_per_group=64, stream_dtype=fmt,
                                 algorithm=algorithm)
            groups5 = list(PrismSource(cfg5, seed=5).groups())
            want, n_runs = card_vs_cpu(cfg5, groups5, f"G=5 {fmt} {algorithm}")
            runs += n_runs
            if algorithm == "alg3":  # the true division is not the reciprocal multiply here
                den = StreamingDenoiser(cfg5, device="cpu")
                state = den.init()
                for k, g in enumerate(groups5):
                    state = den.ingest(state, g, step=k)
                recip = state * torch.tensor(ref.reciprocal(5), dtype=state.dtype)
                discriminates |= not torch.equal(recip, want)
    if not discriminates:
        raise AssertionError("G=5 finalize: true division never differed from x * f32(1/5)")
    for algorithm in ("alg1", "alg2"):  # streams run B2, the one-shot call B10
        cfg5 = DenoiseConfig(num_groups=5, frames_per_group=64, algorithm=algorithm)
        runs += card_vs_cpu(cfg5, list(PrismSource(cfg5, seed=5).groups()),
                            f"G=5 u16 {algorithm}")[1]
    filter_runs = 0
    for extra in (dict(filter_name="temporal_median", median_window=3),  # the ring wraps
                  dict(filter_name="ema_variance"),  # pair_tile 8: 4 merge chunks per group
                  dict(filter_name="spatial_box", spatial_mode="box")):
        cfg5 = DenoiseConfig(num_groups=5, frames_per_group=64, **extra)
        groups5 = list(PrismSource(cfg5, seed=6).groups())
        cfg5b = DenoiseConfig(num_groups=5, frames_per_group=64, num_banks=2, **extra)
        bgroups5 = list(PrismSource(cfg5b, seed=7).banked_groups())
        filter_runs += card_vs_cpu(cfg5, groups5, f"G=5 u16 {extra['filter_name']}", bgroups5)[1]
    u16_runs = 0
    for algorithm in ("alg3", "alg3_v2", "alg1"):  # the paper's u16 container, G = 10
        cfg10 = DenoiseConfig(num_groups=10, frames_per_group=64, accum_dtype="uint16",
                              algorithm=algorithm)
        want, n_runs = card_vs_cpu(cfg10, list(PrismSource(cfg10, seed=8).groups()),
                                   f"G=10 uint16 {algorithm}", drop=False)
        if want.dtype != torch.uint16:
            raise AssertionError(f"G=10 uint16 {algorithm}: output {want.dtype}")
        u16_runs += n_runs
    torch.cuda.synchronize()
    print(f"phase 1b: G=5 N=64 80x256: {runs} pair_average executor runs (u16/u8/p12 x "
          f"alg3/alg3_v2, u16 x alg1/alg2) and {filter_runs} runs of temporal_median/ema_variance/spatial_box "
          f"on the card bitwise equal to the CPU; G=10 uint16 sums: {u16_runs} runs (alg3/alg3_v2/"
          f"alg1) bitwise equal to the CPU ({time.perf_counter() - t1:.1f} s)")

    # -- phases 2 + 3: the main path at the paper's size -----------------
    cfg = DenoiseConfig()  # G=8, N=1000, 80x256, u16, pair_average, alg3
    assert (cfg.num_groups, cfg.frames_per_group, cfg.height, cfg.width) == (8, 1000, 80, 256)
    src = PrismSource(cfg, seed=0)
    groups = list(src.groups())
    frames_dev = torch.from_numpy(np.stack(groups)).to(dev)
    cfg_b = DenoiseConfig(num_banks=2)
    bgroups = list(PrismSource(cfg_b, seed=1).banked_groups())
    want = StreamingDenoiser(cfg, device="cpu").run(groups)
    want_b = StreamingDenoiser(cfg_b, device="cpu").run(bgroups)

    for fn in wrappers.values():
        fn.launches = 0
    for fn in steps:
        fn.vector_launches = fn.scalar_launches = 0
    b2 = wrappers["alg3_stream_step"]
    per_run = {}

    def counted(label, call):
        before = b2.launches
        out = call()
        torch.cuda.synchronize()
        per_run[label] = b2.launches - before
        return out

    t2 = time.perf_counter()
    outs = {
        "run_pipelined(num_slots=2)": counted("pipelined2", lambda: streaming.run_pipelined(
            cfg, iter(groups), num_slots=2)[0]),
        "run_pipelined(num_slots=3)": counted("pipelined3", lambda: streaming.run_pipelined(
            cfg, iter(groups), num_slots=3)[0]),
        "run_inline(prefetch=False)": counted("inline", lambda: streaming.run_inline(
            cfg, iter(groups), prefetch=False)[0]),
        "StreamingDenoiser(cfg)(frames)": counted("oneshot", lambda: StreamingDenoiser(cfg)(
            frames_dev)),
    }
    den_b = StreamingDenoiser(cfg_b)
    state = den_b.init()
    for k, chunk in enumerate(bgroups):
        state = den_b.ingest_many(state, torch.from_numpy(chunk).to(dev), step=k)
    outs_b = {
        "ingest_many": den_b.finalize(state),
        "5-D one-shot": den_b(torch.from_numpy(np.stack(bgroups, axis=1)).to(dev)),
    }
    torch.cuda.synchronize()
    launches = {k: wrappers[k].launches for k in PAIR_AVERAGE_PATH}
    main_s = time.perf_counter() - t2
    for label, out in outs.items():
        if out.shape != (500, 80, 256) or not torch.equal(out.cpu(), want):
            raise AssertionError(f"main path {label}: not bitwise equal to the CPU plain stream")
    for label, out in outs_b.items():
        if out.shape != (2, 500, 80, 256) or not torch.equal(out.cpu(), want_b):
            raise AssertionError(f"banked path {label}: not bitwise equal to the CPU plain stream")
    for label in ("pipelined2", "pipelined3", "inline"):
        if per_run[label] != cfg.num_groups:
            raise AssertionError(f"{label}: {per_run[label]} step launches, want {cfg.num_groups}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    scalar = {f.__name__: f.scalar_launches for f in steps if f.vector_launches != f.launches}
    if scalar:
        raise AssertionError(f"step launches at the paper's shape took the scalar path: {scalar}")
    out_np = outs["run_pipelined(num_slots=2)"].cpu().numpy()
    if not np.isfinite(out_np).all():
        raise AssertionError("non-finite output")
    signal = src.true_signal()
    snr = snr_db(out_np, signal)
    if not snr > 10.0:
        raise AssertionError(f"SNR {snr:.2f} dB against the noise-free signal is too low")
    print(f"phase 2: main path G=8 N=1000 80x256 u16: {len(outs)} runs bitwise equal to each "
          f"other and to the CPU plain stream; alg3_stream_step launches per stream run "
          f"{[per_run[k] for k in ('pipelined2', 'pipelined3', 'inline')]}; SNR {snr:.3f} dB")
    print(f"phase 3: banked (B=2) ingest_many and 5-D one-shot bitwise equal to the CPU plain "
          f"stream; main-path launches {json.dumps(launches)}, every step on the vector path "
          f"({main_s:.1f} s)")
    record.update(main_path_launches=launches, step_launches_per_run=per_run, snr_db=snr)

    # -- phase 4: timing at the paper's shape ------------------------------
    G, N, P = 8, 1000, 500
    out_px = P * H * W

    def bound(nbytes: float, flops: float) -> tuple[float, str]:
        t_bytes, t_ops = nbytes / peak_bw * 1e3, flops / peak_flops * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def step_flops(fmt, df):  # per output pixel per group: sub, +offset, +sum (fma = 2)
        return 3 + (1 if df else 0) + (3 if fmt == "u8" else 0)

    rows = []

    def row(kernel, label, ms, plain, nbytes, flops, library=None, main=False, **extra):
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(kernel=kernel, label=label, ms=ms, plain_ms=plain, library_ms=library,
                         bytes=nbytes, flops=flops, bound_ms=b_ms, bound_by=b_by, main=main,
                         **extra))

    for fmt in quant.STREAM_DTYPES:
        for df in (False, True):
            frames = wire((1, N, H), fmt)[0].to(dev)
            isz = quant.wire_pixel_bytes(fmt)
            s = torch.zeros(P, H, W, device=dev)
            kw = dict(num_groups=G, offset=offset, divide_first=df, stream_dtype=fmt)
            ms = time_ms(lambda: denoise_stream.alg3_stream_step(frames, s, **kw))
            plain = plain_ms(lambda: denoise_stream.alg3_stream_step_plain(frames, s, **kw),
                             reps=5, inner=2)
            row("alg3_stream_step", f"{fmt} {'v2' if df else 'v1'}", ms, plain,
                N * H * W * isz + 2 * out_px * 4, out_px * step_flops(fmt, df),
                main=(fmt == "u16" and not df))
    shapes = {
        "alg3_subtract_average": (None, lambda fr, **kw: denoise_stream.alg3_subtract_average(fr, **kw),
                                  lambda fr, **kw: denoise_stream.alg3_subtract_average_plain(fr, **kw)),
        "multibank_stream_step": (2, None, None),
        "multibank_subtract_average": (2, lambda fr, **kw: denoise_multibank.multibank_subtract_average(fr, **kw),
                                       lambda fr, **kw: denoise_multibank.multibank_subtract_average_plain(fr, **kw)),
    }
    for kernel, (banks, fn, plain_fn) in shapes.items():
        for df in (False, True):
            kw = dict(offset=offset, divide_first=df, stream_dtype="u16")
            b = banks or 1
            if kernel == "multibank_stream_step":
                frames = wire((2, N, H), "u16").to(dev)
                s = torch.zeros(2, P, H, W, device=dev)
                ms = time_ms(lambda: denoise_multibank.multibank_stream_step(frames, s, num_groups=G, **kw))
                plain = plain_ms(lambda: denoise_multibank.multibank_stream_step_plain(
                    frames, s, num_groups=G, **kw), reps=5, inner=2)
                nbytes = b * (N * H * W * 2 + 2 * out_px * 4)
                flops = b * out_px * step_flops("u16", df)
            else:
                frames = wire(((banks,) if banks else ()) + (G, N, H), "u16").to(dev)
                ms = time_ms(lambda: fn(frames, **kw))
                plain = plain_ms(lambda: plain_fn(frames, **kw), reps=3, inner=1)
                nbytes = b * (G * N * H * W * 2 + out_px * 4)
                flops = b * out_px * (G * step_flops("u16", df) + (0 if df else 1))
            row(kernel, f"u16 {'v2' if df else 'v1'} B={b}", ms, plain, nbytes, flops, main=not df)

    # integer sums (u16 wire, the scalar layout): B2-B5 and B10 at the paper's
    # shape, Alg 3 (divide last); the sum moves 4 (int32) or 2 (uint16) bytes
    for acc in (torch.int32, torch.uint16):
        name_acc, acc_bytes = str(acc).split(".")[-1], torch.empty((), dtype=acc).element_size()
        frames1, frames2 = wire((1, N, H), "u16")[0].to(dev), wire((2, N, H), "u16").to(dev)
        s1 = torch.zeros(P, H, W, dtype=acc, device=dev)
        s2 = torch.zeros(2, P, H, W, dtype=acc, device=dev)
        kw = dict(num_groups=G, offset=offset)
        row("alg3_stream_step", f"u16 v1 {name_acc}",
            time_ms(lambda: denoise_stream.alg3_stream_step(frames1, s1, **kw)),
            plain_ms(lambda: denoise_stream.alg3_stream_step_plain(frames1, s1, **kw), reps=3, inner=1),
            N * H * W * 2 + 2 * out_px * acc_bytes, out_px * step_flops("u16", False))
        row("multibank_stream_step", f"u16 v1 B=2 {name_acc}",
            time_ms(lambda: denoise_multibank.multibank_stream_step(frames2, s2, **kw)),
            plain_ms(lambda: denoise_multibank.multibank_stream_step_plain(frames2, s2, **kw),
                     reps=3, inner=1),
            2 * (N * H * W * 2 + 2 * out_px * acc_bytes), 2 * out_px * step_flops("u16", False))
        del frames1, frames2, s1, s2
        kw = dict(offset=offset, accum_dtype=acc)
        for kernel, banks, fn, plain_fn in (
                ("alg3_subtract_average", (), denoise_stream.alg3_subtract_average,
                 denoise_stream.alg3_subtract_average_plain),
                ("multibank_subtract_average", (2,), denoise_multibank.multibank_subtract_average,
                 denoise_multibank.multibank_subtract_average_plain),
                ("alg1_subtract_average", (), wrappers["alg1_subtract_average"],
                 denoise_tmpframe.alg1_subtract_average_plain),
                ("alg2_subtract_average", (), wrappers["alg2_subtract_average"],
                 denoise_tmpframe.alg2_subtract_average_plain)):
            frames = wire(banks + (G, N, H), "u16").to(dev)
            b = banks[0] if banks else 1
            nbytes = b * (G * N * H * W * 2 + out_px * acc_bytes)
            if kernel.startswith(("alg1", "alg2")):  # the tmpFrame written and read back
                nbytes += 2 * G * out_px * acc_bytes
            row(kernel, f"u16 v1 B={b} {name_acc}", time_ms(lambda: fn(frames, **kw)),
                plain_ms(lambda: plain_fn(frames, **kw), reps=3, inner=1), nbytes,
                b * out_px * (G * step_flops("u16", False) + 1))
            del frames

    # the steps' scalar path (the body they ran everywhere before the vector
    # path) on an unaligned view of the same shape, u16 and u8 (the p12 rows
    # above are that path), and the host time a wrapper call takes
    def b2(f, s, fmt):
        return denoise_stream.alg3_stream_step(f, s, num_groups=G, offset=offset, stream_dtype=fmt)

    def b4(f, s, fmt):
        return denoise_multibank.multibank_stream_step(f, s, num_groups=G, offset=offset,
                                                       stream_dtype=fmt)

    scalar_us, host = {}, {}
    for kernel, call, fmt, banks in (("alg3_stream_step", b2, "u16", ()),
                                     ("alg3_stream_step", b2, "u8", ()),
                                     ("multibank_stream_step", b4, "u16", (2,))):
        f, s = wire(banks + (N, H), fmt), torch.zeros(banks + (P, H, W))
        fn = wrappers[kernel]
        before = fn.scalar_launches
        fv, sv = shifted(f), shifted(s)
        scalar_us[f"{kernel} {fmt}"] = time_ms(lambda: call(fv, sv, fmt)) * 1e3
        if fn.scalar_launches == before:
            raise AssertionError(f"{kernel}: the unaligned view did not take the scalar path")
        if fmt == "u16":
            fa, sa = f.to(dev), s.to(dev)
            host[kernel] = host_us(lambda: call(fa, sa, fmt))
    ema1 = [torch.zeros(P, H, W, device=dev), torch.zeros(H, W, device=dev),
            torch.zeros(H, W, device=dev)]
    fa = wire((N, H), "u16").to(dev)
    host["ema_welford_step"] = host_us(lambda: denoise_ema.ema_welford_step(
        *ema1, fa, alpha=0.25, offset=offset, pair_tile=5))
    del f, s, ema1, fa, sa, fv, sv

    # B6-B9 at the paper's shape (u16 wire, a 5-slot window, P = 500 frames)
    group = wire((1, N, H), "u16")[0].to(dev)
    window = torch.zeros(5, P, H, W, device=dev)
    kw = dict(slot=2, offset=offset)
    row("median_window_insert", "u16", time_ms(lambda: denoise_median.median_window_insert(
        window, group, **kw)), plain_ms(lambda: denoise_median.median_window_insert_plain(
            window, group, **kw), reps=5, inner=2),
        N * H * W * 2 + out_px * 4, out_px * 2, main=True)
    for k in range(5):  # fill the window with real diffs
        denoise_median.median_window_insert(window, wire((1, N, H), "u16")[0].to(dev), slot=k,
                                            offset=offset)
    for k in (4, 5):  # K(K-1)/2 compare-exchanges of two operations each
        win = window[:k]
        lib = None
        if k % 2:  # torch.median returns the lower middle value: the same function for odd K
            lib_out = torch.median(win, dim=0).values
            if not torch.equal(lib_out, denoise_median.median_combine(win)):
                raise AssertionError("torch.median and median_combine disagree at odd K")
            lib = plain_ms(lambda: torch.median(win, dim=0), reps=5, inner=2)
        row("median_combine", f"K={k}", time_ms(lambda: denoise_median.median_combine(win)),
            plain_ms(lambda: denoise_median.median_combine_plain(win), reps=5, inner=2),
            (k + 1) * out_px * 4, out_px * k * (k - 1), library=lib, main=(k == 5))
    del window, win
    ema, wmean, wm2 = (torch.zeros(P, H, W, device=dev), torch.zeros(H, W, device=dev),
                       torch.zeros(H, W, device=dev))
    tp = 5  # the pinned pick at this shape: 100 merge chunks
    kw = dict(alpha=0.25, offset=offset, prior_count=0, pair_tile=tp)
    # per pair-pixel: diff 2, EMA 3, chunk sum 1, centred square 3; per chunk-pixel: merge ~12
    row("ema_welford_step", "u16 pair_tile=5", time_ms(lambda: denoise_ema.ema_welford_step(
        ema, wmean, wm2, group, **kw)), plain_ms(lambda: denoise_ema.ema_welford_step_plain(
            ema, wmean, wm2, group, **kw), reps=3, inner=1),
        N * H * W * 2 + 2 * out_px * 4 + 4 * H * W * 4, out_px * 9 + (P // tp) * H * W * 12,
        main=True)
    del ema
    x = outs["run_pipelined(num_slots=2)"]  # the averaged frames the stage smooths
    padded_pool = lambda: F.avg_pool2d(F.pad(x[:, None], (1, 1, 1, 1), mode="replicate"), 3,
                                       stride=1)[:, 0]
    lib_rel = rel_diff(padded_pool(), denoise_spatial.spatial_filter_3x3(x, mode="box"))
    if not lib_rel < 1e-6:
        raise AssertionError(f"avg_pool2d over replicate padding is not the box mean ({lib_rel})")
    row("spatial_filter_3x3", "box", time_ms(lambda: denoise_spatial.spatial_filter_3x3(x)),
        plain_ms(lambda: denoise_spatial.spatial_filter_3x3_plain(x), reps=5, inner=2),
        2 * out_px * 4, out_px * 10, library=plain_ms(padded_pool, reps=5, inner=2), main=True)
    kw = dict(mode="bilateral", range_sigma=cfg.spatial_range_sigma)
    # per neighbour: 8 operations plus an expf counted as 8; then one division
    row("spatial_filter_3x3", "bilateral", time_ms(lambda: denoise_spatial.spatial_filter_3x3(
        x, **kw)), plain_ms(lambda: denoise_spatial.spatial_filter_3x3_plain(x, **kw), reps=5,
                            inner=2),
        2 * out_px * 4, out_px * (9 * 16 + 1))
    # B10 at the paper's shape: each algorithm in total and each pass alone
    frames8 = wire((G, N, H), "u16").to(dev)
    tmp_px = G * P * H * W
    bytes_a, flops_a = G * N * H * W * 2 + tmp_px * 4, tmp_px * 2
    bytes_b, flops_b = tmp_px * 4 + out_px * 4, out_px * (G + 1)
    for kernel in BASELINE_PATH:
        burst = kernel.startswith("alg2")
        row(kernel, "u16 total", time_ms(lambda: wrappers[kernel](frames8, offset=offset)),
            plain_ms(lambda: denoise_tmpframe.alg1_subtract_average_plain(frames8, offset=offset),
                     reps=3, inner=1),
            bytes_a + bytes_b, flops_a + flops_b, main=True)
        row(kernel, "pass A", time_ms(lambda: denoise_tmpframe.subtract_pass(
            frames8, offset=offset, burst=burst)), plain_ms(
                lambda: denoise_tmpframe.subtract_pass_plain(frames8, offset=offset), reps=3,
                inner=1), bytes_a, flops_a)
    tmp = denoise_tmpframe.subtract_pass(frames8, offset=offset, burst=True)
    lib_sum = torch.sum(tmp, dim=0)  # the nearest single call to pass B (no 1/G scale)
    sum_err = diff_max(lib_sum * ref.reciprocal(G), denoise_tmpframe.reduce_pass(tmp))
    row("alg1_subtract_average", "pass B (both)", time_ms(lambda: denoise_tmpframe.reduce_pass(tmp)),
        plain_ms(lambda: denoise_tmpframe.reduce_pass_plain(tmp), reps=5, inner=2), bytes_b,
        flops_b, library=time_ms(lambda: torch.sum(tmp, dim=0)), library_call="torch.sum(tmp, 0)",
        library_max_abs_diff=sum_err)
    del frames8, tmp, lib_sum
    for r in rows:
        lib = f"  library {r['library_ms'] * 1e3:9.1f} us" if r["library_ms"] is not None else ""
        print(f"  {r['kernel']:28s} {r['label']:16s} {r['ms'] * 1e3:9.2f} us  bound "
              f"{r['bound_ms'] * 1e3:8.2f} us ({r['bytes'] / 1e6:.2f} MB, {r['bound_by']})"
              f"  {r['bound_ms'] / r['ms']:6.1%} of peak  plain {r['plain_ms'] * 1e3:10.1f} us"
              f"{lib}")
    print("  scalar path on an unaligned view, v1: " + ", ".join(
        f"{k} {v:.2f} us" for k, v in scalar_us.items()))
    print("  host time per wrapper call: " + ", ".join(f"{k} {v:.1f} us" for k, v in host.items()))

    # executor: ms per group, live synthesis vs pre-generated groups
    executor = {}
    for label, make in (("prism_source", lambda: PrismSource(cfg, seed=2).groups()),
                        ("pregenerated", lambda: iter(groups))):
        for depth in (2, 3):
            _, rep = streaming.run_pipelined(cfg, make(), num_slots=depth)
            executor[f"{label}/num_slots={depth}"] = dict(
                ms_per_group=rep.elapsed_s / cfg.num_groups * 1e3, overlap_frac=rep.overlap_frac,
                stall_ms_per_group=rep.stall_s / cfg.num_groups * 1e3,
                transfer_ms_per_group=rep.transfer_s / cfg.num_groups * 1e3)
    _, rep = streaming.run_inline(cfg, iter(groups), prefetch=False)
    executor["pregenerated/inline_serial"] = dict(
        ms_per_group=rep.elapsed_s / cfg.num_groups * 1e3, overlap_frac=rep.overlap_frac,
        stall_ms_per_group=rep.stall_s / cfg.num_groups * 1e3,
        transfer_ms_per_group=rep.transfer_s / cfg.num_groups * 1e3)
    t_syn = time.perf_counter()
    for _ in PrismSource(cfg, seed=3).groups():
        pass
    synth_ms = (time.perf_counter() - t_syn) / cfg.num_groups * 1e3
    for k, v in executor.items():
        print(f"  executor {k:32s} {v['ms_per_group']:8.2f} ms/group (camera {CAMERA_GROUP_MS:.0f}) "
              f"overlap_frac {v['overlap_frac']:.3f} stall {v['stall_ms_per_group']:.2f} ms/group")
    print(f"  host frame synthesis alone: {synth_ms:.2f} ms/group")
    record.update(rows=rows, scalar_path_us=scalar_us, host_us_per_call=host,
                  executor=executor, synth_ms_per_group=synth_ms,
                  camera_group_ms=CAMERA_GROUP_MS)

    # -- phase 5: the other filters' path at the paper's size ----------------
    filters = {
        "temporal_median": dict(filter_name="temporal_median"),  # K = 5: the ring wraps at G = 8
        "ema_variance": dict(filter_name="ema_variance"),  # pair_tile 5: 100 chunks per group
        "spatial_box/box": dict(filter_name="spatial_box", spatial_mode="box"),
        "spatial_box/bilateral": dict(filter_name="spatial_box", spatial_mode="bilateral"),
    }
    t5 = time.perf_counter()
    cfgs = {label: DenoiseConfig(**extra) for label, extra in filters.items()}
    wants = {label: StreamingDenoiser(c, device="cpu").run(groups) for label, c in cfgs.items()}
    for fn in wrappers.values():
        fn.launches = 0
    outs5 = {
        label: {
            "run_pipelined(num_slots=2)": streaming.run_pipelined(c, iter(groups), num_slots=2)[0],
            "run_inline(prefetch=False)": streaming.run_inline(c, iter(groups), prefetch=False)[0],
            "one-shot": StreamingDenoiser(c)(frames_dev),
        }
        for label, c in cfgs.items()
    }
    torch.cuda.synchronize()
    filter_launches = {k: wrappers[k].launches for k in FILTER_PATH}
    missing = [k for k, n in filter_launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the filters' path: {missing}")
    snrs, bilateral_path_rel = {}, 0.0
    for label, runs5 in outs5.items():
        for how, out in runs5.items():
            got = out.cpu()
            if got.shape != (500, 80, 256) or not torch.isfinite(got).all():
                raise AssertionError(f"{label} {how}: shape {tuple(got.shape)} or non-finite output")
            if label.endswith("bilateral"):
                rel = rel_diff(got, wants[label])
                bilateral_path_rel = max(bilateral_path_rel, rel)
                if not rel <= denoise_spatial.BILATERAL_RTOL:
                    raise AssertionError(f"{label} {how}: max relative diff {rel:.3g} against the "
                                         f"CPU plain stream")
            elif not torch.equal(got, wants[label]):
                raise AssertionError(f"{label} {how}: not bitwise equal to the CPU plain stream")
        snrs[label] = snr_db(runs5["run_pipelined(num_slots=2)"].cpu().numpy(), signal)
    print(f"phase 5: temporal_median, ema_variance, spatial_box (box, bilateral) at G=8 N=1000 "
          f"80x256 u16: run_pipelined, run_inline and the one-shot call equal to the CPU plain "
          f"stream (bitwise; bilateral max relative diff {bilateral_path_rel:.3g}); launches "
          f"{json.dumps(filter_launches)} ({time.perf_counter() - t5:.1f} s)")
    print("  SNR against the noise-free signal: " + ", ".join(
        f"{label} {v:.3f} dB" for label, v in snrs.items()) + f", pair_average {snr:.3f} dB")
    record.update(filter_path_launches=filter_launches, filter_snr_db=snrs,
                  bilateral_path_max_rel=bilateral_path_rel)
    launches.update(filter_launches)

    def reset_counters():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counters(path, what):
        torch.cuda.synchronize()
        counts = {k: wrappers[k].launches for k in path}
        missing = [k for k, n in counts.items() if n == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {what}: {missing}")
        return counts

    # -- phase 6: the paper's Alg 1/2 baselines at the paper's size ----------
    t6 = time.perf_counter()
    want6 = StreamingDenoiser(DenoiseConfig(algorithm="alg1"), device="cpu")(np.stack(groups))
    alg3_oneshot = outs["StreamingDenoiser(cfg)(frames)"].cpu()
    reset_counters()
    outs6 = {a: StreamingDenoiser(DenoiseConfig(algorithm=a))(frames_dev) for a in ("alg1", "alg2")}
    baseline_launches = read_counters(BASELINE_PATH, "baselines' path")
    for a, out in outs6.items():
        got = out.cpu()
        if got.shape != (500, 80, 256) or not torch.equal(got, want6):
            raise AssertionError(f"{a} one-shot: not bitwise equal to the CPU plain result")
        if not torch.equal(got, alg3_oneshot):
            raise AssertionError(f"{a} one-shot: not bitwise equal to the Alg 3 one-shot")
    print(f"phase 6: Alg 1 and Alg 2 one-shot at G=8 N=1000 80x256 u16 bitwise equal to the CPU "
          f"plain result and to the Alg 3 one-shot; launches {json.dumps(baseline_launches)} "
          f"({time.perf_counter() - t6:.1f} s)")
    record["baseline_path_launches"] = baseline_launches
    for k, n in baseline_launches.items():
        launches[k] = launches.get(k, 0) + n
    del outs6, frames_dev

    # -- phase 7: the bank executor on one card ------------------------------
    cfg2 = DenoiseConfig(num_banks=2)
    per_bank = [list(src) for src in PrismSource(cfg2, seed=4).bank_sources(2)]  # not live
    bframes = np.stack([np.stack(g) for g in per_bank])  # (B, G, N, H, W)
    banked = {label: dataclasses.replace(cfgs[label], num_banks=2) for label in cfgs}
    banked = {"pair_average": cfg2, **banked}
    t7 = time.perf_counter()
    cpu2 = BankMesh(("cpu", "cpu"))
    wants7 = {label: run_pipelined_banked(c, [iter(g) for g in per_bank], cpu2)[0]
              for label, c in banked.items()}
    want_bsa = banked_subtract_average(bframes, cpu2, config=cfg2)
    cpu_s = time.perf_counter() - t7

    def banked_runs(mesh):
        outs7 = {label: run_pipelined_banked(c, [iter(g) for g in per_bank], mesh)[0]
                 for label, c in banked.items()}
        outs7["banked_subtract_average"] = banked_subtract_average(bframes, mesh,
                                                                         config=cfg2)
        return outs7

    def check_banked(outs7, what):
        rel = 0.0
        for label, out in outs7.items():
            want = want_bsa if label == "banked_subtract_average" else wants7[label]
            got = out.cpu()
            if got.shape != (2, 500, 80, 256) or not torch.isfinite(got).all():
                raise AssertionError(f"{what} {label}: shape {tuple(got.shape)} or non-finite")
            if label.endswith("bilateral"):
                rel = max(rel, rel_diff(got, want))
                if not rel <= denoise_spatial.BILATERAL_RTOL:
                    raise AssertionError(f"{what} {label}: max relative diff {rel:.3g}")
            elif not torch.equal(got, want):
                raise AssertionError(f"{what} {label}: not bitwise equal to the CPU run")
        return rel

    one_card = BankMesh(("cuda:0", "cuda:0"))
    t7 = time.perf_counter()
    reset_counters()
    outs7 = banked_runs(one_card)
    bank_launches = read_counters(BANKED_PATH, "banked path")
    bank_rel = check_banked(outs7, "BankMesh(cuda:0, cuda:0)")
    if not torch.equal(outs7["pair_average"].cpu(), want_bsa):
        raise AssertionError("banked pair_average stream and one-shot differ")
    print(f"phase 7: run_pipelined_banked over BankMesh(cuda:0, cuda:0) at G=8 N=1000 80x256 u16 "
          f"for {', '.join(banked)} and banked_subtract_average equal to the CPU run (bitwise; "
          f"bilateral max relative diff {bank_rel:.3g}); launches {json.dumps(bank_launches)} "
          f"({time.perf_counter() - t7:.1f} s on the card, {cpu_s:.1f} s for the CPU runs)")
    del outs7
    if torch.cuda.device_count() >= 2:
        check_banked(banked_runs(make_bank_mesh(2)), "make_bank_mesh(2)")
        print("phase 7: make_bank_mesh(2), one bank per card: every output equal to the CPU run")
        record["two_card_mesh"] = "passed"
    else:
        print("phase 7: make_bank_mesh(2) not run: only one CUDA device is present")
        record["two_card_mesh"] = "not run: one CUDA device"
    record.update(banked_path_launches=bank_launches, banked_bilateral_max_rel=bank_rel)
    for k, n in bank_launches.items():
        launches[k] = launches.get(k, 0) + n

    # the executor per group at 1 and at 2 banks (pair_average, pre-generated)
    bank_exec = {1: [], 2: []}
    one_bank = BankMesh(("cuda:0",))
    for b in (1, 2, 2, 1):
        mesh = one_bank if b == 1 else one_card
        _, rep = run_pipelined_banked(DenoiseConfig(num_banks=b),
                                            [iter(g) for g in per_bank[:b]], mesh)
        bank_exec[b].append(dict(
            ms_per_group=rep.elapsed_s / cfg2.num_groups * 1e3,
            stall_ms_per_group=rep.stall_s / cfg2.num_groups * 1e3,
            transfer_ms_per_group=rep.transfer_s / cfg2.num_groups * 1e3,
            overlap_frac=rep.overlap_frac))
    for b, reps in bank_exec.items():
        print(f"  run_pipelined_banked {b} bank(s) on one card: ms/group "
              f"{[round(r['ms_per_group'], 2) for r in reps]} (camera {CAMERA_GROUP_MS:.0f}), "
              f"stall {[round(r['stall_ms_per_group'], 2) for r in reps]}, transfer (summed over "
              f"banks) {[round(r['transfer_ms_per_group'], 2) for r in reps]} ms/group")
    record["banked_executor"] = {f"{b}_banks": reps for b, reps in bank_exec.items()}

    serve_launches, serve_record = serve_phase(
        cfg, groups, wrappers, reset_counters, read_counters, one_card, bound, time_ms)
    record["serve"] = serve_record
    for k, n in serve_launches.items():
        launches[k] = launches.get(k, 0) + n

    fleet_launches, fleet_record = fleet_phase(
        cfg, groups, reset_counters, read_counters, one_card, smi, serve_record["timing"])
    record["fleet"] = fleet_record
    for k, n in fleet_launches.items():
        launches[k] = launches.get(k, 0) + n

    elastic_launches, record["elastic"] = elastic_phase(cfg, groups, reset_counters,
                                                        read_counters)
    tuned_launches, record["tune"] = tune_phase(cfg, groups, reset_counters, read_counters)
    for k, n in list(elastic_launches.items()) + list(tuned_launches.items()):
        launches[k] = launches.get(k, 0) + n

    main_rows = {r["kernel"]: r for r in rows if r["main"]}
    kernels = [
        {
            "name": k, "route": "cuda", "source": CSRC + src_file, "replaces": replaces,
            "launches": launches[k], "max_abs_err": max_err[k],
            "ms": main_rows[k]["ms"], "plain_ms": main_rows[k]["plain_ms"],
            "bound_ms": main_rows[k]["bound_ms"], "bound_by": main_rows[k]["bound_by"],
            "library_ms": main_rows[k]["library_ms"],
        }
        for k, (src_file, replaces) in KERNELS.items()
    ]
    record["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
