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
   pairs (above the register cap), on a ragged 7 x 130 plane, with
   pair_tile 2, 3, 6, 7 and 8 (each its own kernel), with 24, 25 and 28
   (the long tile's chain and its 8 lanes) and, at N = 1000, 50 and 500
   (its windows of 32); B7 (median combine)
   bitwise for K in {1, 4, 5} and, on its selection path, K in {65, 100};
   B9 (3x3 spatial) bitwise in box mode and within its declared tolerance
   in bilateral mode, on the main path's planes and on planes that take
   each tile path at its edges (partial row and column tiles, H = 1 and 2
   on the float4 path; W % 4 != 0, an unaligned view and W = 1 on the
   scalar path); every kernel B2-B10 with float16 and bfloat16
   accumulators bitwise against its plain version,
   for u16/u8/p12, G in {5, 8}, both variants, on the 80 x 256 plane and a
   ragged 7 x 130 one (B9 bilateral too, also on planes around 300 where
   the range weights matter, on its four-pixel and its scalar path; B8
   also on pairs within +-12 at offset 0, where a float16 M2 stays
   finite, and in every register tile and long order), and B2-B5 with p12 wire into int32
   and uint16 sums at G = 10, their uint16 sums wrapping; the one-shots
   B3/B5 on their vector path for u16/u8/p12 x float32/float16/bfloat16
   x both variants, B = 1 and 2, G in {5, 8}, offset 0 and 4096, with
   the wire formats' largest values, on a 40 x 136 plane (partial last
   block and warp), on one vector a plane, on the scalar path for a
   ragged plane and unaligned views (each launch on the path
   ``oneshot_path`` names), and at every exact-divisor tile, bitwise,
   with the bfloat16 division rule held to the true division on every
   bfloat16 value for G = 1..64; B6 (median insert) on both its paths for
   u16/u8/p12 x float32/float16/bfloat16, 8 groups into a 5-slot window
   that wraps, in the default layout and two plan geometries: the paper's
   80 x 256 plane on the vector path, a ragged 7 x 130 plane and a view 2
   (p12: 3) bytes in on the scalar path, each launch on the path
   ``insert_path`` names. Then (1b) runs the executors on
   the card at G = 5, where 1/G is inexact, for ``pair_average`` and the
   three other filters, so the eager true divisions (finalize, a
   consumer's partials, a ``drop_oldest`` stream made to drop one group
   whatever the thread timing), the one-shot call and the banked path
   are held bitwise against the same runs on the CPU; and the
   ``pair_average`` executors with a uint16 sum at G = 10 (Alg 3, Alg 3 v2,
   Alg 1), whose plain steps (init, the floor division of finalize and of
   the partials) run on a CUDA uint16 tensor; and every filter with
   float16 and bfloat16 accumulators at G = 5 (``run_pipelined``, the
   one-shot call and ``run_pipelined_banked`` over
   ``BankMesh(("cuda:0", "cuda:0"))``) against the same runs on the CPU;
2. drives the main path at the paper's size (G = 8, N = 1000, 80 x 256,
   u16): ``PrismSource`` -> ``run_pipelined`` (ring depth 2 and 3),
   ``run_inline(prefetch=False)`` and the one-shot ``StreamingDenoiser``
   call, all bitwise equal to each other and to the CPU plain stream,
   with every step and one-shot launch on the vector path;
3. drives the banked path on one card (two banks): ``ingest_many`` and
   the 5-D one-shot call;
4. times each kernel at the paper's shape with CUDA events (device time:
   each sample waits behind a device sleep that outlasts the host's
   queuing of its calls, so the host's launch rate does not count)
   against the least time the card needs for its bytes or operations,
   times its plain version and, where one PyTorch call computes the same
   function, that call (B2 and B4 also on their scalar path, u16 and u8,
   in the same run, B2-B5 and B10 with int32 and uint16 sums, B2-B10 with
   float16 and bfloat16 accumulators, B6 in every wire format and window
   type, B2 and B3 with p12 wire into int32
   and uint16 sums, and the host time per call of the B2, B4 and B8
   wrappers); and times the pipelined
   executor per group against the
   camera's 57 ms inter-group interval;
5. drives the other filters at the paper's size (``temporal_median``
   with its 5-slot window, ``ema_variance``, ``spatial_box`` in box and
   bilateral mode): ``run_pipelined`` (depth 2),
   ``run_inline(prefetch=False)`` and the one-shot call, each equal to
   the CPU plain stream, every B6 launch on its vector path, and prints
   each filter's SNR against the noise-free signal;
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
   state on the card, and a bfloat16 ``pair_average`` session
   checkpointed (``V2`` leaves) and restored, bitwise its CPU run; (9b)
   live migration under a co-tenant's load,
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
   heuristic with ``time_ms`` when it differs) and the tuned ``num_slots``;
12. serves the model substrate's full-width models through
   ``repro_torch.launch.serve.generate`` (random weights from a seeded
   CUDA generator, greedy): 12a ``h2o-danube-1.8b`` (24 layers, d_model
   2560, bfloat16) at batch 4, prompt 128, 32 tokens; 12b the same at
   batch 1 with a 4160-token prompt (windowed q-chunked prefill, ring
   cache rolled) and 12b+ with 8320 (banded prefill), 16 tokens each; 12c
   ``gemma3-1b`` (26 layers, vocab 262144, tied) as 12a. It prints prefill
   ms, decode ms per step beside the step's byte bound, tokens/s and
   peak memory, and holds every decode step's logits to the port's own
   forward over the same tokens (``BF16_CONSISTENCY``). 12d runs
   ``h2o-danube-1.8b`` at full width and depth 2 in float32 (TF32 off) on
   the card and on the CPU: logits within twice the CPU's own float32
   error against float64 (``F32_CARD_VS_CPU_OF_F32_ERROR``), greedy tokens
   equal wherever the top-2 margin exceeds that. 12e-12j serve every other
   family at its published widths (``FAMILY_RUNS``): 12e ``mixtral-8x7b``
   cut to 8 of its 32 layers (its float32 parameters outgrow the card) and
   12f ``deepseek-v2-lite-16b`` (27 layers, MLA and 64 experts) at batch 4,
   prompt 128, 32 tokens; 12g ``recurrentgemma-9b`` and 12h
   ``mamba2-780m`` at batch 1 with a 4160-token prompt (the scan past the
   2048 window; 32.5 SSD chunks, the pad path), 16 tokens; 12i
   ``llama-3.2-vision-11b`` at batch 4, prompt 128, 1601 image
   embeddings, 32 tokens; 12j ``whisper-large-v3`` at batch 4 from 1500
   encoder frames, 32 tokens decoded from token 0. Their weights follow the
   reference's rules except that every ``fan_in`` weight is drawn
   N(0, 1/d_model) (``scaled_init``; the vlm's gates seeded nonzero), and
   each prints what 12a prints and its seconds. Every decode step is held
   to the model's own forward within ``BF16_CONSISTENCY``; an MoE model is
   timed at its published capacity factor and held at
   ``MOE_CONSISTENCY_CAPACITY`` at the positions whose top-k sets agree
   in every MoE layer, the flips counted;
13. trains the model substrate on the card: 13a ``gemma3-1b`` at full
   width (26 layers, vocab 262144, tied, remat on) through
   ``repro_torch.launch.train.main`` with the reference trainer's default
   command line (batch 8, seq 128, the config's 4 microbatches, 20 steps,
   checkpoints into a temporary directory), printing the median step ms
   after the first and the first alone, tokens/s, peak GB and the step's
   bound (6 * params * tokens * 4/3 over 989 TFLOP/s against one read of
   float32 parameters, gradients and both moments at 3.35 TB/s), failing
   unless every loss is finite and the last is below the first; 13b
   ``h2o-danube-1.8b`` at full width, 3 steps at M = 1 and at M = 4 from
   one init, the first step's loss and gradient norm held to each other
   within ``TRAIN_BF16_OF_F32_GAP`` times the M = 1 run's bfloat16 gap to
   the float32 step (at least ``BF16_ROUNDOFF``); 13c danube at depth 2 in
   float32 (TF32 off, ``scaled_init``), 2 steps of ``launch.steps`` on the
   card and on the CPU, within ``TRAIN_F32_OF_F32_ERROR`` times the CPU's
   float32 error against float64 (at least ``TRAIN_F32_FLOOR``); 13d smoke
   danube, 5 steps with a checkpoint every 2 resumed to 8, bitwise the
   uninterrupted run (losses and final state);
14. runs the pipeline schedule, the roofline counter and the dry run on
   the card: 14a ``pipeline_forward`` over ``StageMesh(("cuda:0",) * 4)``
   at the reference test's shape (M = 8, mb = 2, D = 16, float32) and at
   an LLM's width (mb = 256, D = 4096, bfloat16), each bitwise equal to
   the stages composed one microbatch at a time on the card (the small one
   within ``PIPE_CPU_ATOL`` of the CPU run), with both ms and the bubble
   fraction; 14b phase 13a's step (``gemma3-1b``, batch 8 x 128, M = 4,
   remat) read by ``roofline.op_costs.analyze`` on the card's tensors and
   on ``meta``: equal FLOPs, the meta peak within ``PEAK_BAND`` of the
   bare step's ``max_memory_allocated``, the counted bound (the larger of
   the products at 989 TFLOP/s and the bytes the step must move at 3.35
   TB/s; the eager operator traffic printed beside it, as no bound) next
   to ``HAND_BOUND_MS`` and the step's measured ms; 14c
   ``launch.dryrun.run_cell`` on ``DRYRUN_CELLS`` (one cell of each kind),
   printing ``fits_hbm``, the bound and ``trace_s``;
15. (run first, before the build, so that its ranks have the card to
   themselves) runs the decoder-only families over a ``(2, 2)`` mesh of
   four gloo ranks that share the card (``MESH_RUNS``: 15a ``gemma3-1b``,
   15b ``mixtral-8x7b``, 15c ``deepseek-v2-lite-16b``, 15d ``mamba2-780m``
   and 15e ``recurrentgemma-9b`` at their published widths, the depth
   cut), in float32 with TF32 off and ``scaled_init``:
   prefill, decode steps and two train steps held to the same weights in
   one process (logits within ``MESH_SERVE_RTOL`` and greedy tokens
   equal; losses, gradient norms, new parameters and AdamW's moments leaf
   by leaf; an MoE model's routing compared call by call, a sequence held
   only while it agrees, a train step only while its routing and every
   earlier step's agree, AdamW's moments after the first step always),
   with the ms a step, the collectives a step issues and each rank's
   peak. ``--only-mesh [LABEL,...]`` runs this phase, or some of its runs,
   alone.

Phases 2-3 are the ``pair_average`` path (B2-B5), phase 5 the other
filters' path (B6-B9), phase 6 the baselines' path (B10), phase 7 the
banked path (B4-B9), phase 8 (8a-8d) the service's path (B2, B4, B6,
B7), phase 9 (9a-9d) the fleet's path (B2, B4, B6-B9), phase 10 the
elastic tier's (B2, B4, B6, B7) and phase 11 the tuned runs' (B2,
B6-B9): every launch counter is set to 0 just before each and read just
after; a kernel of the path launched no time there fails the run. Phases
12-15 (the model substrate serving and training, the pipeline, the
counter, the dry run and the mesh) hold no kernel of the port: phases 13
and 14 zero the counters before and fail if any moved, and phase 15's
ranks load none. A kernel's ``launches``
in the ``{"kernels": [...]}`` line is
its sum over those phases. The float16/bfloat16 launches of each entry
point over the whole run (``AccumTally``) go to ``half_launches``. The
script prints the card's ``nvidia-smi`` name and power
limit, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
It exits with code 2, printing no result, when no CUDA device is present.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
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
#: the half-precision accumulators every kernel takes (phase 1, 1b and 4)
HALF_TYPES = (torch.float16, torch.bfloat16)
#: B8's register tiles (1-8) and one chunk length of each long order (12
#: the chain, 27 the 8 lanes, 40 the windows), each held in a half type
HALF_EMA_TILES = (1, 2, 3, 4, 5, 6, 7, 8, 12, 27, 40)

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


class AccumTally:
    """Counts the calls of each kernel entry point by the accumulator code
    it passes (``quant.cuh`` AccumCode), read off its ``int acc`` argument:
    from construction on, the library the wrappers load is this proxy.
    The half-type instances run on no main path, so their launches are
    counted here rather than by the wrappers' own counters."""

    def __init__(self, build):
        self.calls: collections.Counter = collections.Counter()
        self._pos = {}
        for src in build.SOURCES:
            for m in re.finditer(r"^int (\w+_launch)\(([^)]*)\)", src.read_text(), re.M):
                params = [" ".join(p.split()) for p in m.group(2).split(",")]
                if "int acc" in params:
                    self._pos[m.group(1)] = params.index("int acc")
        self._lib = build.library()
        build.library = lambda: self

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self._pos:
            return fn
        pos = self._pos[name]

        def call(*args):
            self.calls[name, args[pos]] += 1
            return fn(*args)

        return call

    def by_type(self, codes: dict) -> dict:
        """``{entry point: {type name: calls}}`` for the accumulator codes
        ``codes`` (``{code: name}``)."""
        out: dict = {}
        for (name, code), n in sorted(self.calls.items()):
            if code in codes:
                out.setdefault(name, {})[codes[code]] = n
        return out


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

        # 9a in bfloat16: one pair_average session checkpoints its bfloat16
        # sum every group (host leaves of dtype V2, the reference's format),
        # ex0 dies before its 6th group, and the session restores on ex1 and
        # finishes bitwise equal to its run on the CPU
        cb = dataclasses.replace(cfg, accum_dtype="bfloat16")
        want = streaming.run_pipelined(cb, iter(tenants[0]), device="cpu")[0]
        plan, path = FaultPlan().crash("ex0", at_step=5), ckpt("9a-bfloat16")
        with FleetScheduler(checkpoint_dir=path, faults=plan, slots_per_executor=1,
                            max_executors=2, **on) as fleet:
            out, rep = fleet.submit(Session(config=cb, source=iter(tenants[0]), name="b")).result(
                timeout=SESSION_TIMEOUT_S)
        host, step = CheckpointManager(os.path.join(path, "b")).restore()
        if (out.dtype != torch.bfloat16 or out.device.type != dev.type
                or not torch.equal(out.cpu().view(torch.int16), want.view(torch.int16))):
            raise AssertionError("9a bfloat16: not bitwise equal to its run on the CPU")
        if (rep.restarts, step) != (1, G) or "recover@b->ex1:steps=5+0" not in fleet.events:
            raise AssertionError(f"9a bfloat16: restarts {rep.restarts}, last checkpoint {step}, "
                                 f"events {fleet.events}")
        if any(a.dtype != np.dtype("V2") for a in tree_leaves(host)[0]):
            raise AssertionError("9a bfloat16: the checkpoint's leaves are not bfloat16 bits (V2)")
        print("phase 9a: a bfloat16 pair_average session checkpointed on the card (V2 leaves), "
              "killed before its 6th group and restored on ex1: bitwise equal to its CPU run")

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
                heur = autotune.tile_candidates(
                    fam, p, h, w, vector=autotune.family_vector_path(fam, c),
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


#: phase 12's serving runs at the published configs: (label, arch, batch,
#: prompt tokens, generated tokens)
SERVE_RUNS = (
    ("12a", "h2o-danube-1.8b", 4, 128, 32),
    # longer than the 4096-token window: the windowed q-chunked prefill (S <
    # 2W) and the ring cache's roll
    ("12b", "h2o-danube-1.8b", 1, 4160, 16),
    # longer than twice the window: the banded prefill (S > 2W) and the roll
    ("12b+", "h2o-danube-1.8b", 1, 8320, 16),
    ("12c", "gemma3-1b", 4, 128, 32),
)
#: bfloat16 decode logits against the port's own forward over the same
#: tokens, as a fraction of the forward's largest |logit| at that position:
#: the cached decode and the full forward round in another order
BF16_CONSISTENCY = 0.1
#: 12d: the card's float32 logits (TF32 off) against the CPU's may differ by
#: this many times the CPU's own float32 error against float64 on the same
#: model: both round the same function, each in its own order
F32_CARD_VS_CPU_OF_F32_ERROR = 2.0
#: phase 12's runs of the other families at their published widths:
#: (label, arch, depth (None: the published depth), batch, prompt tokens,
#: generated tokens). 12e cuts mixtral to 8 of its 32 layers: its float32
#: parameters (187 GB) outgrow the card's 80 GB. 12j (audio) has no prompt:
#: it encodes 1500 frames and decodes from token 0.
FAMILY_RUNS = (
    ("12e", "mixtral-8x7b", 8, 4, 128, 32),
    ("12f", "deepseek-v2-lite-16b", None, 4, 128, 32),
    # a long prompt through the scan and past the 2048-token window
    ("12g", "recurrentgemma-9b", None, 1, 4160, 16),
    # 4160 = 32.5 chunks of 128: the pad path
    ("12h", "mamba2-780m", None, 1, 4160, 16),
    ("12i", "llama-3.2-vision-11b", None, 4, 128, 32),
    ("12j", "whisper-large-v3", None, 4, 0, 32),
)
#: the MoE runs' decode is held to the forward at this capacity factor, as
#: the reference's own decode test does: no token is dropped at any length
MOE_CONSISTENCY_CAPACITY = 64.0


def _top2_margin(logits: torch.Tensor) -> torch.Tensor:
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in float64."""
    want = want.double()
    return float((got.double().to(want.device) - want).abs().max()) / float(want.abs().max())


def serve_lm_phase(smi: str) -> dict:
    """Phase 12: the model substrate serves full-width models on the card
    through ``repro_torch.launch.serve.generate`` (random weights from a
    seeded CUDA generator, the reference's prompt draws). Each decode
    step's logits are held to the port's own forward over the prompt and
    the chosen tokens, and beside them the forward's distance from its own
    float32 run; 12d holds float32 logits on the card to the CPU's.
    Returns the phase's record."""
    from repro_torch.checkpoint.checkpoint import flat_leaves, map_tree
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.inputs import make_train_batch
    from repro_torch.models import build_model
    from repro_torch.models.layers import full_float32_matmul

    dev = torch.device("cuda")
    t12 = time.perf_counter()
    peak_bw = card_peaks(torch.cuda.get_device_name(0))[0]
    record, models = {}, {}
    for label, arch, batch, prompt_len, gen in SERVE_RUNS:
        cfg = get_config(arch)
        if arch not in models:
            models.clear()
            torch.cuda.empty_cache()
            model = build_model(cfg)
            params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
            warm = make_train_batch(cfg, batch, 16, seed=2, device=dev)
            serve.generate(model, params, {"tokens": warm["tokens"]}, prompt_len=16, gen=2)
            models[arch] = (model, params)
        model, params = models[arch]
        prompt = make_train_batch(cfg, batch, prompt_len, seed=1, device=dev)
        prompt.pop("labels")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = serve.generate(model, params, prompt, prompt_len=prompt_len, gen=gen)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        fed = torch.cat([prompt["tokens"], torch.from_numpy(out.first)[:, None].to(dev),
                         torch.from_numpy(out.tokens[:, :-1]).to(dev)], dim=1)
        f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        with torch.no_grad():
            full = model.forward(params, {"tokens": fed})[:, prompt_len:].float()
            with full_float32_matmul():
                exact = f32.forward(params, {"tokens": fed})[:, prompt_len:]
        worst, bf16_gap, checked = 0.0, 0.0, 0
        for i, step in enumerate(out.logits):
            want = full[:, i]
            worst = max(worst, _rel(step, want))
            bf16_gap = max(bf16_gap, _rel(want, exact[:, i]))
            sure = _top2_margin(want) > BF16_CONSISTENCY * float(want.abs().max())
            chose = torch.from_numpy(out.tokens[:, i]).to(dev)
            if not torch.equal(chose[sure].long(), want.argmax(-1)[sure]):
                raise AssertionError(f"phase {label}: step {i} chose another token than the "
                                     f"forward where the top-2 margin exceeds the tolerance")
            checked += int(sure.sum())
        del full, exact
        if not worst <= BF16_CONSISTENCY:
            raise AssertionError(f"phase {label}: decode logits differ from the forward by "
                                 f"{worst:.3g} of max |logit| > {BF16_CONSISTENCY}")
        # one decode step's bound: every float32 parameter and the KV cache
        # read once
        cache_bytes = sum(math.prod(s.shape) * (2 if s.dtype == torch.bfloat16 else 4)
                          for s in flat_leaves(model.cache_spec(batch, prompt_len + gen)))
        param_bytes = model.param_count() * 4
        step_ms = out.decode_s / gen * 1e3
        bound_ms = (param_bytes + cache_bytes) / peak_bw * 1e3
        row = dict(arch=arch, layers=cfg.num_layers, batch=batch, prompt=prompt_len, gen=gen,
                   prefill_ms=out.prefill_s * 1e3, decode_ms_per_step=step_ms,
                   tokens_per_s=batch * gen / out.decode_s, peak_gb=peak_gb,
                   step_bound_ms=bound_ms, param_gb=param_bytes / 1e9,
                   cache_gb=cache_bytes / 1e9, consistency_max_rel=worst,
                   bf16_vs_f32_max_rel=bf16_gap, tokens_checked=checked, card=smi)
        record[label] = row
        print(f"phase {label}: {arch} full width ({cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"vocab {cfg.vocab_size}, {cfg.dtype}) batch {batch} prompt {prompt_len} gen {gen}: "
              f"prefill {row['prefill_ms']:.2f} ms, decode {step_ms:.3f} ms/step "
              f"(bound {bound_ms:.3f} ms: {param_bytes / 1e9:.2f} GB float32 params + "
              f"{cache_bytes / 1e9:.3f} GB KV cache at {peak_bw / 1e12:.2f} TB/s; "
              f"{step_ms / bound_ms:.2f}x the bound), {row['tokens_per_s']:.1f} tok/s aggregate, "
              f"peak {peak_gb:.2f} GB; decode logits within {worst:.3g} of max |logit| of the "
              f"forward (declared {BF16_CONSISTENCY}; the bfloat16 forward is {bf16_gap:.3g} "
              f"from its float32 run), {checked} clear tokens equal ({smi})")
    models.clear()
    torch.cuda.empty_cache()

    # 12d: full width at depth 2 in float32, the card against the CPU
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=2, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    params_cpu = map_tree(lambda t: t.cpu(), params)
    params_f64 = map_tree(lambda t: t.double() if t.is_floating_point() else t, params_cpu)
    batch, prompt_len, gen = 2, 32, 8
    prompt = make_train_batch(cfg, batch, prompt_len, seed=1, device=dev)
    prompt.pop("labels")
    card = serve.generate(model, params, prompt, prompt_len=prompt_len, gen=gen)
    cpu = serve.generate(model, params_cpu, {"tokens": prompt["tokens"].cpu()},
                         prompt_len=prompt_len, gen=gen)
    fed = torch.cat([prompt["tokens"].cpu(), torch.from_numpy(card.first)[:, None],
                     torch.from_numpy(card.tokens[:, :-1])], dim=1)
    with full_float32_matmul(), torch.no_grad():
        f_card = model.forward(params, {"tokens": fed.to(dev)}).cpu()
        f_cpu = model.forward(params_cpu, {"tokens": fed})
        f_64 = build_model(dataclasses.replace(cfg, dtype="float64")).forward(
            params_f64, {"tokens": fed})
    f32_err = _rel(f_cpu, f_64)  # the CPU's float32 against float64
    tol = F32_CARD_VS_CPU_OF_F32_ERROR * f32_err
    fwd_rel, card_err = _rel(f_card, f_cpu), _rel(f_card, f_64)
    scale = float(f_cpu.abs().max())
    sure = _top2_margin(f_cpu) > tol * scale
    if not torch.equal(f_card.argmax(-1)[sure], f_cpu.argmax(-1)[sure]):
        raise AssertionError("phase 12d: the card's forward chose another token than the CPU's "
                             "where the top-2 margin exceeds the tolerance")
    own = max(_rel(card.logits[i], f_card[:, prompt_len + i]) for i in range(gen))
    step_rel, compared = 0.0, 0
    same = np.array_equal(card.first, cpu.first)
    for i in range(gen):
        if not same:
            break  # a near tie sent the two runs down different sequences
        a, b = card.logits[i].cpu(), cpu.logits[i]
        step_rel = max(step_rel, _rel(a, b))
        clear = (_top2_margin(b) > tol * float(b.abs().max())).numpy()
        if not np.array_equal(card.tokens[:, i][clear], cpu.tokens[:, i][clear]):
            raise AssertionError(f"phase 12d: decode step {i} chose another token on the card")
        compared += 1
        same = np.array_equal(card.tokens[:, i], cpu.tokens[:, i])
    worst = max(fwd_rel, step_rel, own)
    if not worst <= tol:
        raise AssertionError(f"phase 12d: card against CPU {worst:.3g} of max |logit| > {tol:.3g} "
                             f"({F32_CARD_VS_CPU_OF_F32_ERROR} x the CPU's float32 error "
                             f"{f32_err:.3g})")
    record["12d"] = dict(forward_max_rel=fwd_rel, decode_max_rel=step_rel,
                         card_decode_vs_forward=own, cpu_f32_vs_f64=f32_err,
                         card_f32_vs_f64=card_err, tolerance=tol, steps_compared=compared,
                         clear_positions=int(sure.sum()), positions=int(sure.numel()),
                         tokens_equal=bool(np.array_equal(card.tokens, cpu.tokens)), card=smi)
    print(f"phase 12d: h2o-danube-1.8b full width at depth 2, float32 (TF32 off), batch {batch} "
          f"prompt {prompt_len} gen {gen}: card against CPU forward {fwd_rel:.3g}, decode "
          f"{step_rel:.3g} over {compared} steps, the card's decode against its forward "
          f"{own:.3g} of max |logit| (declared {tol:.3g}: {F32_CARD_VS_CPU_OF_F32_ERROR} x the "
          f"CPU's float32 error {f32_err:.3g} against float64; the card's {card_err:.3g}); "
          f"argmax equal at {int(sure.sum())}/{sure.numel()} clear positions; greedy tokens "
          f"{'equal' if record['12d']['tokens_equal'] else 'diverge after a near tie'}")
    for run in FAMILY_RUNS:
        record[run[0]] = serve_family_run(*run, smi=smi, peak_bw=peak_bw)
    print(f"phase 12: {time.perf_counter() - t12:.1f} s")
    return record


def _moe_sets(routes, n_layers: int, batch: int):
    """Per MoE layer, the sorted expert choices (B, T, k) of the calls in
    ``routes`` (each call's (G, gs, k) choices over B x T tokens)."""
    per_layer = [[] for _ in range(n_layers)]
    for i, r in enumerate(routes):
        per_layer[i % n_layers].append(r["expert_idx"].reshape(batch, -1, r["expert_idx"].shape[-1]))
    return [torch.cat(calls, dim=1).sort(-1).values for calls in per_layer]


def _step_param_bytes(model, decode_routes, gen: int) -> float:
    """The float32 parameter bytes one decode step must read: every
    parameter, less (audio) the encoder's, which decode never reads, and
    all but one row of the learned decoder positions, and less (MoE) the
    experts no token of the step chose, averaged over the steps."""
    from repro_torch.distributed import sharding as sh

    cfg, spec = model.cfg, model.spec()
    n = sh.count_params(spec)
    if cfg.family == "audio":
        n -= (sh.count_params(spec["encoder"]) + sh.count_params(spec["enc_pos"])
              + sh.count_params(spec["enc_norm"]) + (cfg.decoder_positions - 1) * cfg.d_model)
    if cfg.num_experts:
        if len(decode_routes) != (cfg.num_layers - cfg.first_dense_layers) * gen:
            raise AssertionError(f"{len(decode_routes)} MoE routings recorded over {gen} steps")
        per_expert = 3 * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff)
        unused = sum(cfg.num_experts - int(torch.unique(r["expert_idx"][r["kept"]]).numel())
                     for r in decode_routes)
        n -= unused * per_expert / gen
    return n * 4


def scaled_init(model, generator, device, mesh=None, rules=None):
    """Random parameters for 12e-12j and 15: the reference's rules, except that
    every ``fan_in`` weight is drawn N(0, 1/d_model). The reference's
    ``fan_in`` divides by the square root of a leaf's first axis, which for
    a stacked weight is its layer count (1/sqrt(8) for mixtral's experts,
    not 1/sqrt(4096)): such a random model amplifies rounding until its
    bfloat16 forward lies O(1) of max |logit| from its float32 one, and no
    two orders of the same bfloat16 sums agree within ``BF16_CONSISTENCY``
    (PERF.md §6). Over a ``mesh`` of several ranks each rank keeps its
    shard of the same parameters."""
    from repro_torch.checkpoint.checkpoint import map_tree
    from repro_torch.distributed import sharding as sh

    scale = 1.0 / math.sqrt(model.cfg.d_model)
    spec = map_tree(lambda s: dataclasses.replace(s, init="normal", scale=scale)
                    if s.init == "fan_in" else s, model.spec())
    return sh.init_params(spec, generator=generator, device=device, mesh=mesh, rules=rules)


def serve_family_run(label, arch, depth, batch, prompt_len, gen, *, smi, peak_bw) -> dict:
    """One of 12e-12j: ``arch`` at its published widths (``depth`` layers
    where the card cannot hold them all), served through
    ``serve.generate`` after a warm-up; every decode step held to the
    port's own forward over the same tokens within ``BF16_CONSISTENCY``.
    An MoE model is timed at its published capacity factor and held to its
    forward at ``MOE_CONSISTENCY_CAPACITY``, at the (sequence, step)
    positions whose top-k sets agree in every MoE layer; the flips are
    counted and printed."""
    from repro_torch.checkpoint.checkpoint import flat_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.inputs import make_train_batch
    from repro_torch.models import build_model
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import full_float32_matmul

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    published = get_config(arch)
    cfg = dataclasses.replace(published, num_layers=depth) if depth else published
    model = build_model(cfg)
    params = scaled_init(model, torch.Generator(device=dev).manual_seed(0), dev)
    if cfg.family == "vlm":
        # the gates start at zero, which skips every cross layer: seeded
        # nonzero gates, so decode reads the image embeddings
        gen_g = torch.Generator(device=dev).manual_seed(5)
        for k in ("gate_attn", "gate_mlp"):
            params["cross_layers"][k].uniform_(0.5, 1.5, generator=gen_g)
    prompt = make_train_batch(cfg, batch, prompt_len, seed=1, device=dev)
    prompt.pop("labels")
    extras = {k: prompt[k] for k in ("image_embeds", "frames") if k in prompt}
    warm = make_train_batch(cfg, batch, 0 if cfg.family == "audio" else 16, seed=2, device=dev)
    warm.pop("labels")
    serve.generate(model, params, warm, prompt_len=warm["tokens"].shape[1], gen=2)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with MOE.recording_routes() as routes:
        out = serve.generate(model, params, prompt, prompt_len=prompt_len, gen=gen)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(bool(torch.isfinite(step).all()) for step in out.logits):
        raise AssertionError(f"phase {label}: a decode step's logits are not finite")
    moe_layers = cfg.num_layers - cfg.first_dense_layers if cfg.num_experts else 0
    param_bytes = _step_param_bytes(model, routes[len(routes) - moe_layers * gen:], gen)
    cache_bytes = sum(math.prod(s.shape) * (2 if s.dtype == torch.bfloat16 else 4)
                      for s in flat_leaves(model.cache_spec(batch, prompt_len + gen)))
    input_bytes = sum(t.numel() * t.element_size() for t in extras.values())
    step_ms = out.decode_s / gen * 1e3
    bound_ms = (param_bytes + cache_bytes + input_bytes) / peak_bw * 1e3
    del routes

    # consistency: decode against the model's own forward over the same tokens
    held, held_cfg = out, cfg
    if cfg.num_experts:
        held_cfg = dataclasses.replace(cfg, capacity_factor=MOE_CONSISTENCY_CAPACITY)
    held_model = build_model(held_cfg)
    with MOE.recording_routes() as routes:
        if cfg.num_experts:
            held = serve.generate(held_model, params, prompt, prompt_len=prompt_len, gen=gen)
        fed = torch.cat([prompt["tokens"], torch.from_numpy(held.first)[:, None].to(dev),
                         torch.from_numpy(held.tokens[:, :-1]).to(dev)], dim=1)
        n_run = len(routes)
        with torch.no_grad():
            full = held_model.forward(params, {"tokens": fed, **extras})[:, prompt_len:].float()
    agree = torch.ones((batch, gen), dtype=torch.bool, device=dev)
    flips = prompt_flips = 0
    if cfg.num_experts:
        run_sets = _moe_sets(routes[:moe_layers], moe_layers, batch)  # the prefill
        step_sets = _moe_sets(routes[moe_layers:n_run], moe_layers, batch)
        fwd_sets = _moe_sets(routes[n_run:], moe_layers, batch)
        for pre, dec, fwd in zip(run_sets, step_sets, fwd_sets):
            prompt_flips += int((pre != fwd[:, :prompt_len]).any(-1).sum())
            differ = (dec != fwd[:, prompt_len:]).any(-1)
            flips += int(differ.sum())
            agree &= ~differ
    del routes
    with torch.no_grad(), full_float32_matmul():
        exact = build_model(dataclasses.replace(held_cfg, dtype="float32")).forward(
            params, {"tokens": fed, **extras})[:, prompt_len:]
    worst, bf16_gap, checked = 0.0, 0.0, 0
    for i, step in enumerate(held.logits):
        want = full[:, i]
        rows = agree[:, i]
        scale = float(want.abs().max())
        if bool(rows.any()):
            diff = (step.double() - want.double()).abs().amax(-1)
            worst = max(worst, float(diff[rows].max()) / scale)
        bf16_gap = max(bf16_gap, _rel(want, exact[:, i]))
        sure = rows & (_top2_margin(want) > BF16_CONSISTENCY * scale)
        chose = torch.from_numpy(held.tokens[:, i]).to(dev)
        if not torch.equal(chose[sure].long(), want.argmax(-1)[sure]):
            raise AssertionError(f"phase {label}: step {i} chose another token than the "
                                 f"forward where the top-2 margin exceeds the tolerance")
        checked += int(sure.sum())
    del full, exact, held
    if not worst <= BF16_CONSISTENCY:
        raise AssertionError(f"phase {label}: decode logits differ from the forward by "
                             f"{worst:.3g} of max |logit| > {BF16_CONSISTENCY}")
    row = dict(arch=arch, layers=cfg.num_layers, published_layers=published.num_layers,
               batch=batch, prompt=prompt_len, gen=gen, prefill_ms=out.prefill_s * 1e3,
               decode_ms_per_step=step_ms, tokens_per_s=batch * gen / out.decode_s,
               peak_gb=peak_gb, step_bound_ms=bound_ms, step_param_gb=param_bytes / 1e9,
               param_gb=model.param_count() * 4 / 1e9, cache_gb=cache_bytes / 1e9,
               consistency_max_rel=worst, bf16_vs_f32_max_rel=bf16_gap,
               tokens_checked=checked, positions_held=int(agree.sum()),
               routing_flips=flips, prompt_routing_flips=prompt_flips,
               consistency_capacity_factor=held_cfg.capacity_factor if cfg.num_experts else None,
               seconds=0.0, card=smi)
    del params, model, held_model, out
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t0
    cut = (f"depth cut to {cfg.num_layers} of {published.num_layers} layers"
           if depth else f"{cfg.num_layers} layers")
    moe = (f"; held at capacity_factor {MOE_CONSISTENCY_CAPACITY} (timed at "
           f"{cfg.capacity_factor}): {flips} of {batch * gen * moe_layers} decode (token, layer) "
           f"top-k sets differ from the forward's, {prompt_flips} of the prefill's "
           f"{batch * prompt_len * moe_layers}; held at the "
           f"{int(agree.sum())} positions whose routing agrees" if cfg.num_experts else "")
    print(f"phase {label}: {arch} full width ({cut}, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}) batch {batch} prompt {prompt_len} gen {gen}: "
          f"prefill {row['prefill_ms']:.2f} ms, decode {step_ms:.3f} ms/step (bound "
          f"{bound_ms:.3f} ms: {param_bytes / 1e9:.2f} GB of float32 params a step reads + "
          f"{cache_bytes / 1e9:.3f} GB cache + {input_bytes / 1e9:.3f} GB inputs at "
          f"{peak_bw / 1e12:.2f} TB/s; {step_ms / bound_ms:.2f}x the bound), "
          f"{row['tokens_per_s']:.1f} tok/s aggregate, peak {peak_gb:.2f} GB; decode logits "
          f"within {worst:.3g} of max |logit| of the forward (declared {BF16_CONSISTENCY}; the "
          f"bfloat16 forward is {bf16_gap:.3g} from its float32 run){moe}, {checked} clear "
          f"tokens equal; {row['seconds']:.1f} s ({smi})")
    return row


#: phase 13a: the reference trainer's default arch and command line at full
#: width (remat on, as the config says), with the config's 4 microbatches
TRAIN_13A = ["--arch", "gemma3-1b", "--batch", "8", "--seq", "128", "--microbatches", "4",
             "--steps", "20"]
#: 13b: h2o-danube-1.8b at full width, M = 1 against M = 4 (batch 8, seq 128)
TRAIN_13B = ["--arch", "h2o-danube-1.8b", "--batch", "8", "--seq", "128", "--steps", "3"]
#: 13b: M = 1 and M = 4 round the same step in bfloat16 in two shapes: their
#: first losses (and gradient norms) may differ by this many times the M = 1
#: run's own gap to the float32 step on the same parameters and batch, and
#: at least by bfloat16's unit roundoff
TRAIN_BF16_OF_F32_GAP = 2.0
BF16_ROUNDOFF = 2.0 ** -8
#: 13c: the card's float32 step (TF32 off) against the CPU's: losses and
#: gradient norms within this many times the CPU's own float32 error against
#: float64 on the first step, and at least ``TRAIN_F32_FLOOR`` (relative)
TRAIN_F32_OF_F32_ERROR = 2.0
TRAIN_F32_FLOOR = 1e-5
#: 13d: smoke danube, the trainer's resume test on the card
TRAIN_13D = ["--arch", "h2o-danube-1.8b", "--smoke", "--batch", "4", "--seq", "32",
             "--lr", "1e-2", "--ckpt-every", "2"]


def _grad_norm_and_loss(model, params, batch):
    """One loss and the float32 norm of its gradients (no update)."""
    from repro_torch.checkpoint.checkpoint import flat_leaves, map_tree

    tracked = map_tree(lambda t: t.detach().requires_grad_(), params)
    loss = model.loss(tracked, batch)
    grads = torch.autograd.grad(loss, flat_leaves(tracked))
    return float(loss.detach()), float(torch.sqrt(sum(torch.sum(torch.square(g.double()))
                                             for g in grads)))


def train_phase(smi: str, wrappers: dict) -> dict:
    """Phase 13: the model substrate trains on the card through
    ``repro_torch.launch.train.main`` and ``launch.steps``. 13a trains
    full-width ``gemma3-1b`` for 20 steps (the reference trainer's default
    command line, remat on, 4 microbatches, checkpoints into a temporary
    directory) and prints step ms, tokens/s and peak GB against the step's
    bound; 13b holds full-width ``h2o-danube-1.8b``'s first step at M = 1
    and M = 4 to each other; 13c holds a float32 step of danube at depth 2
    on the card to the CPU's; 13d resumes a smoke run from its checkpoint,
    bitwise. No kernel of the port runs on this path: the counters are
    zeroed before and read after. Returns the phase's record."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.checkpoint import flat_leaves, map_tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import HW
    from repro_torch.models import build_model
    from repro_torch.models.layers import full_float32_matmul
    from repro_torch.optim import AdamW, cosine_schedule

    dev = torch.device("cuda")
    t13 = time.perf_counter()
    for fn in wrappers.values():
        fn.launches = 0
    record: dict = {"card": smi}

    # 13a: gemma3-1b at full width, the reference trainer's command line
    t = time.perf_counter()
    cfg = get_config("gemma3-1b")
    n_params = build_model(cfg).param_count()
    batch, seq = 8, 128
    with tempfile.TemporaryDirectory(prefix="train-ckpt-") as ckpt:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = train.main(TRAIN_13A + ["--ckpt-dir", ckpt])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ckpt_steps = CheckpointManager(ckpt).steps()
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 13a: losses not finite and falling: {list(losses)}")
    step_ms = statistics.median(losses.step_s[1:]) * 1e3
    tokens = batch * seq
    flops = 6 * n_params * tokens * (4 / 3 if cfg.remat else 1)
    state_bytes = 4 * 4 * n_params  # float32 params, grads, mu, nu, each read once
    bound_ms = max(flops / HW.PEAK_BF16_FLOPS, state_bytes / HW.HBM_BW) * 1e3
    bound_by = "operations" if flops / HW.PEAK_BF16_FLOPS > state_bytes / HW.HBM_BW else "bytes"
    record["13a"] = dict(
        arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
        params=n_params, batch=batch, seq=seq, microbatches=4, remat=cfg.remat,
        remat_policy=cfg.remat_policy, steps=len(losses), losses=list(losses),
        grad_norms=losses.grad_norms, step_ms=[x * 1e3 for x in losses.step_s],
        first_step_ms=losses.step_s[0] * 1e3, median_step_ms=step_ms,
        tokens_per_s=tokens / (step_ms / 1e3), peak_gb=peak_gb, bound_ms=bound_ms,
        bound_by=bound_by, bound_flops=flops, bound_bytes=state_bytes,
        checkpoints=ckpt_steps, seconds=time.perf_counter() - t)
    print(f"phase 13a: {cfg.name} full width ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B params, {cfg.dtype}, remat "
          f"{cfg.remat_policy}) batch {batch} seq {seq} M 4, {len(losses)} steps through "
          f"launch.train.main, checkpoints at steps {ckpt_steps}: step {step_ms:.2f} ms "
          f"(median after the first; first {losses.step_s[0] * 1e3:.2f} ms), "
          f"{record['13a']['tokens_per_s']:.1f} tokens/s, peak {peak_gb:.2f} GB; bound "
          f"{bound_ms:.3f} ms by {bound_by} ({flops / 1e12:.2f} TFLOP at "
          f"{HW.PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, {state_bytes / 1e9:.2f} GB at "
          f"{HW.HBM_BW / 1e12:.2f} TB/s; {step_ms / bound_ms:.1f}x); loss "
          f"{[round(x, 4) for x in losses]} ({smi})")

    # 13b: h2o-danube-1.8b at full width, M = 1 against M = 4 from one init
    t = time.perf_counter()
    runs = {m: train.main(TRAIN_13B + ["--microbatches", str(m)]) for m in (1, 4)}
    cfg = get_config("h2o-danube-1.8b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    first = DataPipeline(cfg, batch=8, seq=128, cycle=4, device=dev).batch_at(0)
    f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    with full_float32_matmul():
        f32_loss, f32_gn = _grad_norm_and_loss(f32, params, first)
    del params
    torch.cuda.empty_cache()
    one, four = runs[1], runs[4]
    gaps, tols, diffs = {}, {}, {}
    for key, a, b, ref in (("loss", one[0], four[0], f32_loss),
                           ("grad_norm", one.grad_norms[0], four.grad_norms[0], f32_gn)):
        gaps[key] = abs(a - ref) / abs(ref)
        tols[key] = max(TRAIN_BF16_OF_F32_GAP * gaps[key], BF16_ROUNDOFF)
        diffs[key] = abs(a - b) / abs(a)
        if not (math.isfinite(a) and math.isfinite(b) and diffs[key] <= tols[key]):
            raise AssertionError(f"phase 13b: M = 1 against M = 4 first-step {key} {a} vs {b}: "
                                 f"{diffs[key]:.3g} > {tols[key]:.3g}")
    record["13b"] = dict(arch=cfg.name, losses={m: list(r) for m, r in runs.items()},
                         grad_norms={m: r.grad_norms for m, r in runs.items()},
                         step_ms={m: [x * 1e3 for x in r.step_s] for m, r in runs.items()},
                         f32_first_loss=f32_loss, f32_first_grad_norm=f32_gn,
                         bf16_gap=gaps, tolerance=tols, m1_vs_m4=diffs,
                         seconds=time.perf_counter() - t)
    print(f"phase 13b: {cfg.name} full width, batch 8 seq 128, 3 steps at M = 1 and M = 4 from "
          f"one init: first loss {one[0]:.6f} vs {four[0]:.6f} ({diffs['loss']:.3g}; declared "
          f"{tols['loss']:.3g} from the bfloat16 gap {gaps['loss']:.3g} to the float32 step), "
          f"grad_norm {one.grad_norms[0]:.6g} vs {four.grad_norms[0]:.6g} "
          f"({diffs['grad_norm']:.3g}; declared {tols['grad_norm']:.3g}, gap "
          f"{gaps['grad_norm']:.3g}); later losses M=1 {[round(x, 4) for x in one[1:]]}, M=4 "
          f"{[round(x, 4) for x in four[1:]]}; step ms M=1 "
          f"{[round(x * 1e3, 1) for x in one.step_s]}, M=4 "
          f"{[round(x * 1e3, 1) for x in four.step_s]}")

    # 13c: float32 (TF32 off) at full width and depth 2, the card against the
    # CPU, from scaled_init's weights: under the reference's init the model
    # amplifies float32 rounding of the loss's own float32 softmax until the
    # card's float64 gradients lie 2e-3 of a leaf's max from the CPU's
    t = time.perf_counter()
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=2, dtype="float32")
    model = build_model(cfg)
    cpu_params = scaled_init(model, torch.Generator().manual_seed(0), "cpu")
    pipe = {d: DataPipeline(cfg, batch=2, seq=32, cycle=4, device=d) for d in ("cpu", "cuda")}
    with full_float32_matmul():
        f64 = map_tree(lambda x: x.double(), cpu_params)
        f64_loss, f64_gn = _grad_norm_and_loss(
            build_model(dataclasses.replace(cfg, dtype="float64")), f64, pipe["cpu"].batch_at(0))
        del f64
        got = {}
        for d, p in (("cuda", map_tree(lambda x: x.to(dev), cpu_params)), ("cpu", cpu_params)):
            opt = AdamW(learning_rate=cosine_schedule(3e-3, 5, 2))
            step = steps.build_train_step(model, opt, microbatches=1)
            state = opt.init(p)
            got[d] = []
            for i in range(2):
                p, state, met = step(p, state, pipe[d].batch_at(i))
                got[d].append((float(met["loss"]), float(met["grad_norm"])))
    f32_err = {"loss": abs(got["cpu"][0][0] - f64_loss) / f64_loss,
               "grad_norm": abs(got["cpu"][0][1] - f64_gn) / f64_gn}
    tol = {k: max(TRAIN_F32_OF_F32_ERROR * e, TRAIN_F32_FLOOR) for k, e in f32_err.items()}
    rel = {"loss": max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got["cuda"], got["cpu"])),
           "grad_norm": max(abs(a[1] - b[1]) / abs(b[1])
                            for a, b in zip(got["cuda"], got["cpu"]))}
    for key in rel:
        if not rel[key] <= tol[key]:
            raise AssertionError(f"phase 13c: card against CPU {key} {rel[key]:.3g} > "
                                 f"{tol[key]:.3g}: {got}")
    record["13c"] = dict(card=got["cuda"], cpu=got["cpu"], f64_first=(f64_loss, f64_gn),
                         cpu_f32_vs_f64=f32_err, tolerance=tol, card_vs_cpu=rel,
                         seconds=time.perf_counter() - t)
    print(f"phase 13c: h2o-danube-1.8b full width at depth 2, float32 (TF32 off), scaled_init, "
          f"batch 2 seq 32, 2 steps through launch.steps: card against CPU loss {rel['loss']:.3g}, "
          f"grad_norm {rel['grad_norm']:.3g} (declared {tol['loss']:.3g} and "
          f"{tol['grad_norm']:.3g}: {TRAIN_F32_OF_F32_ERROR} x the CPU's float32 error against "
          f"float64 on the first step, {f32_err['loss']:.3g} and {f32_err['grad_norm']:.3g}, "
          f"at least {TRAIN_F32_FLOOR}); (loss, grad_norm) card {got['cuda']}")

    # 13d: smoke danube on the card, checkpoint every 2, resume to 8: bitwise
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train-resume-") as root:
        whole = train.main(TRAIN_13D + ["--steps", "8", "--ckpt-dir", f"{root}/whole"])
        first = train.main(TRAIN_13D + ["--steps", "5", "--ckpt-dir", f"{root}/resumed"])
        second = train.main(TRAIN_13D + ["--steps", "8", "--ckpt-dir", f"{root}/resumed"])
        finals = [CheckpointManager(f"{root}/{n}").restore()[0] for n in ("whole", "resumed")]
    same_params = all(np.array_equal(a, b) for a, b in
                      zip(flat_leaves(finals[0]), flat_leaves(finals[1])))
    if list(second) != list(whole[5:]) or list(first) != list(whole[:5]) or not same_params:
        raise AssertionError(f"phase 13d: the resumed run is not bitwise the uninterrupted "
                             f"one: {list(whole)} vs {list(first)} + {list(second)} "
                             f"(final state equal: {same_params})")
    record["13d"] = dict(losses=list(whole), resumed=list(second), bitwise=True,
                         seconds=time.perf_counter() - t)
    print(f"phase 13d: smoke h2o-danube-1.8b on the card, 5 steps with a checkpoint every 2, "
          f"resumed to 8: steps 5-7 and the final state bitwise equal to the uninterrupted "
          f"run (losses {[round(x, 4) for x in whole]})")

    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    if any(launches.values()):
        raise AssertionError(f"phase 13: a kernel of the port launched on the training path: "
                             f"{launches}")
    record["launches"] = launches
    record["seconds"] = time.perf_counter() - t13
    print(f"phase 13: launches of the port's kernels {json.dumps(launches)} (none on this "
          f"path); {record['seconds']:.1f} s")
    return record


#: phase 14a: the reference test's pipeline (P stages, M microbatches, mb, D,
#: dtype) and one at an LLM's width
PIPE_RUNS = (("small", 4, 8, 2, 16, torch.float32), ("wide", 4, 8, 256, 4096, torch.bfloat16))
#: 14a: the card's small pipeline against the port's CPU run
PIPE_CPU_ATOL = 1e-5
#: 14b: the counter's peak of phase 13a's step, traced on meta, over the
#: card's ``max_memory_allocated`` of that step run bare: declared before the
#: first run on the card (the counter cannot see workspaces an operator
#: allocates inside itself, nor the allocator's rounding)
PEAK_BAND = (0.8, 1.05)
#: 14b: PERF.md's hand-worked bound of phase 13a's step (6 * params * tokens
#: * 4/3 at 989 TFLOP/s)
HAND_BOUND_MS = 8.282
#: 14c: one dry-run cell of each kind on a small arch
DRYRUN_CELLS = (("gemma3-1b", "train_4k"), ("gemma3-1b", "prefill_32k"),
                ("gemma3-1b", "decode_32k"))


def roofline_phase(smi: str, wrappers: dict) -> dict:
    """Phase 14: the pipeline schedule, the roofline counter and the dry run
    on the card. 14a runs ``pipeline_forward`` over ``StageMesh(("cuda:0",)
    * 4)`` at the reference test's shape and at an LLM's width, each bitwise
    equal to the stages composed one microbatch at a time on the card (the
    small one also within ``PIPE_CPU_ATOL`` of the port's CPU run); 14b
    reads phase 13a's step (``gemma3-1b``, batch 8 x 128, M = 4, remat) with
    ``roofline.op_costs.analyze`` once on the card's tensors and once on
    ``meta``: equal FLOPs, the meta peak within ``PEAK_BAND`` of the card's
    measured peak of the bare step, and the counted bound (products, or the
    bytes the step must move: ``analysis.step_bound``) beside the
    hand-worked one and the step's measured ms; 14c runs
    ``launch.dryrun.run_cell`` on one cell of each kind. No kernel of the
    port runs on this path: the counters are zeroed before and read after.
    Returns the phase's record."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline_parallel import (
        StageMesh,
        bubble_fraction,
        pipeline_forward,
    )
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.inputs import make_train_batch
    from repro_torch.launch.mesh import HW, make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.roofline import analysis, op_costs

    dev = torch.device("cuda")
    t14 = time.perf_counter()
    for fn in wrappers.values():
        fn.launches = 0
    record: dict = {"card": smi}

    # 14a: the GPipe schedule over four stages on one card
    def stage_fn(params, x):
        return torch.tanh(x @ params["w"])

    def sequential(ws, xs):
        outs = []
        for x in xs:
            for s in range(ws.shape[0]):
                x = stage_fn({"w": ws[s]}, x)
            outs.append(x)
        return torch.stack(outs)

    def host_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    record["14a"] = {}
    for label, p, m, mb, d, dtype in PIPE_RUNS:
        gen = torch.Generator().manual_seed(p * 1000 + d)
        ws = (torch.randn((p, d, d), generator=gen) / math.sqrt(d)).to(dtype)
        xs = torch.randn((m, mb, d), generator=gen).to(dtype)
        mesh = StageMesh(("cuda:0",) * p)
        ws_c, xs_c = ws.to(dev), xs.to(dev)
        out = pipeline_forward({"w": ws_c}, xs_c, mesh, stage_fn)
        want = sequential(ws_c, xs_c)
        if out.shape != (m, mb, d) or not torch.equal(out, want):
            raise AssertionError(f"phase 14a {label}: the pipeline is not bitwise the sequential "
                                 f"run on the card")
        run = dict(stages=p, microbatches=m, mb=mb, d=d, dtype=str(dtype).replace("torch.", ""),
                   bubble_fraction=bubble_fraction(p, m))
        if label == "small":
            cpu = pipeline_forward({"w": ws}, xs, StageMesh(("cpu",) * p), stage_fn)
            run["card_vs_cpu"] = float((out.cpu() - cpu).abs().max())
            if not run["card_vs_cpu"] <= PIPE_CPU_ATOL:
                raise AssertionError(f"phase 14a: card against CPU {run['card_vs_cpu']:.3g} > "
                                     f"{PIPE_CPU_ATOL}")
        run["pipeline_ms"] = host_ms(lambda: pipeline_forward({"w": ws_c}, xs_c, mesh, stage_fn))
        run["sequential_ms"] = host_ms(lambda: sequential(ws_c, xs_c))
        record["14a"][label] = run
        print(f"phase 14a: pipeline_forward over StageMesh(cuda:0 x {p}) {label}: M {m} mb {mb} "
              f"D {d} {run['dtype']}, tanh(x @ w), bitwise equal to the sequential run on the "
              f"card" + (f", {run['card_vs_cpu']:.3g} from the CPU run (declared "
                         f"{PIPE_CPU_ATOL})" if "card_vs_cpu" in run else "")
              + f"; pipeline {run['pipeline_ms']:.3f} ms, sequential {run['sequential_ms']:.3f} "
              f"ms (host clock, median of 5), bubble fraction {run['bubble_fraction']:.4f}")
        del ws_c, xs_c, out, want

    # 14b: phase 13a's step read by the counter on the card and on meta
    t = time.perf_counter()
    cfg = get_config("gemma3-1b")
    model = build_model(cfg)
    batch, seq, micro = 8, 128, 4
    meta_mesh = make_mesh((1, 1), ("data", "model"), device="meta")
    meta_step, abstract = steps.jit_train_step(
        model, AdamW(), meta_mesh, steps.resolve_rules(cfg, meta_mesh), microbatches=micro,
        batch=batch, seq=seq)
    t_meta = time.perf_counter()
    meta = op_costs.analyze(meta_step, *abstract)
    t_meta = time.perf_counter() - t_meta
    del meta["result"]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    card_mesh = make_mesh((1, 1), ("data", "model"))
    step, _ = steps.jit_train_step(model, AdamW(), card_mesh,
                                   steps.resolve_rules(cfg, card_mesh), microbatches=micro,
                                   batch=batch, seq=seq)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_state = AdamW().init(params)
    data = make_train_batch(cfg, batch, seq, microbatches=micro, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_card = time.perf_counter()
    card = op_costs.analyze(step, params, opt_state, data)
    float(card["result"][2]["loss"])
    t_card = time.perf_counter() - t_card
    counted_run_peak = torch.cuda.max_memory_allocated() - base
    del card["result"]
    step_ms, bare_peaks = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s0 = time.perf_counter()
        _, _, met = step(params, opt_state, data)
        float(met["loss"])
        step_ms.append((time.perf_counter() - s0) * 1e3)
        bare_peaks.append(torch.cuda.max_memory_allocated() - base)
    del params, opt_state, data, met
    torch.cuda.empty_cache()
    measured_peak = max(bare_peaks)
    ratio = meta["peak_bytes"] / measured_peak
    if card["flops"] != meta["flops"]:
        raise AssertionError(f"phase 14b: the counter read {card['flops']} FLOPs on the card "
                             f"and {meta['flops']} on meta")
    if not PEAK_BAND[0] <= ratio <= PEAK_BAND[1]:
        raise AssertionError(f"phase 14b: the counted peak {meta['peak_bytes']} is {ratio:.4f} "
                             f"of the measured {measured_peak}, outside {PEAK_BAND}")
    terms = analysis.roofline_terms(meta)
    bound_s, bound_by = analysis.step_bound(meta)
    bound_ms = bound_s * 1e3
    median_ms = statistics.median(step_ms)
    hand_flops = 6 * model.param_count() * batch * seq * (4 / 3 if cfg.remat else 1)
    record["14b"] = dict(
        arch=cfg.name, batch=batch, seq=seq, microbatches=micro, remat=cfg.remat,
        flops=meta["flops"], card_flops=card["flops"], bytes=meta["bytes"],
        card_bytes=card["bytes"], peak_bytes=meta["peak_bytes"],
        card_counted_peak_bytes=card["peak_bytes"], argument_bytes=meta["argument_bytes"],
        temp_bytes=meta["temp_bytes"], measured_peak_bytes=measured_peak,
        bare_peaks=bare_peaks, counted_run_measured_peak_bytes=counted_run_peak,
        peak_ratio=ratio, peak_band=PEAK_BAND, roofline=terms.asdict(), bound_ms=bound_ms,
        bound_by=bound_by, io_bytes=meta["io_bytes"], traffic_ms=terms.memory_s * 1e3,
        hand_bound_ms=HAND_BOUND_MS, hand_flops=hand_flops, step_ms=step_ms,
        median_step_ms=median_ms, meta_trace_s=t_meta, card_trace_s=t_card,
        seconds=time.perf_counter() - t)
    print(f"phase 14b: {cfg.name} batch {batch} seq {seq} M {micro} remat {cfg.remat_policy} "
          f"(phase 13a's step) read by op_costs.analyze on the card ({t_card:.1f} s) and on meta "
          f"({t_meta:.1f} s): {meta['flops']:.6e} FLOPs on both (6ND x 4/3 {hand_flops:.6e}), "
          f"{meta['bytes']:.6e} bytes on meta ({card['bytes']:.6e} on the card); peak "
          f"{meta['peak_bytes'] / 1e9:.3f} GB counted on meta ({card['peak_bytes'] / 1e9:.3f} on "
          f"the card) against {measured_peak / 1e9:.3f} GB measured for the bare step "
          f"(max_memory_allocated, steps {[round(x / 1e9, 3) for x in bare_peaks]}): ratio "
          f"{ratio:.4f} (declared {PEAK_BAND[0]}-{PEAK_BAND[1]}); the counted run itself "
          f"peaked at {counted_run_peak / 1e9:.3f} GB; counted bound {bound_ms:.3f} ms by "
          f"{bound_by} (compute {terms.compute_s * 1e3:.3f} ms at "
          f"{HW.PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, {meta['io_bytes'] / 1e9:.3f} GB to move "
          f"{meta['io_bytes'] / HW.HBM_BW * 1e3:.3f} ms at {HW.HBM_BW / 1e12:.2f} TB/s) beside "
          f"the hand-worked {HAND_BOUND_MS} ms; the eager operator traffic (no bound) "
          f"{terms.memory_s * 1e3:.3f} ms; the bare step {median_ms:.2f} ms (median of {[round(x, 1) for x in step_ms]}), "
          f"{median_ms / bound_ms:.2f}x the counted bound, {median_ms / HAND_BOUND_MS:.1f}x "
          f"the hand-worked ({smi})")

    # 14c: the dry run, one cell of each kind
    record["14c"] = []
    for arch, shape in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, verbose=False)
        if rec["status"] != "ok":
            raise AssertionError(f"phase 14c: {arch} {shape}: {rec['status']}")
        record["14c"].append(rec)
        roof = rec["roofline"]
        print(f"phase 14c: dryrun.run_cell({arch}, {shape}) on the {rec['mesh']} mesh: trace "
              f"{rec['trace_s']} s, {rec['hlo_flops_per_device']:.4e} FLOPs (useful "
              f"{rec['useful_flops_ratio']:.3f}), hbm {rec['hbm_needed_gib']} GiB, fits_hbm "
              f"{rec['fits_hbm']}, bound {rec['bound']['bound_s'] * 1e3:.4g} ms by "
              f"{rec['bound']['bound_by']}, operator traffic {roof['memory_s'] * 1e3:.4g} ms "
              f"(dominant term {roof['dominant']})")

    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    if any(launches.values()):
        raise AssertionError(f"phase 14: a kernel of the port launched on this path: "
                             f"{launches}")
    record["launches"] = launches
    record["seconds"] = time.perf_counter() - t14
    print(f"phase 14: launches of the port's kernels {json.dumps(launches)} (none on this "
          f"path); {record['seconds']:.1f} s")
    return record

#: phase 15: the decoder-only families over a (2, 2) mesh of four ranks that
#: share the one card, a gloo group met through a file, each configuration
#: at its published widths in float32 (TF32 off, ``scaled_init``) and held
#: to the same weights in one process. ``layers`` cuts the depth (None: the
#: published depth) so that the four ranks' shards and the one-process
#: train state fit the card together (``scripts/torch_mesh_peaks.py``
#: reckons each on ``meta``)
MESH_SHAPE, MESH_RANKS = (2, 2), 4
MESH_RUNS = (
    dict(label="15a", arch="gemma3-1b", layers=6, batch=4, prompt=128, gen=8,
         train_batch=8, train_seq=128, train_steps=2),
    dict(label="15b", arch="mixtral-8x7b", layers=1, batch=4, prompt=128, gen=4,
         train_batch=8, train_seq=128, train_steps=2),
    dict(label="15c", arch="deepseek-v2-lite-16b", layers=3, batch=4, prompt=128, gen=4,
         train_batch=8, train_seq=128, train_steps=2),
    dict(label="15d", arch="mamba2-780m", layers=8, batch=4, prompt=128, gen=4,
         train_batch=8, train_seq=128, train_steps=2),
    dict(label="15e", arch="recurrentgemma-9b", layers=3, batch=4, prompt=128, gen=4,
         train_batch=8, train_seq=128, train_steps=2),
)
MESH_LR = 1e-3
MESH_TIMEOUT_S = 600.0
#: against the same weights in one process on the card (ROADMAP.md queue C):
#: logits within this fraction of max |logit|, the loss and grad_norm
#: relative, every new parameter within 2 lr (AdamW's first steps move each
#: by about lr times the sign of its gradient)
MESH_SERVE_RTOL = 3e-5
MESH_LOSS_RTOL = 1e-6
MESH_GN_RTOL = 5e-5
#: each leaf's AdamW moments within this fraction of the leaf's largest
#: (nu, a square, twice it): a gradient reduced twice or over the wrong axis
#: moves a leaf's moments by half its largest or more, the model's own
#: rounding by far less (queue C: 4.6e-3 between the two frameworks on
#: smoke gemma3)
MESH_MOMENT_RTOL = 1e-2


class CollectiveTally:
    """Counts the collectives the mesh's steps issue while it is entered,
    with the bytes of each call's local input: it wraps the functional
    collectives DTensor's placements call (the names of the card's torch,
    2.11) and ``torch.distributed.all_reduce`` (the embedding's sum over
    the vocabulary's split, ``models.layers._rows``)."""

    def __init__(self):
        self.calls: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()

    def __enter__(self):
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.tensor import placement_types as pt

        issuers = (("all_gather_into_tensor", funcol, "all_gather_tensor"),
                   ("reduce_scatter_tensor", funcol, "reduce_scatter_tensor"),
                   ("all_reduce", funcol, "all_reduce"),
                   ("all_to_all_single", pt, "shard_dim_alltoall"),
                   ("all_reduce (torch.distributed)", dist, "all_reduce"))
        self._saved = []
        for name, mod, attr in issuers:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def call(t, *args, **kwargs):
            self.calls[name] += 1
            self.bytes[name] += t.numel() * t.element_size()
            return fn(t, *args, **kwargs)

        return call

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)

    def summary(self) -> dict:
        return {k: {"calls": self.calls[k], "bytes": self.bytes[k]} for k in sorted(self.calls)}


def _on_lead(t, lead: bool):
    """The full value of a DTensor as a host array on rank 0 (``None`` on
    the others): each rank sends its block to rank 0 through gloo on the
    host, and only rank 0 receives (a full tensor would gather every leaf
    on every rank, four times the traffic and the memory). Every rank
    calls it."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    local = t.to_local().detach().to("cpu").contiguous()
    pieces = [torch.empty_like(local) for _ in range(mesh.size())] if lead else None
    dist.gather(local, pieces, dst=0)
    if not lead:
        return None
    full = np.empty(tuple(t.shape), dtype=local.numpy().dtype)
    ranks = mesh.mesh
    for r, piece in enumerate(pieces):
        coord = [int(c) for c in (ranks == r).nonzero()[0]]
        index = [slice(0, n) for n in t.shape]
        for i, p in enumerate(t.placements):  # mesh dimensions, major to minor
            if isinstance(p, Shard):
                d = p.dim
                n = (index[d].stop - index[d].start) // mesh.size(i)
                start = index[d].start + coord[i] * n
                index[d] = slice(start, start + n)
        full[tuple(index)] = piece.numpy()
    return full


def _route_rows(routes, batch: int) -> list[np.ndarray]:
    """Each recorded MoE call's expert choices and kept flags as one host
    array (B, T, 2k) per call: groups are consecutive tokens of the
    batch-major token order. Every rank calls it (a DTensor's full tensor
    is a collective)."""
    from repro_torch.checkpoint.checkpoint import to_host

    rows = []
    for r in routes:
        idx, kept = to_host(r["expert_idx"]), to_host(r["kept"])
        rows.append(np.concatenate([idx.reshape(batch, -1, idx.shape[-1]),
                                    kept.reshape(batch, -1, kept.shape[-1])], -1))
    return rows


def _mesh_config(run, mesh, dev, lead: bool) -> dict:
    """One configuration of ``MESH_RUNS`` on every rank: serve, then train,
    over the mesh; rank 0 then the same in one process; compares on rank 0
    (every rank sends it its blocks of the parameters and moments)."""
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpoint import flat_leaves, map_tree, to_host
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import steps
    from repro_torch.launch.inputs import make_train_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import full_float32_matmul
    from repro_torch.optim import AdamW

    t0 = time.perf_counter()
    published = get_config(run["arch"])
    cfg = dataclasses.replace(published, dtype="float32",
                              **({"num_layers": run["layers"]} if run["layers"] else {}))
    model = build_model(cfg)
    rules = steps.resolve_rules(cfg, mesh)
    b, p, gen = run["batch"], run["prompt"], run["gen"]
    tb, ts = run["train_batch"], run["train_seq"]
    tokens = make_train_batch(cfg, b, p, seed=1, device=dev)["tokens"]
    data = DataPipeline(cfg, batch=tb, seq=ts, device=dev)
    spec = model.cache_spec(b, p + gen)
    moe = bool(cfg.num_experts)

    def pad(t, s):
        widths = [w for n, m in reversed(list(zip(t.shape, s.shape))) for w in (0, m - n)]
        return torch.nn.functional.pad(t, tuple(widths),
                                       value=s.scale if s.init == "const" else 0)

    def synced(fn, *args):
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t1) * 1e3

    def gap(a, w, relative: bool) -> float:
        """max |a - w| of two host arrays (over max |w| where
        ``relative``), computed on the card."""
        a, w = (torch.from_numpy(x).to(dev) for x in (a, w))
        err = float((a - w).abs().max())
        return err / max(float(w.abs().max()), 1e-30) if relative else err

    def host_moments(opt_state):
        """AdamW's moments as host arrays on rank 0 (every rank calls it)."""
        out = {}
        for key in ("mu", "nu"):
            out[key] = []
            for t in flat_leaves(opt_state[key]):
                leaf = _on_lead(t, lead) if hasattr(t, "device_mesh") else to_host(t)
                if lead:
                    out[key].append(leaf)
        return out

    def run_once(mesh_or_none):
        """Serve, then train, on the mesh or (None) on one device ->
        (logits, tokens, losses, grad norms, params, AdamW's state and its
        moments after the first step, times, collectives, MoE routes per
        call)."""
        on_mesh = mesh_or_none is not None
        m = mesh_or_none if on_mesh else make_mesh((1, 1), ("data", "model"), device=dev)
        r = steps.resolve_rules(cfg, m)
        params = scaled_init(model, torch.Generator(device=dev).manual_seed(0), dev,
                             mesh=m, rules=r)
        prefill, _ = steps.jit_prefill_step(model, m, r, batch=b, seq=p)
        decode, _ = steps.jit_decode_step(model, m, r, batch=b, seq=p + gen)
        opt = AdamW(learning_rate=MESH_LR)
        train, _ = steps.jit_train_step(model, opt, m, r, microbatches=1, batch=tb, seq=ts)
        out = dict(logits=[], tokens=[], losses=[], grad_norms=[], ms={}, collectives={},
                   routes={"serve": [], "train": []})

        def step(fn, *args, tally_key=None, routes="serve", rows=b):
            with contextlib.ExitStack() as stack:
                tally = (stack.enter_context(CollectiveTally())
                         if tally_key and on_mesh else None)
                recorded = stack.enter_context(MOE.recording_routes())
                res, ms = synced(fn, *args)
            if tally is not None:
                out["collectives"][tally_key] = tally.summary()
            out["routes"][routes].append(_route_rows(recorded, rows))
            return res, ms

        with torch.no_grad(), full_float32_matmul():
            (logits, caches), out["ms"]["prefill"] = step(prefill, params, {"tokens": tokens})
            out["logits"].append(to_host(logits))
            caches = map_tree(pad, map_tree(lambda t: torch.from_numpy(to_host(t)).to(dev),
                                            caches), spec)
            decode_ms = []
            for i in range(gen):
                tok = torch.from_numpy(out["logits"][-1].argmax(-1).astype(np.int32)).to(dev)
                out["tokens"].append(tok.cpu().numpy())
                (logits, caches), ms = step(decode, params, caches, {"token": tok[:, None]},
                                            p + i, tally_key="decode_step" if i == 0 else None)
                decode_ms.append(ms)
                out["logits"].append(to_host(logits))
            out["ms"]["decode"] = decode_ms
        del caches
        opt_state = opt.init(params)
        train_ms = []
        with full_float32_matmul():
            for i in range(run["train_steps"]):
                batch = data.batch_at(i)
                (params, opt_state, met), ms = step(
                    train, params, opt_state, batch,
                    tally_key="train_step" if i == 0 else None, routes="train", rows=tb)
                train_ms.append(ms)
                out["losses"].append(float(met["loss"]))
                out["grad_norms"].append(float(met["grad_norm"]))
                if i == 0 and moe:  # held even where a later step's routing differs
                    torch.cuda.empty_cache()
                    out["first_moments"] = host_moments(opt_state)
        out["ms"]["train"] = train_ms
        out["params"], out["opt"] = params, opt_state
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    got = run_once(mesh)
    split = {"mesh": time.perf_counter() - t0}
    peaks = [None] * MESH_RANKS
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated(dev) / 1e9)
    res = {"arch": run["arch"], "layers": cfg.num_layers,
           "published_layers": published.num_layers, "peak_gb_ranks": peaks,
           "mesh": {k: got[k] for k in ("tokens", "losses", "grad_norms", "ms", "collectives")}}
    res["placements"] = {
        "logits": str(steps._logits_sharding(cfg, mesh, rules, b).placements),
        "embedding": str(got["params"]["embed"]["embedding"].placements)}
    torch.cuda.empty_cache()  # the mesh's cached blocks, for the one-process run
    dist.barrier()
    want = None
    if lead:
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        want = run_once(None)
        split["one"] = time.perf_counter() - t1
        res["one_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        # its state on the host: the card holds one compared leaf at a time
        want["params"], want["opt"] = (map_tree(to_host, want[k]) for k in ("params", "opt"))
        torch.cuda.empty_cache()
    dist.barrier()
    if lead:
        res["one"] = {k: want[k] for k in ("tokens", "losses", "grad_norms", "ms")}
        # MoE: the calls' choices and kept flags; a sequence whose routing
        # differs in a call is held at no later step (its caches differ), a
        # train step only while its routing and every earlier step's agree
        held = np.ones((gen + 1, b), dtype=bool)
        flips = {"serve": 0, "train": [0] * run["train_steps"]}
        if moe:
            disturbed = np.zeros(b, dtype=bool)
            for s, (ours, theirs) in enumerate(zip(got["routes"]["serve"],
                                                    want["routes"]["serve"])):
                for a, w in zip(ours, theirs):
                    differ = (a != w).any(-1)
                    flips["serve"] += int(differ.sum())
                    disturbed |= differ.any(-1)
                held[s] = ~disturbed
            for i, (ours, theirs) in enumerate(zip(got["routes"]["train"],
                                                   want["routes"]["train"])):
                flips["train"][i] = sum(int((a != w).any(-1).sum())
                                        for a, w in zip(ours, theirs))
            res["moe_calls"] = sum(len(x) for x in got["routes"]["serve"])
        res["routing_flips"] = flips
        res["positions_held"] = int(held.sum())
        scale = max(float(np.abs(x).max()) for x in want["logits"])
        res["logits_max_rel"] = max(
            (float(np.abs(a - w)[h].max()) / scale
             for a, w, h in zip(got["logits"], want["logits"], held) if h.any()), default=0.0)
        res["tokens_equal"] = all(np.array_equal(a[h], w[h]) for a, w, h in
                                  zip(got["tokens"], want["tokens"], held))
        res["train_steps_held"] = next(
            (i for i, n in enumerate(flips["train"]) if n), run["train_steps"])
        if moe:
            res["first_moments_max_rel"] = {
                key: max(gap(a, w, True) for a, w in zip(got["first_moments"][key],
                                                         want["first_moments"][key]))
                for key in ("mu", "nu")}
            del got["first_moments"], want["first_moments"]
    worst = {"params": 0.0, "mu": 0.0, "nu": 0.0}
    for key in worst:
        tree = got["params"] if key == "params" else got["opt"][key]
        ours = flat_leaves(tree)
        mine = (flat_leaves(want["params"] if key == "params" else want["opt"][key]) if lead
                else [None] * len(ours))
        for leaf, ref in zip(ours, mine):
            full = _on_lead(leaf, lead)  # rank 0 compares
            if lead:  # the moments: a fraction of each leaf's largest
                worst[key] = max(worst[key], gap(full, ref, key != "params"))
            del full
    if lead:
        res["params_max_abs"] = worst["params"]
        res["moments_max_rel"] = {"mu": worst["mu"], "nu": worst["nu"]}
        res["lr"] = MESH_LR
    del got, want
    torch.cuda.empty_cache()
    dist.barrier()
    res["seconds"] = time.perf_counter() - t0
    res["seconds_split"] = split  # the mesh's run, the one process's; the rest compares
    return res


def mesh_rank(rank: int, root: str, labels=None) -> None:
    """One of phase 15's four ranks (``chip_smoke.py --mesh-rank R DIR``):
    the probe, then each configuration of ``MESH_RUNS`` (or those whose
    label is in ``labels``) over the mesh and, on rank 0, in one process
    (:func:`_mesh_config`); rank 0 writes ``DIR/result.json``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, start_group

    import faulthandler

    faulthandler.enable()  # a crash in a collective leaves its stack in the rank's log
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    start_group(str(Path(root) / "store"), rank, MESH_RANKS, timeout_s=MESH_TIMEOUT_S)
    lead = rank == 0
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_gloo_cuda_probe import probe

    res: dict = {"probe": probe(dev)}
    mesh = make_mesh(MESH_SHAPE, ("data", "model"))
    res["probe_functional"] = probe(dev, functional=True)
    res["runs"] = {}
    for run in MESH_RUNS:
        if labels and run["label"] not in labels:
            continue
        res["runs"][run["label"]] = _mesh_config(run, mesh, dev, lead)
        if lead:  # what has run so far, should a later configuration fail
            (Path(root) / "result.json").write_text(json.dumps(res, default=str))
    dist.barrier()
    dist.destroy_process_group()


def mesh_phase(smi: str, labels=None) -> dict:
    """Phase 15: the decoder-only families over a ``(2, 2)`` mesh (DTensor
    placements over a gloo group) of four ranks that share the one card:
    each rank is this script with ``--mesh-rank``. Prints the probe of
    gloo's collectives on CUDA tensors, then for each configuration of
    ``MESH_RUNS`` its prefill, decode (ms a step) and train steps (ms a
    step) over the mesh beside the same in one process, the collectives
    and bytes of one decode and one train step and each rank's peak, and holds the logits, greedy tokens,
    losses, gradient norms, new parameters and AdamW's moments to the run
    in one process on the card; an MoE model's routing is compared call by
    call, and a sequence is held only while its routing agrees. No kernel
    of the port runs on this path (the ranks load none)."""
    import tempfile

    t15 = time.perf_counter()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    extra = ["--labels", ",".join(labels)] if labels else []
    with tempfile.TemporaryDirectory(prefix="mesh-") as root:
        logs = [open(Path(root) / f"rank{r}.log", "w") for r in range(MESH_RANKS)]
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
                                   str(r), root, *extra], env=env, stdout=logs[r],
                                  stderr=subprocess.STDOUT)
                 for r in range(MESH_RANKS)]
        deadline = time.monotonic() + MESH_TIMEOUT_S
        try:
            # until every rank has ended, one has failed (the others would
            # wait in a collective) or the deadline
            while (time.monotonic() < deadline and any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)):
                time.sleep(0.5)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for f in logs:
                f.close()
        failed = {r: (Path(root) / f"rank{r}.log").read_text()[-4000:]
                  for r, proc in enumerate(procs) if proc.returncode != 0}
        if failed:  # the whole logs beside the run's other details
            (ROOT / "chiprun_out").mkdir(exist_ok=True)
            for r in range(MESH_RANKS):
                shutil.copy(Path(root) / f"rank{r}.log", ROOT / "chiprun_out" / f"mesh_rank{r}.log")
            done = Path(root) / "result.json"
            raise AssertionError(f"phase 15: ranks failed (exit codes "
                                 f"{[proc.returncode for proc in procs]}; finished before: "
                                 f"{done.read_text()[:6000] if done.exists() else None}): "
                                 f"{failed}")
        res = json.loads((Path(root) / "result.json").read_text())
    res["seconds"] = time.perf_counter() - t15
    res["card"] = smi
    print(f"phase 15: gloo on CUDA tensors, 4 ranks on one card: torch.distributed "
          f"{json.dumps(res['probe'])}; the functional ops DTensor issues, after make_mesh "
          f"{json.dumps(res['probe_functional'])}")
    for run in MESH_RUNS:
        if run["label"] in res["runs"]:
            _report_mesh_config(run, res["runs"][run["label"]], smi)
    print(f"phase 15: {res['seconds']:.1f} s")
    return res


def mesh_beside(mesh: dict, record: dict) -> None:
    """Print 15a's decode and train steps over the mesh beside phase 12c's
    and 13a's in one process (bfloat16, gemma3 at its full depth)."""
    run = mesh["runs"]["15a"]
    c12 = record.get("serve_lm", {}).get("12c", {}).get("decode_ms_per_step")
    t13 = record.get("train", {}).get("13a", {}).get("median_step_ms")
    print(f"phase 15a beside phases 12c and 13a: decode "
          f"{statistics.median(run['mesh']['ms']['decode'][1:]):.2f} ms/step over the mesh "
          f"({run['layers']} layers, float32) against 12c's {c12} (26 layers, bfloat16, batch "
          f"4); train {[round(x, 1) for x in run['mesh']['ms']['train']]} ms against 13a's "
          f"median {t13} (M = 4)")


def _report_mesh_config(run, res: dict, smi: str) -> None:
    """Print one configuration of phase 15 and fail where it does not hold."""
    label = run["label"]
    mesh_ms, one_ms = res["mesh"]["ms"], res["one"]["ms"]
    dec = statistics.median(mesh_ms["decode"][1:])
    dec_one = statistics.median(one_ms["decode"][1:])
    cut = (f"{res['layers']} of {res['published_layers']} layers" if run["layers"]
           else f"{res['layers']} layers")
    print(f"phase {label}: {run['arch']} full width ({cut}; batch {run['batch']} prompt "
          f"{run['prompt']} gen {run['gen']}, train batch {run['train_batch']} x "
          f"{run['train_seq']}), float32 TF32 off, scaled_init, over a {MESH_SHAPE} mesh of "
          f"{MESH_RANKS} ranks (gloo) on {smi}: prefill {mesh_ms['prefill']:.1f} ms (first "
          f"call), decode {dec:.2f} ms/step (median of steps 1-{len(mesh_ms['decode']) - 1}; "
          f"step 0 {mesh_ms['decode'][0]:.1f} ms), train steps "
          f"{[round(x, 1) for x in mesh_ms['train']]} ms; one process: prefill "
          f"{one_ms['prefill']:.1f} ms, decode {dec_one:.2f} ms/step, train "
          f"{[round(x, 1) for x in one_ms['train']]} ms; peak GB a rank "
          f"{[round(x, 2) for x in res['peak_gb_ranks']]}, one process "
          f"{res['one_peak_gb']:.2f} GB; {res['seconds']:.1f} s (mesh "
          f"{res['seconds_split']['mesh']:.1f}, one process {res['seconds_split']['one']:.1f})")
    print(f"phase {label}: collectives of one decode step "
          f"{json.dumps(res['mesh']['collectives']['decode_step'])}; of one train step "
          f"{json.dumps(res['mesh']['collectives']['train_step'])}")
    moe = ""
    steps_held = res["train_steps_held"]
    if "moe_calls" in res:
        moe = (f"; MoE routing of {res['moe_calls']} serving calls: "
               f"{res['routing_flips']['serve']} (token, call) choices or drops differ from "
               f"one process, {res['routing_flips']['train']} in each train step; held at "
               f"{res['positions_held']} of {(run['gen'] + 1) * run['batch']} (step, sequence) "
               f"positions and {steps_held} of {run['train_steps']} train steps")
    print(f"phase {label}: against one process: logits {res['logits_max_rel']:.3g} of max "
          f"|logit| (declared {MESH_SERVE_RTOL}), greedy tokens "
          f"{'equal' if res['tokens_equal'] else 'DIFFER'}, losses {res['mesh']['losses']} vs "
          f"{res['one']['losses']}, grad norms {res['mesh']['grad_norms']} vs "
          f"{res['one']['grad_norms']}; AdamW's moments"
          + (f" after the first step within {json.dumps(res['first_moments_max_rel'])} of each "
             f"leaf's largest," if "first_moments_max_rel" in res else "")
          + f" after the last within {json.dumps(res['moments_max_rel'])} (declared mu "
          f"{MESH_MOMENT_RTOL}, nu "
          f"{2 * MESH_MOMENT_RTOL}), new parameters within {res['params_max_abs']:.3g} (2 lr = "
          f"{2 * MESH_LR}){moe}; placements {res['placements']}")
    if res["logits_max_rel"] > MESH_SERVE_RTOL or not res["tokens_equal"]:
        raise AssertionError(f"phase {label}: the mesh's logits or greedy tokens differ from "
                             "one process")
    if not res["positions_held"] or not steps_held:
        raise AssertionError(f"phase {label}: the routing differs from one process in the "
                             f"prefill or the first train step")
    for key, tol in (("losses", MESH_LOSS_RTOL), ("grad_norms", MESH_GN_RTOL)):
        for a, w in list(zip(res["mesh"][key], res["one"][key]))[:steps_held]:
            if not (math.isfinite(a) and abs(a - w) <= tol * abs(w)):
                raise AssertionError(f"phase {label}: {key} {a} vs {w} beyond {tol}")
    final = ((res["moments_max_rel"],) if steps_held == run["train_steps"] else ())
    first = (res["first_moments_max_rel"],) if "first_moments_max_rel" in res else ()
    for worst in first + final:
        for key, tol in (("mu", MESH_MOMENT_RTOL), ("nu", 2 * MESH_MOMENT_RTOL)):
            if not worst[key] <= tol:
                raise AssertionError(f"phase {label}: AdamW's {key} {worst[key]} of a leaf's "
                                     f"largest beyond {tol}")
    if final and not res["params_max_abs"] <= 2 * MESH_LR * (1 + 1e-5):
        raise AssertionError(f"phase {label}: new parameters {res['params_max_abs']} beyond "
                             "2 lr")


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
    # phase 15 first: its four ranks and its one-process runs need the card
    # to themselves, before this process holds the other phases' tensors
    mesh_record = mesh_phase(smi)
    t0 = time.perf_counter()
    _build.library()
    took = time.perf_counter() - t0
    print(f"build: {', '.join(s.name for s in _build.SOURCES)} built and loaded in {took:.1f} s")
    record: dict = {"card": smi, "device": name, "torch": torch.__version__, "build_s": took}
    tally = AccumTally(_build)

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

    def tmpframe_paths() -> list[tuple[int, int]]:
        """B10's (vector, scalar) launches of pass A and of pass B."""
        return [(f.vector_launches, f.scalar_launches)
                for f in (denoise_tmpframe.subtract_pass, denoise_tmpframe.reduce_pass)]

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
        for tp in (24, 25, 28):  # the long tile's chain and its 8 lanes (with a rest)
            ema_case(wire((2, 4 * tp, 16), fmt), fmt, tp, f"G=2 N={4 * tp} 16x256 {fmt} "
                     f"pair_tile={tp}", hw=(16, W))
        for tp in (50, 500):  # windows of 32 at the paper's shape: 10 chunks, one chunk
            ema_case(wire((g, 1000, H), fmt), fmt, tp, f"G={g} N=1000 {fmt} pair_tile={tp}")
        new_cases += 13
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
    # B10, Alg 1 and Alg 2, in every float type at G = 3/5/8 (a division by G
    # would differ at G = 3 and 5) and 65/100 (bfloat16's true division on the
    # vector path): on the paper's plane (N = 64; 16 above G = 64), on 40x132
    # (a row of 16 half vectors and 4 pixels over, the next starting mid-vector;
    # a partial warp), on 7x130 (H*W = 910: both passes' scalar paths) and at
    # the main path's N = 1000, G = 8; each pass's path counted, pass B also on
    # a tmpFrame view one element into its buffer (its scalar path)
    b10_cases = 0
    b10_planes = [((n, H, W), "vector") for n in (64, 16)] + [
        ((14, 40, 132), "vector"), ((6, 7, 130), "scalar")]
    b10_runs = [(g, plane, path) for g in (3, 5, 8, 65, 100) for plane, path in b10_planes
                if (plane[0] == 16) == (g > 8)] + [(8, (1000, H, W), "vector")]
    b10_rng = np.random.default_rng(31)
    for g, (n, h, w), path in b10_runs:
        if (g, n, h, w) in ((5, 64, H, W), (8, 64, H, W)):
            frames = wire((g, n, h), "u16")  # the draws of the later phases stay as they were
        else:
            frames = torch.from_numpy(b10_rng.integers(0, 4096, (g, n, h, w)).astype(np.uint16))
        for acc in denoise_stream.FLOAT_ACCUMS:
            what = f"{str(acc).replace('torch.', '')} G={g} N={n} {h}x{w} u16"
            kw = dict(offset=offset, accum_dtype=acc)
            before = tmpframe_paths()
            want = denoise_tmpframe.alg1_subtract_average_plain(frames, **kw)
            for k in BASELINE_PATH:
                same(k, wrappers[k](frames.to(dev), **kw), want, what)
            tmp = shifted(denoise_tmpframe.subtract_pass_plain(frames, **kw))
            same("alg1_subtract_average", denoise_tmpframe.reduce_pass(tmp), want,
                 f"{what}, pass B on a view one element in")
            took = [(v - v0, s - s0) for (v, s), (v0, s0) in zip(tmpframe_paths(), before)]
            if took != ([(2, 0), (2, 1)] if path == "vector" else [(0, 2), (0, 3)]):
                raise AssertionError(f"B10 {what}: passes A, B took {took} (vector, scalar) "
                                     f"launches, want the {path} paths")
            b10_cases += 1
        del frames, tmp
    torch.cuda.synchronize()
    print(f"phase 1: B6/B7/B8 bitwise equal to the CPU plain versions in {new_cases} cases "
          f"(u16/u8/p12, G=5/8, K=1/4/5; B8 also with 500 chunks, one chunk of 32 pairs, "
          f"a ragged 7x130 plane, pair_tile 2/3/6/7/8, 24/25/28 and, at N=1000, 50 and 500) "
          f"and B8 at N=1000 with 100 chunks; B7 "
          f"at K=65/100 (selection path); B9 on {len(b9_planes)} planes (both tile paths) box bitwise, "
          f"bilateral max relative diff {bilateral_rel:.3g} (declared "
          f"{denoise_spatial.BILATERAL_RTOL:g}); B10 Alg 1 and Alg 2 bitwise equal to the CPU "
          f"plain version in {b10_cases} cases (float32/float16/bfloat16, G=3/5/8/65/100 on "
          f"80x256, 40x132 and 7x130, G=8 at N=1000; each pass on the path its planes allow, "
          f"pass B also on an unaligned view) ({time.perf_counter() - t1:.1f} s)")
    record.update(bilateral_max_rel=bilateral_rel, b10_cases=b10_cases)

    # B2-B10 with float16 and bfloat16 accumulators (the scalar paths), and
    # B2-B5 with p12 wire into int32/uint16 sums, against their plain versions
    # on the CPU: bitwise, output dtype included; a float16 M2 of 12-bit
    # differences overflows to inf and its merges make NaN in the same places
    # on both (as in the reference), so NaN is held to NaN
    t1 = time.perf_counter()

    def same_nan(kernel: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        got = got.cpu()
        nan = torch.isnan(want)
        if (got.shape != want.shape or got.dtype != want.dtype
                or not torch.equal(torch.isnan(got), nan) or not torch.equal(got[~nan], want[~nan])):
            err = diff_max(got[~nan], want[~nan]) if got.shape == want.shape else float("nan")
            raise AssertionError(f"{kernel} {what}: not bitwise equal to its plain version "
                                 f"(max |diff| {err}, {got.dtype} against {want.dtype})")
        max_err[kernel] = max(max_err[kernel], diff_max(got[~nan], want[~nan]))

    def near_wire(shape, fmt, width=W):
        """Frames whose control and excitation differ by at most 12."""
        px = rng.integers(64, 4032, shape + (width,)).astype(np.int32)
        px[..., 1::2, :, :] = px[..., 0::2, :, :] + rng.integers(-12, 13, px[..., 1::2, :, :].shape)
        return torch.from_numpy(np.ascontiguousarray(quant.encode(px.astype(np.uint16), fmt)))

    def ema_half(frames, fmt, tp, off, acc, what):
        """B8 in a half type over ``frames`` (G, N, h, wire_w) from zero
        states, card against plain; returns the plain states."""
        g, n, h = frames.shape[:3]
        hw = (h, quant.logical_width(frames.shape[-1], fmt))
        gpu = [torch.zeros(n // 2, *hw, dtype=acc, device=dev),
               torch.zeros(hw, dtype=acc, device=dev), torch.zeros(hw, dtype=acc, device=dev)]
        cpu = [t.cpu().clone() for t in gpu]
        for k in range(g):
            kw = dict(alpha=0.3, offset=off, prior_count=k * (n // 2), pair_tile=tp,
                      stream_dtype=fmt)
            denoise_ema.ema_welford_step(*gpu, frames[k].to(dev), **kw)
            cpu = list(denoise_ema.ema_welford_step_plain(*cpu, frames[k], **kw))
        for a, b in zip(gpu, cpu):
            same_nan("ema_welford_step", a, b, what)
        return cpu

    half_cases = 0
    for acc in HALF_TYPES:
        tag = str(acc).replace("torch.", "")
        for g, fmt, df in [(g, f, d) for g in (5, 8) for f in quant.STREAM_DTYPES for d in (False, True)]:
            for n, (h, w) in ((64, (H, W)), (12, (7, 130))):  # the paper's plane and a ragged one
                what = f"{tag} G={g} N={n} {h}x{w} {fmt} {'divide_first' if df else 'divide_last'}"
                kw = dict(offset=offset, divide_first=df, stream_dtype=fmt)
                banked = wire((2, g, n, h), fmt, width=w)
                s1 = torch.zeros(n // 2, h, w, dtype=acc, device=dev)
                s2 = torch.zeros(2, n // 2, h, w, dtype=acc, device=dev)
                c1, c2 = s1.cpu().clone(), s2.cpu().clone()
                for k in range(g):
                    chunk, fin = banked[:, k].contiguous(), k == g - 1
                    denoise_stream.alg3_stream_step(chunk[0].to(dev), s1, num_groups=g, final=fin, **kw)
                    c1 = denoise_stream.alg3_stream_step_plain(chunk[0], c1, num_groups=g, final=fin, **kw)
                    denoise_multibank.multibank_stream_step(chunk.to(dev), s2, num_groups=g, **kw)
                    c2 = denoise_multibank.multibank_stream_step_plain(chunk, c2, num_groups=g, **kw)
                same_nan("alg3_stream_step", s1, c1, what)
                same_nan("multibank_stream_step", s2, c2, what)
                kw["accum_dtype"] = acc
                same_nan("alg3_subtract_average",
                         denoise_stream.alg3_subtract_average(banked[0].to(dev), **kw),
                         denoise_stream.alg3_subtract_average_plain(banked[0], **kw), what)
                same_nan("multibank_subtract_average",
                         denoise_multibank.multibank_subtract_average(banked.to(dev), **kw),
                         denoise_multibank.multibank_subtract_average_plain(banked, **kw), what)
                half_cases += 1
        for g in (5, 8):
            for fmt in quant.STREAM_DTYPES:
                for n, (h, w) in ((64, (H, W)), (12, (7, 130))):
                    what = f"{tag} G={g} N={n} {h}x{w} {fmt}"
                    frames = wire((g, n, h), fmt, width=w)
                    w_gpu = torch.zeros(5, n // 2, h, w, dtype=acc, device=dev)
                    w_cpu = w_gpu.cpu().clone()
                    for k in range(g):  # B6: the 5-slot ring wraps at G = 8
                        kw = dict(slot=k % 5, offset=offset, stream_dtype=fmt)
                        denoise_median.median_window_insert(w_gpu, frames[k].to(dev), **kw)
                        denoise_median.median_window_insert_plain(w_cpu, frames[k], **kw)
                    same_nan("median_window_insert", w_gpu, w_cpu, what)
                    for k in (1, 4, 5):  # B7, even and odd K
                        same_nan("median_combine", denoise_median.median_combine(w_gpu[:k]),
                                 denoise_median.median_combine_plain(w_cpu[:k]), f"{what} K={k}")
                    for tp in ((2, 8) if n == 64 else (3,)):  # B8: 16 and 4 chunks a group
                        gpu = [torch.zeros(n // 2, h, w, dtype=acc, device=dev),
                               torch.zeros(h, w, dtype=acc, device=dev),
                               torch.zeros(h, w, dtype=acc, device=dev)]
                        cpu = [t.cpu().clone() for t in gpu]
                        for k in range(g):
                            kw = dict(alpha=0.3, offset=offset, prior_count=k * (n // 2),
                                      pair_tile=tp, stream_dtype=fmt)
                            denoise_ema.ema_welford_step(*gpu, frames[k].to(dev), **kw)
                            cpu = list(denoise_ema.ema_welford_step_plain(*cpu, frames[k], **kw))
                        for a, b in zip(gpu, cpu):
                            same_nan("ema_welford_step", a, b, f"{what} pair_tile={tp}")
                    half_cases += 1
            frames = wire((g, 64, H), "u16")  # B10, Alg 1 and Alg 2, on the vector paths
            want = denoise_tmpframe.alg1_subtract_average_plain(frames, offset=offset, accum_dtype=acc)
            before = tmpframe_paths()
            for k in BASELINE_PATH:
                same_nan(k, wrappers[k](frames.to(dev), offset=offset, accum_dtype=acc), want,
                         f"{tag} G={g} N=64 u16")
            took = [(v - v0, s - s0) for (v, s), (v0, s0) in zip(tmpframe_paths(), before)]
            if took != [(2, 0)] * 2:
                raise AssertionError(f"B10 {tag} G={g} N=64: passes A, B took {took} (vector, "
                                     f"scalar) launches, want the vector paths")
        for g in (5, 8):  # B8 on pairs within +-12 at offset 0: a finite float16 M2
            for fmt in quant.STREAM_DTYPES:
                for n, (h, w), tps in ((64, (H, W), (2, 8)), (12, (7, 130), (3,))):
                    what = f"{tag} G={g} N={n} {h}x{w} {fmt} offset 0 near pairs"
                    frames = near_wire((g, n, h), fmt, width=w)
                    for tp in tps:
                        gpu = [torch.zeros(n // 2, h, w, dtype=acc, device=dev),
                               torch.zeros(h, w, dtype=acc, device=dev),
                               torch.zeros(h, w, dtype=acc, device=dev)]
                        cpu = [t.cpu().clone() for t in gpu]
                        for k in range(g):
                            kw = dict(alpha=0.3, offset=0.0, prior_count=k * (n // 2),
                                      pair_tile=tp, stream_dtype=fmt)
                            denoise_ema.ema_welford_step(*gpu, frames[k].to(dev), **kw)
                            cpu = list(denoise_ema.ema_welford_step_plain(*cpu, frames[k], **kw))
                        if not torch.isfinite(cpu[2]).all():
                            raise AssertionError(f"ema_welford_step {what}: M2 not finite")
                        for a, b in zip(gpu, cpu):
                            same_nan("ema_welford_step", a, b, f"{what} pair_tile={tp}")
                    half_cases += 1
        # B8: every register tile and long order of its one body, one group
        # (a prior count is held by the G = 5/8 cases above)
        for fmt in quant.STREAM_DTYPES:
            for tp in HALF_EMA_TILES:
                n = 2 * (9 if tp <= 8 else 2) * tp  # two chunk rounds, or two long chunks
                for h, w in ((H, W), (7, 130)):
                    for off, make in ((offset, wire), (0.0, near_wire)):
                        what = f"{tag} G=1 N={n} {h}x{w} {fmt} pair_tile={tp} offset={off:g}"
                        cpu = ema_half(make((1, n, h), fmt, width=w), fmt, tp, off, acc, what)
                        if off == 0.0 and not torch.isfinite(cpu[2]).all():
                            raise AssertionError(f"ema_welford_step {what}: M2 not finite")
                        half_cases += 1
        # B9: box and bilateral bitwise, on its four-pixel path (W % 4 == 0,
        # 8-byte aligned planes) and its scalar path (W = 130, a view 2 bytes in)
        for shape, place, path in (((32, H, W), to_dev, "vector"), ((4, 7, 130), to_dev, "scalar"),
                                   ((4, H, W), shifted, "scalar")):
            for base, noise in ((4096, 40), (300, 20)):  # around 300 the weights matter
                x = (base + noise * torch.from_numpy(rng.standard_normal(shape))).to(acc)
                x[:, 3, 5] += 900.0  # a hot pixel
                what = (f"{tag} " + "x".join(map(str, shape)) + f" around {base}"
                        + (" unaligned" if place is shifted else ""))
                before = (spatial.vector_launches, spatial.scalar_launches)
                xd = place(x)
                same_nan("spatial_filter_3x3", spatial(xd, mode="box"),
                         denoise_spatial.spatial_filter_3x3_plain(x, mode="box"), f"{what} box")
                for sigma in (10.0, 60.0):
                    kw = dict(mode="bilateral", range_sigma=sigma)
                    same_nan("spatial_filter_3x3", spatial(xd, **kw),
                             denoise_spatial.spatial_filter_3x3_plain(x, **kw),
                             f"{what} bilateral sigma {sigma}")
                took = (spatial.vector_launches - before[0], spatial.scalar_launches - before[1])
                if took != ((3, 0) if path == "vector" else (0, 3)):
                    raise AssertionError(f"B9 {what}: launches {took} on (vector, scalar), "
                                         f"want the {path} path")
                half_cases += 1
    p12_cases = 0
    for off in (0.0, offset):  # p12 wire into integer sums, G = 10, the uint16 sums wrapping
        banked = torch.from_numpy(np.ascontiguousarray(quant.encode(int_wire((2, 10, 64, H)).numpy(),
                                                                     "p12")))
        for acc in (torch.int32, torch.uint16):
            for df in (False, True):
                what = f"G=10 N=64 p12 {acc} offset={off:g} {'divide_first' if df else 'divide_last'}"
                kw = dict(offset=off, divide_first=df, stream_dtype="p12")
                s1 = torch.zeros(32, H, W, dtype=acc, device=dev)
                s2 = torch.zeros(2, 32, H, W, dtype=acc, device=dev)
                c1, c2 = s1.cpu().clone(), s2.cpu().clone()
                for k in range(10):
                    chunk, fin = banked[:, k].contiguous(), k == 9
                    denoise_stream.alg3_stream_step(chunk[0].to(dev), s1, num_groups=10, final=fin, **kw)
                    c1 = denoise_stream.alg3_stream_step_plain(chunk[0], c1, num_groups=10, final=fin, **kw)
                    denoise_multibank.multibank_stream_step(chunk.to(dev), s2, num_groups=10, **kw)
                    c2 = denoise_multibank.multibank_stream_step_plain(chunk, c2, num_groups=10, **kw)
                same("alg3_stream_step", s1, c1, what)
                same("multibank_stream_step", s2, c2, what)
                kw["accum_dtype"] = acc
                same("alg3_subtract_average", denoise_stream.alg3_subtract_average(banked[0].to(dev), **kw),
                     denoise_stream.alg3_subtract_average_plain(banked[0], **kw), what)
                same("multibank_subtract_average",
                     denoise_multibank.multibank_subtract_average(banked.to(dev), **kw),
                     denoise_multibank.multibank_subtract_average_plain(banked, **kw), what)
                p12_cases += 1
    torch.cuda.synchronize()
    print(f"phase 1: float16/bfloat16 accumulators bitwise equal to the CPU plain versions in "
          f"{half_cases} cases (B2-B5 at G=5/8 u16/u8/p12 both variants on 80x256 and a ragged "
          f"7x130 plane; B6/B7 K=1/4/5; B8 pair_tile 2/8 and 3, also on pairs within +-12 at "
          f"offset 0 with a finite M2, and every register tile and long order "
          f"{'/'.join(map(str, HALF_EMA_TILES))} on 80x256 and 7x130 at offset 4096 and on near "
          f"pairs at offset 0; B9 box and bilateral around 4096 and 300 on its four-pixel and "
          f"scalar paths (7x130, a view 2 bytes in); B10 Alg 1/2); "
          f"B2-B5 with p12 wire into int32/uint16 sums in {p12_cases} cases (G=10, offset 0 "
          f"and 4096) ({time.perf_counter() - t1:.1f} s)")
    record.update(half_cases=half_cases, p12_int_cases=p12_cases,
                  half_phase1_s=time.perf_counter() - t1)

    # B3/B5 on their vector path and its edges, every wire format x float sum
    # x variant, B = 1 (bank 0) and B = 2: G = 5 and 8, offset 0 and 4096, one
    # pixel in eight at the wire's largest value (65535, 255, 4095) and one at
    # 0, on 40 x 136 (680 u16 / 340 u8 and p12 vectors: a partial last block
    # and warp); one vector a plane; the scalar path on a ragged 7 x 130 plane
    # and on views 2 (p12: 3) and 8 bytes in, which p12's 8-byte loads take;
    # every exact-divisor tile at 40 x 136 with 6 pairs, bitwise the default
    # launch. Bitwise, the sign of zero included, NaN held to NaN.
    t1 = time.perf_counter()
    b3, b5 = denoise_stream.alg3_subtract_average, denoise_multibank.multibank_subtract_average
    bits = {torch.float32: torch.int32, torch.float16: torch.int16, torch.bfloat16: torch.int16}

    def same_bits(kernel: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        same_nan(kernel, got, want, what)
        nan = torch.isnan(want)
        if not torch.equal(got.cpu()[~nan].view(bits[want.dtype]), want[~nan].view(bits[want.dtype])):
            raise AssertionError(f"{kernel} {what}: a zero's sign differs from its plain version")

    orng = np.random.default_rng(29)  # the later phases' draws stay as they were

    def extreme_wire(shape, fmt, width):
        px = orng.integers(0, 4096, shape + (width,)).astype(np.uint16)
        pick = orng.random(px.shape)
        px[pick < 0.125], px[pick > 0.875] = 4095, 0
        out = quant.encode(px, fmt)
        if fmt == "u16":
            out = np.where(out == 4095, np.uint16(65535), out)
        return torch.from_numpy(np.ascontiguousarray(out))

    def oneshot_paths() -> list[tuple[int, int]]:
        return [(f.vector_launches, f.scalar_launches) for f in (b3, b5)]

    def at_shift(t: torch.Tensor, shift_bytes: int) -> torch.Tensor:
        n = shift_bytes // t.element_size()
        buf = torch.empty(t.numel() + n, dtype=t.dtype, device=dev)
        view = buf[n:].view(t.shape)
        view.copy_(t)
        return view

    def oneshot_case(banked, acc, kw, shift_bytes, what) -> str:
        """B3 on bank 0 and B5 on both against their plain versions; returns
        the path both took (they must agree with ``oneshot_path``)."""
        before = oneshot_paths()
        kw = dict(kw, accum_dtype=acc)
        same_bits("alg3_subtract_average", b3(at_shift(banked[0], shift_bytes), **kw),
                  denoise_stream.alg3_subtract_average_plain(banked[0], **kw), what)
        same_bits("multibank_subtract_average", b5(at_shift(banked, shift_bytes), **kw),
                  denoise_multibank.multibank_subtract_average_plain(banked, **kw), what)
        h, w = banked.shape[-2], quant.logical_width(banked.shape[-1], kw["stream_dtype"])
        path = denoise_stream.oneshot_path(h * w, kw["stream_dtype"], 4096 + shift_bytes, 4096)
        took = [(v - v0, s - s0) for (v, s), (v0, s0) in zip(oneshot_paths(), before)]
        if took != [(1, 0) if path == "vector" else (0, 1)] * 2:
            raise AssertionError(f"{what}: B3/B5 took {took}, not the {path} path")
        return path

    vec_cases, edge_cases, tile_cases = 0, 0, 0
    for fmt in quant.STREAM_DTYPES:
        for acc in denoise_stream.FLOAT_ACCUMS:
            tag = str(acc).replace("torch.", "")
            for g in (5, 8) + ((65, 100) if acc == torch.bfloat16 else ()):  # bfloat16: / G
                banked = extreme_wire((2, g, 4, 40), fmt, 136)
                for off in (0.0, offset):
                    for df in (False, True):
                        what = f"{tag} G={g} 40x136 {fmt} offset={off:g} {'v2' if df else 'v1'}"
                        kw = dict(offset=off, divide_first=df, stream_dtype=fmt)
                        if oneshot_case(banked, acc, kw, 0, what) != "vector":
                            raise AssertionError(f"{what}: not the vector path")
                        vec_cases += 1
            for (h, w), shift in (((1, 8), 0), ((1, 16), 0), ((7, 130), 0),
                                  ((40, 136), 3 if fmt == "p12" else 2), ((40, 136), 8)):
                banked = extreme_wire((2, 5, 4, h), fmt, w)
                for df in (False, True):
                    what = f"{tag} G=5 {h}x{w} {fmt} {shift} bytes in {'v2' if df else 'v1'}"
                    oneshot_case(banked, acc, dict(offset=offset, divide_first=df,
                                                   stream_dtype=fmt), shift, what)
                    edge_cases += 1
            banked = extreme_wire((2, 3, 12, 40), fmt, 136).to(dev)
            kw = dict(offset=offset, stream_dtype=fmt, accum_dtype=acc)
            want3, want5 = b3(banked[0], **kw).cpu(), b5(banked, **kw).cpu()
            same_bits("alg3_subtract_average", want3,
                      denoise_stream.alg3_subtract_average_plain(banked[0].cpu(), **kw), tag)
            for th in (1, 2, 4, 5, 8, 10, 20, 40):
                for tp in (1, 2, 3, 6):
                    what = f"{tag} G=3 40x136 {fmt} row_tile={th} pair_tile={tp}"
                    same_bits("alg3_subtract_average", b3(banked[0], row_tile=th, pair_tile=tp, **kw),
                              want3, what)
                    same_bits("multibank_subtract_average",
                              b5(banked, row_tile=th, pair_tile=tp, **kw), want5, what)
                    tile_cases += 1
    # the vector path's bfloat16 x / G against the true division, every
    # bfloat16 value, G = 1..64
    every_bf16 = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    every_dev = every_bf16.to(dev)
    for g in range(1, 65):
        true_q = denoise_stream.bf16_quotient_probe(every_dev, g, true_division=True)
        same_bits("alg3_subtract_average", true_q, (every_bf16.float() / g).to(torch.bfloat16),
                  f"bfloat16 true quotient, G={g}")
        same_bits("alg3_subtract_average", denoise_stream.bf16_quotient_probe(every_dev, g),
                  true_q.cpu(), f"bfloat16 quotient rule, G={g}")
    # B6 on both paths: every format and window type, 8 groups into a 5-slot
    # window that wraps, the default layout and two plan geometries, each
    # launch on the path insert_path names
    ins = wrappers["median_window_insert"]
    b6_cases = 0
    b6_shapes = (((64, H, W), 0, ((8, 4), (H, 2))), ((12, 7, 130), 0, ((7, 3), (1, 2))),
                 ((12, 40, 136), None, ((8, 3), (40, 1))))
    for fmt in quant.STREAM_DTYPES:
        for acc in denoise_stream.FLOAT_ACCUMS:
            tag = str(acc).replace("torch.", "")
            for (n, h, w), shift, geoms in b6_shapes:
                shift = (3 if fmt == "p12" else 2) if shift is None else shift
                frames = extreme_wire((8, n, h), fmt, w)
                want_w = torch.zeros(5, n // 2, h, w, dtype=acc)
                for k in range(8):
                    denoise_median.median_window_insert_plain(
                        want_w, frames[k], slot=k % 5, offset=offset, stream_dtype=fmt)
                path = denoise_median.insert_path(h * w, fmt, 4096 + shift, 4096)
                if path != ("vector" if (h, w) == (H, W) else "scalar"):
                    raise AssertionError(f"B6 {fmt} {h}x{w} {shift} bytes in: {path} path")
                placed = [at_shift(frames[k], shift) for k in range(8)]
                for th, tp in ((None, None),) + geoms:
                    what = (f"{tag} G=8 N={n} {h}x{w} {fmt} {shift} bytes in "
                            f"row_tile={th} pair_tile={tp}")
                    before = (ins.vector_launches, ins.scalar_launches)
                    got_w = torch.zeros(5, n // 2, h, w, dtype=acc, device=dev)
                    for k in range(8):
                        ins(got_w, placed[k], slot=k % 5, offset=offset, stream_dtype=fmt,
                            row_tile=th, pair_tile=tp)
                    same_bits("median_window_insert", got_w, want_w, what)
                    took = (ins.vector_launches - before[0], ins.scalar_launches - before[1])
                    if took != ((8, 0) if path == "vector" else (0, 8)):
                        raise AssertionError(f"B6 {what}: took {took}, not the {path} path")
                    b6_cases += 1
    torch.cuda.synchronize()
    print(f"phase 1: B6 bitwise equal to its plain version in {b6_cases} cases (u16/u8/p12 x "
          f"float32/float16/bfloat16, 8 groups into a 5-slot window, the default layout and "
          f"two plan geometries each): 80x256 on the vector path, 7x130 and a view 2 (p12: 3) "
          f"bytes in on the scalar path, the launches counted")
    record.update(insert_cases=b6_cases)
    torch.cuda.synchronize()
    print(f"phase 1: B3/B5 bitwise equal to the CPU plain versions on the vector path in "
          f"{vec_cases} cases (u16/u8/p12 x float32/float16/bfloat16 x v1/v2, G=5/8 and "
          f"bfloat16 also G=65/100, offset 0 and 4096, extreme wire values, 40x136), on {edge_cases} edge cases (one vector a "
          f"plane, a ragged 7x130 plane and views 2/3 and 8 bytes in, each on the path "
          f"oneshot_path names), and in {tile_cases} tiled launches (each format and sum at 32 "
          f"row_tile x pair_tile), bitwise the default launch; the bfloat16 quotient rule "
          f"equal to the true division on all 65536 bfloat16 values, G=1..64 "
          f"({time.perf_counter() - t1:.1f} s)")
    record.update(oneshot_vector_cases=vec_cases, oneshot_edge_cases=edge_cases,
                  oneshot_tile_cases=tile_cases, oneshot_phase1_s=time.perf_counter() - t1)

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

    # every filter with float16 and bfloat16 accumulators at G = 5:
    # run_pipelined, the one-shot call, and run_pipelined_banked over
    # BankMesh(cuda:0, cuda:0) against the same runs on the CPU (bitwise, NaN
    # to NaN)
    t1 = time.perf_counter()
    half_filters = {
        "pair_average": {}, "pair_average v2 u8": dict(algorithm="alg3_v2", stream_dtype="u8"),
        "pair_average p12": dict(stream_dtype="p12"),
        "temporal_median": dict(filter_name="temporal_median", median_window=3),
        "ema_variance": dict(filter_name="ema_variance"),
        "spatial_box box": dict(filter_name="spatial_box", spatial_mode="box"),
        "spatial_box bilateral": dict(filter_name="spatial_box"),
    }
    meshes = {"cuda": BankMesh(("cuda:0", "cuda:0")), "cpu": BankMesh(("cpu", "cpu"))}
    half_runs = 0
    for acc in HALF_TYPES:
        tag = str(acc).replace("torch.", "")
        for label, extra in half_filters.items():
            cfg5 = DenoiseConfig(num_groups=5, frames_per_group=64, accum_dtype=tag, **extra)
            cfg5b = dataclasses.replace(cfg5, num_banks=2)
            groups5 = list(PrismSource(cfg5, seed=9).groups())
            per_bank = [list(src) for src in PrismSource(cfg5b, seed=10).bank_sources(2)]
            runs5 = {
                "run_pipelined": lambda d: streaming.run_pipelined(cfg5, iter(groups5), device=d)[0],
                "one-shot": lambda d: StreamingDenoiser(cfg5, device=d)(np.stack(groups5)),
                "run_pipelined_banked": lambda d: run_pipelined_banked(
                    cfg5b, [iter(g) for g in per_bank], meshes[d])[0],
            }
            for run, call in runs5.items():
                got, want = call("cuda").cpu(), call("cpu")
                what = f"G=5 {tag} {label} {run}"
                if got.dtype != acc or want.dtype != acc:
                    raise AssertionError(f"{what}: outputs {got.dtype} and {want.dtype}")
                if not torch.equal(torch.isnan(got), torch.isnan(want)) or not torch.equal(
                        got.nan_to_num(0.0), want.nan_to_num(0.0)):
                    raise AssertionError(f"{what}: card and CPU differ")
                half_runs += 1
    torch.cuda.synchronize()
    print(f"phase 1b: float16/bfloat16 accumulators at G=5 N=64 80x256: {half_runs} runs of "
          f"{', '.join(half_filters)} (run_pipelined, one-shot, run_pipelined_banked over "
          f"BankMesh(cuda:0, cuda:0)) on the card equal to the same runs on the CPU "
          f"({time.perf_counter() - t1:.1f} s)")
    record.update(half_executor_runs=half_runs, half_phase1b_s=time.perf_counter() - t1)

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
    two_path = steps + (wrappers["alg3_subtract_average"], wrappers["multibank_subtract_average"])
    for fn in two_path:
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
    scalar = {f.__name__: f.scalar_launches for f in two_path if f.vector_launches != f.launches}
    if scalar:
        raise AssertionError(f"B2-B5 launches at the paper's shape took the scalar path: {scalar}")
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
    # float16 and bfloat16 accumulators (the scalar paths) at the same shapes:
    # every sum, window, state and frame moves 2 bytes a pixel; and p12 wire
    # into int32/uint16 sums on the steps
    # each format's frames are made once (host synthesis and packing take
    # seconds at this size): two banks of G groups; B3 reads bank 0, the
    # steps and B6/B8 its first group
    half_first = len(rows)
    one_shots = (("alg3_subtract_average", (), denoise_stream.alg3_subtract_average,
                  denoise_stream.alg3_subtract_average_plain),
                 ("multibank_subtract_average", (2,), denoise_multibank.multibank_subtract_average,
                  denoise_multibank.multibank_subtract_average_plain))
    first_group = {}
    for fmt in quant.STREAM_DTYPES:
        isz = quant.wire_pixel_bytes(fmt)
        banked = wire((2, G, N, H), fmt).to(dev)
        inputs = {(): banked[0], (2,): banked}
        frames1, frames2 = banked[0, 0], banked[:, 0].contiguous()
        first_group[fmt] = frames1.clone()
        accs = HALF_TYPES + ((torch.int32, torch.uint16) if fmt == "p12" else ())
        for acc in accs:  # B2-B5: every wire format, both variants; p12 into integer sums
            tag = str(acc).replace("torch.", "")
            acc_bytes = torch.empty((), dtype=acc).element_size()
            s1 = torch.zeros(P, H, W, dtype=acc, device=dev)
            s2 = torch.zeros(2, P, H, W, dtype=acc, device=dev)
            variants = (False, True) if acc in HALF_TYPES else (False,)
            for df in variants:
                v = "v2" if df else "v1"
                kw = dict(num_groups=G, offset=offset, divide_first=df, stream_dtype=fmt)
                row("alg3_stream_step", f"{fmt} {v} {tag}",
                    time_ms(lambda: denoise_stream.alg3_stream_step(frames1, s1, **kw)),
                    plain_ms(lambda: denoise_stream.alg3_stream_step_plain(frames1, s1, **kw),
                             reps=3, inner=1),
                    N * H * W * isz + 2 * out_px * acc_bytes, out_px * step_flops(fmt, df))
                row("multibank_stream_step", f"{fmt} {v} B=2 {tag}",
                    time_ms(lambda: denoise_multibank.multibank_stream_step(frames2, s2, **kw)),
                    plain_ms(lambda: denoise_multibank.multibank_stream_step_plain(frames2, s2, **kw),
                             reps=3, inner=1),
                    2 * (N * H * W * isz + 2 * out_px * acc_bytes), 2 * out_px * step_flops(fmt, df))
            del s1, s2
            for kernel, banks, fn, plain_fn in one_shots:
                frames = inputs[banks]
                b = banks[0] if banks else 1
                for df in variants:
                    kw = dict(offset=offset, accum_dtype=acc, divide_first=df, stream_dtype=fmt)
                    row(kernel, f"{fmt} {'v2' if df else 'v1'} B={b} {tag}",
                        time_ms(lambda: fn(frames, **kw)),
                        plain_ms(lambda: plain_fn(frames, **kw), reps=3, inner=1),
                        b * (G * N * H * W * isz + out_px * acc_bytes),
                        b * out_px * (G * step_flops(fmt, df) + (0 if df else 1)))
        if fmt != "u16":  # the one-shots from u8 and p12 wire into float32 (u16: above)
            for kernel, banks, fn, plain_fn in one_shots:
                frames = inputs[banks]
                b = banks[0] if banks else 1
                for df in (False, True):
                    kw = dict(offset=offset, divide_first=df, stream_dtype=fmt)
                    row(kernel, f"{fmt} {'v2' if df else 'v1'} B={b}",
                        time_ms(lambda: fn(frames, **kw)),
                        plain_ms(lambda: plain_fn(frames, **kw), reps=3, inner=1),
                        b * (G * N * H * W * isz + out_px * 4),
                        b * out_px * (G * step_flops(fmt, df) + (0 if df else 1)))
        del banked, inputs, frames, frames2
    u16_groups = wire((G, N, H), "u16").to(dev)
    window = torch.zeros(5, P, H, W, device=dev)
    for fmt in ("u8", "p12"):  # B6 from u8 and p12 wire into float32 (u16: above)
        group_f = first_group[fmt]
        kw = dict(slot=2, offset=offset, stream_dtype=fmt)
        row("median_window_insert", fmt, time_ms(
            lambda: denoise_median.median_window_insert(window, group_f, **kw)),
            plain_ms(lambda: denoise_median.median_window_insert_plain(window, group_f, **kw),
                     reps=5, inner=2),
            N * H * W * quant.wire_pixel_bytes(fmt) + out_px * 4,
            out_px * (2 + (3 if fmt == "u8" else 0)))
    del window
    for acc in HALF_TYPES:
        tag = str(acc).replace("torch.", "")
        kw = dict(offset=offset, accum_dtype=acc)
        for kernel, fn, plain_fn in (  # B10 takes u16 wire only
                ("alg1_subtract_average", wrappers["alg1_subtract_average"],
                 denoise_tmpframe.alg1_subtract_average_plain),
                ("alg2_subtract_average", wrappers["alg2_subtract_average"],
                 denoise_tmpframe.alg2_subtract_average_plain)):
            # the frames read, the tmpFrame written and read back, the sum written
            nbytes = G * N * H * W * 2 + 2 * G * out_px * 2 + out_px * 2
            row(kernel, f"u16 v1 B=1 {tag}", time_ms(lambda: fn(u16_groups, **kw)),
                plain_ms(lambda: plain_fn(u16_groups, **kw), reps=3, inner=1), nbytes,
                out_px * (G * step_flops("u16", False) + 1))
        window = torch.zeros(5, P, H, W, dtype=acc, device=dev)
        for fmt in quant.STREAM_DTYPES:
            group_f = first_group[fmt]
            kw = dict(slot=2, offset=offset, stream_dtype=fmt)
            row("median_window_insert", f"{fmt} {tag}", time_ms(
                lambda: denoise_median.median_window_insert(window, group_f, **kw)),
                plain_ms(lambda: denoise_median.median_window_insert_plain(window, group_f, **kw),
                         reps=5, inner=2),
                N * H * W * quant.wire_pixel_bytes(fmt) + out_px * 2,
                out_px * (2 + (3 if fmt == "u8" else 0)))
        for k in range(5):
            denoise_median.median_window_insert(window, u16_groups[k], slot=k, offset=offset)
        row("median_combine", f"K=5 {tag}", time_ms(lambda: denoise_median.median_combine(window)),
            plain_ms(lambda: denoise_median.median_combine_plain(window), reps=5, inner=2),
            6 * out_px * 2, out_px * 20, library=plain_ms(lambda: torch.median(window, dim=0),
                                                          reps=5, inner=2))
        del window
        state = [torch.zeros(P, H, W, dtype=acc, device=dev), torch.zeros(H, W, dtype=acc, device=dev),
                 torch.zeros(H, W, dtype=acc, device=dev)]
        for fmt in quant.STREAM_DTYPES:
            group_f = first_group[fmt]
            kw = dict(alpha=0.25, offset=offset, prior_count=0, pair_tile=5, stream_dtype=fmt)
            row("ema_welford_step", f"{fmt} pair_tile=5 {tag}", time_ms(
                lambda: denoise_ema.ema_welford_step(*state, group_f, **kw)),
                plain_ms(lambda: denoise_ema.ema_welford_step_plain(*state, group_f, **kw), reps=3,
                         inner=1),
                N * H * W * quant.wire_pixel_bytes(fmt) + 2 * out_px * 2 + 4 * H * W * 2,
                out_px * (9 + (3 if fmt == "u8" else 0)) + (P // 5) * H * W * 12)
        del state
        xh = x.to(acc)
        for mode, flops in (("box", out_px * 10), ("bilateral", out_px * (9 * 16 + 1))):
            kw = dict(mode=mode, range_sigma=cfg.spatial_range_sigma)
            row("spatial_filter_3x3", f"{mode} {tag}", time_ms(
                lambda: denoise_spatial.spatial_filter_3x3(xh, **kw)),
                plain_ms(lambda: denoise_spatial.spatial_filter_3x3_plain(xh, **kw), reps=5,
                         inner=2), 2 * out_px * 2, flops)
        del xh
    del u16_groups, first_group
    half_rows = rows[half_first:]
    record["half_and_p12_rows"] = [r["kernel"] + " " + r["label"] for r in half_rows]
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
    ins = wrappers["median_window_insert"]
    ins.vector_launches = ins.scalar_launches = 0
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
    if ins.scalar_launches or ins.vector_launches != ins.launches:
        raise AssertionError(f"B6 at the paper's shape: {ins.scalar_launches} of {ins.launches} "
                             f"launches took the scalar path")
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

    record["serve_lm"] = serve_lm_phase(smi)
    record["train"] = train_phase(smi, wrappers)
    record["roofline"] = roofline_phase(smi, wrappers)
    record["mesh"] = mesh_record
    mesh_beside(mesh_record, record)

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
    half_codes = {denoise_stream.ACCUM_CODES[t]: str(t).replace("torch.", "") for t in HALF_TYPES}
    record["half_launches"] = tally.by_type(half_codes)
    print(f"float16/bfloat16 launches of each entry point in this run (phases 1, 1b, 4, 9): "
          f"{json.dumps(record['half_launches'])}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(int(sys.argv[2]), sys.argv[3],
                  sys.argv[5].split(",") if sys.argv[4:5] == ["--labels"] else None)
        sys.exit(0)
    if sys.argv[1:2] == ["--only-mesh"]:  # phase 15 alone, or its runs LABEL,...
        if not torch.cuda.is_available():
            sys.exit(2)
        print(nvidia_smi())
        mesh_phase(nvidia_smi(), sys.argv[2].split(",") if len(sys.argv) > 2 else None)
        sys.exit(0)
    sys.exit(main())
