#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(nvcc, into ``src/repro_torch/kernels/build``), then:

1. holds every kernel of the main path against its plain PyTorch version
   run on the CPU, bitwise, for u16/u8/p12 wire formats, both variants
   (Alg 3 and Alg 3 v2) and G in {5, 8}; then (1b) runs the executors on
   the card at G = 5, where 1/G is inexact, so the eager true divisions
   (``stream_finalize``, a consumer's partials, a ``drop_oldest`` stream
   cut short) are held bitwise against the same runs on the CPU;
2. drives the main path at the paper's size (G = 8, N = 1000, 80 x 256,
   u16): ``PrismSource`` -> ``run_pipelined`` (ring depth 2 and 3),
   ``run_inline(prefetch=False)`` and the one-shot ``StreamingDenoiser``
   call, all bitwise equal to each other and to the CPU plain stream;
3. drives the banked path on one card (two banks): ``ingest_many`` and
   the 5-D one-shot call;
4. times each kernel at the paper's shape with CUDA events against the
   least time the card needs to move its bytes, times its plain version,
   and times the pipelined executor per group against the camera's 57 ms
   inter-group interval.

Phases 2 and 3 are the main path: every launch counter is set to 0 just
before them and read just after; a kernel launched no time there fails
the run. The script prints the card's ``nvidia-smi`` name and power
limit, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
It exits with code 2, printing no result, when no CUDA device is present.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SOURCE = "src/repro_torch/kernels/csrc/denoise_stream.cu"
#: (match in the card's name, HBM bytes/s, float32 non-tensor FLOP/s):
#: NVIDIA data sheets, dense, at the full power limit
PEAKS = (
    ("H200", 4.8e12, 67e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", 3.35e12, 67e12),  # SXM5 (named "H100 80GB HBM3" or "H100 SXM")
)
CAMERA_GROUP_MS = 57e-3 * 1000  # 57 us per frame x 1000 frames per group


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


def time_ms(fn, *, reps: int = 15, inner: int = 10, warmup: int = 3) -> float:
    """Median CUDA-event time of one ``fn()`` call: ``inner`` back-to-back
    calls between two events, ``reps`` times, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2

    from repro_torch.core import streaming
    from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser
    from repro_torch.data.prism import PrismSource, snr_db
    from repro_torch.kernels import _build, denoise_multibank, denoise_stream, quant, ref

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi)
    name = torch.cuda.get_device_name(0)
    peak_bw, peak_flops = card_peaks(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.library()
    took = time.perf_counter() - t0
    print(f"build: {_build.SOURCE.name} built and loaded in {took:.1f} s")
    record: dict = {"card": smi, "device": name, "torch": torch.__version__, "build_s": took}

    wrappers = {
        "alg3_stream_step": denoise_stream.alg3_stream_step,
        "alg3_subtract_average": denoise_stream.alg3_subtract_average,
        "multibank_stream_step": denoise_multibank.multibank_stream_step,
        "multibank_subtract_average": denoise_multibank.multibank_subtract_average,
    }
    replaces = {
        "alg3_stream_step": "src/repro/kernels/denoise_stream.py:252",
        "alg3_subtract_average": "src/repro/kernels/denoise_stream.py:160",
        "multibank_stream_step": "src/repro/kernels/denoise_multibank.py:201",
        "multibank_subtract_average": "src/repro/kernels/denoise_multibank.py:113",
    }
    max_err = {k: 0.0 for k in wrappers}

    def same(kernel: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        got = got.cpu()
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        max_err[kernel] = max(max_err[kernel], err)
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{kernel} {what}: not bitwise equal to its plain version (max |diff| {err})")

    rng = np.random.default_rng(0)
    offset = 4096.0
    H, W = 80, 256

    def wire(shape, fmt):
        px = rng.integers(0, 4096, shape + (W,)).astype(np.uint16)
        return torch.from_numpy(np.ascontiguousarray(quant.encode(px, fmt)))

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
    torch.cuda.synchronize()
    print(f"phase 1: {len(cases)} cases x 4 kernels bitwise equal to the CPU plain versions "
          f"({time.perf_counter() - t1:.1f} s)")

    # -- phase 1b: the executors at G = 5, card against CPU ----------------
    t1 = time.perf_counter()
    runs, discriminates = 0, False
    for fmt in quant.STREAM_DTYPES:
        for algorithm in ("alg3", "alg3_v2"):
            cfg5 = DenoiseConfig(num_groups=5, frames_per_group=64, stream_dtype=fmt,
                                 algorithm=algorithm)
            groups5 = list(PrismSource(cfg5, seed=5).groups())
            what = f"G=5 {fmt} {algorithm}"

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

            want = both("run_pipelined", piped)
            both("run_inline(prefetch=False)", lambda d: streaming.run_inline(
                cfg5, iter(groups5), prefetch=False, device=d)[0])
            both("DownloadConsumer partials", partials)
            both("drop_oldest, 3 of 5 groups", lambda d: piped(
                d, groups=groups5[:3], policy="drop_oldest"))
            both("one-shot", lambda d: StreamingDenoiser(cfg5, device=d)(np.stack(groups5)))
            runs += 5
            if algorithm == "alg3":  # the true division is not the reciprocal multiply here
                den = StreamingDenoiser(cfg5, device="cpu")
                state = den.init()
                for k, g in enumerate(groups5):
                    state = den.ingest(state, g, step=k)
                recip = state * torch.tensor(ref.reciprocal(5), dtype=state.dtype)
                discriminates |= not torch.equal(recip, want)
    torch.cuda.synchronize()
    if not discriminates:
        raise AssertionError("G=5 finalize: true division never differed from x * f32(1/5)")
    print(f"phase 1b: G=5 N=64 80x256, u16/u8/p12 x alg3/alg3_v2: {runs} executor runs on the "
          f"card bitwise equal to the CPU ({time.perf_counter() - t1:.1f} s)")

    # -- phases 2 + 3: the main path at the paper's size -----------------
    cfg = DenoiseConfig()  # G=8, N=1000, 80x256, u16, pair_average, alg3
    assert (cfg.num_groups, cfg.frames_per_group, cfg.height, cfg.width) == (8, 1000, 80, 256)
    src = PrismSource(cfg, seed=0)
    groups = list(src.groups())
    cfg_b = DenoiseConfig(num_banks=2)
    bgroups = list(PrismSource(cfg_b, seed=1).banked_groups())
    want = StreamingDenoiser(cfg, device="cpu").run(groups)
    want_b = StreamingDenoiser(cfg_b, device="cpu").run(bgroups)

    for fn in wrappers.values():
        fn.launches = 0
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
            torch.from_numpy(np.stack(groups)).to(dev))),
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
    launches = {k: fn.launches for k, fn in wrappers.items()}
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
    out_np = outs["run_pipelined(num_slots=2)"].cpu().numpy()
    if not np.isfinite(out_np).all():
        raise AssertionError("non-finite output")
    snr = snr_db(out_np, src.true_signal())
    if not snr > 10.0:
        raise AssertionError(f"SNR {snr:.2f} dB against the noise-free signal is too low")
    print(f"phase 2: main path G=8 N=1000 80x256 u16: {len(outs)} runs bitwise equal to each "
          f"other and to the CPU plain stream; alg3_stream_step launches per stream run "
          f"{[per_run[k] for k in ('pipelined2', 'pipelined3', 'inline')]}; SNR {snr:.3f} dB")
    print(f"phase 3: banked (B=2) ingest_many and 5-D one-shot bitwise equal to the CPU plain "
          f"stream; main-path launches {json.dumps(launches)} ({main_s:.1f} s)")
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
    for fmt in quant.STREAM_DTYPES:
        for df in (False, True):
            frames = wire((1, N, H), fmt)[0].to(dev)
            isz = quant.wire_pixel_bytes(fmt)
            s = torch.zeros(P, H, W, device=dev)
            kw = dict(num_groups=G, offset=offset, divide_first=df, stream_dtype=fmt)
            ms = time_ms(lambda: denoise_stream.alg3_stream_step(frames, s, **kw))
            plain = time_ms(lambda: denoise_stream.alg3_stream_step_plain(frames, s, **kw), reps=5, inner=2)
            nbytes = N * H * W * isz + 2 * out_px * 4
            b_ms, b_by = bound(nbytes, out_px * step_flops(fmt, df))
            rows.append(dict(kernel="alg3_stream_step", fmt=fmt, divide_first=df, ms=ms,
                             plain_ms=plain, bytes=nbytes, bound_ms=b_ms, bound_by=b_by))
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
                plain = time_ms(lambda: denoise_multibank.multibank_stream_step_plain(
                    frames, s, num_groups=G, **kw), reps=5, inner=2)
                nbytes = b * (N * H * W * 2 + 2 * out_px * 4)
                flops = b * out_px * step_flops("u16", df)
            else:
                frames = wire(((banks,) if banks else ()) + (G, N, H), "u16").to(dev)
                ms = time_ms(lambda: fn(frames, **kw))
                plain = time_ms(lambda: plain_fn(frames, **kw), reps=3, inner=1)
                nbytes = b * (G * N * H * W * 2 + out_px * 4)
                flops = b * out_px * (G * step_flops("u16", df) + (0 if df else 1))
            b_ms, b_by = bound(nbytes, flops)
            rows.append(dict(kernel=kernel, fmt="u16", divide_first=df, banks=b, ms=ms,
                             plain_ms=plain, bytes=nbytes, bound_ms=b_ms, bound_by=b_by))
    for r in rows:
        print(f"  {r['kernel']:28s} {r['fmt']:4s} {'v2' if r['divide_first'] else 'v1'} "
              f"{r['ms'] * 1e3:9.2f} us  bound {r['bound_ms'] * 1e3:8.2f} us ({r['bytes'] / 1e6:.2f} MB)"
              f"  {r['bound_ms'] / r['ms']:6.1%} of peak  plain {r['plain_ms'] * 1e3:10.1f} us")

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
    record.update(rows=rows, executor=executor, synth_ms_per_group=synth_ms,
                  camera_group_ms=CAMERA_GROUP_MS)

    main_rows = {r["kernel"]: r for r in rows if r["fmt"] == "u16" and not r["divide_first"]}
    kernels = [
        {
            "name": k, "route": "cuda", "source": SOURCE, "replaces": replaces[k],
            "launches": launches[k], "max_abs_err": max_err[k],
            "ms": main_rows[k]["ms"], "plain_ms": main_rows[k]["plain_ms"],
            "bound_ms": main_rows[k]["bound_ms"], "bound_by": main_rows[k]["bound_by"],
            "library_ms": None,
        }
        for k in wrappers
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
