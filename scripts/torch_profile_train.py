#!/usr/bin/env python3
"""Where a training step of the port's model substrate spends its time, on
the card (``torch.profiler``).

Run on the machine with the card, from the root of a checkout::

    python3 scripts/torch_profile_train.py [--arch gemma3-1b] [--layers N]
        [--batch 8] [--seq 128] [--microbatches 4] [--remat on|off|config]
        [--steps 3] [--out FILE]

It builds the published config (``--layers`` cuts its depth; ``--remat``
forces rematerialization on or off, ``config`` keeps the config's) with
random weights (a seeded CUDA generator, as ``launch/train.py`` draws
them), the trainer's optimizer (``AdamW`` under ``cosine_schedule(3e-3,
5, 20)``) and its data (``DataPipeline``, cycle 4), takes two steps to
warm up, times ``--steps`` steps of ``launch.steps.build_train_step`` on
the host clock (each ends by reading its loss; no checkpoint, no
profiler), then profiles as many more. It prints one JSON object: the
card, the host time of a step, the optimizer's share (``AdamW.update``
alone on zero gradients, synchronised), the device time its kernels take
(the sum of the kernels' durations in the trace), the device's idle share
(1 - device / host), kernel launches a step, peak memory, and the kernels
and host operations that take most of each.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--remat", choices=("on", "off", "config"), default="config")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_train: no CUDA device", file=sys.stderr)
        return 2

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint.checkpoint import flat_leaves
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.remat != "config":
        cfg = dataclasses.replace(cfg, remat=args.remat == "on")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = AdamW(learning_rate=cosine_schedule(3e-3, 5, 20))
    state = opt.init(params)
    step_fn = steps.build_train_step(model, opt, microbatches=args.microbatches)
    data = DataPipeline(cfg, batch=args.batch, seq=args.seq, microbatches=args.microbatches,
                        cycle=4, device=dev)
    at = 0

    def step():
        nonlocal params, state, at
        params, state, met = step_fn(params, state, data.batch_at(at))
        at += 1
        return float(met["loss"])

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    host_ms = (time.perf_counter() - t0) / args.steps * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    zeros = [torch.zeros_like(p) for p in flat_leaves(params)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.update(zeros, state, params)
    torch.cuda.synchronize()
    adamw_ms = (time.perf_counter() - t0) * 1e3
    del zeros
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()

    events = prof.key_averages()
    device_us = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=device_us, reverse=True)
    device_ms = sum(device_us(e) for e in kernels) / args.steps / 1e3
    host_ops = sorted((e for e in events if e.device_type == DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
    out = {
        "card": card, "arch": cfg.name, "layers": cfg.num_layers, "batch": args.batch,
        "seq": args.seq, "microbatches": args.microbatches, "remat": cfg.remat,
        "remat_policy": cfg.remat_policy, "dtype": cfg.dtype, "steps": args.steps,
        "params": model.param_count(), "host_ms_per_step": host_ms, "adamw_ms": adamw_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": max(0.0, 1 - device_ms / host_ms) if host_ms else None,
        "kernel_launches_per_step": sum(e.count for e in kernels) / args.steps,
        "peak_gb": peak_gb,
        "top_kernels": [
            {"name": e.key[:90], "ms_per_step": device_us(e) / args.steps / 1e3,
             "calls_per_step": e.count / args.steps} for e in kernels[:10]],
        "top_host_ops": [
            {"name": e.key, "self_cpu_ms_per_step": e.self_cpu_time_total / args.steps / 1e3,
             "calls_per_step": e.count / args.steps} for e in host_ops[:10]],
    }
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
