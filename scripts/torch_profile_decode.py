#!/usr/bin/env python3
"""Where a decode step of the port's model substrate spends its time, on
the card (``torch.profiler``).

Run on the machine with the card, from the root of a checkout::

    python3 scripts/torch_profile_decode.py [--arch h2o-danube-1.8b]
        [--layers N] [--batch 4] [--prompt 128] [--steps 8] [--out FILE]

It builds the published config (``--layers`` cuts its depth) with random
weights (a seeded CUDA generator, as ``chip_smoke.py`` phase 12 does),
prefills ``--prompt`` tokens (the audio family encodes its frames and
decodes from token 0 instead, as ``serve.generate`` does; decode batches
carry the image or frame embeddings), takes three decode steps to warm up, times ``--steps`` greedy
decode steps on the host clock (synchronised, no profiler), then
profiles as many more. It prints one JSON object: the card, the host
time of a step, the device time its kernels take (the sum of the
kernels' durations in the trace), the device's idle share (1 - device /
host), and the kernels and host operations that take most of each, the
parameter casts (``aten::to``/``aten::_to_copy``) among them.
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
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_decode: no CUDA device", file=sys.stderr)
        return 2

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.inputs import make_train_batch
    from repro_torch.launch.serve import _start_audio
    from repro_torch.models import build_model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    audio = cfg.family == "audio"
    prompt = make_train_batch(cfg, args.batch, 0 if audio else args.prompt, seed=1, device=dev)
    extras = {k: prompt[k] for k in ("image_embeds", "frames") if k in prompt}
    total = args.prompt + 3 + 2 * args.steps

    with torch.no_grad():
        if audio:
            caches = _start_audio(model, params, prompt, total)
            tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=dev)
            index = 0
        else:
            logits, caches = model.prefill(params, prompt, max_len=total)
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
            index = args.prompt

        def step():
            nonlocal logits, caches, tok, index
            logits, caches = model.decode_step(params, caches, {"token": tok, **extras}, index)
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
            index += 1

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / args.steps * 1e3
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
    casts = [e for e in events if e.key in ("aten::to", "aten::_to_copy", "aten::copy_")]
    out = {
        "card": card, "arch": cfg.name, "layers": cfg.num_layers, "batch": args.batch,
        "prompt": args.prompt, "steps": args.steps, "host_ms_per_step": host_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": max(0.0, 1 - device_ms / host_ms) if host_ms else None,
        "top_kernels": [
            {"name": e.key[:90], "ms_per_step": device_us(e) / args.steps / 1e3,
             "calls_per_step": e.count / args.steps} for e in kernels[:10]],
        "top_host_ops": [
            {"name": e.key, "self_cpu_ms_per_step": e.self_cpu_time_total / args.steps / 1e3,
             "calls_per_step": e.count / args.steps} for e in host_ops[:10]],
        "casts": [
            {"name": e.key, "cpu_ms_per_step": e.cpu_time_total / args.steps / 1e3,
             "calls_per_step": e.count / args.steps} for e in casts],
    }
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
