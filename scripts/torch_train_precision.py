#!/usr/bin/env python3
"""How far a training step's gradients lie from each other on the card
and on the CPU, in float32 and float64, under two random-weight rules.

Run on the machine with the card, from the root of a checkout::

    python3 scripts/torch_train_precision.py [--arch h2o-danube-1.8b]
        [--layers 2] [--batch 2] [--seq 32] [--out FILE]

It builds the published config cut to ``--layers`` layers, draws its
parameters on the CPU under the reference's rules (``Model.init``) and
under ``scaled_init`` (``chip_smoke.py``: every ``fan_in`` weight drawn
N(0, 1/d_model)), and takes the gradient of one loss (the trainer's
first batch) four ways: float32 and float64 models (TF32 off), each on
the CPU and on the card. The loss itself is a float32 softmax in every
case, as in the reference. It prints one JSON object: for each rule, each
run's loss and gradient norm, and for each pair of runs the largest
gradient difference as a fraction of its leaf's largest magnitude
(worst leaf) and the gradient norms' relative difference.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

PAIRS = (("cpu32", "cpu64"), ("cuda32", "cpu64"), ("cuda64", "cpu64"), ("cuda32", "cpu32"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_precision: no CUDA device", file=sys.stderr)
        return 2

    from chip_smoke import scaled_init
    from repro_torch.checkpoint.checkpoint import flat_leaves, map_tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import build_model
    from repro_torch.models.layers import full_float32_matmul

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers, dtype="float32")
    models = {32: build_model(cfg), 64: build_model(dataclasses.replace(cfg, dtype="float64"))}
    rules = {
        "reference": lambda: models[32].init(torch.Generator().manual_seed(0), device="cpu"),
        "scaled": lambda: scaled_init(models[32], torch.Generator().manual_seed(0), "cpu"),
    }

    def grads(bits, params, device):
        batch = DataPipeline(cfg, batch=args.batch, seq=args.seq, cycle=4,
                             device=device).batch_at(0)
        dtype = torch.float32 if bits == 32 else torch.float64
        tracked = map_tree(lambda t: t.to(device=device, dtype=dtype).requires_grad_(), params)
        loss = models[bits].loss(tracked, batch)
        g = torch.autograd.grad(loss, flat_leaves(tracked))
        return float(loss.detach()), [x.detach().double().cpu() for x in g]

    out = {"card": card, "arch": cfg.name, "layers": cfg.num_layers, "batch": args.batch,
           "seq": args.seq}
    with full_float32_matmul():
        for rule, init in rules.items():
            params = init()
            runs = {f"{dev}{bits}": grads(bits, params, dev)
                    for dev in ("cpu", "cuda") for bits in (32, 64)}
            norms = {k: float(torch.sqrt(sum((x ** 2).sum() for x in g)))
                     for k, (_, g) in runs.items()}
            pairs = {}
            for a, b in PAIRS:
                worst = max(float((x - y).abs().max() / y.abs().max().clamp(min=1e-300))
                            for x, y in zip(runs[a][1], runs[b][1]))
                pairs[f"{a}_vs_{b}"] = {
                    "worst_leaf": worst,
                    "grad_norm_rel": abs(norms[a] - norms[b]) / norms[b]}
            out[rule] = {"loss": {k: v[0] for k, v in runs.items()}, "grad_norm": norms,
                         "pairs": pairs}
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
