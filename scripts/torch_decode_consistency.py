#!/usr/bin/env python3
"""How far a decode step of the port's model substrate lies from the
model's own forward over the same tokens, on the card, under either
random-weight rule.

Run on the machine with the card, from the root of a checkout::

    python3 scripts/torch_decode_consistency.py [--run 12e ...]
        [--dtype float32|bfloat16] [--init reference scaled] [--gen 8]
        [--out FILE]

For each of ``chip_smoke.py``'s ``FAMILY_RUNS`` (12e-12j: the arch, its
depth cut, batch and prompt), it draws the parameters by the reference's
rules (``--init reference``: ``Model.init``) or by ``chip_smoke``'s
``scaled_init`` (every ``fan_in`` weight N(0, 1/d_model)), serves
``--gen`` greedy tokens through ``serve.generate`` and prints the largest
|decode logit - forward logit| over the forward's largest |logit| of the
step, one line per run and rule, then one JSON object of them all. In
float32 the products run in full float32 (TF32 off); MoE models run at
``capacity_factor`` 64, as the reference's own decode test does, so no
token is dropped at any length.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", nargs="*", default=None, help="labels of FAMILY_RUNS (all)")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--init", nargs="+", default=["reference", "scaled"],
                    choices=("reference", "scaled"))
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_consistency: no CUDA device", file=sys.stderr)
        return 2

    from chip_smoke import FAMILY_RUNS, _rel, nvidia_smi, scaled_init
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.inputs import make_train_batch
    from repro_torch.models import build_model
    from repro_torch.models.layers import full_float32_matmul

    card = nvidia_smi()
    dev = torch.device("cuda")
    record = {"card": card, "dtype": args.dtype, "gen": args.gen, "runs": {}}
    for label, arch, depth, batch, prompt_len, _ in FAMILY_RUNS:
        if args.run and label not in args.run:
            continue
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, num_layers=depth or cfg.num_layers, dtype=args.dtype)
        if cfg.num_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=64.0)
        model = build_model(cfg)
        for init in args.init:
            t0 = time.perf_counter()
            torch.cuda.empty_cache()
            gen = torch.Generator(device=dev).manual_seed(0)
            params = (model.init(gen, device=dev) if init == "reference"
                      else scaled_init(model, gen, dev))
            if cfg.family == "vlm":  # nonzero gates, as chip_smoke.py sets them
                gates = torch.Generator(device=dev).manual_seed(5)
                for k in ("gate_attn", "gate_mlp"):
                    params["cross_layers"][k].uniform_(0.5, 1.5, generator=gates)
            prompt = make_train_batch(cfg, batch, prompt_len, seed=1, device=dev)
            prompt.pop("labels")
            extras = {k: prompt[k] for k in ("image_embeds", "frames") if k in prompt}
            out = serve.generate(model, params, prompt, prompt_len=prompt_len, gen=args.gen)
            fed = torch.cat([prompt["tokens"], torch.from_numpy(out.first)[:, None].to(dev),
                             torch.from_numpy(out.tokens[:, :-1]).to(dev)], dim=1)
            with torch.no_grad(), full_float32_matmul():
                full = model.forward(params, {"tokens": fed, **extras})[:, prompt_len:]
            worst = max(_rel(step, full[:, i]) for i, step in enumerate(out.logits))
            record["runs"][f"{label} {init}"] = worst
            print(f"{label} {arch} ({cfg.num_layers} layers) {args.dtype}, {init} init: decode "
                  f"against the forward {worst:.3g} of max |logit| over {args.gen} steps "
                  f"({time.perf_counter() - t0:.1f} s; {card})", flush=True)
            del params, out, full
    text = json.dumps(record)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
