#!/usr/bin/env python3
"""The readings behind ``denoise_spatial.BILATERAL_RTOL``.

Run from the root of a checkout on a machine with a CUDA card::

    python3 scripts/torch_bilateral_margin.py

It runs the bilateral mode of the CUDA 3x3 spatial kernel and its plain
PyTorch version (on the CPU) over a sweep of inputs: three seeds, three
noise levels around the default offset 4096 with 1 % hot pixels (+900),
range sigmas 10, 30, 60 and 200, and the averaged frames of a PRISM
stream. It prints, for each range sigma and over all, the largest
relative difference between the two, and of each against the same
function evaluated in float64. The last line is one JSON object with
those numbers. Run it on a copy whose kernel was deliberately broken to
read what the declared tolerance has to catch.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SIGMAS = (10.0, 30.0, 60.0, 200.0)
NOISES = (10.0, 40.0, 160.0)
SEEDS = (0, 1, 2)
FRAMES, H, W = 64, 80, 256


def exact(x: torch.Tensor, sigma: float, neighbours) -> torch.Tensor:
    """The bilateral mean in float64, with the kernel's float32 weight scale."""
    x = x.double()
    inv2s2 = float(np.float32(1.0 / (2.0 * sigma * sigma)))
    acc, wsum = torch.zeros_like(x), torch.zeros_like(x)
    for nb in neighbours(x):
        wgt = torch.exp(-((nb - x) ** 2) * inv2s2)
        acc += wgt * nb
        wsum += wgt
    return acc / wsum


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got.double() - want.double()).abs() / want.double().abs()).max())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bilateral_margin: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from repro_torch.core import streaming
    from repro_torch.core.denoise import DenoiseConfig
    from repro_torch.data.prism import PrismSource
    from repro_torch.kernels import denoise_spatial

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    inputs = []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        for noise in NOISES:
            x = (4096 + noise * rng.standard_normal((FRAMES, H, W))).astype(np.float32)
            x[rng.random(x.shape) < 0.01] += 900.0
            inputs.append((f"seed={seed} noise={noise:g}", torch.from_numpy(x)))
    cfg = DenoiseConfig(filter_name="pair_average", frames_per_group=2 * FRAMES)
    averaged, _ = streaming.run_inline(cfg, PrismSource(cfg, seed=0).groups(), prefetch=False,
                                       device="cpu")
    inputs.append(("PRISM average G=8", averaged))

    by_sigma = {}
    worst = {"kernel_vs_plain": 0.0, "kernel_vs_float64": 0.0, "plain_vs_float64": 0.0}
    for sigma in SIGMAS:
        kw = dict(mode="bilateral", range_sigma=sigma)
        here = dict.fromkeys(worst, 0.0)
        for _, x in inputs:
            got = denoise_spatial.spatial_filter_3x3(x.cuda(), **kw).cpu()
            plain = denoise_spatial.spatial_filter_3x3_plain(x, **kw)
            ref = exact(x, sigma, denoise_spatial._neighbours)
            here["kernel_vs_plain"] = max(here["kernel_vs_plain"], rel(got, plain))
            here["kernel_vs_float64"] = max(here["kernel_vs_float64"], rel(got, ref))
            here["plain_vs_float64"] = max(here["plain_vs_float64"], rel(plain, ref))
        by_sigma[f"{sigma:g}"] = here
        for k, v in here.items():
            worst[k] = max(worst[k], v)
        print(f"sigma {sigma:5g}: " + ", ".join(f"{k} {v:.3g}" for k, v in here.items()))
    print(f"over {len(inputs)} inputs of {FRAMES}x{H}x{W} and {len(SIGMAS)} sigmas: "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" (declared {denoise_spatial.BILATERAL_RTOL:g})")
    print(json.dumps({"card": smi, "max_rel": worst, "by_sigma": by_sigma,
                      "declared_rtol": denoise_spatial.BILATERAL_RTOL}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
