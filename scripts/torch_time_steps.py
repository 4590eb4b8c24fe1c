#!/usr/bin/env python3
"""Device time of the step kernels (B2, B4) and the EMA kernel (B8) at the
paper's shape, for the port of a given source tree.

Run on the machine with the card, from the root of a checkout::

    python3 scripts/torch_time_steps.py [TREE] [--out FILE]

``TREE`` (default: this checkout) is the root of a checkout whose
``src/repro_torch`` is timed; its kernels are built from its own sources.
Every tree is timed with this checkout's ``chip_smoke.time_ms``, so two
trees (a commit and its parent, unpacked with ``git archive``) read the
same way. Time them in one machine session, in the order parent, change,
change, parent. It prints one JSON object (the card, the tree, and the µs
of each kernel and case), and writes it to ``FILE`` too if asked.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_time_steps: no CUDA device", file=sys.stderr)
        return 2
    # the tree's package first, then this checkout's timing helpers
    from repro_torch.kernels import denoise_ema, denoise_multibank, denoise_stream, quant
    sys.path.insert(1, str(ROOT))
    from chip_smoke import host_us, nvidia_smi, time_ms

    if not Path(denoise_stream.__file__).is_relative_to(tree):
        raise RuntimeError(f"imported {denoise_stream.__file__}, not the tree {tree}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    G, N, H, W = 8, 1000, 80, 256
    P, offset = N // 2, 4096.0

    def wire(shape, fmt):
        px = rng.integers(0, 4096, shape + (W,)).astype(np.uint16)
        return torch.from_numpy(np.ascontiguousarray(quant.encode(px, fmt))).to(dev)

    rows = []
    for fmt in ("u16", "u8", "p12"):
        frames, s = wire((N, H), fmt), torch.zeros(P, H, W, device=dev)
        call = lambda: denoise_stream.alg3_stream_step(  # noqa: E731
            frames, s, num_groups=G, offset=offset, stream_dtype=fmt)
        rows.append(dict(kernel="alg3_stream_step", label=f"{fmt} v1",
                         us=time_ms(call) * 1e3, host_us=host_us(call)))
    frames, s = wire((2, N, H), "u16"), torch.zeros(2, P, H, W, device=dev)
    call = lambda: denoise_multibank.multibank_stream_step(  # noqa: E731
        frames, s, num_groups=G, offset=offset)
    rows.append(dict(kernel="multibank_stream_step", label="u16 v1 B=2",
                     us=time_ms(call) * 1e3, host_us=host_us(call)))
    group = wire((N, H), "u16")
    state = [torch.zeros(P, H, W, device=dev), torch.zeros(H, W, device=dev),
             torch.zeros(H, W, device=dev)]
    call = lambda: denoise_ema.ema_welford_step(  # noqa: E731
        *state, group, alpha=0.25, offset=offset, prior_count=0, pair_tile=5)
    rows.append(dict(kernel="ema_welford_step", label="u16 pair_tile=5",
                     us=time_ms(call) * 1e3, host_us=host_us(call)))
    out = dict(card=nvidia_smi(), tree=str(tree), torch=torch.__version__, rows=rows)
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
