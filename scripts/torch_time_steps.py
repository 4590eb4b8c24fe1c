#!/usr/bin/env python3
"""Device time of the step kernels (B2, B4), the EMA kernel (B8) and the
3x3 spatial kernel (B9, box and bilateral) at the paper's shape, for the
port of a given source tree.

Run on the machine with the card, from the root of a checkout::

    python3 scripts/torch_time_steps.py [TREE] [--out FILE]
        [--b9-save FILE] [--b9-ref FILE]

``TREE`` (default: this checkout) is the root of a checkout whose
``src/repro_torch`` is timed; its kernels are built from its own sources.
Every tree is timed with this checkout's ``chip_smoke.time_ms``, so two
trees (a commit and its parent, unpacked with ``git archive``) read the
same way. Time them in one machine session, in the order parent, change,
change, parent. It prints one JSON object (the card and its clock, the
tree, the µs of each kernel and case, and the B9 kernels' SASS
instruction counts), and writes it to ``FILE`` too if asked.

B9 runs on seeded frames (500 x 80 x 256 around 4096 with hot pixels):
``--b9-save`` writes the tree's box and bilateral outputs there, and
``--b9-ref`` compares them with those another tree saved (bitwise, and
the largest relative difference), so that two trees' bits can be held
against each other. The SASS counts (``cuobjdump -sass`` of the tree's
built library) split each B9 kernel at its block barriers; from them the
script estimates the instructions a bilateral output pixel issues and the
least time the card's schedulers (4 a SM, one warp instruction a clock
each, at the card's maximum SM clock) take to issue them.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sass_segments(library: str, match: str, dump: str | None = None) -> dict[str, list[int]]:
    """Per kernel function whose name holds ``match``: the counts of SASS
    instructions (NOPs left out) between its block barriers, up to the
    first unpredicated EXIT, which ends the main body (the subroutines
    after it, such as the division's slow path and a 64-bit division that
    no launch here calls, are left out). ``dump`` names a file for the
    listing of those functions."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    if dump:
        keep, lines = False, []
        for line in text.splitlines():
            if "Function : " in line:
                keep = match in line
            if keep:
                lines.append(line)
        Path(dump).parent.mkdir(parents=True, exist_ok=True)
        Path(dump).write_text("\n".join(lines) + "\n")
    out, name, segs, done = {}, None, [], False
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            if name and match in name:
                out[name] = segs
            name, segs, done = head.group(1), [0], False
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not ins or name is None or done:
            continue
        op = ins.group(2)
        if op.startswith("BAR.SYNC"):
            segs.append(0)
        elif not op.startswith("NOP"):
            segs[-1] += 1
            done = op == "EXIT"
    if name and match in name:
        out[name] = segs
    return out


def b9_issue(segments: dict[str, list[int]], pixels: int, sm_count: int, clock_hz: float) -> dict:
    """Warp instructions a bilateral output pixel issues, from the SASS
    counts of the kernel this tree has, and the issue-time floor at
    ``pixels``. The per-pixel kernel (one pixel a thread, one pass of its
    loop at W = 256) issues its main body once a pixel. The tile kernel
    (2,048 pixels a block of 8 warps) runs its phases 1 and 3 once a warp,
    and its weight loop 19 times a block (17 chunk rows, 2 of halo
    weights), each pass counted with both branches: an upper bound."""
    # the bilateral instance (BOX = false), on its float4 path where it has one
    args = {k: k.split("kernel")[-1] for k in segments}
    name = min((k for k, a in args.items() if a.startswith("ILb0E")),
               key=lambda k: not args[k].startswith("ILb0ELb1E"))
    segs = segments[name]
    if len(segs) == 1:
        per_px = segs[0] / 32
    else:
        per_px = (8 * (segs[0] + segs[2]) + 19 * segs[1]) / 2048
    return dict(kernel=name, segments=segs, warp_instructions_per_px=per_px,
                thread_instructions_per_px=per_px * 32,
                issue_floor_us=pixels * per_px / (sm_count * 4 * clock_hz) * 1e6)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--out", default=None)
    ap.add_argument("--b9-save", default=None)
    ap.add_argument("--b9-ref", default=None)
    ap.add_argument("--sass-dump", default=None, help="write the B9 kernels' SASS to this file")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_time_steps: no CUDA device", file=sys.stderr)
        return 2
    # the tree's package first, then this checkout's timing helpers
    from repro_torch.kernels import (
        _build,
        denoise_ema,
        denoise_multibank,
        denoise_spatial,
        denoise_stream,
        quant,
    )
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
    del state, group, frames, s
    b9rng = np.random.default_rng(9)
    x = (4096 + 40 * b9rng.standard_normal((P, H, W))).astype(np.float32)
    x[b9rng.random(x.shape) < 0.01] += 900.0  # 1 % hot pixels
    x = torch.from_numpy(x).to(dev)
    b9 = {}
    for mode in ("box", "bilateral"):
        call = lambda: denoise_spatial.spatial_filter_3x3(  # noqa: E731
            x, mode=mode, range_sigma=60.0)
        b9[mode] = call().cpu()
        rows.append(dict(kernel="spatial_filter_3x3", label=mode, us=time_ms(call) * 1e3,
                         host_us=host_us(call)))
    if args.b9_save:
        Path(args.b9_save).parent.mkdir(parents=True, exist_ok=True)
        torch.save(b9, args.b9_save)
    b9_vs = None
    if args.b9_ref:
        ref = torch.load(args.b9_ref)
        b9_vs = {mode: dict(bitwise_equal=bool(torch.equal(b9[mode], ref[mode])),
                            max_rel=float(((b9[mode].double() - ref[mode].double()).abs()
                                           / ref[mode].double().abs()).max()))
                 for mode in b9}
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]
    clock_hz = float(clock) * 1e6
    segments = sass_segments(_build.library()._name, "spatial", args.sass_dump)
    issue = b9_issue(segments, P * H * W, torch.cuda.get_device_properties(0).multi_processor_count,
                     clock_hz)
    out = dict(card=nvidia_smi(), max_sm_clock_mhz=float(clock), tree=str(tree),
               torch=torch.__version__, rows=rows, b9_vs_ref=b9_vs, b9_sass=segments,
               b9_bilateral_issue=issue)
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
