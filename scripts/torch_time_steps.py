#!/usr/bin/env python3
"""Device time of every kernel of the port (B2-B10: each row of the
kernel table in PERF.md section 6, the integer sums and the step's scalar
path among them) at the paper's shape, at each kernel's default launch
geometry, for the port of a given source tree.

Run on the machine with the card, from the root of a checkout::

    python3 scripts/torch_time_steps.py [TREE] [--out FILE]
        [--b9-save FILE] [--b9-ref FILE] [--build-times] [--sass-mix MATCH] [--oneshot]
        [--tmpframe] [--median]

``TREE`` (default: this checkout) is the root of a checkout whose
``src/repro_torch`` is timed; its kernels are built from its own sources.
Every tree is timed with this checkout's ``chip_smoke.time_ms``, so two
trees (a commit and its parent, unpacked with ``git archive``) read the
same way. Time them in one machine session, in the order parent, change,
change, parent. It prints one JSON object (the card and its clock, the
tree, the µs of each kernel and case, and the B9 kernels' SASS
instruction counts), and writes it to ``FILE`` too if asked.

The float16 and bfloat16 instance of every kernel is timed beside the
float32 rows, at chip_smoke.py's phase 4 labels (B2-B6 and B8 on every
wire format, B2-B5 both variants; the one-shots B3/B5 also into float32
from every format in both variants, each with its byte bound), with two
PyTorch calls as yardsticks in the half type: pad + ``avg_pool2d`` for B9
box and ``torch.sum(tmp, 0)`` for B10's pass B. ``--oneshot`` times only
B3/B5 in every instance, B3 at each candidate of the step family's tile
search (the geometry a plan hands the one-shot) beside its default
launch, and B10's pass B and B7 (K = 5) in the half types beside
``torch.sum(tmp, 0)`` and ``torch.median``: a short run for comparing
two trees' one-shots. ``--tmpframe`` times only B10, in float32, float16
and bfloat16: pass A of each algorithm, pass B beside
``torch.sum(tmp, 0)``, and each algorithm in total, each with its byte
bound. ``--median`` times only B6, the median window's insert, in every
wire format into a float32, float16 and bfloat16 window (each with its
byte bound), at the launch model's candidates for its plans, and on its
scalar path (an unaligned view), with B3/B5 from u16 wire in each float
type as the control for the pair difference they share. ``--build-times`` also
compiles each of the tree's sources alone, cold, with the port's flags,
and records the seconds of each; ``--sass-mix MATCH`` counts the SASS
opcodes of every kernel whose mangled name the regular expression
``MATCH`` finds.

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


def sass_mix(library: str, match: str) -> dict[str, dict[str, int]]:
    """Per kernel function whose name ``match`` (a regular expression)
    finds: how many SASS instructions of each opcode (modifiers dropped, NOPs left out) its
    code holds, up to the first unpredicated EXIT. Static counts: a loop
    body is counted once."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out: dict[str, dict[str, int]] = {}
    name, done = None, False
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name, done = head.group(1), False
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not ins or name is None or done or not re.search(match, name):
            continue
        op = ins.group(2).split()
        op = op[1] if op[0].startswith("@") else op[0]
        if op.startswith("NOP"):
            continue
        done = ins.group(2) == "EXIT"
        key = op.split(".")[0]
        counts = out.setdefault(name, {})
        counts[key] = counts.get(key, 0) + 1
    return out


def b9_issue(segments: dict[str, list[int]], pixels: int, sm_count: int, clock_hz: float) -> dict:
    """Warp instructions a bilateral output pixel issues, from the SASS
    counts of the kernel this tree has, and the issue-time floor at
    ``pixels``. The per-pixel kernel (one pixel a thread, one pass of its
    loop at W = 256) issues its main body once a pixel. The tile kernel
    (2,048 pixels a block of 8 warps) runs its phases 1 and 3 once a warp,
    and its weight loop 19 times a block (17 chunk rows, 2 of halo
    weights), each pass counted with both branches: an upper bound."""
    # the float32 bilateral instance (BOX = false), on its float4 path where
    # it has one: <false, true, float> of a tile kernel over the frame type,
    # <false, true> of one over float32 frames, or a per-pixel <false>
    args = {k: k.split("kernel")[-1] for k in segments}
    name = next(k for pre in ("ILb0ELb1EfE", "ILb0ELb1EE", "ILb0EE")
                for k, a in args.items() if a.startswith(pre))
    segs = segments[name]
    if len(segs) == 1:
        per_px = segs[0] / 32
    else:
        per_px = (8 * (segs[0] + segs[2]) + 19 * segs[1]) / 2048
    return dict(kernel=name, segments=segs, warp_instructions_per_px=per_px,
                thread_instructions_per_px=per_px * 32,
                issue_floor_us=pixels * per_px / (sm_count * 4 * clock_hz) * 1e6)


def oneshot_only(args, tree, dev, rows, timed, oneshots, wire, G, N, H, W, P, offset) -> int:
    """``--oneshot``: B3/B5 in every instance, B3 (float32, float16 and
    bfloat16, v1) at each candidate of the tile search for the step family
    (the plans it hands the one-shot) beside its default launch, B10's pass
    B and B7 (K = 5) in the half types beside ``torch.sum(tmp, 0)`` and
    ``torch.median``; prints the JSON object and writes ``--out``."""
    import torch

    from chip_smoke import nvidia_smi
    from repro_torch.kernels import denoise_median, denoise_stream, denoise_tmpframe
    from repro_torch.tune import budget

    oneshots((torch.float32, torch.float16, torch.bfloat16))
    limits = budget.device_limits(dev)
    for fmt in ("u16", "u8", "p12"):
        frames = wire((G, N, H), fmt)
        for acc in (torch.float32, torch.float16, torch.bfloat16):
            tag = str(acc).split(".")[-1]
            vector = fmt != "p12" and acc == torch.float32  # the step's path (tune.autotune)
            for th, tp in budget.model_candidates("stream", P, H, W, stream_dtype=fmt,
                                                  vector=vector, limits=limits):
                timed("alg3_subtract_average", f"{fmt} v1 B=1 {tag} tiles {th}x{tp}",
                      lambda: denoise_stream.alg3_subtract_average(
                          frames, offset=offset, stream_dtype=fmt, accum_dtype=acc,
                          row_tile=th, pair_tile=tp))
        del frames
    u16 = wire((G, N, H), "u16")
    for acc in (torch.float16, torch.bfloat16):
        tag = str(acc).split(".")[-1]
        tmp = denoise_tmpframe.subtract_pass(u16, offset=offset, burst=True, accum_dtype=acc)
        timed("alg1_subtract_average", f"pass B {tag}", lambda: denoise_tmpframe.reduce_pass(tmp))
        timed("library", f"torch.sum(tmp, 0) {tag}", lambda: torch.sum(tmp, dim=0))
        timed("alg1_subtract_average", f"pass B {tag}", lambda: denoise_tmpframe.reduce_pass(tmp))
        del tmp
        window = torch.zeros(5, P, H, W, dtype=acc, device=dev)
        for k in range(5):
            denoise_median.median_window_insert(window, u16[k], slot=k, offset=offset)
        lib = torch.median(window, dim=0).values
        if not torch.equal(lib, denoise_median.median_combine(window)):
            raise AssertionError(f"torch.median and median_combine disagree ({tag}, K=5)")
        timed("median_combine", f"K=5 {tag}", lambda: denoise_median.median_combine(window))
        timed("library", f"torch.median K=5 {tag}", lambda: torch.median(window, dim=0))
        del window, lib
    from repro_torch.kernels import _build

    out = dict(card=nvidia_smi(), tree=str(tree), torch=torch.__version__, rows=rows,
               sass_mix=sass_mix(_build.library()._name, args.sass_mix) if args.sass_mix else None)
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


def tmpframe_only(args, tree, rows, timed, wire, G, N, H, W, P, offset, peak_bw) -> int:
    """``--tmpframe``: B10 at the paper's shape in each float type, pass A of
    Alg 1 and of Alg 2, pass B (both algorithms) beside ``torch.sum(tmp,
    0)`` and each algorithm in total, each with its byte bound (the frames
    and the tmpFrame read once, the tmpFrame and the averages written once);
    prints the JSON object and writes ``--out``."""
    import torch

    from chip_smoke import nvidia_smi
    from repro_torch.kernels import denoise_tmpframe

    frames = wire((G, N, H), "u16")
    tmp_px, out_px = G * P * H * W, P * H * W
    for acc in (torch.float32, torch.float16, torch.bfloat16):
        tag, b = str(acc).split(".")[-1], torch.empty((), dtype=acc).element_size()
        bytes_a = G * N * H * W * 2 + tmp_px * b
        bytes_b = tmp_px * b + out_px * b
        for alg, burst in (("alg1", False), ("alg2", True)):
            timed(f"{alg}_subtract_average", f"pass A {tag}",
                  lambda: denoise_tmpframe.subtract_pass(frames, offset=offset, burst=burst,
                                                         accum_dtype=acc),
                  bytes=bytes_a, bound_us=bytes_a / peak_bw * 1e6)
        tmp = denoise_tmpframe.subtract_pass(frames, offset=offset, burst=True, accum_dtype=acc)
        timed("alg1_subtract_average", f"pass B {tag}", lambda: denoise_tmpframe.reduce_pass(tmp),
              bytes=bytes_b, bound_us=bytes_b / peak_bw * 1e6)
        timed("library", f"torch.sum(tmp, 0) {tag}", lambda: torch.sum(tmp, dim=0))
        del tmp
        for alg in ("alg1", "alg2"):
            fn = getattr(denoise_tmpframe, f"{alg}_subtract_average")
            timed(f"{alg}_subtract_average", f"total {tag}",
                  lambda: fn(frames, offset=offset, accum_dtype=acc), bytes=bytes_a + bytes_b,
                  bound_us=(bytes_a + bytes_b) / peak_bw * 1e6)
    out = dict(card=nvidia_smi(), tree=str(tree), torch=torch.__version__, rows=rows)
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


def median_only(args, tree, dev, rows, timed, wire, G, N, H, W, P, offset, peak_bw) -> int:
    """``--median``: B6 at the paper's shape, one group into slot 2 of a
    5-slot window, in every wire format and window type (the wire read
    once, the slot written once), at each candidate of its family's tile
    search, and on an unaligned view (the scalar path) from u16 into
    float32; B3 and B5 (B = 2) from u16 wire, v1, in each float type;
    prints the JSON object and writes ``--out``."""
    import torch

    from chip_smoke import nvidia_smi
    from repro_torch.kernels import denoise_median, denoise_multibank, denoise_stream, quant
    from repro_torch.tune import budget

    limits = budget.device_limits(dev)
    out_px = P * H * W
    for fmt in ("u16", "u8", "p12"):
        group = wire((N, H), fmt)
        for acc in (torch.float32, torch.float16, torch.bfloat16):
            tag, b = str(acc).split(".")[-1], torch.empty((), dtype=acc).element_size()
            window = torch.zeros(5, P, H, W, dtype=acc, device=dev)
            nbytes = N * H * W * quant.wire_pixel_bytes(fmt) + out_px * b
            timed("median_window_insert", f"{fmt} {tag}",
                  lambda: denoise_median.median_window_insert(window, group, slot=2,
                                                              offset=offset, stream_dtype=fmt),
                  bytes=nbytes, bound_us=nbytes / peak_bw * 1e6)
            for th, tp in budget.model_candidates("median_insert", P, H, W, stream_dtype=fmt,
                                                  vector=True, limits=limits)[1:]:
                timed("median_window_insert", f"{fmt} {tag} tiles {th}x{tp}",
                      lambda: denoise_median.median_window_insert(
                          window, group, slot=2, offset=offset, stream_dtype=fmt,
                          row_tile=th, pair_tile=tp))
            del window
    buf = torch.empty(N * H * W + 1, dtype=torch.uint16, device=dev)
    view = buf[1:].view(N, H, W)
    view.copy_(wire((N, H), "u16"))
    window = torch.zeros(5, P, H, W, device=dev)
    timed("median_window_insert", "u16 float32 scalar (unaligned)",
          lambda: denoise_median.median_window_insert(window, view, slot=2, offset=offset))
    del buf, view, window
    banked = wire((2, G, N, H), "u16")
    for acc in (torch.float32, torch.float16, torch.bfloat16):
        tag, b = str(acc).split(".")[-1], torch.empty((), dtype=acc).element_size()
        kw = dict(offset=offset, accum_dtype=acc)
        for kernel, fn, frames, banks in (
                ("alg3_subtract_average", denoise_stream.alg3_subtract_average, banked[0], 1),
                ("multibank_subtract_average", denoise_multibank.multibank_subtract_average,
                 banked, 2)):
            nbytes = banks * (G * N * H * W * 2 + out_px * b)
            timed(kernel, f"u16 v1 B={banks} {tag}", lambda: fn(frames, **kw), bytes=nbytes,
                  bound_us=nbytes / peak_bw * 1e6)
    out = dict(card=nvidia_smi(), tree=str(tree), torch=torch.__version__, rows=rows)
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--out", default=None)
    ap.add_argument("--b9-save", default=None)
    ap.add_argument("--b9-ref", default=None)
    ap.add_argument("--sass-dump", default=None, help="write the B9 kernels' SASS to this file")
    ap.add_argument("--sass-mix", default=None, metavar="MATCH",
                    help="count the SASS opcodes of each kernel whose name this regex finds")
    ap.add_argument("--build-times", action="store_true",
                    help="compile each source alone, cold, and record its seconds")
    ap.add_argument("--oneshot", action="store_true",
                    help="time only the one-shots (B3/B5) in every instance and at the tile "
                         "search's candidates, B10's pass B and B7 in the half types beside "
                         "their library calls")
    ap.add_argument("--tmpframe", action="store_true",
                    help="time only B10: each pass and each algorithm in float32, float16 and "
                         "bfloat16, pass B beside torch.sum(tmp, 0)")
    ap.add_argument("--median", action="store_true",
                    help="time only B6 in every wire format and window type, at its plans' "
                         "candidates and on its scalar path, with B3/B5 from u16 wire")
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
        denoise_median,
        denoise_multibank,
        denoise_spatial,
        denoise_stream,
        denoise_tmpframe,
        quant,
    )
    sys.path.insert(1, str(ROOT))
    from chip_smoke import card_peaks, host_us, nvidia_smi, time_ms

    if not Path(denoise_stream.__file__).is_relative_to(tree):
        raise RuntimeError(f"imported {denoise_stream.__file__}, not the tree {tree}")
    import time

    t0 = time.perf_counter()
    _build.library()  # the tree's own parallel build, as chip_smoke.py's
    library_build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    G, N, H, W = 8, 1000, 80, 256
    P, offset = N // 2, 4096.0

    def wire(shape, fmt):
        px = rng.integers(0, 4096, shape + (W,)).astype(np.uint16)
        return torch.from_numpy(np.ascontiguousarray(quant.encode(px, fmt))).to(dev)

    rows = []
    peak_bw = card_peaks(torch.cuda.get_device_name(0))[0]

    def timed(kernel, label, call, **extra):
        rows.append(dict(kernel=kernel, label=label, us=time_ms(call) * 1e3, **extra))

    def oneshots(accs):
        """B3 (bank 0) and B5 (B = 2) in every wire format, variant and sum
        type of ``accs``, each beside its byte bound: the wire read once, the
        averages written once."""
        for fmt in ("u16", "u8", "p12"):
            banked = wire((2, G, N, H), fmt)
            for acc in accs:
                tag, acc_bytes = str(acc).split(".")[-1], torch.empty((), dtype=acc).element_size()
                for df in (False, True):
                    kw = dict(offset=offset, divide_first=df, stream_dtype=fmt, accum_dtype=acc)
                    for kernel, fn, frames, b in (
                            ("alg3_subtract_average", denoise_stream.alg3_subtract_average,
                             banked[0], 1),
                            ("multibank_subtract_average",
                             denoise_multibank.multibank_subtract_average, banked, 2)):
                        nbytes = b * (G * N * H * W * quant.wire_pixel_bytes(fmt)
                                      + P * H * W * acc_bytes)
                        timed(kernel, f"{fmt} {'v2' if df else 'v1'} B={b} {tag}",
                              lambda: fn(frames, **kw), bytes=nbytes,
                              bound_us=nbytes / peak_bw * 1e6)
            del banked

    if args.tmpframe:
        return tmpframe_only(args, tree, rows, timed, wire, G, N, H, W, P, offset, peak_bw)
    if args.oneshot:
        return oneshot_only(args, tree, dev, rows, timed, oneshots, wire, G, N, H, W, P, offset)
    if args.median:
        return median_only(args, tree, dev, rows, timed, wire, G, N, H, W, P, offset, peak_bw)
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

    # the step's scalar path (an unaligned view) and the integer sums (B2-B5, B10)
    buf = torch.empty(N * H * W + 1, dtype=torch.uint16, device=dev)
    fv = buf[1:].view(N, H, W)
    fv.copy_(wire((N, H), "u16"))
    sbuf = torch.zeros(P * H * W + 1, device=dev)
    sv = sbuf[1:].view(P, H, W)
    timed("alg3_stream_step", "u16 v1 scalar (unaligned)", lambda: denoise_stream.alg3_stream_step(
        fv, sv, num_groups=G, offset=offset))
    del buf, fv, sbuf, sv
    frames8 = wire((G, N, H), "u16")
    frames2 = wire((2, G, N, H), "u16")
    for acc in (torch.float32, torch.int32, torch.uint16):
        name = str(acc).split(".")[-1]
        one, two = frames8[0], frames2[:, 0].contiguous()
        s1 = torch.zeros(P, H, W, dtype=acc, device=dev)
        s2 = torch.zeros(2, P, H, W, dtype=acc, device=dev)
        if acc != torch.float32:
            timed("alg3_stream_step", f"u16 v1 {name}", lambda: denoise_stream.alg3_stream_step(
                one, s1, num_groups=G, offset=offset))
            timed("multibank_stream_step", f"u16 v1 B=2 {name}",
                  lambda: denoise_multibank.multibank_stream_step(two, s2, num_groups=G,
                                                                  offset=offset))
        timed("alg3_subtract_average", f"u16 v1 {name}",
              lambda: denoise_stream.alg3_subtract_average(frames8, offset=offset,
                                                           accum_dtype=acc))
        timed("multibank_subtract_average", f"u16 v1 B=2 {name}",
              lambda: denoise_multibank.multibank_subtract_average(frames2, offset=offset,
                                                                   accum_dtype=acc))
        for alg in ("alg1", "alg2"):
            fn = getattr(denoise_tmpframe, f"{alg}_subtract_average")
            timed(f"{alg}_subtract_average", f"u16 {name}",
                  lambda: fn(frames8, offset=offset, accum_dtype=acc))
        del s1, s2
    tmp = denoise_tmpframe.subtract_pass(frames8, offset=offset, burst=True)
    timed("alg1_subtract_average", "pass B", lambda: denoise_tmpframe.reduce_pass(tmp))
    for burst in (False, True):
        timed("alg2_subtract_average" if burst else "alg1_subtract_average", "pass A",
              lambda: denoise_tmpframe.subtract_pass(frames8, offset=offset, burst=burst))
    del frames2, tmp
    oneshots((torch.float32,))  # every wire format and variant into a float32 sum
    # the median window (B6) and its combine (B7, K = 5)
    window = torch.zeros(5, P, H, W, device=dev)
    for k in range(5):
        denoise_median.median_window_insert(window, frames8[k], slot=k, offset=offset)
    timed("median_window_insert", "u16", lambda: denoise_median.median_window_insert(
        window, frames8[5], slot=2, offset=offset))
    timed("median_combine", "K=5", lambda: denoise_median.median_combine(window))
    del window, frames8
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
    # the float16 and bfloat16 instances of every kernel (the labels of
    # chip_smoke.py's phase 4), and the library calls beside B9 and B10
    import torch.nn.functional as F

    half = (torch.float16, torch.bfloat16)
    tags = {acc: str(acc).split(".")[-1] for acc in half}
    for fmt in ("u16", "u8", "p12"):
        banked = wire((2, G, N, H), fmt)
        one, two, group = banked[0], banked[:, 0].contiguous(), banked[0, 0]
        for acc in half:
            tag = tags[acc]
            s1 = torch.zeros(P, H, W, dtype=acc, device=dev)
            s2 = torch.zeros(2, P, H, W, dtype=acc, device=dev)
            for df in (False, True):
                v = "v2" if df else "v1"
                kw = dict(offset=offset, divide_first=df, stream_dtype=fmt)
                timed("alg3_stream_step", f"{fmt} {v} {tag}", lambda: denoise_stream.alg3_stream_step(
                    group, s1, num_groups=G, **kw))
                timed("multibank_stream_step", f"{fmt} {v} B=2 {tag}",
                      lambda: denoise_multibank.multibank_stream_step(two, s2, num_groups=G, **kw))
                timed("alg3_subtract_average", f"{fmt} {v} B=1 {tag}",
                      lambda: denoise_stream.alg3_subtract_average(one, accum_dtype=acc, **kw))
                timed("multibank_subtract_average", f"{fmt} {v} B=2 {tag}",
                      lambda: denoise_multibank.multibank_subtract_average(banked, accum_dtype=acc,
                                                                           **kw))
            window = torch.zeros(5, P, H, W, dtype=acc, device=dev)
            timed("median_window_insert", f"{fmt} {tag}", lambda: denoise_median.median_window_insert(
                window, group, slot=2, offset=offset, stream_dtype=fmt))
            if fmt == "u16":
                for k in range(5):
                    denoise_median.median_window_insert(window, one[k], slot=k, offset=offset)
                timed("median_combine", f"K=5 {tag}", lambda: denoise_median.median_combine(window))
            del s1, s2, window
            state = [torch.zeros(P, H, W, dtype=acc, device=dev),
                     torch.zeros(H, W, dtype=acc, device=dev),
                     torch.zeros(H, W, dtype=acc, device=dev)]
            timed("ema_welford_step", f"{fmt} pair_tile=5 {tag}", lambda: denoise_ema.ema_welford_step(
                *state, group, alpha=0.25, offset=offset, prior_count=0, pair_tile=5,
                stream_dtype=fmt))
            del state
            if fmt == "u16":
                for alg in ("alg1", "alg2"):
                    fn = getattr(denoise_tmpframe, f"{alg}_subtract_average")
                    timed(f"{alg}_subtract_average", f"u16 v1 B=1 {tag}",
                          lambda: fn(one, offset=offset, accum_dtype=acc))
                tmp = denoise_tmpframe.subtract_pass(one, offset=offset, burst=True,
                                                     accum_dtype=acc)
                timed("alg1_subtract_average", f"pass B {tag}",
                      lambda: denoise_tmpframe.reduce_pass(tmp))
                timed("library", f"torch.sum(tmp, 0) {tag}", lambda: torch.sum(tmp, dim=0))
                del tmp
        del banked, one, two, group
    for acc in half:
        tag = tags[acc]
        xh = x.to(acc)
        for mode in ("box", "bilateral"):
            timed("spatial_filter_3x3", f"{mode} {tag}", lambda: denoise_spatial.spatial_filter_3x3(
                xh, mode=mode, range_sigma=60.0))
        timed("library", f"pad + avg_pool2d {tag}", lambda: F.avg_pool2d(
            F.pad(xh[:, None], (1, 1, 1, 1), mode="replicate"), 3, stride=1))
        del xh
    build_s = None
    if args.build_times:
        import tempfile

        build_s = {}
        with tempfile.TemporaryDirectory() as tmpdir:
            for src in _build.SOURCES:
                t0 = time.perf_counter()
                subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                                str(Path(tmpdir) / f"{src.stem}.o"), str(src)],
                               check=True, capture_output=True, timeout=900)
                build_s[src.name] = time.perf_counter() - t0
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
               b9_bilateral_issue=issue, library_build_s=library_build_s, build_s=build_s,
               sass_mix=sass_mix(_build.library()._name, args.sass_mix) if args.sass_mix else None)
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
