"""The temporal-median filter's kernels on Hopper (counterpart of
``repro.kernels.denoise_median``), over ``csrc/denoise_median.cu``.

* :func:`median_window_insert` — one group's pair diffs written into
  ``window[slot]`` of the ``(K, N/2, H, W)`` window, **in place** (the
  reference donates the window). Only that slot is written: the step
  moves one group in and one frame out, as Alg 3's running-sum step.
* :func:`median_combine` — the per-pixel median over the leading axis of
  the filled prefix ``(K, N/2, H, W)``, as a **fresh** ``(N/2, H, W)``
  tensor: the reference's odd-even transposition network of min/max,
  and ``(lo + hi) * 0.5`` for even K. Both are exact, so the plain
  version below and the kernel agree bit for bit, with each other and
  with the reference's network or its ``jnp.sort``.

The window is float32, float16 or bfloat16 (the even-K add rounds to
its type). Dispatch, checks and launch counters are as in
:mod:`repro_torch.kernels.denoise_stream`. The insert has two paths, chosen
on the host (:func:`insert_path`) and passed to the kernel as a flag, which
refuses a vector launch on operands that do not allow it and never
reroutes one: the vector path takes the one-shot's wire vectors (8 u16
pixels a thread in one 16-byte load, 16 u8 in one, 16 p12 in three 8-byte
loads), computes their differences as the one-shot does (packed pairs for
a half window) and stores 16-byte words of the slot; the scalar path takes
a ragged plane or an unaligned view. Each launch is counted in
``median_window_insert.vector_launches`` or ``.scalar_launches`` as well
as in ``.launches``. The scalar path takes a plan's geometry,
``row_tile`` rows of ``pair_tile`` pairs a block; the vector path has one
layout (512 vectors of a pair a block) and validates a plan's tiles
without taking them: each geometry the launch model offers ran slower on
the H100, or equal within noise (``PERF.md`` section 6). Every geometry
gives the same bits. The combine
has one geometry, a flat grid of 256-thread blocks: it validates the
tiles a plan gives it, as the reference does, and launches that one. The CUDA combine runs the
network for K <= :data:`NETWORK_WINDOW` and, above it, an exact selection
of the middle ranks by counting, which gives the same values (its
launches also count in ``median_combine.select_launches``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, quant, ref
from repro_torch.kernels.denoise_stream import (
    ACCUM_CODES,
    FLOAT_ACCUMS,
    NOT_PORTED_ACCUM,
    acc_constants,
    check_kernel_operands,
    check_launch,
    on_cuda,
    oneshot_path,
)
from repro_torch.tune.budget import launch_tiles

__all__ = [
    "NETWORK_WINDOW",
    "insert_path",
    "median_window_insert",
    "median_window_insert_plain",
    "median_combine",
    "median_combine_plain",
]

#: the longest window the CUDA combine sorts with its network; longer ones
#: take the selection path (``kMaxWindow`` in ``csrc/denoise_median.cu``)
NETWORK_WINDOW = 64


def _check_insert(window, group_frames, slot, stream_dtype):
    if window.ndim != 4 or group_frames.ndim != 3:
        raise ValueError(
            f"expected a (K, N/2, H, W) window and (N, H, wire_W) frames, got "
            f"{tuple(window.shape)} and {tuple(group_frames.shape)}"
        )
    k, p, h, w = window.shape
    n, fh, wp = group_frames.shape
    if (n, fh, quant.logical_width(wp, stream_dtype)) != (2 * p, h, w):
        raise ValueError(
            f"group {tuple(group_frames.shape)} does not match window "
            f"{tuple(window.shape)} ({stream_dtype})"
        )
    if not 0 <= slot < k:
        raise ValueError(f"slot {slot} outside window of {k}")


def insert_path(plane_px: int, stream_dtype: str, frames_ptr: int, slot_ptr: int) -> str:
    """The insert kernel's path for planes of ``plane_px`` = H*W pixels.

    ``"vector"`` (the one-shot's vector: 8 u16 or 16 u8/p12 pixels a
    thread) when H*W is a multiple of that vector, the group's frames start
    on the alignment of its loads (16 bytes, 8 for p12) and the window slot
    on 16 bytes: every plane then starts so aligned. ``"scalar"``
    otherwise: a ragged plane, an unaligned view. The rule is the
    one-shot's (:func:`~repro_torch.kernels.denoise_stream.oneshot_path`),
    for every float window.
    """
    return oneshot_path(plane_px, stream_dtype, frames_ptr, slot_ptr)


def median_window_insert_plain(
    window: torch.Tensor, group_frames: torch.Tensor, *, slot: int,
    offset: float = 0.0, stream_dtype: str = "u16",
) -> torch.Tensor:
    """Plain PyTorch version of the insert: writes ``window[slot]`` in place."""
    window[slot] = ref.pair_diff(
        group_frames, offset=offset, accum_dtype=window.dtype, stream_dtype=stream_dtype
    )
    return window


def median_window_insert(
    window: torch.Tensor,
    group_frames: torch.Tensor,
    *,
    slot: int,
    offset: float = 0.0,
    stream_dtype: str = "u16",
    row_tile: int | None = None,
    pair_tile: int | None = None,
) -> torch.Tensor:
    """Write the group's diff frames into ``window[slot]``; returns ``window``."""
    _check_insert(window, group_frames, slot, stream_dtype)
    tiles = launch_tiles(window.shape[1], window.shape[2], row_tile, pair_tile)
    if not on_cuda(window, group_frames):
        return median_window_insert_plain(
            window, group_frames, slot=slot, offset=offset, stream_dtype=stream_dtype
        )
    dst = window[slot]
    fmt, items, row_bytes = check_kernel_operands(group_frames, window, stream_dtype)
    n, h, _ = group_frames.shape
    path = insert_path(h * window.shape[-1], stream_dtype, group_frames.data_ptr(),
                       dst.data_ptr())
    lib = _build.library()
    with torch.cuda.device(window.device):
        rc = lib.median_window_insert_launch(
            group_frames.data_ptr(), dst.data_ptr(), n // 2, h, items, row_bytes, fmt,
            int(path == "vector"), *acc_constants(window.dtype, offset)[:2], *tiles,
            ACCUM_CODES[window.dtype], torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "median_window_insert")
    median_window_insert.launches += 1
    setattr(median_window_insert, f"{path}_launches",
            getattr(median_window_insert, f"{path}_launches") + 1)
    return window


median_window_insert.launches = 0
median_window_insert.vector_launches = 0
median_window_insert.scalar_launches = 0


def median_combine_plain(window: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the combine: the same min/max network; a
    fresh tensor for every K (never a view of the window)."""
    count = window.shape[0]
    vals = [window[i] for i in range(count)]
    for rnd in range(count):
        for i in range(rnd % 2, count - 1, 2):
            lo = torch.minimum(vals[i], vals[i + 1])
            hi = torch.maximum(vals[i], vals[i + 1])
            vals[i], vals[i + 1] = lo, hi
    if count % 2:
        return vals[count // 2].clone()
    return (vals[count // 2 - 1] + vals[count // 2]) * torch.tensor(0.5, dtype=window.dtype)


def median_combine(
    window: torch.Tensor, *, row_tile: int | None = None, pair_tile: int | None = None,
) -> torch.Tensor:
    """(K, N/2, H, W) filled window prefix -> (N/2, H, W) per-pixel median."""
    if window.ndim != 4 or window.shape[0] < 1:
        raise ValueError(f"expected a (K >= 1, N/2, H, W) window, got {tuple(window.shape)}")
    launch_tiles(window.shape[1], window.shape[2], row_tile, pair_tile)
    if not on_cuda(window):
        return median_combine_plain(window)
    k = window.shape[0]
    if window.dtype not in FLOAT_ACCUMS:
        raise NotImplementedError(f"accumulator {window.dtype}: {NOT_PORTED_ACCUM}")
    if not window.is_contiguous():
        raise ValueError("the CUDA kernels need a contiguous window")
    out = torch.empty(window.shape[1:], dtype=window.dtype, device=window.device)
    lib = _build.library()
    with torch.cuda.device(window.device):
        rc = lib.median_combine_launch(
            window.data_ptr(), out.data_ptr(), k, out.numel(), ACCUM_CODES[window.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "median_combine")
    median_combine.launches += 1
    median_combine.select_launches += k > NETWORK_WINDOW
    return out


median_combine.launches = 0
median_combine.select_launches = 0
