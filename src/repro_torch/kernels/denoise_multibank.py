"""Multi-bank subtract-accumulate on Hopper: every bank in one launch.

Counterpart of ``repro.kernels.denoise_multibank``. The paper gives each
256×80 pixel bank its own FPGA, and banks never communicate; here a bank
is one more index the kernel decodes from its block number, so banks
share one launch and never touch each other's data.

* :func:`multibank_stream_step` — one group per bank ``(B, N, H, wire_W)``
  folded into the sums ``(B, N/2, H, W)``, **in place**.
* :func:`multibank_subtract_average` — one shot ``(B, G, N, H, wire_W)``
  -> ``(B, N/2, H, W)``.

Both run kernels of ``csrc/denoise_stream.cu`` (the bank axis is a stride
of the same templated bodies) through launchers and launch counters of
their own. The step takes the vector or the scalar path, as
:func:`repro_torch.kernels.denoise_stream.step_path` picks, counted in
``multibank_stream_step.vector_launches`` / ``.scalar_launches``.
Dispatch and checks are as in :mod:`repro_torch.kernels.denoise_stream`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, quant, ref
from repro_torch.kernels.denoise_stream import (
    ACCUM_CODES,
    U8_SCALE_F32,
    check_step_shapes,
    alg3_stream_step_plain,
    alg3_subtract_average_plain,
    check_kernel_operands,
    check_launch,
    launch_step,
    on_cuda,
)
from repro_torch.tune.budget import launch_tiles

__all__ = [
    "multibank_stream_step",
    "multibank_stream_step_plain",
    "multibank_subtract_average",
    "multibank_subtract_average_plain",
]

#: the plain versions are the single-bank ones: both carry leading axes
multibank_stream_step_plain = alg3_stream_step_plain
multibank_subtract_average_plain = alg3_subtract_average_plain


def multibank_stream_step(
    group_frames: torch.Tensor,
    sum_frames: torch.Tensor,
    *,
    num_groups: int,
    offset: float = 0.0,
    divide_first: bool = False,
    final: bool = False,
    stream_dtype: str = "u16",
    row_tile: int | None = None,
    pair_tile: int | None = None,
) -> torch.Tensor:
    """Fold one group per bank (B, N, H, wire_W) into sums (B, N/2, H, W), in
    place; ``row_tile`` / ``pair_tile`` as for the single-bank step."""
    check_step_shapes(group_frames, sum_frames, stream_dtype, banked=True)
    b, n, h, _ = group_frames.shape
    tiles = launch_tiles(n // 2, h, row_tile, pair_tile)
    if not on_cuda(group_frames, sum_frames):
        return sum_frames.copy_(multibank_stream_step_plain(
            group_frames, sum_frames, num_groups=num_groups, offset=offset,
            divide_first=divide_first, final=final, stream_dtype=stream_dtype,
        ))
    fmt, items, row_bytes = check_kernel_operands(group_frames, sum_frames, stream_dtype,
                                                  integer_sums=True)
    launch_step(multibank_stream_step, "multibank_stream_step_launch", group_frames,
                sum_frames, (b, n // 2, h, items, row_bytes), fmt=fmt,
                divide_first=divide_first, final=final, offset=offset,
                num_groups=num_groups, stream_dtype=stream_dtype, tiles=tiles)
    return sum_frames


multibank_stream_step.launches = 0
multibank_stream_step.vector_launches = 0
multibank_stream_step.scalar_launches = 0


def multibank_subtract_average(
    frames: torch.Tensor,
    *,
    offset: float = 0.0,
    divide_first: bool = False,
    accum_dtype=torch.float32,
    stream_dtype: str = "u16",
    row_tile: int | None = None,
    pair_tile: int | None = None,
) -> torch.Tensor:
    """frames (B, G, N, H, wire_W) -> (B, N/2, H, W), one launch."""
    if frames.ndim != 5 or frames.shape[2] % 2:
        raise ValueError(
            f"expected (B, G, N, H, wire_W) with N even, got {tuple(frames.shape)}"
        )
    tiles = launch_tiles(frames.shape[2] // 2, frames.shape[3], row_tile, pair_tile)
    if not on_cuda(frames):
        return multibank_subtract_average_plain(
            frames, offset=offset, divide_first=divide_first,
            accum_dtype=accum_dtype, stream_dtype=stream_dtype,
        )
    b, g, n, h, wp = frames.shape
    out = torch.empty(
        (b, n // 2, h, quant.logical_width(wp, stream_dtype)),
        dtype=ref.as_torch_dtype(accum_dtype), device=frames.device,
    )
    fmt, items, row_bytes = check_kernel_operands(frames, out, stream_dtype, integer_sums=True)
    lib = _build.library()
    with torch.cuda.device(frames.device):
        rc = lib.multibank_subtract_average_launch(
            frames.data_ptr(), out.data_ptr(), b, g, n // 2, h, items,
            row_bytes, fmt, int(divide_first), float(offset), U8_SCALE_F32,
            ref.reciprocal(g), ACCUM_CODES[out.dtype], *tiles,
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "multibank_subtract_average")
    multibank_subtract_average.launches += 1
    return out


multibank_subtract_average.launches = 0
