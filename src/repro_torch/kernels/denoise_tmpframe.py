"""Paper Algorithms 1 and 2 (the baselines) on Hopper: the tmpFrame in HBM.

Counterpart of ``repro.kernels.denoise_tmpframe``. Both algorithms write
every difference frame, the tmpFrame ``(G, N/2, H, W)`` float32, to device
memory in a first pass and read it back in a second, so they move some
``2 * G * N/2 * H * W * 4`` bytes more than the fused Algorithm 3 kernel.
That traffic is the point of the paper's comparison, so the two passes
stay two kernels and two launches (``csrc/denoise_tmpframe.cu``):

* :func:`subtract_pass` (pass A) — ``tmp = f32(exc) - f32(ctl) + offset``
  into a tmpFrame allocated on the call's device;
* :func:`reduce_pass` (pass B) — the G tmpFrames summed from zero in group
  order, then multiplied by ``f32(1/G)`` (the reference's jitted ``/ G``).

:func:`alg1_subtract_average` runs pass A at Alg 1's granularity (one
image row per block, one element per thread), :func:`alg2_subtract_average`
at Alg 2's (wide tiles, 16-byte stores); both share pass B. The tile
changes no number, so the two are bitwise equal, to each other and to
Alg 3's one-shot kernel.

Dispatch is as in :mod:`repro_torch.kernels.denoise_stream`: on a CUDA
tensor the wrapper checks its operands, launches both kernels on the
current stream and adds one to ``<wrapper>.launches`` at each launch (two
per call); on a CPU tensor it runs the plain version (``*_plain``). The
kernels ingest u16 frames only, as the reference's Pallas baselines have
no dequant path, into a float32 accumulator or an int32 or uint16 one
(the tmpFrame then has that type; pass B floors its division by G, as
the plain version does).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.denoise_stream import (
    ACCUM_CODES,
    NOT_PORTED_ACCUM,
    check_launch,
    on_cuda,
)
from repro_torch.tune.budget import launch_tiles

__all__ = [
    "alg1_subtract_average",
    "alg1_subtract_average_plain",
    "alg2_subtract_average",
    "alg2_subtract_average_plain",
    "reduce_pass",
    "subtract_pass",
    "subtract_pass_plain",
    "reduce_pass_plain",
]


def _check_frames(frames: torch.Tensor) -> None:
    if frames.ndim != 4 or frames.shape[1] % 2 or frames.shape[0] < 1:
        raise ValueError(
            f"expected (G, N, H, W) frames with G >= 1 and N even, got "
            f"{tuple(frames.shape)}"
        )


def _check_cuda_frames(frames: torch.Tensor, accum_dtype) -> None:
    if ref.as_torch_dtype(accum_dtype) not in ACCUM_CODES:
        raise NotImplementedError(f"accumulator {accum_dtype}: {NOT_PORTED_ACCUM}")
    if frames.dtype != torch.uint16:
        raise TypeError(
            f"the tmpFrame kernels ingest torch.uint16 frames, got {frames.dtype}"
        )
    if not frames.is_contiguous():
        raise ValueError("the CUDA kernels need contiguous frames")


def subtract_pass_plain(
    frames: torch.Tensor, *, offset: float = 0.0, accum_dtype=torch.float32
) -> torch.Tensor:
    """Plain PyTorch pass A: (G, N, H, W) -> tmpFrame (G, N/2, H, W)."""
    return ref.pair_diff(frames, offset=offset, accum_dtype=accum_dtype)


def reduce_pass_plain(tmp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pass B: sum over G from zero, in order, then the
    reciprocal scale (a floor division for integer accumulators)."""
    g = tmp.shape[0]
    total = torch.zeros(tmp.shape[1:], dtype=tmp.dtype, device=tmp.device)
    for k in range(g):
        total = ref.fold(total, tmp[k], divide_first=False, num_groups=g)
    return ref.scale_reciprocal(total, g)


def subtract_pass(frames: torch.Tensor, *, offset: float = 0.0, burst: bool,
                  accum_dtype=torch.float32, tiles: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Pass A on the card: a new (G, N/2, H, W) tmpFrame in HBM, of the
    accumulator's type. ``burst`` picks Alg 2's wide tiles over Alg 1's
    single rows; ``tiles`` is the launcher's ``(row_tile, pair_tile)``
    (``launch_tiles``; 0 = the default geometry)."""
    _check_frames(frames)
    _check_cuda_frames(frames, accum_dtype)
    g, n, h, w = frames.shape
    acc = ref.as_torch_dtype(accum_dtype)
    tmp = torch.empty((g, n // 2, h, w), dtype=acc, device=frames.device)
    with torch.cuda.device(frames.device):
        rc = _build.library().tmpframe_subtract_launch(
            frames.data_ptr(), tmp.data_ptr(), g * (n // 2), h, w, int(burst),
            float(offset), ACCUM_CODES[acc], *tiles, torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "tmpframe_subtract")
    return tmp


def reduce_pass(tmp: torch.Tensor, *, tiles: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Pass B on the card: tmpFrame (G, P, H, W) -> (P, H, W) averaged,
    ``tiles`` as for :func:`subtract_pass`."""
    if tmp.ndim != 4 or tmp.dtype not in ACCUM_CODES or not tmp.is_contiguous():
        raise ValueError(
            f"expected a contiguous (G, P, H, W) float32, int32 or uint16 "
            f"tmpFrame, got {tuple(tmp.shape)} {tmp.dtype}"
        )
    g, p, h, w = tmp.shape
    out = torch.empty((p, h, w), dtype=tmp.dtype, device=tmp.device)
    with torch.cuda.device(tmp.device):
        rc = _build.library().tmpframe_reduce_launch(
            tmp.data_ptr(), out.data_ptr(), g, p, h, w, ref.reciprocal(g),
            ACCUM_CODES[tmp.dtype], *tiles, torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "tmpframe_reduce")
    return out


def _two_pass(fn, frames, *, offset, accum_dtype, burst, row_tile, pair_tile):
    _check_frames(frames)
    tiles = launch_tiles(frames.shape[1] // 2, frames.shape[2], row_tile, pair_tile)
    if not on_cuda(frames):
        return alg1_subtract_average_plain(frames, offset=offset, accum_dtype=accum_dtype)
    tmp = subtract_pass(frames, offset=offset, burst=burst, accum_dtype=accum_dtype,
                        tiles=tiles)
    fn.launches += 1
    out = reduce_pass(tmp, tiles=tiles)
    fn.launches += 1
    return out


def alg1_subtract_average_plain(
    frames: torch.Tensor, *, offset: float = 0.0, accum_dtype=torch.float32
) -> torch.Tensor:
    """Plain PyTorch version of both baselines: pass A, then pass B."""
    return reduce_pass_plain(
        subtract_pass_plain(frames, offset=offset, accum_dtype=accum_dtype)
    )


#: the tile changes no number: one plain version serves both algorithms
alg2_subtract_average_plain = alg1_subtract_average_plain


def alg1_subtract_average(
    frames: torch.Tensor, *, offset: float = 0.0, accum_dtype=torch.float32,
    row_tile: int | None = None, pair_tile: int | None = None,
) -> torch.Tensor:
    """Algorithm 1: tmpFrame in HBM, single-row (non-burst) writes and reads;
    ``row_tile`` / ``pair_tile`` set both passes' launch geometry."""
    return _two_pass(
        alg1_subtract_average, frames, offset=offset, accum_dtype=accum_dtype, burst=False,
        row_tile=row_tile, pair_tile=pair_tile,
    )


alg1_subtract_average.launches = 0


def alg2_subtract_average(
    frames: torch.Tensor, *, offset: float = 0.0, accum_dtype=torch.float32,
    row_tile: int | None = None, pair_tile: int | None = None,
) -> torch.Tensor:
    """Algorithm 2: burst (wide-tile) writes of the tmpFrame, row reads;
    ``row_tile`` / ``pair_tile`` as for :func:`alg1_subtract_average`."""
    return _two_pass(
        alg2_subtract_average, frames, offset=offset, accum_dtype=accum_dtype, burst=True,
        row_tile=row_tile, pair_tile=pair_tile,
    )


alg2_subtract_average.launches = 0
