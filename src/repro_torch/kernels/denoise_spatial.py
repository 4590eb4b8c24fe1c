"""The post-average 3×3 spatial stage on Hopper (counterpart of
``repro.kernels.denoise_spatial``), over ``csrc/denoise_spatial.cu``.

:func:`spatial_filter_3x3` maps ``(P, H, W)`` float32 frames to a fresh
``(P, H, W)`` tensor, image edges replicated:

* ``box`` — the 3×3 mean, rounded as the reference's jitted
  ``sum(neighbours) / 9``: a sequential sum (rows top to bottom, columns
  left to right) times ``f32(1/9)``. Bitwise equal to the reference.
* ``bilateral`` — uniform support with Gaussian range weights
  ``exp(-(x_i - x_c)^2 * f32(1/(2 sigma^2)))`` and a true division by the
  weight sum. ``exp`` is not the same function in XLA, PyTorch and CUDA,
  so this mode is held to the reference and to the kernel within
  :data:`BILATERAL_RTOL`.

The kernel stages tiles of 16 rows x 128 columns with their halo in
shared memory. It takes one of two paths, chosen on the host by
:func:`tile_path` and counted in ``spatial_filter_3x3.vector_launches``
or ``.scalar_launches``: float4 loads and stores where W % 4 == 0 and
both planes are 16-byte aligned, scalar ones otherwise. Dispatch, checks
and the launch counter are as in :mod:`repro_torch.kernels.denoise_stream`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.denoise_stream import check_launch, on_cuda
from repro_torch.tune.budget import launch_tiles

__all__ = ["BILATERAL_RTOL", "spatial_filter_3x3", "spatial_filter_3x3_plain", "tile_path"]

#: declared tolerance of ``bilateral`` against the reference and between
#: the kernel and its plain version. Each float32 evaluation rounds its
#: two 9-term sums at every step and lands within about 5e-7 of the
#: float64 value; a few ulp of ``exp`` error move the weighted mean by
#: less than that. Across data around 4096 and range sigmas 10-200 the
#: kernel and its plain version differ by at most 3.75e-7, while a dropped
#: neighbour or a wrong range sigma differs by 1.2e-3 or more
#: (``scripts/torch_bilateral_margin.py``); the limit sits between them.
BILATERAL_RTOL = 1e-6

_MODES = {"box": 0, "bilateral": 1}


def _inv2s2(range_sigma: float) -> float:
    """``f32(1 / (2 sigma^2))``, computed in float64 as the reference's host does."""
    return float(np.float32(1.0 / (2.0 * range_sigma * range_sigma)))


def tile_path(width: int, in_ptr: int, out_ptr: int) -> str:
    """The kernel's path for rows of ``width`` pixels: ``"vector"`` (float4
    loads and stores) when W % 4 == 0 and both planes start 16-byte aligned
    (every row then does), ``"scalar"`` otherwise."""
    return "vector" if width % 4 == 0 and in_ptr % 16 == 0 and out_ptr % 16 == 0 else "scalar"


def _neighbours(frames: torch.Tensor) -> list[torch.Tensor]:
    """The nine edge-replicated shifts of ``frames``, rows top to bottom,
    columns left to right."""
    _, h, w = frames.shape
    rows = torch.arange(h, device=frames.device)
    cols = torch.arange(w, device=frames.device)
    out = []
    for dr in (-1, 0, 1):
        r = (rows + dr).clamp(0, h - 1)
        for dc in (-1, 0, 1):
            c = (cols + dc).clamp(0, w - 1)
            out.append(frames[:, r][:, :, c])
    return out


def spatial_filter_3x3_plain(
    frames: torch.Tensor, *, mode: str = "box", range_sigma: float = 50.0
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (and the reference's padded-shift
    XLA composite, which rounds alike); a fresh tensor."""
    nbs = _neighbours(frames)
    if mode == "box":
        total = torch.zeros_like(frames)
        for nb in nbs:
            total = total + nb
        return total * torch.tensor(np.float32(1) / np.float32(9))
    inv2s2 = torch.tensor(_inv2s2(range_sigma), dtype=frames.dtype)
    acc = torch.zeros_like(frames)
    wsum = torch.zeros_like(frames)
    for nb in nbs:
        d = nb - frames
        wgt = torch.exp(-(d * d) * inv2s2)
        acc = ref.fma_f32(wgt, nb, acc)
        wsum = wsum + wgt
    return acc / wsum


def spatial_filter_3x3(
    frames: torch.Tensor, *, mode: str = "box", range_sigma: float = 50.0,
    row_tile: int | None = None, pair_tile: int | None = None,
) -> torch.Tensor:
    """(P, H, W) -> (P, H, W): 3×3 box or bilateral-lite smoothing per frame.

    The kernel has one geometry, its 16 x 128 tile: ``row_tile`` /
    ``pair_tile`` from a plan are validated as the reference does, and that
    one geometry runs."""
    if frames.ndim != 3:
        raise ValueError(f"expected (P, H, W) frames, got {tuple(frames.shape)}")
    launch_tiles(frames.shape[0], frames.shape[1], row_tile, pair_tile)
    if not on_cuda(frames):
        return spatial_filter_3x3_plain(frames, mode=mode, range_sigma=range_sigma)
    if frames.dtype != torch.float32:
        raise NotImplementedError(f"frames {frames.dtype}: the CUDA kernels take float32 only")
    if not frames.is_contiguous():
        raise ValueError("the CUDA kernels need contiguous frames")
    p, h, w = frames.shape
    out = torch.empty_like(frames)
    path = tile_path(w, frames.data_ptr(), out.data_ptr())
    lib = _build.library()
    with torch.cuda.device(frames.device):
        rc = lib.spatial_filter_3x3_launch(
            frames.data_ptr(), out.data_ptr(), p, h, w, _MODES[mode], int(path == "vector"),
            _inv2s2(range_sigma), torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "spatial_filter_3x3")
    spatial_filter_3x3.launches += 1
    setattr(spatial_filter_3x3, f"{path}_launches",
            getattr(spatial_filter_3x3, f"{path}_launches") + 1)
    return out


spatial_filter_3x3.launches = 0
spatial_filter_3x3.vector_launches = 0
spatial_filter_3x3.scalar_launches = 0
