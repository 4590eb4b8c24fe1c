"""The EMA + running-variance filter's kernel on Hopper (counterpart of
``repro.kernels.denoise_ema``), over ``csrc/denoise_ema.cu``.

:func:`ema_welford_step` folds one group ``(N, H, wire_W)`` into three
states, all updated **in place** (the reference donates them):

* ``ema`` ``(N/2, H, W)``: ``ema' = (1-a)*ema + a*diff`` per (pair, pixel);
* ``wmean`` / ``wm2`` ``(H, W)``: the per-pixel mean and M2 pooled over
  every diff sample seen, merged ``pair_tile`` pairs at a time by Chan's
  parallel update, chunks in order.

``pair_tile`` changes the rounding of ``wmean``/``wm2``, so it is not
ignored here: ``None`` resolves to the reference's pinned pick
(:func:`repro_torch.tune.budget.resolve_tiles`), and an explicit tile must
divide N/2. ``prior_count`` (samples already merged) is a runtime
argument of the kernel, so no group ever rebuilds anything.

**Rounding.** The reference's Pallas kernel, compiled by XLA, contracts
some products into FMAs and not others; the plain version below and the
CUDA kernel both follow it step by step (the list is in the CUDA
source), with every FMA computed exactly (:func:`ref.fma_f32`), so the
kernel, the plain version and the reference's interpret mode agree bit
for bit. :func:`ema_welford_step_xla` is the reference's one-pass XLA
composite (``backend="xla"``), a different function in its last bits.

Dispatch, checks and the launch counter are as in
:mod:`repro_torch.kernels.denoise_stream`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, quant, ref
from repro_torch.kernels.denoise_stream import (
    U8_SCALE_F32,
    check_kernel_operands,
    check_launch,
    on_cuda,
)
from repro_torch.tune import budget

__all__ = ["ema_welford_step", "ema_welford_step_plain", "ema_welford_step_xla"]


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.float32(x))


def _ema_update(ema, diff, alpha):
    """``fma(ema, f32(1-a), f32(a*diff))``, the reference's contraction."""
    a = np.float32(alpha)
    return ref.fma_f32(ema, float(np.float32(1) - a), diff * _f32(a).to(diff.device))


def _seq_sum(d: torch.Tensor) -> torch.Tensor:
    """``((0 + d[0]) + d[1]) + ...`` over the leading axis, in float32."""
    s = torch.zeros_like(d[0])
    for i in range(d.shape[0]):
        s = s + d[i]
    return s


def _sum_squares(d: torch.Tensor) -> torch.Tensor:
    """``fma(d[m-1], d[m-1], ... fma(d[0], d[0], 0))`` over the leading axis."""
    acc = torch.zeros_like(d[0])
    for i in range(d.shape[0]):
        acc = ref.fma_f32(d[i], d[i], acc)
    return acc


def _check(ema, wmean, wm2, group_frames, stream_dtype):
    if ema.ndim != 3 or group_frames.ndim != 3:
        raise ValueError(
            f"expected an (N/2, H, W) ema and (N, H, wire_W) frames, got "
            f"{tuple(ema.shape)} and {tuple(group_frames.shape)}"
        )
    p, h, w = ema.shape
    n, fh, wp = group_frames.shape
    if (n, fh, quant.logical_width(wp, stream_dtype)) != (2 * p, h, w):
        raise ValueError(
            f"group {tuple(group_frames.shape)} does not match ema "
            f"{tuple(ema.shape)} ({stream_dtype})"
        )
    if tuple(wmean.shape) != (h, w) or tuple(wm2.shape) != (h, w):
        raise ValueError(
            f"wmean/wm2 must be (H, W) = {(h, w)}, got {tuple(wmean.shape)} "
            f"and {tuple(wm2.shape)}"
        )


def ema_welford_step_plain(
    ema: torch.Tensor, wmean: torch.Tensor, wm2: torch.Tensor,
    group_frames: torch.Tensor, *, alpha: float, offset: float = 0.0,
    prior_count=0, pair_tile: int, stream_dtype: str = "u16",
):
    """Plain PyTorch version of the kernel; returns new ``(ema, wmean, wm2)``."""
    diff = ref.pair_diff(group_frames, offset=offset, accum_dtype=ema.dtype,
                         stream_dtype=stream_dtype)
    new_ema = _ema_update(ema, diff, alpha)
    dev = ema.device
    m = _f32(pair_tile).to(dev)
    rcp = _f32(np.float32(1) / np.float32(pair_tile)).to(dev)
    prior = _f32(prior_count).to(dev)
    mean, m2 = wmean, wm2
    for k in range(diff.shape[0] // pair_tile):
        d = diff[k * pair_tile:(k + 1) * pair_tile]
        s = _seq_sum(d)
        cm = s * rcp
        chunk = _sum_squares(d - cm)
        n = prior + _f32(k).to(dev) * m
        tot = n + m
        r, c = m / tot, (n * m) / tot
        dp = cm - mean
        m2 = m2 + ref.fma_f32(dp * dp, c, chunk)
        mean = ref.fma_f32(ref.fma_f32(s, rcp, -mean), r, mean)
    return new_ema, mean, m2


def ema_welford_step_xla(
    ema: torch.Tensor, wmean: torch.Tensor, wm2: torch.Tensor,
    group_frames: torch.Tensor, *, alpha: float, offset: float = 0.0,
    prior_count=0, stream_dtype: str = "u16",
):
    """The reference's one-pass XLA composite (the whole group's N/2 samples
    merged at once), rounded as XLA compiles it; returns new tensors."""
    diff = ref.pair_diff(group_frames, offset=offset, accum_dtype=ema.dtype,
                         stream_dtype=stream_dtype)
    new_ema = _ema_update(ema, diff, alpha)
    dev = ema.device
    p = diff.shape[0]
    m, n = _f32(p).to(dev), _f32(prior_count).to(dev)
    rcp = _f32(np.float32(1) / np.float32(p)).to(dev)
    s = _seq_sum(diff)
    cm = s * rcp
    chunk = _sum_squares(diff - cm)
    tot = n + m
    new_mean = ref.fma_f32(ref.fma_f32(s, rcp, -wmean), m / tot, wmean)
    dp = cm - wmean
    new_m2 = ref.fma_f32(dp * dp, (n * m) / tot, wm2 + chunk)
    return new_ema, new_mean, new_m2


def ema_welford_step(
    ema: torch.Tensor,
    wmean: torch.Tensor,
    wm2: torch.Tensor,
    group_frames: torch.Tensor,
    *,
    alpha: float,
    offset: float = 0.0,
    prior_count=0,
    row_tile: int | None = None,
    pair_tile: int | None = None,
    stream_dtype: str = "u16",
):
    """Fold one group into ``(ema, wmean, wm2)`` in place; returns the three."""
    _check(ema, wmean, wm2, group_frames, stream_dtype)
    p, h, w = ema.shape
    _, tp = budget.resolve_tiles("ema", p, h, w, row_tile, pair_tile)
    if not on_cuda(ema, wmean, wm2, group_frames):
        new = ema_welford_step_plain(
            ema, wmean, wm2, group_frames, alpha=alpha, offset=offset,
            prior_count=prior_count, pair_tile=tp, stream_dtype=stream_dtype,
        )
        for dst, src in zip((ema, wmean, wm2), new):
            dst.copy_(src)
        return ema, wmean, wm2
    fmt, items, row_bytes = check_kernel_operands(group_frames, ema, stream_dtype)
    for t in (wmean, wm2):
        check_kernel_operands(group_frames, t, stream_dtype)
    a = np.float32(alpha)
    lib = _build.library()
    with torch.cuda.device(ema.device):
        rc = lib.ema_welford_step_launch(
            group_frames.data_ptr(), ema.data_ptr(), wmean.data_ptr(),
            wm2.data_ptr(), p, h, items, row_bytes, tp, fmt, float(offset),
            U8_SCALE_F32, float(a), float(np.float32(1) - a),
            float(np.float32(prior_count)), float(np.float32(1) / np.float32(tp)),
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "ema_welford_step")
    ema_welford_step.launches += 1
    return ema, wmean, wm2


ema_welford_step.launches = 0
