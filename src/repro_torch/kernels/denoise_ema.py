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

**The order of a chunk's sums** depends on its length ``m`` (pairs), as
XLA's CPU compiler lays out ``diff.mean(0)`` and
``((diff - mean) ** 2).sum(0)``:

* ``m <= CHAIN_MAX`` (24): one sequential chain, the squares fused into
  it (``fma(dc, dc, acc)``);
* ``m <= LANES_MAX`` (32): LLVM vectorizes the loop over the chunk,
  8 lanes wide: lane ``l`` chains elements ``l, l + 8, ...`` below
  ``8 * (m // 8)``, the lanes are folded pairwise (``l + l+4``, then
  ``+2``, then ``+1``), and the rest follow in order;
* ``m > LANES_MAX``: XLA rewrites the reduction as windows of
  ``WINDOW`` (32) over the chunk padded with zeros to a multiple of 32
  (the low pad ``(padded - m) // 2``), each window summed in order, then
  the partials in order. The squares are rounded on their own, and the
  centring ``x - s / m`` and the merge's ``s / m - mean`` are contracted
  into FMAs.

Between 22 and 27 pairs XLA's choice between the first two also depends
on the size of the fused loop body (the wire format, and Pallas against
the XLA composite); there the port keeps the rule above and differs from
the reference by the tolerance ``ROADMAP.md`` declares for B8.

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


CHAIN_MAX = 24   # a chunk of up to this many pairs: one sequential chain
LANES_MAX = 32   # up to this many: 8 vector lanes, a pairwise fold, the rest
WINDOW = 32      # longer: zero-padded windows of 32, then their partials


def _seq_sum(d: torch.Tensor) -> torch.Tensor:
    """``((0 + d[0]) + d[1]) + ...`` over the leading axis, in float32."""
    s = torch.zeros_like(d[0])
    for i in range(d.shape[0]):
        s = s + d[i]
    return s


def _lanes(d: torch.Tensor, step) -> torch.Tensor:
    """The 8-lane vector loop: ``step(acc, x)`` down each lane, the lanes
    folded pairwise (``l + l+4``, ``+2``, ``+1``), then the rest in order."""
    full = d.shape[0] // 8 * 8
    acc = torch.zeros_like(d[:8])
    for k in range(0, full, 8):
        acc = step(acc, d[k:k + 8])
    acc = acc[:4] + acc[4:]
    acc = acc[:2] + acc[2:]
    acc = acc[0] + acc[1]
    for i in range(full, d.shape[0]):
        acc = step(acc, d[i])
    return acc


def _windows(d: torch.Tensor) -> torch.Tensor:
    """XLA's windowed sum: pad to a multiple of ``WINDOW`` (low pad
    ``(padded - m) // 2``), sum each window in order, then the partials."""
    m = d.shape[0]
    padded = -(-m // WINDOW) * WINDOW
    low = (padded - m) // 2
    x = torch.cat([d.new_zeros((low,) + d.shape[1:]), d,
                   d.new_zeros((padded - m - low,) + d.shape[1:])])
    return _seq_sum(_seq_sum(x.reshape((-1, WINDOW) + d.shape[1:]).transpose(0, 1)))


def _add(acc, x):
    return acc + x


def _fma_square(acc, x):
    return ref.fma_f32(x, x, acc)


def chunk_sums(d: torch.Tensor, rcp: torch.Tensor):
    """``(s, chunk_m2, windowed)`` of one chunk ``d`` ``(m, ...)`` in the
    reference's order for its length; ``windowed`` says the merge
    contracts ``s / m - mean`` (chunks above ``LANES_MAX``)."""
    m = d.shape[0]
    if m > LANES_MAX:
        s = _windows(d)
        dc = ref.fma_f32(-s.expand_as(d), float(rcp), d)
        return s, _windows(dc * dc), True
    if m > CHAIN_MAX:
        s = _lanes(d, _add)
        return s, _lanes(d - s * rcp, _fma_square), False
    s = _seq_sum(d)
    acc = torch.zeros_like(d[0])
    for dc in d - s * rcp:
        acc = _fma_square(acc, dc)
    return s, acc, False


def _centred_delta(s, rcp, mean, windowed):
    """``s / m - mean``: contracted after a windowed sum, else rounded."""
    return ref.fma_f32(s, float(rcp), -mean) if windowed else s * rcp - mean


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
        s, chunk, windowed = chunk_sums(diff[k * pair_tile:(k + 1) * pair_tile], rcp)
        n = prior + _f32(k).to(dev) * m
        tot = n + m
        r, c = m / tot, (n * m) / tot
        dp = _centred_delta(s, rcp, mean, windowed)
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
    s, chunk, windowed = chunk_sums(diff, rcp)
    tot = n + m
    new_mean = ref.fma_f32(ref.fma_f32(s, rcp, -wmean), m / tot, wmean)
    dp = _centred_delta(s, rcp, wmean, windowed)
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
