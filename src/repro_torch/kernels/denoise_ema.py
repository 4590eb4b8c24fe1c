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

**Half-precision states** (float16, bfloat16) follow what XLA makes of
the reference's kernel for each type (:func:`half_chunk_stats`,
:func:`half_merge`): ``jnp.mean`` and ``jnp.sum`` take a chunk's
statistics in float32 in the order above and round them once; the EMA and
the merge round every operation, float16 contracting the FMAs of the
float32 list. On the card they run the float32 kernel's body, which
takes the state type as a template argument and differs only in where it
rounds (the list is in the CUDA source).

Dispatch, checks and the launch counter are as in
:mod:`repro_torch.kernels.denoise_stream`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, quant, ref
from repro_torch.kernels.denoise_stream import (
    ACCUM_CODES,
    acc_constants,
    check_kernel_operands,
    check_launch,
    on_cuda,
)
from repro_torch.tune import budget

__all__ = ["ema_welford_step", "ema_welford_step_plain", "ema_welford_step_xla"]


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.float32(x))


def _ema_update(ema, diff, alpha):
    """``ema * (1 - a) + a * diff`` in the state's type, ``a`` rounded to
    it: ``fma(ema, 1-a, a*diff)`` where XLA contracts (``ref.contracts``),
    each operation rounded on its own for bfloat16."""
    dt = ema.dtype
    a = torch.tensor(ref.round_const(alpha, dt), dtype=dt, device=ema.device)
    one_minus = 1 - a
    if ref.contracts(dt):
        return ref.fma(ema, float(one_minus), diff * a)
    return ema * one_minus + a * diff


#: the state types whose chunk statistics ``jnp.mean``/``jnp.sum`` take in float32
HALF_TYPES = (torch.float16, torch.bfloat16)

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


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """A float32 sum over the leading axis in XLA's order for its length."""
    m = x.shape[0]
    if m > LANES_MAX:
        return _windows(x)
    return _lanes(x, _add) if m > CHAIN_MAX else _seq_sum(x)


def half_chunk_stats(d: torch.Tensor, d_wide: torch.Tensor):
    """``(mean, m2)`` of one float16/bfloat16 chunk ``d`` ``(m, ...)``, in
    ``d``'s type, as ``jnp.mean`` and ``jnp.sum`` compute them: both sum in
    float32 (in XLA's order for the length), the mean scales by
    ``f32(1/m)``, and each result is rounded once to the half type.
    ``d_wide`` is the float32 the mean sums (:func:`sum_input`). The
    centring rounds in the half type; the squares round to float16, while
    a bfloat16 square stays in float32 (where it is exact)."""
    dt = d.dtype
    rcp = float(np.float32(1) / np.float32(d.shape[0]))
    mean = (_ordered_sum(d_wide) * rcp).to(dt)
    dc = d - mean
    sq = (dc * dc).to(torch.float32) if dt == torch.float16 else dc.float() * dc.float()
    return mean, _ordered_sum(sq).to(dt)


def sum_input(group_frames, diff, *, offset, stream_dtype):
    """The float32 values ``jnp.mean`` sums for the chunk mean: ``diff``
    widened, except that for bfloat16 XLA computes the last operation of
    the prologue, ``+ offset``, in float32 and does not round it."""
    if diff.dtype != torch.bfloat16:
        return diff.to(torch.float32)
    pre = ref.pair_diff(group_frames, offset=0.0, accum_dtype=diff.dtype,
                        stream_dtype=stream_dtype)
    return pre.to(torch.float32) + ref.round_const(offset, diff.dtype)


def half_merge(mean, m2, chunk_mean, chunk_m2, n, m, *, sum_first: bool):
    """Chan's merge of a chunk's ``(chunk_mean, chunk_m2)`` into ``(mean,
    m2)`` in a half type, ``n`` and ``m`` 0-dim tensors of that type.
    ``sum_first`` is the XLA composite's order, ``(m2 + chunk_m2) + ...``;
    the Pallas kernel adds ``chunk_m2 + ...`` to ``m2`` last."""
    dt = mean.dtype
    delta = chunk_mean - mean
    tot = n + m
    r, c = m / tot, (n * m) / tot
    dd = delta * delta
    if ref.contracts(dt):
        new_mean = ref.fma(delta, float(r), mean)
        new_m2 = (ref.fma(dd, float(c), m2 + chunk_m2) if sum_first
                  else m2 + ref.fma(dd, float(c), chunk_m2))
    else:
        new_mean = mean + delta * r
        new_m2 = (m2 + chunk_m2 + dd * c) if sum_first else m2 + (chunk_m2 + dd * c)
    return new_mean, new_m2


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
    if ema.dtype in HALF_TYPES:
        dt = ema.dtype
        m = torch.tensor(pair_tile, dtype=dt, device=dev)
        prior = torch.tensor(prior_count, dtype=dt, device=dev)
        wide = sum_input(group_frames, diff, offset=offset, stream_dtype=stream_dtype)
        mean, m2 = wmean, wm2
        for k in range(diff.shape[0] // pair_tile):
            chunk = slice(k * pair_tile, (k + 1) * pair_tile)
            cm, cm2 = half_chunk_stats(diff[chunk], wide[chunk])
            n = prior + torch.tensor(k, dtype=dt, device=dev) * m
            mean, m2 = half_merge(mean, m2, cm, cm2, n, m, sum_first=False)
        return new_ema, mean, m2
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
    if ema.dtype in HALF_TYPES:
        dt = ema.dtype
        cm, cm2 = half_chunk_stats(
            diff, sum_input(group_frames, diff, offset=offset, stream_dtype=stream_dtype))
        return (new_ema, *half_merge(
            wmean, wm2, cm, cm2, torch.tensor(prior_count, dtype=dt, device=dev),
            torch.tensor(p, dtype=dt, device=dev), sum_first=True))
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
        if t.dtype != ema.dtype:
            raise TypeError(f"ema is {ema.dtype}, a statistics plane {t.dtype}")
    dt = ema.dtype
    a = torch.tensor(ref.round_const(alpha, dt), dtype=dt)
    lib = _build.library()
    with torch.cuda.device(ema.device):
        rc = lib.ema_welford_step_launch(
            group_frames.data_ptr(), ema.data_ptr(), wmean.data_ptr(),
            wm2.data_ptr(), p, h, items, row_bytes, tp, fmt,
            *acc_constants(dt, offset)[:2], float(a), float(1 - a),
            ref.round_const(prior_count, dt), float(np.float32(1) / np.float32(tp)),
            ACCUM_CODES[dt], torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "ema_welford_step")
    ema_welford_step.launches += 1
    return ema, wmean, wm2


ema_welford_step.launches = 0
