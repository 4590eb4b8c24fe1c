"""EMA + running-variance filter: recency-weighted average with shot-noise
masking (counterpart of ``repro.denoise.ema_variance``).

Two coupled accumulators per step (one fused ``ops.ema_welford_step``):

* an **exponential moving average** of the pair diffs —
  ``ema' = (1-alpha)*ema + alpha*diff`` per (pair, pixel);
* a **Welford/Chan running variance** per *pixel*, pooled over every diff
  sample seen (all pairs × groups): O(H·W) state.

``finalize`` bias-corrects the EMA (``ema / (1 - (1-alpha)^steps)``) and
shrinks the pixels whose temporal variance exceeds ``ema_mask_sigma^2 ×``
the median variance to their pooled long-run mean. It is eager in the
reference, so here too: true divisions (by 0-dim tensors on the data's
device, :func:`repro_torch.kernels.ref.true_divide`), and the median of an
even pixel count is the mean of the two middle values, as ``jnp.median``.

State: ``{"ema": (N/2,H,W), "wmean": (H,W), "wm2": (H,W)}``, updated in
place; banked, each leaf gains a leading bank axis and a step loops over
the banks on contiguous per-bank views (variance pooling never crosses
banks).
"""

from __future__ import annotations

import torch

from repro_torch.denoise.base import StreamingFilter
from repro_torch.denoise.registry import register_filter
from repro_torch.kernels import ops, ref

__all__ = ["EmaVarianceFilter", "pixel_median"]


def pixel_median(var: torch.Tensor) -> torch.Tensor:
    """``jnp.median(var, axis=(-2, -1), keepdims=True)``: per leading index,
    the middle value of the H·W pixels, or the mean of the two middle
    values for an even count (``torch.median`` would return the lower)."""
    flat = var.reshape(var.shape[:-2] + (-1,))
    srt = torch.sort(flat, dim=-1).values
    n = flat.shape[-1]
    if n % 2:
        mid = srt[..., n // 2]
    else:
        mid = (srt[..., n // 2 - 1] + srt[..., n // 2]) * torch.tensor(0.5, dtype=var.dtype)
    return mid[..., None, None]


@register_filter("ema_variance")
class EmaVarianceFilter(StreamingFilter):
    """Bias-corrected EMA of pair diffs + Welford variance masking."""

    @classmethod
    def validate(cls, config) -> None:
        if not 0.0 < config.ema_alpha <= 1.0:
            raise ValueError(
                f"ema_alpha must be in (0, 1], got {config.ema_alpha}"
            )
        if config.ema_mask_sigma <= 0.0:
            raise ValueError(
                f"ema_mask_sigma must be > 0, got {config.ema_mask_sigma}"
            )
        if not ref.as_torch_dtype(config.accum_dtype).is_floating_point:
            raise ValueError(
                "ema_variance needs a floating accum_dtype (EMA and variance "
                f"arithmetic), got {config.accum_dtype!r}"
            )

    def init(self, *, banks: int | None = None):
        c = self.config
        lead = () if banks is None else (banks,)
        kw = dict(dtype=ref.as_torch_dtype(c.accum_dtype), device=self.device)
        return {
            "ema": torch.zeros(lead + (c.pairs_per_group, c.height, c.width), **kw),
            "wmean": torch.zeros(lead + (c.height, c.width), **kw),
            "wm2": torch.zeros(lead + (c.height, c.width), **kw),
        }

    def _step_one(self, ema, wmean, wm2, group_frames, step_index: int):
        c = self.config
        ops.ema_welford_step(
            ema,
            wmean,
            wm2,
            group_frames,
            alpha=c.ema_alpha,
            offset=c.offset,
            prior_count=step_index * c.pairs_per_group,
            backend=c.backend,
            stream_dtype=getattr(c, "stream_dtype", "u16"),
            **self.tile_args("ema"),
        )

    def step(self, state, group_frames, *, step_index: int):
        ema, wmean, wm2 = state["ema"], state["wmean"], state["wm2"]
        if group_frames.ndim == 3:
            self._step_one(ema, wmean, wm2, group_frames, step_index)
        else:
            for b in range(group_frames.shape[0]):
                self._step_one(ema[b], wmean[b], wm2[b], group_frames[b], step_index)
        return state

    def finalize(self, state, *, steps: int | None = None):
        c = self.config
        steps = c.num_groups if steps is None else steps
        ema, wmean, wm2 = state["ema"], state["wmean"], state["wm2"]
        corr = 1.0 - (1.0 - c.ema_alpha) ** max(steps, 1)
        est = ref.true_divide(ema, corr)
        samples = steps * c.pairs_per_group
        if samples < 2:
            return est
        var = ref.true_divide(wm2, samples - 1)
        typical = pixel_median(var)
        limit = torch.tensor(c.ema_mask_sigma**2, dtype=var.dtype, device=var.device)
        mask = var > limit * typical
        # broadcast the (H, W) mask/mean over the pair axis (axis -3)
        return torch.where(mask[..., None, :, :], wmean[..., None, :, :], est)

    def is_banked(self, state) -> bool:
        return state["ema"].ndim == 4
