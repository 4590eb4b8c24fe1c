"""Temporal-median filter: sliding-window rank statistic over pair diffs
(counterpart of ``repro.denoise.temporal_median``).

Impulse / cosmic-ray rejection: a transient spike corrupts one group's
diff frame, lands in one window slot, and is discarded by the per-pixel
median, where ``pair_average`` smears it over the output at 1/G
amplitude. The window covers the last ``config.median_window`` groups.

State: a (K, N/2, H, W) ring of past diff frames — banked:
(K, B, N/2, H, W), the slot axis leading so that the banked window is the
single-bank kernel's (K, B·N/2, H, W) layout without a copy. ``step``
writes one slot in place through ``ops.median_window_insert``;
``finalize`` runs ``ops.median_combine`` over the filled prefix and
returns a fresh tensor.
"""

from __future__ import annotations

import torch

from repro_torch.denoise.base import StreamingFilter
from repro_torch.denoise.registry import register_filter
from repro_torch.kernels import ops, ref

__all__ = ["TemporalMedianFilter"]


@register_filter("temporal_median")
class TemporalMedianFilter(StreamingFilter):
    """Per-pixel median over a sliding window of pair-difference frames."""

    @classmethod
    def validate(cls, config) -> None:
        if config.median_window < 1:
            raise ValueError(
                f"median_window must be >= 1, got {config.median_window}"
            )
        if not ref.as_torch_dtype(config.accum_dtype).is_floating_point:
            raise ValueError(
                "temporal_median needs a floating accum_dtype (even window "
                f"prefixes average the two middle ranks), got "
                f"{config.accum_dtype!r}"
            )

    def init(self, *, banks: int | None = None):
        c = self.config
        shape = (c.median_window, c.pairs_per_group, c.height, c.width)
        if banks is not None:
            shape = (c.median_window, banks) + shape[1:]
        return torch.zeros(shape, dtype=ref.as_torch_dtype(c.accum_dtype), device=self.device)

    def step(self, state, group_frames, *, step_index: int):
        c = self.config
        window = state
        if group_frames.ndim == 4:
            # bank-major flatten: (K, B, P, H, W) -> (K, B*P, H, W) pairs up
            # with the (B*N, H, wire_W) flatten of the chunk
            k, b, p, h, w = state.shape
            window = state.view(k, b * p, h, w)
            group_frames = group_frames.reshape(-1, *group_frames.shape[-2:])
        ops.median_window_insert(
            window,
            group_frames,
            slot=step_index % c.median_window,
            offset=c.offset,
            backend=c.backend,
            stream_dtype=getattr(c, "stream_dtype", "u16"),
            **self.tile_args("median_insert"),
        )
        return state

    def finalize(self, state, *, steps: int | None = None):
        c = self.config
        steps = c.num_groups if steps is None else steps
        count = min(max(steps, 1), c.median_window)
        window = state
        if state.ndim == 5:
            k, b, p, h, w = state.shape
            window = state.view(k, b * p, h, w)
        out = ops.median_combine(
            window[:count], backend=c.backend, **self.tile_args("median_combine")
        )
        if state.ndim == 5:
            out = out.view(b, p, h, w)
        return out

    def is_banked(self, state) -> bool:
        return state.ndim == 5

    def state_pspec(self, state):
        return (None, "bank", None, None, None)
