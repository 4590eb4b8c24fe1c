"""The paper's subtract-and-average path as the default registered filter
(counterpart of ``repro.denoise.pair_average``).

``init/step/finalize`` call ``ops.stream_*`` / ``ops.multibank_stream_*``
with the arguments the reference passes. State is the single running
sumFrame of paper Alg 3 — (N/2, H, W), or (B, N/2, H, W) banked — updated
in place by every step.
"""

from __future__ import annotations

import torch

from repro_torch.denoise.base import StreamingFilter
from repro_torch.denoise.registry import register_filter
from repro_torch.kernels import ops, quant, ref

__all__ = ["PairAverageFilter"]


@register_filter("pair_average")
class PairAverageFilter(StreamingFilter):
    """Running-sum subtract-and-average (paper Alg 3 / Alg 3 v2)."""

    # the running-sum update is the same at every group index (inherited
    # by spatial_box, whose step is this step)
    phase_invariant = True

    def init(self, *, banks: int | None = None):
        c = self.config
        acc = ref.as_torch_dtype(c.accum_dtype)
        if banks is not None:
            return ops.multibank_stream_init(
                banks, c.frames_per_group, c.height, c.width, acc, device=self.device
            )
        return ops.stream_init(
            c.frames_per_group, c.height, c.width, acc, device=self.device
        )

    def step(self, state, group_frames, *, step_index: int):
        c = self.config
        kw = dict(
            num_groups=c.num_groups,
            offset=c.offset,
            variant=c.variant,
            backend=c.backend,
            stream_dtype=getattr(c, "stream_dtype", "u16"),
            **self.tile_args("stream"),
        )
        if group_frames.ndim == 4:
            return ops.multibank_stream_step(state, group_frames, **kw)
        return ops.stream_step(state, group_frames, **kw)

    def finalize(self, state, *, steps: int | None = None):
        c = self.config
        if steps is None or steps == c.num_groups:
            return ops.stream_finalize(state, c.num_groups, variant=c.variant)
        # drop_oldest executor path: average only the surviving groups
        return self._scaled(state, steps)

    def partial(self, state, *, step_index: int):
        return self._scaled(state, step_index + 1)

    def is_banked(self, state) -> bool:
        return state.ndim == 4

    def _scaled(self, state, groups_seen: int):
        """Estimate averaging ``groups_seen`` groups, as a fresh tensor.

        divide_last keeps a raw running sum, so the estimate is ``sum/k``
        (a true division, as the reference's eager one); divide_first
        pre-divides every diff by G, so it is ``sum * f32(G/k)`` — widened
        to int32 for integer accumulators. At ``groups_seen == G`` both
        match ``finalize`` bit for bit.
        """
        c = self.config
        k = groups_seen
        if c.variant == "divide_first":
            if not state.dtype.is_floating_point:
                wide = quant.widen(state).to(torch.int32) * c.num_groups // k
                return quant.narrow(wide, state.dtype)
            return state * torch.tensor(c.num_groups / k, dtype=state.dtype)
        return ref.true_divide(state, k)
