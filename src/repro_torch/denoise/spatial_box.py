"""Spatial box / bilateral-lite filter: pair-average plus a 3×3 stage
(counterpart of ``repro.denoise.spatial_box``).

A stuck/hot pixel is wrong in every frame, so temporal filters cannot
repair it; its spatial neighbours can. This filter reuses the
``pair_average`` accumulation as it is (same running sum, same in-place
``ops.stream_step``) and applies ``ops.spatial_filter`` to the averaged
output of ``finalize`` and ``partial``:

* ``spatial_mode="box"`` — plain 3×3 mean;
* ``spatial_mode="bilateral"`` — a Gaussian *range* kernel on uniform
  spatial support (``spatial_range_sigma`` in pixel units).

The spatial stage is per-frame independent, so banked outputs flatten the
bank axis into the pair axis for one kernel call.
"""

from __future__ import annotations

from repro_torch.denoise.pair_average import PairAverageFilter
from repro_torch.denoise.registry import register_filter
from repro_torch.kernels import ops, ref

__all__ = ["SpatialBoxFilter"]


@register_filter("spatial_box")
class SpatialBoxFilter(PairAverageFilter):
    """Pair-average accumulation with a post-average 3×3 spatial stage."""

    @classmethod
    def validate(cls, config) -> None:
        if config.spatial_mode not in ops.SPATIAL_MODES:
            raise ValueError(
                f"spatial_mode must be one of {ops.SPATIAL_MODES}, got "
                f"{config.spatial_mode!r}"
            )
        if config.spatial_range_sigma <= 0.0:
            raise ValueError(
                f"spatial_range_sigma must be > 0, got "
                f"{config.spatial_range_sigma}"
            )
        if not ref.as_torch_dtype(config.accum_dtype).is_floating_point:
            raise ValueError(
                "spatial_box needs a floating accum_dtype (box/bilateral "
                f"weights), got {config.accum_dtype!r}"
            )

    def _smooth(self, averaged):
        c = self.config
        frames = averaged
        if averaged.ndim == 4:
            b, p, h, w = averaged.shape
            frames = averaged.reshape(b * p, h, w)
        out = ops.spatial_filter(
            frames,
            mode=c.spatial_mode,
            range_sigma=c.spatial_range_sigma,
            backend=c.backend,
            **self.tile_args("spatial"),
        )
        return out.view(averaged.shape)

    def finalize(self, state, *, steps: int | None = None):
        return self._smooth(super().finalize(state, steps=steps))

    def partial(self, state, *, step_index: int):
        return self._smooth(super().partial(state, step_index=step_index))
