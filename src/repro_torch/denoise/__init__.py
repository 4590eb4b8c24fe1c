"""Streaming-filter subsystem (counterpart of ``repro.denoise``).

Four filters share one ``init / step / finalize`` state contract
(``base.StreamingFilter``), as in the reference:

* ``pair_average`` — the paper's subtract-and-average path (the default);
* ``temporal_median`` — sliding-window median of pair diffs;
* ``ema_variance`` — exponential moving average with Welford
  running-variance shot-noise masking;
* ``spatial_box`` — pair-average plus a post-average 3×3 box /
  bilateral-lite spatial stage.

Importing this package populates the registry. All device work goes
through ``repro_torch.kernels.ops``, never a kernel module directly.
"""

from repro_torch.denoise.base import StreamingFilter
from repro_torch.denoise.registry import FILTERS, get_filter, register_filter
from repro_torch.denoise import ema_variance, pair_average, spatial_box, temporal_median
from repro_torch.denoise.ema_variance import EmaVarianceFilter
from repro_torch.denoise.pair_average import PairAverageFilter
from repro_torch.denoise.spatial_box import SpatialBoxFilter
from repro_torch.denoise.temporal_median import TemporalMedianFilter

__all__ = [
    "FILTERS",
    "get_filter",
    "register_filter",
    "StreamingFilter",
    "PairAverageFilter",
    "TemporalMedianFilter",
    "EmaVarianceFilter",
    "SpatialBoxFilter",
    "ema_variance",
    "pair_average",
    "spatial_box",
    "temporal_median",
]
