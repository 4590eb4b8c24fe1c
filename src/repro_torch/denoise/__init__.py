"""Streaming-filter subsystem (counterpart of ``repro.denoise``).

This slice registers the default ``pair_average`` filter only (the
paper's subtract-and-average path). The reference's ``temporal_median``,
``ema_variance`` and ``spatial_box`` raise ``NotImplementedError`` from
``get_filter`` until their slice lands (ROADMAP.md queue A item 6).
"""

from repro_torch.denoise.base import StreamingFilter
from repro_torch.denoise.registry import FILTERS, NOT_PORTED, get_filter, register_filter
from repro_torch.denoise import pair_average
from repro_torch.denoise.pair_average import PairAverageFilter

__all__ = [
    "FILTERS",
    "NOT_PORTED",
    "get_filter",
    "register_filter",
    "StreamingFilter",
    "PairAverageFilter",
    "pair_average",
]
