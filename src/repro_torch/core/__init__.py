"""The streaming denoiser and its executors (counterpart of ``repro.core``).

  DenoiseConfig / StreamingDenoiser — the subtract-and-average stage
  run_pipelined                      — ring-pipelined 3-stage executor (§5)
  run_inline / run_buffered          — inline vs buffer-then-process drivers
  RingBuffer                         — bounded ring with backpressure

The reference's ``banks``, ``egress`` and ``latency_model`` modules are
later slices (ROADMAP.md queue A items 7 and 8).
"""

from repro_torch.core.denoise import (  # noqa: F401
    DEFAULT_OFFSET,
    MONO12_MAX,
    DenoiseConfig,
    StreamingDenoiser,
)
from repro_torch.core.ringbuf import RingBuffer, RingClosed, RingStats  # noqa: F401
from repro_torch.core.streaming import (  # noqa: F401
    DownloadConsumer,
    StreamReport,
    run_buffered,
    run_inline,
    run_pipelined,
)
