"""The streaming denoiser and its executors (counterpart of ``repro.core``).

  DenoiseConfig / StreamingDenoiser — the subtract-and-average stage
  run_pipelined                      — ring-pipelined 3-stage executor (§5)
  run_inline / run_buffered          — inline vs buffer-then-process drivers
  RingBuffer                         — bounded ring with backpressure
  BankMesh / run_pipelined_banked    — one pipeline per bank (Table 5)
"""

from repro_torch.core.banks import (  # noqa: F401
    BankMesh,
    banked_filter_finalize,
    banked_filter_init,
    banked_filter_step,
    banked_stream_step,
    banked_subtract_average,
    make_bank_mesh,
    run_pipelined_banked,
)
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
