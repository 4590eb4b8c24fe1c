"""StreamingDenoiser — the paper's preprocessing stage on PyTorch
(counterpart of ``repro.core.denoise``).

``DenoiseConfig`` is field for field the reference's config: same fields,
defaults, ``__post_init__`` errors and ``stream_key()``, so
``dataclasses.asdict`` of one is a valid config of the other. The device
is not a config field: ``StreamingDenoiser(config, device=None)`` runs on
CUDA unless the caller names another device, and raises when CUDA is
absent rather than carrying on on the CPU.

The denoiser drives the filter's ``init / step / finalize`` contract
(``repro_torch.denoise``: all four of the reference's filters) with PRISM
acquisition semantics — G groups × N alternating frames, a fixed
pre-subtraction ``offset`` removed by ``remove_offset``, divide-last (Alg 3)
or divide-first (Alg 3 v2) accumulation — plus a one-shot ``__call__``
(one kernel for ``pair_average``, a replay of the stream for the other
filters) and the u16-container emulation ``reference_u16``. The filter
state is updated in place by every ``ingest``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from repro_torch.denoise import get_filter
from repro_torch.kernels import ops, quant
from repro_torch.kernels.quant import MONO12_MAX  # noqa: F401  (re-export)
from repro_torch.kernels.ref import as_torch_dtype, ref_subtract_average

__all__ = ["DenoiseConfig", "StreamingDenoiser", "MONO12_MAX", "DEFAULT_OFFSET"]

DEFAULT_OFFSET = MONO12_MAX + 1  # keeps (exc - ctl + offset) non-negative


@dataclasses.dataclass(frozen=True)
class DenoiseConfig:
    """Static description of one PRISM acquisition."""

    num_groups: int = 8          # G  (paper default)
    frames_per_group: int = 1000  # N  (paper default; must be even)
    height: int = 80             # paper bank: 256 x 80 pixels
    width: int = 256
    offset: float = float(DEFAULT_OFFSET)
    algorithm: str = "alg3"      # alg1 | alg2 | alg3 | alg3_v2
    accum_dtype: str = "float32"
    backend: str = "auto"        # auto | pallas | xla
    # ingest wire format (repro_torch.kernels.quant.STREAM_DTYPES)
    stream_dtype: str = "u16"
    num_banks: int = 1           # B  (paper: one FPGA per 256x80 bank)
    row_tile: int | None = None  # image rows a block covers (None = the plan's)
    pair_tile: int | None = None  # frame pairs a block covers
    # heuristic (the kernels' default layouts) | auto (measured on the card,
    # cached) | a path to a pre-built plan file (repro_torch.tune)
    tile_plan: str = "heuristic"
    num_slots: int = 2           # ring depth for run_pipelined (2 = ping-pong)
    overflow_policy: str = "block"  # block (lossless) | drop_oldest (real-time)
    # -- streaming-filter subsystem ------------------------------------------
    filter_name: str = "pair_average"
    median_window: int = 5
    ema_alpha: float = 0.25
    ema_mask_sigma: float = 6.0
    spatial_mode: str = "bilateral"
    spatial_range_sigma: float = 60.0

    def __post_init__(self):
        if self.frames_per_group % 2:
            raise ValueError("frames_per_group (N) must be even")
        if self.algorithm not in ops.ALGORITHMS:
            raise ValueError(
                f"algorithm must be one of {ops.ALGORITHMS}, got "
                f"{self.algorithm!r}"
            )
        if self.num_banks < 1:
            raise ValueError("num_banks must be >= 1")
        if not isinstance(self.tile_plan, str) or not self.tile_plan:
            raise ValueError(
                f"tile_plan must be one of {ops.TILE_PLANS} or a plan-file "
                f"path, got {self.tile_plan!r}"
            )
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        quant.validate_stream_dtype(self.stream_dtype)
        if self.stream_dtype != "u16":
            if self.stream_dtype == "p12" and self.width % 2:
                raise ValueError(
                    "stream_dtype='p12' packs pixel pairs: width must be "
                    f"even, got {self.width}"
                )
            if self.stream_dtype == "u8" and not as_torch_dtype(
                self.accum_dtype
            ).is_floating_point:
                raise ValueError(
                    "stream_dtype='u8' dequantizes to fractional pixel "
                    "values and needs a floating accum_dtype, got "
                    f"{self.accum_dtype!r}"
                )
            if self.backend == "pallas" and self.algorithm in ("alg1", "alg2"):
                raise ValueError(
                    f"the {self.algorithm} pallas baseline has no "
                    f"{self.stream_dtype!r} ingest path; use backend='xla' "
                    "or stream_dtype='u16'"
                )
        if self.overflow_policy not in ("block", "drop_oldest"):
            raise ValueError(
                "overflow_policy must be 'block' or 'drop_oldest', got "
                f"{self.overflow_policy!r}"
            )
        # raises ValueError listing the registered filters for unknown
        # names, then lets the filter reject unusable parameter combinations
        get_filter(self.filter_name).validate(self)

    # scheduling-only knobs: never part of the numeric stream's identity
    _SCHEDULING_FIELDS = ("num_slots", "overflow_policy", "num_banks")

    def stream_key(self) -> tuple:
        """Hashable identity of the numeric stream this config defines
        (every field except the scheduling-only ones), as the reference's."""
        d = dataclasses.asdict(self)
        return tuple(
            (k, d[k]) for k in sorted(d) if k not in self._SCHEDULING_FIELDS
        )

    @property
    def pairs_per_group(self) -> int:
        return self.frames_per_group // 2

    @property
    def frame_pixels(self) -> int:
        return self.height * self.width

    @property
    def variant(self) -> str:
        return "divide_first" if self.algorithm == "alg3_v2" else "divide_last"

    @property
    def wire_pixel_bytes(self) -> float:
        """Wire bytes per logical pixel for the ingest format (2 / 1 / 1.5)."""
        return quant.wire_pixel_bytes(self.stream_dtype)

    @property
    def wire_width(self) -> int:
        """Minor-axis length of one wire-format frame row."""
        return quant.wire_width(self.width, self.stream_dtype)

    @property
    def bytes_per_frame(self) -> int:
        """Wire bytes of one ingest frame (exact int for every format)."""
        return int(self.frame_pixels * self.wire_pixel_bytes)

    @property
    def input_bytes(self) -> int:
        return self.num_groups * self.frames_per_group * self.bytes_per_frame

    @property
    def output_frames(self) -> int:
        return self.pairs_per_group


def as_device_tensor(x, device: torch.device) -> torch.Tensor:
    """A tensor on ``device``: numpy arrays are copied over, tensors moved."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class StreamingDenoiser:
    """The paper's preprocessing stage, streaming one group at a time.

    Drives ``get_filter(config.filter_name)`` on ``device`` (CUDA unless
    the caller names another; ``RuntimeError`` when CUDA is absent). The
    state threaded through ``init / ingest / finalize`` is the filter's
    (a bare running-sum tensor for ``pair_average``, a window tensor for
    ``temporal_median``, a dict of tensors for ``ema_variance``), updated
    in place.
    Executors pass an explicit ``step`` index; direct callers may omit it.
    Chunks may be tensors or numpy arrays; arrays are copied to the device.
    """

    def __init__(self, config: DenoiseConfig, device=None):
        self.config = config
        self.device = ops.resolve_device(device)
        self._accum = as_torch_dtype(config.accum_dtype)
        self.filter = get_filter(config.filter_name)(config, device=self.device)
        self.plan = self.filter.plan
        self._step = 0

    # -- streaming interface (filter init/step/finalize) --------------------
    def init(self):
        c = self.config
        self._step = 0
        return self.filter.init(banks=c.num_banks if c.num_banks > 1 else None)

    def _next_step(self, step: int | None) -> int:
        if step is None:
            step = self._step
        self._step = step + 1
        return step

    def ingest(self, state, group_frames, step: int | None = None):
        """Fold one group into the filter state, in place.

        Shapes: (N, H, W) single-bank, (B, N, H, W) banked — banked input
        routes through ``ingest_many`` automatically.
        """
        c = self.config
        group_frames = as_device_tensor(group_frames, self.device)
        if group_frames.ndim == 4:
            if c.num_banks == 1 and not self.filter.is_banked(state):
                if group_frames.shape[0] != 1:
                    raise ValueError(
                        f"state is single-bank but chunk has "
                        f"{group_frames.shape[0]} banks"
                    )
                group_frames = group_frames[0]
            else:
                return self.ingest_many(state, group_frames, step=step)
        elif c.num_banks > 1:
            raise ValueError(
                f"config has num_banks={c.num_banks}: ingest expects banked "
                f"(B, N, H, W) chunks, got shape {tuple(group_frames.shape)}"
            )
        return self.filter.step(
            state, group_frames, step_index=self._next_step(step)
        )

    def ingest_many(self, state, group_frames, step: int | None = None):
        """Fold one group per bank (B, N, H, W) into the banked state."""
        if not self.filter.is_banked(state):
            raise ValueError(
                "ingest_many needs banked state; init() returns one when "
                "num_banks > 1"
            )
        group_frames = as_device_tensor(group_frames, self.device)
        banks = max(self.config.num_banks, 1)
        if group_frames.ndim != 4 or group_frames.shape[0] != banks:
            raise ValueError(
                f"chunk shape {tuple(group_frames.shape)} does not match "
                f"{banks} banks"
            )
        return self.filter.step(
            state, group_frames, step_index=self._next_step(step)
        )

    def finalize(self, state, *, steps: int | None = None):
        """Final denoised frames; ``steps`` < G averages only the groups
        that survived (the ``drop_oldest`` executor path)."""
        return self.filter.finalize(state, steps=steps)

    def partial(self, state, step: int):
        """Estimate after groups ``0..step`` as a fresh tensor (the
        consumer-stage hook); at the last step it equals ``finalize``."""
        return self.filter.partial(state, step_index=step)

    def run(self, groups: Iterable) -> torch.Tensor:
        """Drive the full stream: groups yields G arrays of (N, H, W)."""
        state = self.init()
        count = 0
        for group in groups:
            state = self.ingest(state, group, step=count)
            count += 1
        if count != self.config.num_groups:
            raise ValueError(
                f"expected {self.config.num_groups} groups, got {count}"
            )
        return self.finalize(state)

    # -- one-shot interface -------------------------------------------------
    def __call__(self, frames) -> torch.Tensor:
        """(G, N, H, W) -> (N/2, H, W); (B, G, N, H, W) -> (B, N/2, H, W)."""
        c = self.config
        frames = as_device_tensor(frames, self.device)
        if c.filter_name != "pair_average":
            # other filters replay the stream: same calls, same results
            banks = frames.shape[0] if frames.ndim == 5 else None
            state = self.filter.init(banks=banks)
            for g in range(frames.shape[1] if banks else frames.shape[0]):
                chunk = frames[:, g].contiguous() if banks else frames[g]
                state = self.filter.step(state, chunk, step_index=g)
            return self.filter.finalize(state)
        tiles = self.filter.tile_args("stream")
        fn = ops.multibank_subtract_average if frames.ndim == 5 else ops.subtract_average
        return fn(
            frames,
            offset=c.offset,
            algorithm=c.algorithm,
            backend=c.backend,
            accum_dtype=self._accum,
            stream_dtype=c.stream_dtype,
            **tiles,
        )

    # -- container-faithful reference (overflow reproduction) ---------------
    def reference_u16(self, frames, variant: str | None = None) -> torch.Tensor:
        """Bit-faithful u16-container accumulation (paper §4.2 overflow note).

        With 12-bit pixels and the standard offset, divide-last accumulation
        overflows the u16 container once G > 8; divide-first (v2) never
        does. Runs the plain oracle, in int32 wrapped to 16 bits.
        """
        if self.config.stream_dtype != "u16":
            raise ValueError(
                "reference_u16 models the u16-container pipeline; decode "
                f"the {self.config.stream_dtype!r} wire stream first "
                "(repro_torch.kernels.quant.decode)"
            )
        frames = as_device_tensor(frames, self.device)
        if frames.dtype != torch.uint16:
            frames = frames.to(torch.int32).to(torch.uint16)
        return ref_subtract_average(
            frames,
            offset=int(self.config.offset),
            variant=variant or self.config.variant,
            accum_dtype=torch.uint16,
        )

    def remove_offset(self, out: torch.Tensor) -> torch.Tensor:
        """Offset removal (paper §4.2 implementation note 2)."""
        return out - torch.tensor(self.config.offset, dtype=out.dtype)
