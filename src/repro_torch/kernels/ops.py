"""Public entry points for the denoise kernels (counterpart of
``repro.kernels.ops``): the port's backend boundary.

Dispatch follows the tensors' device, never a guess about the machine:

* ``backend='auto'`` and ``'pallas'`` — on a CUDA tensor, the Hopper
  kernel (``denoise_stream``, ``denoise_multibank``, ``denoise_tmpframe``,
  ``denoise_median``, ``denoise_ema``, ``denoise_spatial``); on a CPU
  tensor, the kernel's plain PyTorch version (the counterpart of the
  reference's interpret mode).
* ``backend='xla'`` — the plain PyTorch composite, on whatever device the
  tensors are on.

The one exception is the banked Alg 1/2 baseline: the reference has no
multi-bank Pallas kernel for it and runs its XLA composite on every
backend but ``'pallas'`` (an error), so the port runs the plain
materialized composite on every device. Nothing catches a build or launch
failure to run something else. The running sums of
``stream_step`` / ``multibank_stream_step``, the median window of
``median_window_insert`` and the three EMA states of ``ema_welford_step``
are updated **in place**, where the reference donates them; each returns
the updated tensors.

``row_tile`` / ``pair_tile`` are a tuning plan's launch geometry
(:mod:`repro_torch.tune`): the kernels' wrappers check that an explicit
tile divides H or N/2 (``ValueError``, as the reference's) and the
row-gridded kernels launch it (:mod:`repro_torch.kernels.denoise_stream`);
the geometry never changes a bit of a result, except ``ema_welford_step``'s
``pair_tile``, which sets its merge chunks as the reference's does
(:mod:`repro_torch.kernels.denoise_ema`). ``xla`` ignores them, as the
reference's does. ``placement`` is accepted for parity and ignored: the
port has one placement, the compiler's.
Rounding follows the reference's jitted functions, except
``stream_finalize``, which like the reference (not jitted) divides truly
on every device (:mod:`repro_torch.kernels.ref`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import (
    denoise_ema,
    denoise_median,
    denoise_multibank,
    denoise_spatial,
    denoise_stream,
    denoise_tmpframe,
    ref,
)
from repro_torch.kernels.quant import (  # noqa: F401  (shared dequant prologue)
    STREAM_DTYPES,
    dequant,
    pair_diff_block,
)

__all__ = [
    "ALGORITHMS",
    "BACKENDS",
    "SPATIAL_MODES",
    "STREAM_DTYPES",
    "TILE_PLANS",
    "resolve_device",
    "subtract_average",
    "stream_init",
    "stream_step",
    "stream_finalize",
    "multibank_subtract_average",
    "multibank_stream_init",
    "multibank_stream_step",
    "pair_diff",
    "dequant",
    "pair_diff_block",
    "median_window_insert",
    "median_combine",
    "ema_welford_step",
    "spatial_filter",
]

ALGORITHMS = ("alg1", "alg2", "alg3", "alg3_v2")
BACKENDS = ("auto", "pallas", "xla")
SPATIAL_MODES = ("box", "bilateral")
TILE_PLANS = ("heuristic", "auto")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Raises ``RuntimeError`` when CUDA is asked for and
    absent, rather than carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend}")


def _check_algorithm(algorithm: str) -> None:
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}, got {algorithm}")


def pair_diff(
    group_frames: torch.Tensor, *, offset: float, accum_dtype, stream_dtype: str = "u16"
) -> torch.Tensor:
    """(..., N, H, wire_W) -> (..., N/2, H, W): exc - ctl + offset (plain torch)."""
    return ref.pair_diff(
        group_frames, offset=offset, accum_dtype=accum_dtype, stream_dtype=stream_dtype
    )


def _materialized(frames, *, offset, accum_dtype, stream_dtype, group_axis):
    """Alg 1/2 dataflow: every diff first (tmpFrame), then the reduction."""
    acc = ref.as_torch_dtype(accum_dtype)
    tmp = pair_diff(frames, offset=offset, accum_dtype=acc, stream_dtype=stream_dtype)
    total = tmp.select(group_axis, 0)
    for k in range(1, tmp.shape[group_axis]):
        total = ref.fold(total, tmp.select(group_axis, k), divide_first=False, num_groups=1)
    return ref.scale_reciprocal(total, tmp.shape[group_axis])


def subtract_average(
    frames: torch.Tensor,
    *,
    offset: float = 0.0,
    algorithm: str = "alg3",
    backend: str = "auto",
    accum_dtype=torch.float32,
    row_tile: int | None = None,
    pair_tile: int | None = None,
    stream_dtype: str = "u16",
    placement: str | None = None,
) -> torch.Tensor:
    """PRISM denoise: (G, N, H, wire_W) frames -> (N/2, H, W) averaged diffs.

    Alg 1/2 with ``auto``/``pallas`` run the two-pass tmpFrame kernels
    (B10, :mod:`repro_torch.kernels.denoise_tmpframe`), which ingest u16
    only, as the reference's Pallas baselines; ``xla`` decodes every wire
    format through the plain materialized composite.
    """
    _check_algorithm(algorithm)
    _check_backend(backend)
    if algorithm in ("alg1", "alg2"):
        if backend == "xla":
            return _materialized(
                frames, offset=offset, accum_dtype=accum_dtype,
                stream_dtype=stream_dtype, group_axis=0,
            )
        if stream_dtype != "u16":
            raise ValueError(
                f"no {stream_dtype!r} ingest for the {algorithm} pallas "
                "baseline; use backend='xla' or stream_dtype='u16'"
            )
        fn = (
            denoise_tmpframe.alg1_subtract_average
            if algorithm == "alg1"
            else denoise_tmpframe.alg2_subtract_average
        )
        return fn(frames, offset=offset, accum_dtype=accum_dtype,
                  row_tile=row_tile, pair_tile=pair_tile)
    if backend == "xla":
        return denoise_stream.alg3_subtract_average_plain(
            frames, offset=offset, divide_first=(algorithm == "alg3_v2"),
            accum_dtype=accum_dtype, stream_dtype=stream_dtype,
        )
    return denoise_stream.alg3_subtract_average(
        frames, offset=offset, divide_first=(algorithm == "alg3_v2"),
        accum_dtype=accum_dtype, stream_dtype=stream_dtype,
        row_tile=row_tile, pair_tile=pair_tile,
    )


# ---------------------------------------------------------------------------
# Streaming API (one group per call — the production/camera entry point).
# ---------------------------------------------------------------------------


def stream_init(n: int, h: int, w: int, accum_dtype=torch.float32, *, device=None):
    """Running-sum state: (N/2, H, W) zeros on ``device`` (CUDA unless the
    caller names another; ``RuntimeError`` when CUDA is absent)."""
    return ref.ref_stream_init(n, h, w, accum_dtype, device=resolve_device(device))


def stream_step(
    sum_frame: torch.Tensor,
    group_frames: torch.Tensor,
    *,
    num_groups: int,
    offset: float = 0.0,
    variant: str = "divide_last",
    backend: str = "auto",
    row_tile: int | None = None,
    pair_tile: int | None = None,
    stream_dtype: str = "u16",
    placement: str | None = None,
) -> torch.Tensor:
    """Fold one group into ``sum_frame`` in place; returns ``sum_frame``."""
    _check_backend(backend)
    if backend != "xla":
        return denoise_stream.alg3_stream_step(
            group_frames, sum_frame, num_groups=num_groups, offset=offset,
            divide_first=(variant == "divide_first"), stream_dtype=stream_dtype,
            row_tile=row_tile, pair_tile=pair_tile,
        )
    return sum_frame.copy_(ref.ref_stream_step(
        sum_frame, group_frames, offset=offset, variant=variant,
        num_groups=num_groups, stream_dtype=stream_dtype,
    ))


def stream_finalize(sum_frame, num_groups, *, variant="divide_last"):
    """Final average, dividing truly on every device; a fresh tensor."""
    return ref.ref_stream_finalize(sum_frame, num_groups, variant=variant)


# ---------------------------------------------------------------------------
# Multi-bank API: leading bank axis.
# ---------------------------------------------------------------------------


def multibank_subtract_average(
    frames: torch.Tensor,
    *,
    offset: float = 0.0,
    algorithm: str = "alg3",
    backend: str = "auto",
    accum_dtype=torch.float32,
    row_tile: int | None = None,
    pair_tile: int | None = None,
    stream_dtype: str = "u16",
    placement: str | None = None,
) -> torch.Tensor:
    """(B, G, N, H, wire_W) -> (B, N/2, H, W), banks independent.

    Only the Alg 3 variants have a multi-bank kernel; ``backend='pallas'``
    with Alg 1/2 is an error, as in the reference, and ``auto``/``xla``
    run the plain materialized composite on every device (the reference's
    XLA composite).
    """
    _check_algorithm(algorithm)
    if backend == "pallas" and algorithm in ("alg1", "alg2"):
        raise ValueError(
            f"no multibank pallas kernel for {algorithm}; use backend='auto'/"
            "'xla' (vmapped materialized baseline) or the single-bank "
            "subtract_average"
        )
    _check_backend(backend)
    divide_first = algorithm == "alg3_v2"
    if algorithm in ("alg1", "alg2"):
        return _materialized(
            frames, offset=offset, accum_dtype=accum_dtype,
            stream_dtype=stream_dtype, group_axis=1,
        )
    if backend == "xla":
        return denoise_multibank.multibank_subtract_average_plain(
            frames, offset=offset, divide_first=divide_first,
            accum_dtype=accum_dtype, stream_dtype=stream_dtype,
        )
    return denoise_multibank.multibank_subtract_average(
        frames, offset=offset, divide_first=divide_first,
        accum_dtype=accum_dtype, stream_dtype=stream_dtype,
        row_tile=row_tile, pair_tile=pair_tile,
    )


def multibank_stream_init(
    banks: int, n: int, h: int, w: int, accum_dtype=torch.float32, *, device=None
) -> torch.Tensor:
    """Running-sum state with a leading bank axis: (B, N/2, H, W) zeros,
    on ``device`` as for :func:`stream_init`."""
    return torch.zeros(
        (banks, n // 2, h, w), dtype=ref.as_torch_dtype(accum_dtype),
        device=resolve_device(device),
    )


def multibank_stream_step(
    sum_frames: torch.Tensor,
    group_frames: torch.Tensor,
    *,
    num_groups: int,
    offset: float = 0.0,
    variant: str = "divide_last",
    backend: str = "auto",
    row_tile: int | None = None,
    pair_tile: int | None = None,
    stream_dtype: str = "u16",
    placement: str | None = None,
) -> torch.Tensor:
    """Fold one group per bank (B, N, H, wire_W) into ``sum_frames`` in place."""
    _check_backend(backend)
    if backend != "xla":
        return denoise_multibank.multibank_stream_step(
            group_frames, sum_frames, num_groups=num_groups, offset=offset,
            divide_first=(variant == "divide_first"), stream_dtype=stream_dtype,
            row_tile=row_tile, pair_tile=pair_tile,
        )
    return sum_frames.copy_(ref.ref_stream_step(
        sum_frames, group_frames, offset=offset, variant=variant,
        num_groups=num_groups, stream_dtype=stream_dtype,
    ))



# ---------------------------------------------------------------------------
# The other filters' kernels (temporal_median, ema_variance, spatial_box).
# ---------------------------------------------------------------------------


def median_window_insert(
    window: torch.Tensor,
    group_frames: torch.Tensor,
    *,
    slot: int,
    offset: float = 0.0,
    backend: str = "auto",
    row_tile: int | None = None,
    pair_tile: int | None = None,
    stream_dtype: str = "u16",
    placement: str | None = None,
) -> torch.Tensor:
    """Fold one group's diffs into slot ``slot`` of the (K, N/2, H, W)
    window, in place; returns the window."""
    _check_backend(backend)
    if backend == "xla":
        return denoise_median.median_window_insert_plain(
            window, group_frames, slot=slot, offset=offset, stream_dtype=stream_dtype
        )
    return denoise_median.median_window_insert(
        window, group_frames, slot=slot, offset=offset, stream_dtype=stream_dtype,
        row_tile=row_tile, pair_tile=pair_tile,
    )


def median_combine(
    window: torch.Tensor,
    *,
    backend: str = "auto",
    row_tile: int | None = None,
    pair_tile: int | None = None,
    placement: str | None = None,
) -> torch.Tensor:
    """(K, N/2, H, W) -> (N/2, H, W): per-pixel median over the window
    axis, a fresh tensor. Callers slice the window to its filled prefix.

    ``xla`` is the reference's sort-based composite; a min/max network
    picks the same order statistics exactly, so it runs the plain network.
    """
    _check_backend(backend)
    if backend != "xla":
        return denoise_median.median_combine(window, row_tile=row_tile, pair_tile=pair_tile)
    return denoise_median.median_combine_plain(window)


def ema_welford_step(
    ema: torch.Tensor,
    wmean: torch.Tensor,
    wm2: torch.Tensor,
    group_frames: torch.Tensor,
    *,
    alpha: float,
    offset: float = 0.0,
    prior_count=0,
    backend: str = "auto",
    row_tile: int | None = None,
    pair_tile: int | None = None,
    stream_dtype: str = "u16",
    placement: str | None = None,
):
    """One fused EMA + Welford/Chan update of ``(ema, wmean, wm2)``, in
    place; returns the three. ``xla`` merges the group's N/2 samples at
    once, as the reference's XLA composite does."""
    _check_backend(backend)
    if backend != "xla":
        return denoise_ema.ema_welford_step(
            ema, wmean, wm2, group_frames, alpha=alpha, offset=offset,
            prior_count=prior_count, row_tile=row_tile, pair_tile=pair_tile,
            stream_dtype=stream_dtype,
        )
    new = denoise_ema.ema_welford_step_xla(
        ema, wmean, wm2, group_frames, alpha=alpha, offset=offset,
        prior_count=prior_count, stream_dtype=stream_dtype,
    )
    for dst, src in zip((ema, wmean, wm2), new):
        dst.copy_(src)
    return ema, wmean, wm2


def spatial_filter(
    frames: torch.Tensor,
    *,
    mode: str = "box",
    range_sigma: float = 50.0,
    backend: str = "auto",
    row_tile: int | None = None,
    pair_tile: int | None = None,
    placement: str | None = None,
) -> torch.Tensor:
    """(P, H, W) -> (P, H, W): 3×3 box or bilateral-lite smoothing."""
    if mode not in SPATIAL_MODES:
        raise ValueError(f"mode must be one of {SPATIAL_MODES}, got {mode}")
    _check_backend(backend)
    if backend != "xla":
        return denoise_spatial.spatial_filter_3x3(
            frames, mode=mode, range_sigma=range_sigma, row_tile=row_tile, pair_tile=pair_tile
        )
    return denoise_spatial.spatial_filter_3x3_plain(frames, mode=mode, range_sigma=range_sigma)
