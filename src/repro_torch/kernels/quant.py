"""Quantized-ingest wire formats, PyTorch side (counterpart of
``repro.kernels.quant``).

==========  =================  ==============================================
dtype       wire format        semantics
==========  =================  ==============================================
``"u16"``   uint16, W pixels   mono12-in-u16 containers (bit-exact)
``"u8"``    uint8,  W pixels   12->8-bit quantization, ``q = round(v/S)``
                               with ``S = MONO12_MAX/255`` (lossy, err <= S/2)
``"p12"``   uint8, 3W/2 bytes  two 12-bit pixels packed into 3 bytes along
                               W (W must be even); exact for all 0..4095
==========  =================  ==============================================

The host half (``encode``/``decode`` and the width helpers) is a verbatim
numpy copy, so the same frames give the same wire bytes in both packages.
The device half (``dequant``/``pair_diff_block``) is the plain PyTorch
form of the prologue that ``csrc/denoise_stream.cu`` fuses into every
ingest kernel (``pair_diff``, a ``__device__`` function).

**u8 rounding.** The reference's jitted prologue computes
``exc*S - ctl*S + offset`` with the first product contracted into an FMA:
``fma(exc, S, -(ctl*S)) + offset``. The CUDA prologue writes exactly that
with ``_rn`` intrinsics; this module gets the same value by forming
``exc*S - f32(ctl*S)`` in float64 and rounding once to float32. That is
exact: ``exc*S`` carries at most 32 significant bits and both terms are
multiples of ``ulp(S)``, so the float64 difference is the exact one.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "MONO12_MAX",
    "STREAM_DTYPES",
    "U8_SCALE",
    "validate_stream_dtype",
    "container_dtype",
    "container_name",
    "wire_pixel_bytes",
    "wire_width",
    "logical_width",
    "encode",
    "decode",
    "dequant",
    "pair_diff_block",
    "widen",
    "narrow",
]

MONO12_MAX = 4095  # 12-bit pixels wrapped in u16 containers (paper §6)

#: valid ``DenoiseConfig.stream_dtype`` values, widest first
STREAM_DTYPES = ("u16", "u8", "p12")

#: u8 quantization step: 4095/255, so both range endpoints are exact
U8_SCALE = MONO12_MAX / 255.0

_CONTAINERS = {"u16": np.uint16, "u8": np.uint8, "p12": np.uint8}
_NAMES = {"u16": "uint16", "u8": "uint8", "p12": "pack12"}
_PIXEL_BYTES = {"u16": 2.0, "u8": 1.0, "p12": 1.5}


def validate_stream_dtype(stream_dtype: str) -> str:
    if stream_dtype not in STREAM_DTYPES:
        raise ValueError(
            f"stream_dtype must be one of {STREAM_DTYPES}, got "
            f"{stream_dtype!r}"
        )
    return stream_dtype


def container_dtype(stream_dtype: str) -> np.dtype:
    """Numpy dtype of the wire container."""
    return np.dtype(_CONTAINERS[validate_stream_dtype(stream_dtype)])


def container_torch_dtype(stream_dtype: str) -> torch.dtype:
    """Torch dtype of the wire container (what the CUDA kernels ingest)."""
    return torch.uint16 if validate_stream_dtype(stream_dtype) == "u16" else torch.uint8


def container_name(stream_dtype: str) -> str:
    """Plan-cache key spelling of the wire format."""
    return _NAMES[validate_stream_dtype(stream_dtype)]


def wire_pixel_bytes(stream_dtype: str) -> float:
    """Wire bytes per logical pixel (1.5 for the packed-12-bit format)."""
    return _PIXEL_BYTES[validate_stream_dtype(stream_dtype)]


def wire_width(width: int, stream_dtype: str) -> int:
    """Wire-format minor-axis length for ``width`` logical pixels."""
    validate_stream_dtype(stream_dtype)
    if stream_dtype != "p12":
        return width
    if width % 2:
        raise ValueError(f"p12 packing needs an even width, got {width}")
    return width // 2 * 3


def logical_width(wire_w: int, stream_dtype: str) -> int:
    """Inverse of :func:`wire_width`."""
    validate_stream_dtype(stream_dtype)
    if stream_dtype != "p12":
        return wire_w
    if wire_w % 3:
        raise ValueError(f"p12 wire width must be a multiple of 3, got {wire_w}")
    return wire_w // 3 * 2


# ---------------------------------------------------------------------------
# Host side (numpy): what PrismSource emits / tests decode.
# ---------------------------------------------------------------------------


def encode(frames: np.ndarray, stream_dtype: str) -> np.ndarray:
    """u16 mono12 frames ``(..., W)`` -> wire containers.

    ``"u16"`` returns the input unchanged (no copy).
    """
    validate_stream_dtype(stream_dtype)
    if stream_dtype == "u16":
        return frames
    frames = np.asarray(frames)
    if stream_dtype == "u8":
        return np.clip(
            np.round(frames.astype(np.float64) / U8_SCALE), 0, 255
        ).astype(np.uint8)
    # p12: two 12-bit pixels -> 3 bytes along the minor axis
    w = frames.shape[-1]
    wire_width(w, stream_dtype)  # validates even width
    pairs = frames.astype(np.uint16).reshape(frames.shape[:-1] + (w // 2, 2))
    lo, hi = pairs[..., 0], pairs[..., 1]
    b0 = lo & 0xFF
    b1 = ((lo >> 8) & 0xF) | ((hi & 0xF) << 4)
    b2 = hi >> 4
    return (
        np.stack([b0, b1, b2], axis=-1)
        .astype(np.uint8)
        .reshape(frames.shape[:-1] + (w // 2 * 3,))
    )


def decode(wire: np.ndarray, stream_dtype: str) -> np.ndarray:
    """Exact host-side inverse of :func:`encode`.

    Returns u16 pixel values for the exact formats and float32
    dequantized values for the lossy ``"u8"`` path.
    """
    validate_stream_dtype(stream_dtype)
    if stream_dtype == "u16":
        return wire
    wire = np.asarray(wire)
    if stream_dtype == "u8":
        # scale in float64 so the range endpoints come back exactly
        return (wire.astype(np.float64) * U8_SCALE).astype(np.float32)
    wp = wire.shape[-1]
    logical_width(wp, stream_dtype)  # validates multiple of 3
    trip = wire.reshape(wire.shape[:-1] + (wp // 3, 3)).astype(np.uint16)
    b0, b1, b2 = trip[..., 0], trip[..., 1], trip[..., 2]
    lo = b0 | ((b1 & 0xF) << 8)
    hi = (b1 >> 4) | (b2 << 4)
    return np.stack([lo, hi], axis=-1).reshape(wire.shape[:-1] + (wp // 3 * 2,))


# ---------------------------------------------------------------------------
# Device side (torch): the plain form of the kernels' dequant prologue.
# ---------------------------------------------------------------------------


def widen(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 16-bit containers as exact int32 values.

    ``torch.uint16`` supports conversion but no arithmetic, so it is read
    through an int16 view and masked; every other dtype passes through.
    """
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    return x


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`widen`: int32 values wrapped into ``dtype``
    (modulo 2**16 for ``torch.uint16``, as the reference's containers wrap)."""
    if dtype == torch.uint16:
        return (x & 0xFFFF).to(torch.uint16)
    return x.to(dtype)


def work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype arithmetic on ``dtype`` values runs in (int32 for uint16)."""
    return torch.int32 if dtype == torch.uint16 else dtype


def _unpack12(x: torch.Tensor) -> torch.Tensor:
    """p12 wire ``(..., 3W/2)`` uint8 -> ``(..., W)`` int32 pixels."""
    wp = x.shape[-1]
    w = logical_width(wp, "p12")
    trip = x.reshape(x.shape[:-1] + (wp // 3, 3)).to(torch.int32)
    b0, b1, b2 = trip[..., 0], trip[..., 1], trip[..., 2]
    lo = b0 | ((b1 & 0xF) << 8)
    hi = (b1 >> 4) | (b2 << 4)
    return torch.stack([lo, hi], dim=-1).reshape(x.shape[:-1] + (w,))


def dequant(x: torch.Tensor, stream_dtype: str, accum_dtype: torch.dtype) -> torch.Tensor:
    """Wire values ``(..., wire_w)`` -> pixel values ``(..., W)`` in
    ``accum_dtype`` (the u8 scale as one float32 multiply; the fused
    difference below is what the kernels compute)."""
    validate_stream_dtype(stream_dtype)
    if stream_dtype == "u16":
        return widen(x).to(accum_dtype)
    if stream_dtype == "u8":
        return x.to(accum_dtype) * torch.tensor(U8_SCALE, dtype=accum_dtype)
    return _unpack12(x).to(accum_dtype)


def pair_diff_block(
    block: torch.Tensor, *, offset: float, accum_dtype, stream_dtype: str = "u16"
) -> torch.Tensor:
    """The shared prologue: ``(..., 2, th, wire_w)`` pairs block ->
    dequantized ``(..., th, W)`` difference ``exc - ctl + offset``.

    For ``"u8"`` into float32 the difference is
    ``fma(exc, S, -f32(ctl*S)) + offset``, rounded as the reference's
    jitted prologue and the CUDA ``pair_diff`` round it (module docstring);
    into float16 the same in float16 (the FMA rounded once to float16). Into bfloat16 every operation rounds on its own
    (``ref.contracts``).
    """
    validate_stream_dtype(stream_dtype)
    acc = accum_dtype
    work = work_dtype(acc)
    off = torch.tensor(offset, dtype=work)
    ctl, exc = block[..., 0, :, :], block[..., 1, :, :]
    if stream_dtype == "u8" and acc == torch.float32:
        scale = torch.tensor(U8_SCALE, dtype=torch.float32)
        ctl_s = (ctl.to(torch.float32) * scale).to(torch.float64)
        diff = (exc.to(torch.float64) * float(scale) - ctl_s).to(torch.float32)
        return diff + off
    if stream_dtype == "u8" and acc == torch.float16:
        from repro_torch.kernels.ref import fma  # ref builds on this module

        # the same contraction in float16: fma(exc, S16, -f16(ctl*S16)),
        # rounded once to float16, then + offset
        scale = torch.tensor(U8_SCALE, dtype=torch.float16)
        ctl_s = ctl.to(torch.float16) * scale
        return fma(exc.to(torch.float16), float(scale), -ctl_s) + off
    diff = dequant(exc, stream_dtype, work) - dequant(ctl, stream_dtype, work) + off
    return narrow(diff, acc)
