"""Paper Algorithm 3 (+ v2) on Hopper: fused subtract-accumulate.

Counterpart of ``repro.kernels.denoise_stream``. Two wrappers, each over
its own CUDA kernel in ``csrc/denoise_stream.cu``:

* :func:`alg3_stream_step` — fold one group ``(N, H, wire_W)`` into the
  running sum ``(N/2, H, W)``. The sum is updated **in place** (the
  reference donates it) and returned. Per step the HBM traffic is: read
  ``N*H*wire_W`` wire bytes, read and write ``(N/2)*H*W`` float32.
* :func:`alg3_subtract_average` — one shot over ``(G, N, H, wire_W)``:
  each input byte is read once, the sum stays in registers across the
  group loop, only the averaged ``(N/2, H, W)`` frames are written.

The step kernel has two paths, chosen on the host by :func:`step_path`
and passed to the kernel as a flag: a vector path (eight pixels a thread,
16-byte loads for u16, 8-byte for u8) wherever every plane allows it, and
the scalar path (one pixel a thread, one block per row) on every other
shape, for p12 and for integer sums. Each launch
is counted in ``<wrapper>.vector_launches`` or ``<wrapper>.scalar_launches``
as well as in ``<wrapper>.launches``.

Dispatch is by the tensors' device: on a CUDA tensor the wrapper checks
device, dtype, shape and contiguity, launches its kernel on the current
stream and counts the launch in ``<wrapper>.launches``; on a CPU tensor it
runs the plain PyTorch version beside it (``*_plain``), the counterpart
of the reference's interpret mode. It never falls back from one to the
other. Sums are float32, or, from u16 wire, int32 or uint16 (the paper's
u16 container, which wraps at 16 bits): the integer kernels do the plain
versions' integer arithmetic (``ref.fold``), floor divisions included.
Every wrapper takes a launch geometry, ``row_tile`` image rows of
``pair_tile`` pairs a block (on the step's vector path, a share of
``row_tile * W`` pixels in whole vectors), from a tuning plan
(:mod:`repro_torch.tune`); ``None`` keeps the kernel's default layout. An
explicit tile must divide H or N/2 (``ValueError``, on every device, as
the reference's). The geometry never changes a bit of the result.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, quant, ref
from repro_torch.tune.budget import launch_tiles

__all__ = [
    "alg3_stream_step",
    "alg3_stream_step_plain",
    "alg3_subtract_average",
    "alg3_subtract_average_plain",
    "step_path",
]

_FORMATS = {"u16": 0, "u8": 1, "p12": 2}
#: float32 u8 scale, as the reference's ``jnp.asarray(U8_SCALE, f32)``
U8_SCALE_F32 = float(np.float32(quant.U8_SCALE))
#: ROADMAP.md item an unported request names
NOT_PORTED_ACCUM = (
    "the CUDA kernels accumulate in float32, and the Alg 1-3 kernels also in "
    "int32 and uint16 from u16 wire; other accumulators run on the CPU "
    "(ROADMAP.md queue C, 'other accumulators on CUDA')"
)
#: the C entry points' accumulator codes (``AccumCode``, ``csrc/quant.cuh``)
ACCUM_CODES = {torch.float32: 0, torch.int32: 1, torch.uint16: 2}


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on
    another device type (the wrappers never move data between devices)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(
        f"tensors must all be on one CUDA device or all on the CPU, got "
        f"{[str(t.device) for t in tensors]}"
    )


def check_kernel_operands(
    frames: torch.Tensor, out: torch.Tensor, stream_dtype: str, *,
    integer_sums: bool = False,
) -> tuple[int, int, int]:
    """Validate a CUDA launch; returns ``(format code, items, row_bytes)``.

    ``items`` is the per-row thread count (W, or W/2 for p12, whose 3 wire
    bytes hold two pixels); ``row_bytes`` the wire row length in bytes.
    ``out`` is float32, or with ``integer_sums`` also an int32 or uint16
    sum of u16 wire.
    """
    quant.validate_stream_dtype(stream_dtype)
    integer = integer_sums and stream_dtype == "u16" and out.dtype in (torch.int32, torch.uint16)
    if out.dtype != torch.float32 and not integer:
        raise NotImplementedError(
            f"accumulator {out.dtype} ({stream_dtype} wire): {NOT_PORTED_ACCUM}")
    want = quant.container_torch_dtype(stream_dtype)
    if frames.dtype != want:
        raise TypeError(
            f"stream_dtype={stream_dtype!r} kernels ingest {want} wire "
            f"containers, got {frames.dtype}"
        )
    if not (frames.is_contiguous() and out.is_contiguous()):
        raise ValueError("the CUDA kernels need contiguous frames and sums")
    w = out.shape[-1]
    items = w // 2 if stream_dtype == "p12" else w
    return _FORMATS[stream_dtype], items, frames.shape[-1] * frames.element_size()


#: plane-start alignment (bytes) of the step's vector loads, per wire format
#: that has a vector path (p12 has none)
VECTOR_ALIGN = {"u16": 16, "u8": 8}


def step_path(plane_px: int, stream_dtype: str, frames_ptr: int, sum_ptr: int) -> str:
    """The step kernel's path for planes of ``plane_px`` = H*W pixels.

    ``"vector"`` (eight pixels a thread) for u16 and u8 when H*W is a
    multiple of 8 and the frames and the sum start on the width of their
    vector loads: every plane then starts so aligned. ``"scalar"``
    otherwise, and always for p12.
    """
    align = VECTOR_ALIGN.get(quant.validate_stream_dtype(stream_dtype))
    aligned = align is not None and frames_ptr % align == 0 and sum_ptr % 16 == 0
    return "vector" if plane_px % 8 == 0 and aligned else "scalar"


def launch_step(fn, entry: str, group_frames, sum_frame, dims, *, fmt: int,
                divide_first: bool, final: bool, offset: float, num_groups: int,
                stream_dtype: str, tiles: tuple[int, int]) -> None:
    """Launch the step kernel through the C entry point ``entry`` on the path
    :func:`step_path` picks (the scalar one for an integer sum), and count
    the launch on the wrapper ``fn``. ``dims`` are the launcher's sizes,
    from the bank or pair count to ``row_bytes``; ``tiles`` is the
    launcher's ``(row_tile, pair_tile)`` (:func:`launch_tiles`)."""
    *_, h, w = sum_frame.shape
    acc = ACCUM_CODES[sum_frame.dtype]
    path = "scalar" if acc else step_path(
        h * w, stream_dtype, group_frames.data_ptr(), sum_frame.data_ptr())
    lib = _build.library()
    with torch.cuda.device(sum_frame.device):
        rc = getattr(lib, entry)(
            group_frames.data_ptr(), sum_frame.data_ptr(), *dims, fmt, int(divide_first),
            int(final and not divide_first), int(path == "vector"), float(offset),
            U8_SCALE_F32, ref.reciprocal(num_groups), acc, num_groups, *tiles,
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, fn.__name__)
    fn.launches += 1
    setattr(fn, f"{path}_launches", getattr(fn, f"{path}_launches") + 1)


def check_launch(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (0 = launched)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {rc})")


def check_step_shapes(group_frames, sum_frame, stream_dtype, banked):
    lead = 1 if banked else 0
    if group_frames.ndim != 3 + lead or sum_frame.ndim != 3 + lead:
        raise ValueError(
            f"expected {'(B, ' if banked else '('}N, H, wire_W) frames and a "
            f"matching sum, got {tuple(group_frames.shape)} and "
            f"{tuple(sum_frame.shape)}"
        )
    n, h, wp = group_frames.shape[-3:]
    want = group_frames.shape[:lead] + (n // 2, h, quant.logical_width(wp, stream_dtype))
    if n % 2 or tuple(sum_frame.shape) != tuple(want):
        raise ValueError(
            f"sum shape {tuple(sum_frame.shape)} does not match frames "
            f"{tuple(group_frames.shape)} (want {tuple(want)}, N even)"
        )


def alg3_stream_step_plain(
    group_frames: torch.Tensor,
    sum_frame: torch.Tensor,
    *,
    num_groups: int,
    offset: float = 0.0,
    divide_first: bool = False,
    final: bool = False,
    stream_dtype: str = "u16",
) -> torch.Tensor:
    """Plain PyTorch version of the step kernel; returns a new sum."""
    total = ref.ref_stream_step(
        sum_frame, group_frames, offset=offset,
        variant="divide_first" if divide_first else "divide_last",
        num_groups=num_groups, stream_dtype=stream_dtype,
    )
    if final and not divide_first:
        total = ref.scale_reciprocal(total, num_groups)
    return total


def alg3_stream_step(
    group_frames: torch.Tensor,
    sum_frame: torch.Tensor,
    *,
    num_groups: int,
    offset: float = 0.0,
    divide_first: bool = False,
    final: bool = False,
    stream_dtype: str = "u16",
    row_tile: int | None = None,
    pair_tile: int | None = None,
) -> torch.Tensor:
    """Fold one group (N, H, wire_W) into the running sum (N/2, H, W), in place."""
    check_step_shapes(group_frames, sum_frame, stream_dtype, banked=False)
    n, h, _ = group_frames.shape
    tiles = launch_tiles(n // 2, h, row_tile, pair_tile)
    if not on_cuda(group_frames, sum_frame):
        return sum_frame.copy_(alg3_stream_step_plain(
            group_frames, sum_frame, num_groups=num_groups, offset=offset,
            divide_first=divide_first, final=final, stream_dtype=stream_dtype,
        ))
    fmt, items, row_bytes = check_kernel_operands(group_frames, sum_frame, stream_dtype,
                                                  integer_sums=True)
    launch_step(alg3_stream_step, "alg3_stream_step_launch", group_frames, sum_frame,
                (n // 2, h, items, row_bytes), fmt=fmt, divide_first=divide_first,
                final=final, offset=offset, num_groups=num_groups, stream_dtype=stream_dtype,
                tiles=tiles)
    return sum_frame


alg3_stream_step.launches = 0
alg3_stream_step.vector_launches = 0
alg3_stream_step.scalar_launches = 0


def alg3_subtract_average_plain(
    frames: torch.Tensor,
    *,
    offset: float = 0.0,
    divide_first: bool = False,
    accum_dtype=torch.float32,
    stream_dtype: str = "u16",
) -> torch.Tensor:
    """Plain PyTorch version of the one-shot kernel: groups folded in
    order, then one reciprocal scale (divide_last)."""
    *lead, g, n, h, wp = frames.shape
    acc = ref.as_torch_dtype(accum_dtype)
    total = torch.zeros(
        (*lead, n // 2, h, quant.logical_width(wp, stream_dtype)),
        dtype=acc, device=frames.device,
    )
    variant = "divide_first" if divide_first else "divide_last"
    for k in range(g):
        total = ref.ref_stream_step(
            total, frames[..., k, :, :, :], offset=offset, variant=variant,
            num_groups=g, stream_dtype=stream_dtype,
        )
    return total if divide_first else ref.scale_reciprocal(total, g)


def alg3_subtract_average(
    frames: torch.Tensor,
    *,
    offset: float = 0.0,
    divide_first: bool = False,
    accum_dtype=torch.float32,
    stream_dtype: str = "u16",
    row_tile: int | None = None,
    pair_tile: int | None = None,
) -> torch.Tensor:
    """frames (G, N, H, wire_W) -> averaged difference frames (N/2, H, W)."""
    if frames.ndim != 4 or frames.shape[1] % 2:
        raise ValueError(f"expected (G, N, H, wire_W) with N even, got {tuple(frames.shape)}")
    tiles = launch_tiles(frames.shape[1] // 2, frames.shape[2], row_tile, pair_tile)
    if not on_cuda(frames):
        return alg3_subtract_average_plain(
            frames, offset=offset, divide_first=divide_first,
            accum_dtype=accum_dtype, stream_dtype=stream_dtype,
        )
    g, n, h, wp = frames.shape
    out = torch.empty(
        (n // 2, h, quant.logical_width(wp, stream_dtype)),
        dtype=ref.as_torch_dtype(accum_dtype), device=frames.device,
    )
    fmt, items, row_bytes = check_kernel_operands(frames, out, stream_dtype, integer_sums=True)
    lib = _build.library()
    with torch.cuda.device(frames.device):
        rc = lib.alg3_subtract_average_launch(
            frames.data_ptr(), out.data_ptr(), g, n // 2, h, items, row_bytes,
            fmt, int(divide_first), float(offset), U8_SCALE_F32,
            ref.reciprocal(g), ACCUM_CODES[out.dtype], *tiles,
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "alg3_subtract_average")
    alg3_subtract_average.launches += 1
    return out


alg3_subtract_average.launches = 0
