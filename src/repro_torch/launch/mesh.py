"""Device mesh construction (counterpart of ``repro.launch.mesh``).

A FUNCTION, not a module-level constant: importing this module touches
no device. The port trains and serves on one card, so :func:`make_mesh`
takes a shape whose product is 1 (the card, or the CPU when asked). A
mesh over several devices, and the reference's production meshes (a
16 x 16 pod, two pods), are ROADMAP.md queue A item 13(d).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.ops import resolve_device

__all__ = ["make_production_mesh", "make_mesh", "Mesh", "HW"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh: its shape, axis names and the device it spans."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def _multi_device(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} spans several devices: ROADMAP.md queue A item 13(d); the port "
        "runs on a one-device mesh"
    )


def make_production_mesh(*, multi_pod: bool = False):
    raise _multi_device("the production mesh (2 x 16 x 16 or 16 x 16)")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device=None) -> Mesh:
    """A one-device mesh on ``device`` (CUDA unless the caller names
    another; ``RuntimeError`` without CUDA)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    if math.prod(shape) != 1:
        raise _multi_device(f"a mesh of shape {shape}")
    return Mesh(shape, axes, resolve_device(device))


class HW:
    """NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, as
    ``nvidia-smi --query-gpu=name,power.limit`` reads the card the port is
    measured on ("NVIDIA H100 80GB HBM3, 700.00 W"): NVIDIA's data sheet,
    dense rates. A card set below 700 W runs slower under load."""

    CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
    PEAK_BF16_FLOPS = 989e12     # dense bfloat16 tensor-core FLOP/s
    PEAK_F32_FLOPS = 67e12       # float32 FLOP/s outside the tensor cores
    HBM_BW = 3.35e12             # bytes/s
    HBM_BYTES = 80e9             # 80 GB
