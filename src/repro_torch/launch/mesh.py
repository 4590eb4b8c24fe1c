"""Device mesh construction (counterpart of ``repro.launch.mesh``).

A FUNCTION, not a module-level constant: importing this module touches
no device. :func:`make_mesh` takes a shape whose product is 1 (the card,
or the CPU when asked) or the world size of the default
``torch.distributed`` process group: a ``DeviceMesh`` over that group,
one rank per mesh position, on which ``distributed.sharding`` places
DTensors. Several ranks may share one device (four ranks on one card, or
four CPU processes), as the reference's tests run a ``(2, 2)`` mesh of
four host devices. :func:`start_group` starts such a group on one host
through a file. The reference's production meshes (a 16 x 16 pod, two
pods) are ROADMAP.md queue A item 13(d).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Any

import torch

from repro_torch.kernels.ops import resolve_device

__all__ = ["make_production_mesh", "make_mesh", "start_group", "Mesh", "HW"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh: its shape, axis names and the device each rank
    computes on; ``device_mesh`` is the ``DeviceMesh`` over the process
    group when the mesh spans more than one rank, else ``None``."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    device: torch.device
    device_mesh: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def axis_sizes(self) -> dict[str, int]:
        """``{axis name: size}``, what the reference's ``Mesh.shape`` holds."""
        return dict(zip(self.axis_names, self.shape))


def _multi_device(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} spans several devices: ROADMAP.md queue A item 13(d); the port "
        "runs on a one-device mesh or a mesh over the ranks of one process group"
    )


def make_production_mesh(*, multi_pod: bool = False):
    raise _multi_device("the production mesh (2 x 16 x 16 or 16 x 16)")


def start_group(store_path: str, rank: int, world_size: int, *,
                timeout_s: float = 120.0) -> None:
    """Join the default gloo process group of ``world_size`` ranks on this
    host through the file ``store_path`` (a ``FileStore``: no TCP port, so
    groups started side by side never collide). Every rank passes the same
    path; the file must not exist before the first rank starts."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world_size), rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s),
    )


_GLOO_CUDA_LIBRARY = None


def _gloo_all_gather_into_tensor(inp, group_size: int, group_name: str):
    """``_c10d_functional.all_gather_into_tensor`` as the synchronous
    ``torch.distributed.all_gather_into_tensor``, for a gloo group only:
    any other backend raises (it is never rerouted)."""
    import torch.distributed as dist

    group = dist.distributed_c10d._resolve_process_group(group_name)
    backend = dist.get_backend(group)
    if backend != "gloo":
        raise RuntimeError(
            f"the functional all-gather on CUDA tensors is replaced by gloo's in this "
            f"process (launch.mesh.make_mesh over a gloo group); group {group_name!r} "
            f"is {backend!r}, which it does not serve"
        )
    out = inp.new_empty((group_size * inp.shape[0],) + tuple(inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp.contiguous(), group=group)
    return out


def _gloo_cuda_all_gather() -> None:
    """Give the functional all-gather that DTensor issues a CUDA kernel
    that runs over gloo.

    With gloo, PyTorch's functional ``all_gather_into_tensor`` on CUDA
    tensors ends the process with a segmentation fault (probed by
    ``scripts/torch_gloo_cuda_probe.py`` on torch 2.11.0+cu128 only), while
    ``torch.distributed.all_gather_into_tensor`` on the same tensors runs,
    as do the functional all-reduce, reduce-scatter and all-to-all. This
    registers, for CUDA tensors and for the rest of the process,
    :func:`_gloo_all_gather_into_tensor` in its place; a group of another
    backend that reaches it raises. gloo stages CUDA tensors through host
    memory in every collective.
    """
    global _GLOO_CUDA_LIBRARY
    if _GLOO_CUDA_LIBRARY is not None:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _gloo_all_gather_into_tensor, "CUDA")
    _GLOO_CUDA_LIBRARY = lib


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device=None) -> Mesh:
    """A mesh of ``shape`` on ``device`` (CUDA unless the caller names
    another; ``RuntimeError`` without CUDA). A product of 1 is the one
    device. A larger product needs the default process group initialised
    with that world size (``RuntimeError`` otherwise: it never falls back
    to one device) and builds a ``DeviceMesh`` over it, each rank on
    ``device``."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    dev = resolve_device(device)
    if math.prod(shape) == 1:
        return Mesh(shape, axes, dev)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of shape {shape} needs the default process group of "
            f"{math.prod(shape)} ranks (start_group, or torchrun); none is initialised"
        )
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(
            f"a mesh of shape {shape} has {math.prod(shape)} positions, the process "
            f"group {dist.get_world_size()} ranks"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        _gloo_cuda_all_gather()
    return Mesh(shape, axes, dev, init_device_mesh(dev.type, shape, mesh_dim_names=axes))


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
