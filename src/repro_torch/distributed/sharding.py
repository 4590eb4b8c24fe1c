"""Logical-axis parameter declarations (counterpart of
``repro.distributed.sharding``).

Every parameter is declared once as a :class:`ParamSpec` (shape, logical
axis names, initializer). A spec tree is nested dicts and lists of specs,
walked in JAX's flatten order (``repro_torch.checkpoint.checkpoint``), so
it counts, sizes and initializes without allocating anything but the
result.

The reference maps logical axes to a device mesh through a rules table.
Here :func:`partition_spec` is that mapping as a pure function of the
mesh's axis sizes: it returns the mesh-axis names each dimension would
take, and nothing is placed. Placing tensors over a mesh
(:func:`named_shardings`, :func:`logical_sharding`) needs a device mesh,
ROADMAP.md queue A item 13(d).
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any

import torch

from repro_torch.checkpoint.checkpoint import flat_leaves, map_tree
from repro_torch.kernels.ops import resolve_device

__all__ = [
    "ParamSpec",
    "DEFAULT_RULES",
    "is_spec",
    "abstract_params",
    "init_params",
    "partition_spec",
    "named_shardings",
    "logical_sharding",
    "stack_spec",
    "count_params",
    "spec_bytes",
]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter: shape, logical axes, initializer."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | fan_in | const
    scale: float = 0.02
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    "cache_seq": None,            # flipped to "data" for long-context cells
    "embed": "data",              # FSDP
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qk_dim": None,
    "v_dim": None,
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "kv_lora": "model",
    "state": None,
    "conv": None,
    "layers": None,
    "norm": None,
    "frames": None,
    "img": None,
    "stage": "stage",             # pipeline parallelism (optional axis)
    # --- activation axes (separate vocabulary from parameter axes) ---
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "act_experts": "model",
    "act_expert_mlp": None,
    "act_kv_lora": "model",
    "act_cache_seq": None,
    "act_moe_group": ("pod", "data"),
    "act_attn_q_seq": None,
}


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def abstract_params(spec_tree, dtype=None):
    """The tree as ``meta`` tensors: shapes and dtypes, no storage."""
    return map_tree(
        lambda s: torch.empty(s.shape, dtype=dtype or s.dtype, device="meta"), spec_tree
    )


def init_params(spec_tree, *, generator: torch.Generator, device=None, dtype=None):
    """Materialize parameters on ``device`` (CUDA unless the caller names
    another; ``RuntimeError`` without CUDA) with the reference's rules:
    ``normal`` is N(0, scale), ``fan_in`` is N(0, 1) / sqrt(shape[0]),
    ``zeros``/``ones``/``const`` (the value ``scale``) are filled.

    Random leaves draw from ``generator``, one after another in JAX's leaf
    order, on the generator's device. The numbers are not
    ``jax.random``'s: carry the reference's own parameters with
    ``repro_torch.convert.params_from_reference`` to compare the two.
    """
    dev = resolve_device(device)

    def one(s: ParamSpec):
        dt = dtype or s.dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        if s.init == "const":
            return torch.full(s.shape, s.scale, dtype=dt, device=dev)
        # scaled in place: a second copy of the largest leaf (deepseek's
        # stacked experts, 19 GB) would not fit beside the rest on the card
        x = torch.randn(s.shape, generator=generator, device=generator.device)
        if s.init == "fan_in":
            x.div_(math.sqrt(max(s.shape[0] if s.shape else 1, 1)))
        else:
            x.mul_(s.scale)
        return x.to(device=dev, dtype=dt)

    return map_tree(one, spec_tree)


def _resolve_axis(logical, dim, mesh_shape, rules, taken):
    """Map one logical axis to mesh axes, honoring divisibility + no-reuse."""
    if logical is None:
        return None
    target = rules.get(logical)
    if target is None:
        return None
    axes = (target,) if isinstance(target, str) else tuple(target)
    chosen: list[str] = []
    remaining = dim
    for ax in axes:
        if ax not in mesh_shape or ax in taken or remaining % mesh_shape[ax]:
            continue
        chosen.append(ax)
        taken.add(ax)
        remaining //= mesh_shape[ax]
    if not chosen:
        return None
    return chosen[0] if len(chosen) == 1 else tuple(chosen)


def partition_spec(
    shape: tuple[int, ...],
    axes: tuple[str | None, ...],
    mesh_shape: Mapping[str, int],
    rules: dict | None = None,
) -> tuple:
    """The mesh axes each dimension would be split over, one entry per
    dimension (a name, a tuple of names, or ``None``), for a mesh of
    ``mesh_shape`` axis sizes: the reference's ``PartitionSpec`` entries,
    with its divisibility fallback (a dimension that a mesh axis does not
    divide is replicated) and no mesh axis used twice."""
    rules = rules or DEFAULT_RULES
    taken: set[str] = set()
    return tuple(
        _resolve_axis(a, d, mesh_shape, rules, taken) for d, a in zip(shape, axes)
    )


def named_shardings(spec_tree, mesh, rules: dict | None = None):
    raise NotImplementedError(
        "named_shardings places parameters over a device mesh: ROADMAP.md "
        "queue A item 13(d); partition_spec gives the same axes as metadata"
    )


def logical_sharding(shape, axes, mesh, rules: dict | None = None):
    raise NotImplementedError(
        "logical_sharding places a tensor over a device mesh: ROADMAP.md "
        "queue A item 13(d); partition_spec gives the same axes as metadata"
    )


def stack_spec(spec_tree, n: int, axis_name: str = "layers"):
    """Prefix every spec with a stacked layer dimension."""
    return map_tree(
        lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init, s.scale, s.dtype),
        spec_tree,
    )


def count_params(spec_tree) -> int:
    return sum(math.prod(s.shape) for s in flat_leaves(spec_tree))


def spec_bytes(spec_tree, bytes_per_param: int = 4) -> int:
    return count_params(spec_tree) * bytes_per_param
