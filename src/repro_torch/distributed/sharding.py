"""Logical-axis parameter declarations and their placement over a mesh
(counterpart of ``repro.distributed.sharding``).

Every parameter is declared once as a :class:`ParamSpec` (shape, logical
axis names, initializer). A spec tree is nested dicts and lists of specs,
walked in JAX's flatten order (``repro_torch.checkpoint.checkpoint``), so
it counts, sizes and initializes without allocating anything but the
result.

The reference maps logical axes to a device mesh through a rules table.
:func:`partition_spec` is that mapping as a pure function of the mesh's
axis sizes: the mesh-axis names each dimension takes, with the
reference's divisibility fallback. :func:`named_shardings` and
:func:`logical_sharding` turn those entries into DTensor placements, one
per mesh dimension (:class:`NamedSharding`, the counterpart of
``jax.sharding.NamedSharding``), and :func:`place` distributes a tree by
them over a mesh of several ranks (``launch.mesh.make_mesh``). On a
one-device mesh every placement is ``Replicate`` and nothing moves.
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
    "NamedSharding",
    "placements",
    "place",
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


def init_params(spec_tree, *, generator: torch.Generator, device=None, dtype=None,
                mesh=None, rules: dict | None = None):
    """Materialize parameters on ``device`` (CUDA unless the caller names
    another; ``RuntimeError`` without CUDA) with the reference's rules:
    ``normal`` is N(0, scale), ``fan_in`` is N(0, 1) / sqrt(shape[0]),
    ``zeros``/``ones``/``const`` (the value ``scale``) are filled.

    Random leaves draw from ``generator``, one after another in JAX's leaf
    order, on the generator's device. The numbers are not
    ``jax.random``'s: carry the reference's own parameters with
    ``repro_torch.convert.params_from_reference`` to compare the two.

    With a ``mesh`` of several ranks each leaf is drawn whole, as on one
    device (every rank seeds ``generator`` alike), and only this rank's
    shard under :func:`named_shardings` is kept: the parameters equal the
    one-device ones, placed.
    """
    dev = resolve_device(device)
    shardings = None
    if mesh is not None and mesh.size > 1:
        shardings = named_shardings(spec_tree, mesh, rules)

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

    if shardings is None:
        return map_tree(one, spec_tree)
    return map_tree(lambda s, ns: _place(one(s), ns), spec_tree, shardings)


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


def placements(spec: tuple, axis_names: tuple[str, ...]) -> tuple:
    """DTensor placements of :func:`partition_spec` entries over a mesh
    with ``axis_names``: one per mesh dimension, ``Shard(d)`` for the mesh
    axis that splits tensor dimension ``d``, ``Replicate()`` for one that
    splits none. A dimension split over several mesh axes (``('pod',
    'data')``) takes them major to minor, which DTensor does when they
    come in mesh order; any other order raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(axis_names)
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        order = [axis_names.index(n) for n in names]
        if order != sorted(order):
            raise ValueError(
                f"dimension {d} is split over {names}, against the mesh's axis order "
                f"{axis_names}"
            )
        for i in order:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives on ``mesh`` (``launch.mesh.Mesh``): the
    :func:`partition_spec` entries and their DTensor placements."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh.axis_names)


def logical_sharding(shape, axes, mesh, rules: dict | None = None) -> NamedSharding:
    """The sharding of an activation or input by its logical axes."""
    return NamedSharding(mesh, partition_spec(shape, axes, mesh.axis_sizes, rules))


def named_shardings(spec_tree, mesh, rules: dict | None = None):
    """A :class:`NamedSharding` for every spec of a ParamSpec tree."""
    return map_tree(lambda s: logical_sharding(s.shape, s.axes, mesh, rules), spec_tree)


def _place(t: torch.Tensor, ns: NamedSharding):
    """``t``, the same full tensor on every rank, as a DTensor on
    ``ns.mesh`` holding this rank's shard (a copy: ``t`` may be freed).
    On a one-device mesh ``t`` itself; a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh = ns.mesh
    if mesh.size == 1:
        return t
    if isinstance(t, DTensor):
        return t.redistribute(mesh.device_mesh, ns.placements)
    # every rank holds the full tensor, so each keeps its shard and
    # nothing crosses the group (src_data_rank=None)
    d = distribute_tensor(t.to(mesh.device), mesh.device_mesh, ns.placements,
                          src_data_rank=None)
    return DTensor.from_local(d.to_local().clone(), mesh.device_mesh, ns.placements,
                              run_check=False, shape=d.shape, stride=d.stride())


def place(tree, shardings):
    """Distribute a tree of full tensors (the same on every rank) by a
    matching tree of :class:`NamedSharding`; DTensor leaves are
    redistributed."""
    return map_tree(_place, tree, shardings)


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
