"""GPipe-style pipeline parallelism over a ``stage`` mesh axis (counterpart
of ``repro.distributed.pipeline_parallel``).

* layers are partitioned contiguously across the ``stage`` axis: every
  leaf of ``stage_params`` has a leading ``num_stages`` dim and stage s
  owns slice s, on entry s of the mesh's devices;
* a microbatch flows stage to stage by a ``.to(device)`` of the next
  stage, the counterpart of the reference's ``jax.lax.ppermute``;
* the schedule runs P + M - 1 ticks: at tick t stage s runs microbatch
  t - s when 0 <= t - s < M, so a bubble tick computes nothing. Its
  makespan is the classic (P + M - 1) · t_stage, bubble fraction
  (P - 1)/(P + M - 1).

The mesh is a :class:`StageMesh`, the bank mesh's pattern with the one
axis ``stage``. It may name one device more than once
(``StageMesh(("cuda:0",) * 4)`` runs four stages on one card,
``("cpu",) * 4`` on the host), the counterpart of
``XLA_FLAGS=--xla_force_host_platform_device_count``. The ticks run in
order on the current stream, so stages on one card do not overlap.
"""

from __future__ import annotations

from typing import Callable, ClassVar

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.banks import BankMesh

__all__ = ["pipeline_forward", "bubble_fraction", "StageMesh"]


class StageMesh(BankMesh):
    """A 1-D ``stage`` mesh: one device per pipeline stage, ``shape ==
    {"stage": P}``. A CUDA device it names must exist."""

    axis_names: ClassVar[tuple[str, ...]] = ("stage",)

    def __post_init__(self):
        super().__post_init__()
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        for d in self.devices:
            if d.type == "cuda" and (d.index or 0) >= count:
                raise ValueError(f"a stage mesh names {d}, but {count} CUDA devices exist")


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_stages + num_microbatches - 1)


def pipeline_forward(
    stage_params,
    x_microbatches: torch.Tensor,
    mesh: StageMesh,
    stage_fn: Callable,
    *,
    axis: str = "stage",
):
    """Run a GPipe forward.

    stage_params: pytree with a leading ``num_stages`` dim on every leaf
                  (stage s uses slice s, moved to the mesh's device s).
    x_microbatches: (M, mb, ...) microbatch stream.
    stage_fn(params_slice, x) -> x, applied by each stage.

    Returns (M, mb, ...) outputs after all stages, on the device of
    ``x_microbatches``.
    """
    num_stages = mesh.shape[axis]
    devices = mesh.devices
    m = x_microbatches.shape[0]
    leaves, treedef = pytree.tree_flatten(stage_params)
    for leaf in leaves:
        if leaf.shape[0] != num_stages:
            raise ValueError(f"a stage leaf of shape {tuple(leaf.shape)} does not lead with "
                             f"{num_stages} stages")
    per_stage = list(zip(*(leaf.unbind(0) for leaf in leaves)))
    local = [pytree.tree_unflatten([p.to(devices[s]) for p in per_stage[s]], treedef)
             for s in range(num_stages)]

    held = [None] * num_stages  # each stage's output of the last tick
    outs = [None] * m
    for t in range(m + num_stages - 1):
        # the last stage first: stage s reads what stage s - 1 made last tick
        for s in reversed(range(num_stages)):
            mb = t - s
            if not 0 <= mb < m:
                continue
            x = x_microbatches[mb] if s == 0 else held[s - 1]
            held[s] = stage_fn(local[s], x.to(devices[s]))
            if s == num_stages - 1:
                outs[mb] = held[s].to(x_microbatches.device)
    return torch.stack(outs)
