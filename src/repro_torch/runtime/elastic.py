"""Elastic scaling: re-place live state onto a different device set
(counterpart of ``repro.runtime.elastic``).

Checkpoints are device-agnostic (full numpy leaves + key paths), so
shrink/grow is:
  1. snapshot state to host (or restore the latest checkpoint),
  2. build the new :class:`~repro_torch.core.banks.BankMesh` from the
     surviving device set (:func:`available_mesh`),
  3. describe each leaf's logical axes (:func:`state_spec_tree`),
  4. place every leaf on the new mesh (:func:`elastic_reshard`).

The reference derives ``NamedSharding``\\ s from its model substrate's
``ParamSpec`` rules; the port's meshes are 1-D ``bank`` meshes with no
collectives, so a leaf either splits along its ``bank`` axis, one slice
per shard device (the layout of the port's bank-sharded states: a list
with one state per shard), or lands whole on the mesh's first device.

Callers: the fleet's elastic pool (``repro_torch.serve.fleet``):
``scale_up`` consults :func:`available_mesh` for the device ceiling of a
mesh-backed pool, and a session migrating off a **draining** executor
has its extracted slot state passed through :func:`elastic_reshard`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint.checkpoint import flat_leaves, from_host, map_tree
from repro_torch.core.banks import BankMesh
from repro_torch.kernels import ops

__all__ = [
    "LeafSpec",
    "available_mesh",
    "elastic_reshard",
    "mesh_shape",
    "state_spec_tree",
]


def mesh_shape(num_devices: int, num_axes: int) -> tuple[int, ...]:
    """Largest power-of-2 mesh shape over ``num_devices`` devices.

    1 axis: ``(n,)`` with ``n`` the largest power of two ``<=``
    ``num_devices``. 2 axes: ``(n // m, m)`` with ``m`` the largest
    power of two whose square fits in ``n`` — as square as a power-of-2
    factorization gets, biased toward the first (data) axis. Pure
    arithmetic, factored out of :func:`available_mesh` so shrink/grow
    semantics are testable without multi-device hardware.
    """
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if num_axes not in (1, 2):
        raise ValueError(f"num_axes must be 1 or 2, got {num_axes}")
    n = 1
    while n * 2 <= num_devices:
        n *= 2
    if num_axes == 1:
        return (n,)
    m = 1  # largest power of 2 with m*m <= n
    while (m * 2) * (m * 2) <= n:
        m *= 2
    return (n // m, m)


def available_mesh(axis_names=("bank",), *, devices=None) -> BankMesh:
    """Largest power-of-2 :class:`BankMesh` over the surviving devices.

    With ``devices=None`` those are the distinct CUDA devices present
    (``RuntimeError`` when there is none: the port does not carry on on
    the CPU). A ``devices=`` list is taken as given, in order, a device
    named twice counting as two shards, as a ``BankMesh`` names them
    (the counterpart of the reference's forced host device count); each
    must be present. Only the 1-D ``("bank",)`` mesh exists in the port.
    """
    if tuple(axis_names) != BankMesh.axis_names:
        raise ValueError(
            f"the port's meshes have the one axis {BankMesh.axis_names}, got {tuple(axis_names)}"
        )
    if devices is None:
        ops.resolve_device("cuda")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [ops.resolve_device(d) for d in devices]
    if not devs:
        raise RuntimeError("no devices to build a bank mesh on")
    (n,) = mesh_shape(len(devs), 1)
    return BankMesh(tuple(devs[:n]))


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One leaf's shape, dtype and logical axes (``None`` = whole, or
    ``"bank"`` = split over the mesh's shards)."""

    shape: tuple
    dtype: object
    axes: tuple


def state_spec_tree(state, *, axes: dict[int, str] | None = None):
    """:class:`LeafSpec` tree mirroring a *concrete* tree's leaves.

    Each leaf becomes a spec of its own shape and dtype with every axis
    ``None`` (placed whole), except dims listed in ``axes``
    (``{dim_index: name}`` — e.g. ``{0: "bank"}`` for a banked filter
    state). A single-slot state extracted from a draining executor has
    no bank axis left, so the default all-``None`` spec — plain
    re-placement on the new mesh — is exactly right.
    """
    axes = axes or {}

    def spec(leaf):
        t = from_host(leaf)
        return LeafSpec(
            shape=tuple(t.shape), dtype=t.dtype,
            axes=tuple(axes.get(d) for d in range(t.dim())),
        )

    return map_tree(spec, state)


def elastic_reshard(state, spec_tree, new_mesh: BankMesh):
    """Place a tree (tensors or numpy arrays) on ``new_mesh``, bit-exact.

    When no spec names the ``bank`` axis the tree lands whole on the
    mesh's first device. Otherwise the result is a list with one tree per
    shard, as the port lays out a bank-sharded state: a ``bank``-axis
    leaf is split evenly along that axis, its ``i``-th slice on shard
    ``i``'s device, and every other leaf is placed whole on each shard.
    A leaf moves device to device (never through the host unless the
    mesh names the CPU); one already on its target is passed through.
    """
    banked = any("bank" in s.axes for s in flat_leaves(spec_tree))
    devices = new_mesh.devices if banked else new_mesh.devices[:1]
    n = len(devices)

    def place(i, dev):
        def one(leaf, spec):
            t = from_host(leaf)
            if "bank" in spec.axes:
                ax = spec.axes.index("bank")
                if t.shape[ax] % n:
                    raise ValueError(
                        f"{t.shape[ax]} banks do not split evenly over {n} mesh devices"
                    )
                per = t.shape[ax] // n
                t = t.narrow(ax, i * per, per)
            return t.to(dev)

        return map_tree(one, state, spec_tree)

    shards = [place(i, d) for i, d in enumerate(devices)]
    return shards if banked else shards[0]
