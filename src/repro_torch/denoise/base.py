"""The streaming-filter state contract (counterpart of ``repro.denoise.base``).

A filter is instantiated with a ``DenoiseConfig``-shaped object (duck
typed — this package never imports ``repro_torch.core``) and the device
its state lives on, and exposes an ``init / step / finalize`` cycle over
per-group chunks::

    state = f.init()                       # or init(banks=B) for banked
    for k, group in enumerate(groups):     # group: (N, H, wire_W) tensor
        state = f.step(state, group, step_index=k)
    out = f.finalize(state, steps=G)       # (N/2, H, W)

Contract rules the executors rely on:

* **State is opaque.** Executors thread it through without inspecting
  it. ``step`` updates the state tensors **in place** where the
  reference donates them, and returns the state.
* **Banked states.** ``init(banks=B)`` returns a state whose tensors
  carry a leading bank axis; ``step`` then takes (B, N, H, W) chunks.
* **Determinism.** ``step`` is a function of (state, chunk, step_index):
  the same chunks give bit-identical output under every executor.
* **Partial estimates.** ``partial(state, step_index=k)`` returns a
  *fresh* tensor with the estimate after groups ``0..k``, never the state
  the next step overwrites; at the final step it equals ``finalize`` bit
  for bit. ``finalize(steps=s)`` with ``s < G`` averages only the ``s``
  surviving groups (the ``drop_oldest`` executor path).
* **Backend dispatch.** All device math goes through
  ``repro_torch.kernels.ops``; filters never import kernel modules.
* **Tile plans** are resolved once, at construction, for the filter's
  device, and passed to ``ops`` as plain kwargs: the kernels' launch
  geometry, which never changes a bit of the output (the EMA kernel's
  ``pair_tile`` aside, which the reference pins too).

* **Bank layout.** ``state_pspec`` names each banked tensor's bank axis
  with a tuple spec such as ``("bank", None, None, None)``, in the
  state's own structure (a tensor, or a dict of tensors): the
  counterpart of the reference's ``PartitionSpec`` tree.
  :mod:`repro_torch.core.banks` splits banked states along it.
* **Slot surgery.** A banked state is a slot array: the session service
  hosts one independent stream per bank slot and joins or leaves streams
  mid-run. ``slot_extract`` / ``slot_gather`` copy single slots out,
  ``slot_insert`` / ``slot_scatter`` write them back, locating each
  tensor's bank axis through ``state_pspec``, and none changes the banked
  state's shapes. ``slot_to_host`` / ``slot_from_host`` move one slot's
  state to numpy and back bit-exactly (checkpoint and migration).

``phase_invariant`` declares that ``step`` ignores ``step_index`` (the
session scheduler may co-batch slots at different group indices).
"""

from __future__ import annotations

from typing import Any, Callable, ClassVar, Iterable

import numpy as np
import torch

from repro_torch import tune
from repro_torch.kernels import ops

__all__ = ["StreamingFilter", "tree_leaves", "tree_map"]


def tree_leaves(state) -> tuple[list, Callable[[list], Any]]:
    """A state's tensors, and a function that rebuilds the same structure
    from new leaves: a state is a tensor or a dict of them. A dict's
    leaves come in sorted key order, as JAX flattens them, so two states
    with the same keys pair leaf for leaf whatever their insertion order."""
    if isinstance(state, dict):
        keys = sorted(state)
        return [state[k] for k in keys], lambda leaves: dict(zip(keys, leaves))
    return [state], lambda leaves: leaves[0]


def _index(indices: Iterable[int], device) -> torch.Tensor:
    return torch.as_tensor(list(indices), dtype=torch.long, device=device)


def tree_map(fn: Callable, state, *rest):
    """``fn`` over the leaves of ``state`` (and of ``rest``, leaf by leaf),
    in the state's structure."""
    leaves, rebuild = tree_leaves(state)
    others = [tree_leaves(r)[0] for r in rest]
    return rebuild([fn(*args) for args in zip(leaves, *others)])


class StreamingFilter:
    """Base class; see the module docstring for the contract."""

    #: registry key, set by ``@register_filter``
    name: ClassVar[str] = ""

    #: True when ``step`` is independent of ``step_index``; filters whose
    #: update depends on it (window slot rotation, prior sample counts)
    #: keep False, as in the reference
    phase_invariant: ClassVar[bool] = False

    def __init__(self, config: Any, *, device=None):
        self.config = config
        #: where ``init`` allocates state: CUDA unless the caller names another
        self.device = ops.resolve_device(device)
        # plan resolution is config time, not step time; "auto" times on
        # the device this filter runs on
        self.plan = tune.resolve_plan(config, self.device)

    def tile_args(self, family: str) -> dict:
        """Static ``row_tile``/``pair_tile``/``placement`` kwargs for one
        kernel family (explicit config overrides win, then the plan)."""
        return tune.tile_args(self.config, family, plan=self.plan)

    @classmethod
    def validate(cls, config: Any) -> None:
        """Raise ``ValueError`` for config combinations the filter cannot
        honour (called from ``DenoiseConfig.__post_init__``)."""

    # -- state lifecycle ----------------------------------------------------
    def init(self, *, banks: int | None = None):
        raise NotImplementedError

    def step(self, state, group_frames, *, step_index: int):
        raise NotImplementedError

    def finalize(self, state, *, steps: int | None = None):
        raise NotImplementedError

    def partial(self, state, *, step_index: int):
        """Estimate after groups ``0..step_index``; never consumes state."""
        return self.finalize(state, steps=step_index + 1)

    # -- banked support -----------------------------------------------------
    def is_banked(self, state) -> bool:
        """Whether ``state`` came from ``init(banks=...)``."""
        raise NotImplementedError

    def state_pspec(self, state):
        """Per-tensor bank-axis spec of a *banked* state, as tuples.

        Default: every tensor carries the bank axis first. Filters with
        another layout (``temporal_median``'s window keeps its slot axis
        first) override this.
        """
        return tree_map(lambda t: ("bank",) + (None,) * (t.ndim - 1), state)

    # -- slot surgery (session hosting) -------------------------------------
    # Each hook locates a tensor's bank axis from ``state_pspec``, so every
    # filter gets join/leave support from its declared layout.

    def _flat_with_bank_axes(self, state):
        """A banked state's tensors, its rebuild function, and each
        tensor's bank-axis index."""
        leaves, rebuild = tree_leaves(state)
        specs = tree_leaves(self.state_pspec(state))[0]
        return leaves, rebuild, [spec.index("bank") for spec in specs]

    def slot_extract(self, state, index: int):
        """Bank slot ``index`` as a single-bank state.

        A contiguous copy that shares no storage with the banked state:
        stepping it in place leaves the banked state, and so every other
        slot, untouched. It steps and finalizes as an ``init()`` state.
        """
        leaves, rebuild, axes = self._flat_with_bank_axes(state)
        return rebuild([
            t.select(ax, index).clone(memory_format=torch.contiguous_format)
            for t, ax in zip(leaves, axes)
        ])

    def slot_insert(self, state, slot_state, index: int):
        """Write a single-bank ``slot_state`` into bank slot ``index``.

        Unlike the reference's functional ``.at[].set``, this writes **in
        place** and returns the banked state: the reference's session
        scheduler inserts through a donating variant, whose old buffer is
        dead after the call, so updating it in place is the same for that
        caller without a copy of every slot. Shapes never change. The
        mid-stream join hook: inserting a fresh ``init()`` state starts a
        new stream in that slot.
        """
        leaves, _, axes = self._flat_with_bank_axes(state)
        for t, s, ax in zip(leaves, tree_leaves(slot_state)[0], axes):
            t.select(ax, index).copy_(s)
        return state

    def slot_gather(self, state, indices: Iterable[int]):
        """Banked sub-state of slots ``indices`` (in that order): a copy
        that shares no storage with ``state``."""
        leaves, rebuild, axes = self._flat_with_bank_axes(state)
        return rebuild([
            t.index_select(ax, _index(indices, t.device))
            for t, ax in zip(leaves, axes)
        ])

    def slot_scatter(self, state, sub_state, indices: Iterable[int]):
        """Write a ``slot_gather``-shaped sub-state back into ``indices``,
        in place (as :meth:`slot_insert`); returns the banked state."""
        leaves, _, axes = self._flat_with_bank_axes(state)
        for t, s, ax in zip(leaves, tree_leaves(sub_state)[0], axes):
            t.index_copy_(ax, _index(indices, t.device), s.to(t.device))
        return state

    def slot_to_host(self, slot_state):
        """Numpy copies of a single-bank state's tensors, dtype kept: the
        checkpoint and migration format."""
        return tree_map(lambda t: t.detach().cpu().numpy().copy(), slot_state)

    def slot_from_host(self, slot_state, device=None):
        """Revive a :meth:`slot_to_host` snapshot as tensors on ``device``
        (the filter's own device unless the caller names another)."""
        dev = self.device if device is None else ops.resolve_device(device)
        return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), slot_state)
