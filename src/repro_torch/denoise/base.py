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
* **Tile plans** are resolved once, at construction, and passed to
  ``ops`` as static kwargs (the CUDA kernels ignore them).

``phase_invariant`` declares that ``step`` ignores ``step_index`` (the
session scheduler may co-batch slots at different group indices). The
reference's slot surgery (``slot_insert``/``extract``/``gather``/
``scatter``) and ``state_pspec`` serve the session service and the
shard_map executor; they come with those slices (ROADMAP.md queue A
items 7 and 10).
"""

from __future__ import annotations

from typing import Any, ClassVar

from repro_torch import tune
from repro_torch.kernels import ops

__all__ = ["StreamingFilter"]


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
        # plan resolution is config time, not step time
        self.plan = tune.resolve_plan(config)

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
