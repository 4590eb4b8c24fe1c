"""Carry a stream between the reference and the port.

This system has no weights: what defines a stream is its config, and
what a stream carries from one group to the next is its running sum. So
the counterpart of converting a checkpoint is:

* :func:`config_from_reference` — a ``dataclasses.asdict`` of the
  reference's ``DenoiseConfig`` -> the port's (the fields are the same);
* :func:`state_from_reference` — a host copy (``np.asarray``) of the
  reference's running sum -> a tensor on ``device`` (CUDA by default);
* :func:`state_to_reference` — a port running sum -> a numpy array the
  reference takes as its state (``jnp.asarray``).

Because both packages round every step alike, a stream started in one
package and finished in the other is bit-identical to a stream run in
either alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.denoise import DenoiseConfig
from repro_torch.kernels.ops import resolve_device

__all__ = ["config_from_reference", "state_from_reference", "state_to_reference"]


def config_from_reference(fields: dict) -> DenoiseConfig:
    """The port's config from the reference's ``dataclasses.asdict``."""
    known = {f.name for f in dataclasses.fields(DenoiseConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"fields the port's DenoiseConfig lacks: {unknown}")
    return DenoiseConfig(**fields)


def state_from_reference(state: np.ndarray, device=None) -> torch.Tensor:
    """A running sum from the reference (host copy) as a tensor on ``device``
    (CUDA unless the caller names another; ``RuntimeError`` when CUDA is
    absent)."""
    return torch.from_numpy(np.array(state, copy=True)).to(resolve_device(device))


def state_to_reference(state: torch.Tensor) -> np.ndarray:
    """A port running sum as the numpy array the reference continues from."""
    return state.detach().cpu().numpy().copy()
