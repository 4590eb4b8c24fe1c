"""Carry a stream between the reference and the port.

This system has no weights: what defines a stream is its config, and
what a stream carries from one group to the next is its filter state (a
running sum, a median window, or the EMA dict of ``ema``/``wmean``/
``wm2``). So the counterpart of converting a checkpoint is:

* :func:`config_from_reference` — a ``dataclasses.asdict`` of the
  reference's ``DenoiseConfig`` -> the port's (the fields are the same);
* :func:`state_from_reference` — a host copy (``np.asarray``, leaf by
  leaf for a dict) of the reference's state -> tensors on ``device``
  (CUDA by default);
* :func:`state_to_reference` — a port state -> numpy arrays the
  reference takes as its state (``jnp.asarray``, leaf by leaf).

Because both packages round every step alike, a stream started in one
package and finished in the other is bit-identical to a stream run in
either alone.

The model substrate has weights, drawn by ``jax.random`` in the reference
and by a ``torch.Generator`` here (different numbers from one seed). To
run both on the same model, :func:`params_from_reference` carries the
reference's parameter tree (host copies, ``np.asarray`` of each leaf:
nested dicts and lists in JAX's leaf order, 0-d leaves such as the vlm's
gates included) into the port's tree of the same structure, and
:func:`caches_from_reference` its decode caches, of every family:

* decoder-only: a list of segments, each a list of per-position caches
  stacked over the repeats: attention ``{k, v, pos}``, MLA
  ``{c_kv, k_pe, pos}``, SSD ``{ssm, conv}`` and RG-LRU ``{lru, conv}``
  states;
* vlm: a list of the self-attention positions' stacked ``{k, v, pos}``;
* audio: ``{"self": {k, v, pos}, "cross": {k, v}}``, each stacked over
  the decoder layers.

float32, bfloat16 (``ml_dtypes``) and int32 leaves carry exactly.

Training state carries likewise: :func:`opt_state_from_reference` takes
the reference's AdamW state ``{"mu", "nu", "step"}`` (float32 moments in
the parameters' structure, ``step`` an int32 0-d array) into the port's.
A whole training state also crosses as a checkpoint
(``repro_torch.checkpoint``), in either direction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import map_tree
from repro_torch.core.denoise import DenoiseConfig
from repro_torch.distributed.sharding import place
from repro_torch.kernels.ops import resolve_device

__all__ = ["config_from_reference", "state_from_reference", "state_to_reference",
           "params_from_reference", "caches_from_reference", "opt_state_from_reference"]


def config_from_reference(fields: dict) -> DenoiseConfig:
    """The port's config from the reference's ``dataclasses.asdict``."""
    known = {f.name for f in dataclasses.fields(DenoiseConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"fields the port's DenoiseConfig lacks: {unknown}")
    return DenoiseConfig(**fields)


def state_from_reference(state, device=None):
    """A filter state from the reference (host copies: an array, or a dict
    of arrays) as tensors on ``device`` (CUDA unless the caller names
    another; ``RuntimeError`` when CUDA is absent)."""
    dev = resolve_device(device)
    if isinstance(state, dict):
        return {k: state_from_reference(v, dev) for k, v in state.items()}
    return torch.from_numpy(np.array(state, copy=True)).to(dev)


def state_to_reference(state):
    """A port filter state as the numpy array (or dict of arrays) the
    reference continues from."""
    if isinstance(state, dict):
        return {k: state_to_reference(v) for k, v in state.items()}
    return state.detach().cpu().numpy().copy()


def _leaf_from_reference(a, dev) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_reference(tree, device=None, shardings=None):
    """The reference's parameter tree (numpy leaves) as the port's, leaf for
    leaf, on ``device`` (CUDA unless the caller names another;
    ``RuntimeError`` when CUDA is absent). ``shardings`` (a matching tree of
    ``distributed.sharding.NamedSharding``, as ``named_shardings`` gives)
    places each leaf over its mesh: every rank passes the same tree."""
    dev = resolve_device(device)
    out = map_tree(lambda a: _leaf_from_reference(a, dev), tree)
    return out if shardings is None else place(out, shardings)


def caches_from_reference(tree, device=None, shardings=None):
    """The reference's decode caches of any family (see the module
    docstring; numpy leaves) as the port's, on ``device``, placed by
    ``shardings`` when given."""
    return params_from_reference(tree, device, shardings)


def opt_state_from_reference(state, device=None, shardings=None):
    """The reference's AdamW state (numpy leaves: ``mu`` and ``nu`` float32
    trees, ``step`` an int32 0-d array) as the port's, on ``device``,
    placed by ``shardings`` (``launch.steps.train_state_shardings``' second
    tree) when given."""
    if set(state) != {"mu", "nu", "step"}:
        raise ValueError(f"an AdamW state has keys mu, nu, step; got {sorted(state)}")
    step = np.asarray(state["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"step must be an int32 0-d array; got {step.dtype} {step.shape}")
    return params_from_reference(state, device, shardings)

