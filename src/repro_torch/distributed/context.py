"""Activation-sharding context (counterpart of
``repro.distributed.context``).

The reference pins activations to mesh axes at block boundaries while it
traces a step. On one card there is nothing to pin: :func:`constrain` is
the identity, and :func:`activation_sharding` records the mesh and rules
for the duration of a ``with`` block (:func:`active`), so model code reads
as the reference's and a later multi-card slice (ROADMAP.md queue A item
13(d)) has one place to act.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["activation_sharding", "active", "constrain"]

_TLS = threading.local()


@contextlib.contextmanager
def activation_sharding(mesh, rules):
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (mesh, rules)
    try:
        yield
    finally:
        _TLS.ctx = prev


def active():
    """The ``(mesh, rules)`` of the innermost :func:`activation_sharding`,
    or ``None``."""
    return getattr(_TLS, "ctx", None)


def constrain(x, axes: tuple[str | None, ...]):
    """``x`` itself; inside :func:`activation_sharding` the axes must name
    every dimension, as the reference requires."""
    if active() is not None and len(axes) != x.ndim:
        raise ValueError(f"axes {axes} vs shape {tuple(x.shape)}")
    return x
