"""Activation-sharding context (counterpart of
``repro.distributed.context``).

The reference pins activations to mesh axes at block boundaries while it
traces a step (``with_sharding_constraint``). Here
:func:`activation_sharding` records the mesh and rules for the duration
of a ``with`` block (:func:`active`), and :func:`constrain` redistributes
a DTensor activation to the placements its logical axes give on that
mesh, so model code reads as the reference's. Outside the context, on a
one-device mesh, and for a plain tensor it is the identity.
"""

from __future__ import annotations

import contextlib
import threading

from repro_torch.distributed.sharding import placements, partition_spec

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
    """``x`` at the placements of its logical ``axes`` (inside
    :func:`activation_sharding`, which requires the axes to name every
    dimension, as the reference does), else ``x`` itself."""
    ctx = active()
    if ctx is None:
        return x
    mesh, rules = ctx
    if len(axes) != x.ndim:
        raise ValueError(f"axes {axes} vs shape {tuple(x.shape)}")
    if not hasattr(x, "redistribute") or mesh.size == 1:
        return x
    spec = partition_spec(tuple(x.shape), axes, mesh.axis_sizes, rules)
    return x.redistribute(mesh.device_mesh, placements(spec, mesh.axis_names))
