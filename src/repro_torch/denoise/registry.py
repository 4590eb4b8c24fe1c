"""Filter registry: ``@register_filter`` / ``get_filter`` / ``FILTERS``.

Deliberately dependency-free (no torch, no kernels): the registry is pure
bookkeeping so that ``repro_torch.core.denoise`` can validate
``DenoiseConfig.filter_name`` without importing any filter machinery, and
so user code can register new filters without touching this package.
"""

from __future__ import annotations

from typing import Callable, Type, TypeVar

__all__ = ["FILTERS", "register_filter", "get_filter"]

#: name -> StreamingFilter subclass. Populated by ``@register_filter`` at
#: import of ``repro_torch.denoise``; read-only for everyone else.
FILTERS: dict[str, type] = {}

_T = TypeVar("_T", bound=type)


def register_filter(name: str) -> Callable[[_T], _T]:
    """Class decorator: add a ``StreamingFilter`` subclass to ``FILTERS``.

    Names are unique — re-registering an existing name raises (shadowing a
    filter silently would change executor numerics at a distance).
    """

    def _register(cls: _T) -> _T:
        if name in FILTERS:
            raise ValueError(
                f"filter {name!r} already registered by "
                f"{FILTERS[name].__module__}.{FILTERS[name].__qualname__}"
            )
        cls.name = name
        FILTERS[name] = cls
        return cls

    return _register


def get_filter(name: str) -> Type:
    """Look up a registered filter class by name.

    Raises ``ValueError`` listing the valid names — the same contract as
    ``ops.ALGORITHMS`` / ``ops.BACKENDS`` dispatch errors.
    """
    try:
        return FILTERS[name]
    except KeyError:
        raise ValueError(
            f"filter_name must be one of {tuple(sorted(FILTERS))}, got {name!r}"
        ) from None
