"""The part of the reference's tile budget model whose choice shows in the
numbers (counterpart of ``repro.tune.budget``, copied, not imported).

The CUDA kernels pick their own launch geometry, so tiles mean nothing to
their speed. They mean something to one result: the EMA kernel merges its
per-pixel mean and M2 ``pair_tile`` pairs at a time, so a different
``pair_tile`` rounds differently. The reference pins the EMA heuristic to
its legacy pick; :func:`resolve_tiles` reproduces that pick (and the
reference's validation of explicit tiles) so that both packages chunk a
stream alike.
"""

from __future__ import annotations

__all__ = [
    "VMEM_BUDGET",
    "largest_divisor_leq",
    "legacy_pick_row_tile",
    "legacy_pick_pair_tile",
    "resolve_tiles",
]

#: the reference's block budget (bytes); the legacy pickers are sized by it
VMEM_BUDGET = 2**21


def largest_divisor_leq(n: int, cap: int) -> int:
    """Largest exact divisor of ``n`` that is <= ``cap`` (>= 1)."""
    cap = max(1, min(n, cap))
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            for cand in (d, n // d):
                if cand <= cap:
                    best = max(best, cand)
        d += 1
    return best


def legacy_pick_row_tile(
    h: int, w: int, *, dtype_bytes: int = 4, vmem_budget: int = VMEM_BUDGET
) -> int:
    """Rows per tile under the reference's 2-input + 1-accumulator model."""
    rows = max(1, vmem_budget // max(1, 3 * w * dtype_bytes))
    if rows >= h:
        return h
    return largest_divisor_leq(h, rows)


def legacy_pick_pair_tile(
    p: int, row_tile: int, w: int, *, dtype_bytes: int = 4,
    vmem_budget: int = VMEM_BUDGET,
) -> int:
    """Frame pairs per block under the reference's 3-tile model."""
    per_pair = 3 * row_tile * w * dtype_bytes
    budget = max(1, vmem_budget // max(1, per_pair))
    return largest_divisor_leq(p, budget)


def resolve_tiles(
    family: str, p: int, h: int, w: int,
    row_tile: int | None = None, pair_tile: int | None = None,
) -> tuple[int, int]:
    """``(row_tile, pair_tile)`` of the ``"ema"`` family for a (p, h, w)
    problem: explicit tiles win but must divide exactly (the reference's
    ``ValueError``); the default is the reference's pinned legacy pick."""
    if family != "ema":
        raise ValueError(f"only the 'ema' family's tiles change results, got {family!r}")
    th = row_tile or legacy_pick_row_tile(h, w)
    tp = pair_tile or legacy_pick_pair_tile(p, th, w)
    if h % th:
        raise ValueError(f"row_tile {th} must divide H={h}")
    if p % tp:
        raise ValueError(f"pair_tile {tp} must divide N/2={p}")
    return th, tp
