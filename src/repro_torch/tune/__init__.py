"""Tuning layer (counterpart of ``repro.tune``), heuristic mode only.

``DenoiseConfig.tile_plan="heuristic"`` resolves to
:data:`~repro_torch.tune.plan.HEURISTIC_PLAN`, whose tiles are ``None``:
the CUDA kernels choose their own launch geometry. ``"auto"`` (the
measured tuner with its plan cache) and plan-file paths raise
``NotImplementedError``: ROADMAP.md queue A item 9 (a Hopper launch
geometry model, CUDA-event autotuning, a cache keyed on device and torch
versions).
"""

from __future__ import annotations

from repro_torch.tune.plan import HEURISTIC_PLAN, Plan, TileGeom

__all__ = ["Plan", "TileGeom", "HEURISTIC_PLAN", "resolve_plan", "tile_args"]


def resolve_plan(config) -> Plan:
    """Resolve ``config.tile_plan``; only ``"heuristic"`` is ported."""
    mode = getattr(config, "tile_plan", "heuristic")
    if mode in (None, "heuristic"):
        return HEURISTIC_PLAN
    raise NotImplementedError(
        f"tile_plan={mode!r}: measured tuning and plan files are not ported "
        "yet (ROADMAP.md queue A item 9); use tile_plan='heuristic'"
    )


def tile_args(config, family: str, plan: Plan | None = None) -> dict:
    """ops-call tile kwargs for ``family``: explicit ``config.row_tile`` /
    ``pair_tile`` overrides beat the plan (the CUDA kernels ignore both)."""
    row = getattr(config, "row_tile", None)
    pair = getattr(config, "pair_tile", None)
    if row is not None or pair is not None:
        return {"row_tile": row, "pair_tile": pair, "placement": None}
    return (plan or resolve_plan(config)).tile_args(family)
