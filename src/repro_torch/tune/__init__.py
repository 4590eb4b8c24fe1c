"""Tuning layer (counterpart of ``repro.tune``), heuristic mode only.

``DenoiseConfig.tile_plan="heuristic"`` resolves to
:data:`~repro_torch.tune.plan.HEURISTIC_PLAN`, whose tiles are ``None``:
the CUDA kernels choose their own launch geometry. The one exception is
the ``"ema"`` family, whose ``pair_tile`` changes its rounding: there
:func:`tile_args` returns the reference's pinned pick
(:mod:`repro_torch.tune.budget`). ``"auto"`` (the measured tuner with its
plan cache) and plan-file paths raise ``NotImplementedError``: ROADMAP.md
queue A item 9 (a Hopper launch geometry model, CUDA-event autotuning, a
cache keyed on device and torch versions).
"""

from __future__ import annotations

from repro_torch.tune import budget
from repro_torch.tune.plan import HEURISTIC_PLAN, Plan, TileGeom

__all__ = ["budget", "Plan", "TileGeom", "HEURISTIC_PLAN", "resolve_plan", "tile_args"]


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
    ``pair_tile`` overrides beat the plan. The CUDA kernels ignore both,
    except the EMA kernel's ``pair_tile``, which the heuristic plan pins
    to the reference's pick for the config's shape."""
    row = getattr(config, "row_tile", None)
    pair = getattr(config, "pair_tile", None)
    if row is not None or pair is not None:
        return {"row_tile": row, "pair_tile": pair, "placement": None}
    args = (plan or resolve_plan(config)).tile_args(family)
    if family == "ema" and args["row_tile"] is None and args["pair_tile"] is None:
        th, tp = budget.resolve_tiles(
            "ema", config.frames_per_group // 2, config.height, config.width
        )
        args = {**args, "row_tile": th, "pair_tile": tp}
    return args
