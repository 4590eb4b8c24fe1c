"""Tuning layer: the Hopper launch model, the measured autotuner and the
persistent plan cache (counterpart of ``repro.tune``).

``DenoiseConfig.tile_plan`` selects the mode and this package resolves it
once per config and device (in-process memoized) into an immutable
:class:`~repro_torch.tune.plan.Plan` of launch geometry and executor
knobs:

* ``"heuristic"`` (default) — no plan: every kernel keeps its default
  layout, and the ``"ema"`` family the reference's pinned ``pair_tile``
  (:func:`tile_args`, :mod:`repro_torch.tune.budget`).
* ``"auto"`` — tune-or-cache-hit: consult the persistent JSON plan cache
  (:mod:`repro_torch.tune.cache`); on a miss, time the launch model's
  candidates on the device (:mod:`repro_torch.tune.autotune`) and persist
  the winner. A cache hit performs no measurement.
* any other string — a path to a pre-built plan file (the cache format);
  replayed without measuring, falling back to the heuristic when the
  file is stale or malformed. A missing file raises ``ValueError``.

Resolution happens where configs become executors (filter construction,
``repro_torch.denoise.base``, with the filter's device), never inside a
step. A geometry never changes a bit of a filter's output; the one
exception is the EMA kernel's ``pair_tile``, which sets its merge chunks
as the reference's does, and which ``"auto"`` never moves.
"""

from __future__ import annotations

import os

import torch

from repro_torch.tune import budget
from repro_torch.tune.cache import PlanCache, default_cache_path
from repro_torch.tune.plan import HEURISTIC_PLAN, Plan, TileGeom, device_kind

__all__ = [
    "budget",
    "Plan",
    "TileGeom",
    "PlanCache",
    "HEURISTIC_PLAN",
    "default_cache_path",
    "resolve_plan",
    "tile_args",
    "clear_plan_memo",
]


def _plan_request(config, device: torch.device) -> tuple:
    """Hashable identity of everything a plan resolution depends on: the
    reference's request key (duck-typed config fields, the cache path)
    and the card it resolves for."""
    get = lambda k, d: getattr(config, k, d)  # noqa: E731
    return (
        str(get("tile_plan", "heuristic")),
        str(default_cache_path()),
        str(get("filter_name", "pair_average")),
        str(get("backend", "auto")),
        int(get("frames_per_group", 0) or 0),
        int(get("height", 0) or 0),
        int(get("width", 0) or 0),
        int(get("num_groups", 0) or 0),
        str(get("accum_dtype", "float32")),
        str(get("stream_dtype", "u16")),
        int(get("median_window", 1) or 1),
        str(get("spatial_mode", "bilateral")),
        str(device),
        device_kind(device),
    )


_MEMO: dict[tuple, Plan] = {}


def clear_plan_memo() -> None:
    """Drop the in-process plan memo (tests; never needed in production)."""
    _MEMO.clear()


def resolve_plan(config, device=None) -> Plan:
    """Resolve ``config.tile_plan`` to a :class:`Plan` for ``device``
    (CUDA unless the caller names another: ``"auto"`` times there, and
    raises ``RuntimeError`` when CUDA is absent), memoized per config and
    device."""
    mode = getattr(config, "tile_plan", "heuristic")
    if mode in (None, "heuristic"):
        return HEURISTIC_PLAN
    from repro_torch.kernels.ops import resolve_device

    dev = resolve_device(device)
    req = _plan_request(config, dev)
    plan = _MEMO.get(req)
    if plan is None:
        from repro_torch.tune import autotune  # lazy: keeps kernel imports light

        if mode == "auto":
            plan = autotune.tune_plan(config, dev)
        else:
            plan = autotune.plan_from_file(config, os.fspath(mode), dev)
        _MEMO[req] = plan
    return plan


def tile_args(config, family: str, plan: Plan | None = None, device=None) -> dict:
    """ops-call tile kwargs for ``family`` under ``config``'s plan.

    Explicit ``config.row_tile`` / ``pair_tile`` overrides beat the plan;
    then the plan's geometry for ``family`` (``plan``, or the plan
    resolved for ``device``); where neither names tiles, ``None``s (the
    kernels' default layouts), except the ``"ema"`` family's, which is the
    reference's pinned pick for the config's shape, its merge chunks.
    """
    row = getattr(config, "row_tile", None)
    pair = getattr(config, "pair_tile", None)
    if row is not None or pair is not None:
        return {"row_tile": row, "pair_tile": pair, "placement": None}
    args = (plan or resolve_plan(config, device)).tile_args(family)
    if family == "ema" and args["row_tile"] is None and args["pair_tile"] is None:
        th, tp = budget.resolve_tiles(
            "ema", config.frames_per_group // 2, config.height, config.width
        )
        args = {**args, "row_tile": th, "pair_tile": tp}
    return args
