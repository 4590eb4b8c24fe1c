"""Plan objects: the static tuning decisions a config resolves to
(the part of ``repro.tune.plan`` this slice needs).

Only the heuristic plan exists in the port so far: the CUDA kernels pick
their own launch geometry, and measured tuning with its plan cache is
ROADMAP.md queue A item 9.
"""

from __future__ import annotations

import dataclasses

__all__ = ["TileGeom", "Plan", "HEURISTIC_PLAN"]


@dataclasses.dataclass(frozen=True)
class TileGeom:
    """Block geometry + placement for one kernel family (``None`` = the
    kernel's own choice)."""

    row_tile: int | None = None
    pair_tile: int | None = None
    placement: str | None = None

    def as_args(self) -> dict:
        return {
            "row_tile": self.row_tile,
            "pair_tile": self.pair_tile,
            "placement": self.placement,
        }


@dataclasses.dataclass(frozen=True)
class Plan:
    """Resolved tuning decisions for one config (see ``repro.tune.plan``;
    its executor knobs come with measured tuning)."""

    mode: str = "heuristic"
    tiles: tuple = ()                  # ((family, TileGeom), ...) — hashable

    def tile_args(self, family: str) -> dict:
        """ops-call kwargs for ``family`` (row_tile/pair_tile/placement)."""
        for fam, geom in self.tiles:
            if fam == family:
                return geom.as_args()
        return {"row_tile": None, "pair_tile": None, "placement": None}


HEURISTIC_PLAN = Plan()
