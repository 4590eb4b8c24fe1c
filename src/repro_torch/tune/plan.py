"""Plan objects: the static tuning decisions a config resolves to
(counterpart of ``repro.tune.plan``).

A :class:`Plan` bundles per-kernel-family launch geometry
(:class:`TileGeom`) with executor knobs (ring depth, advisory staging
chunk length). Plans are immutable and resolved once, at config time
(``repro_torch.tune.resolve_plan``); the filters hand their tiles to the
kernels' launchers as plain ints, so a plan never changes mid-stream.

Cache keys over-specify, as the reference's do: a plan measured for one
(kernel family, problem shape, dtypes, backend, card, torch build) is
only replayed for exactly that tuple. The card is the device's own name
(``torch.cuda.get_device_name``, or ``cpu``) and the build is
``torch.__version__``, so a plan tuned on one card or one torch build
never replays on another, and the port's keys never meet the
reference's (``.../jax<version>``) in a shared cache file.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "TileGeom",
    "Plan",
    "HEURISTIC_PLAN",
    "SCHEMA_VERSION",
    "family_key",
    "exec_key",
]

#: bump when the on-disk entry layout changes; readers treat any other
#: version as stale (fall back to heuristic / re-tune, never crash). The
#: reference's value: both packages read one file format.
SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TileGeom:
    """Launch geometry + memory placement for one kernel family.

    ``None`` row/pair tiles keep the kernel's default layout. The port has
    one placement, the compiler's (``"compiler"``): the field is kept so
    that a plan reads like the reference's.
    """

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
    """Resolved tuning decisions for one config.

    ``tiles`` maps kernel family -> :class:`TileGeom`; families absent
    from the map keep the kernels' defaults. ``num_slots`` /
    ``frames_per_chunk`` are the executor knobs (None = config default).
    ``source`` records provenance: ``heuristic``, ``tuned``, ``cache``,
    or the plan-file path.
    """

    mode: str = "heuristic"            # heuristic | auto | <path>
    tiles: tuple = ()                  # ((family, TileGeom), ...) — hashable
    num_slots: int | None = None
    frames_per_chunk: int | None = None
    source: str = "heuristic"

    def tile_args(self, family: str) -> dict:
        """ops-call kwargs for ``family`` (row_tile/pair_tile/placement)."""
        for fam, geom in self.tiles:
            if fam == family:
                return geom.as_args()
        return {"row_tile": None, "pair_tile": None, "placement": None}

    def describe(self) -> str:
        parts = [f"mode={self.mode}", f"source={self.source}"]
        for fam, geom in self.tiles:
            desc = f"{fam}=({geom.row_tile},{geom.pair_tile})"
            if geom.placement is not None:
                desc += f"@{geom.placement}"
            parts.append(desc)
        if self.num_slots is not None:
            parts.append(f"num_slots={self.num_slots}")
        if self.frames_per_chunk is not None:
            parts.append(f"frames_per_chunk={self.frames_per_chunk}")
        return ";".join(parts)


HEURISTIC_PLAN = Plan()


def device_kind(device) -> str:
    """The card a plan is for: the CUDA device's name, or ``cpu``."""
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return name.replace(" ", "_")


def family_key(
    family: str,
    p: int,
    h: int,
    w: int,
    *,
    in_dtype: str,
    acc_dtype: str,
    backend: str,
    device,
    window: int = 1,
) -> str:
    """Persistent-cache key for one kernel family's geometry on ``device``."""
    return (
        f"v{SCHEMA_VERSION}/{family}/p{p}h{h}w{w}k{window}/"
        f"{in_dtype}->{acc_dtype}/{backend}/{device_kind(device)}/"
        f"torch{torch.__version__}"
    )


def exec_key(
    filter_name: str,
    g: int,
    n: int,
    h: int,
    w: int,
    *,
    backend: str,
    device,
) -> str:
    """Persistent-cache key for the executor knobs of one stream shape."""
    return (
        f"v{SCHEMA_VERSION}/exec/{filter_name}/g{g}n{n}h{h}w{w}/"
        f"{backend}/{device_kind(device)}/torch{torch.__version__}"
    )
