"""Launch geometry for Hopper: tile validation, the reference's pinned EMA
pick and a launch model that generates the measured search's candidates
(counterpart of ``repro.tune.budget``, copied, not imported).

The reference sizes ``row_tile`` x ``pair_tile`` blocks against a 2 MiB
model of the TPU's scoped VMEM. That budget means nothing on an H100: a
block's working set here is its registers and shared memory, and what a
geometry changes is how many blocks there are and how many an SM holds
at once. So the model here knows, per kernel family, the launch that the
family's timed kernel makes (:data:`REGISTERS`) and the card's limits
(:func:`device_limits`), and it

* rejects a geometry, with the reason, when the launch cannot run: more
  than 1024 threads a block, more shared memory than a block may opt in
  to, more registers than an SM holds for even one block, a grid the
  launcher cannot express, or fewer blocks than one wave of the card
  (an SM with no block idles through the whole kernel)
  (:func:`reject_reason`);
* scores an admitted geometry by its waves: the blocks over what the
  card holds at once (SMs x blocks an SM holds, whichever of threads,
  registers, shared memory or the 32-block cap binds first), and the
  share of the last wave that is full (:func:`score`).

``row_tile`` is the image rows a block covers and ``pair_tile`` its
pairs; ``None`` is the kernel's default layout (:func:`launch_tiles`
passes it to a launcher as 0). The row-gridded kernels honour both
(``stream``: the step's scalar layout, and its vector path as a share of
``row_tile * W`` pixels in whole vectors; ``median_insert`` on its scalar
path, while its vector path has one layout, 512 vectors of a pair a
block, and validates a plan's tiles without taking them). Three
families have one geometry: ``median_combine`` (a flat 256-thread grid),
``spatial`` (its 16 x 128 tile) and ``ema``, whose 32-pixel tiles with 8
chunk lanes are sized for residency (``csrc/denoise_ema.cu``) and whose
``pair_tile`` changes its rounding, so it stays at the reference's pinned
pick (:func:`resolve_tiles`); ``row_tile`` has no effect on its launch.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "VMEM_BUDGET",
    "KERNEL_FAMILIES",
    "PLACEMENT",
    "DeviceLimits",
    "LaunchSpec",
    "REGISTERS",
    "device_limits",
    "family_launch",
    "largest_divisor_leq",
    "launch_blocks",
    "launch_shape",
    "launch_tiles",
    "model_candidates",
    "legacy_pick_row_tile",
    "legacy_pick_pair_tile",
    "reject_reason",
    "admitted_tiles",
    "resolve_tiles",
    "score",
]

#: the reference's block budget (bytes); the legacy pickers, and so the
#: pinned EMA pick, are sized by it
VMEM_BUDGET = 2**21
KERNEL_FAMILIES = ("stream", "median_insert", "median_combine", "ema", "spatial")
#: the one memory placement the port has: the compiler's (registers and
#: the shared memory a kernel declares); a plan records it for every family
PLACEMENT = "compiler"
#: the families whose launchers honour ``row_tile`` / ``pair_tile``
TILED_FAMILIES = ("stream", "median_insert")
#: vectors one pass of a block covers on the step's and the insert's vector
#: paths (256 threads x 2, ``kVecPerBlock`` in ``csrc/denoise_stream.cu``,
#: ``kInsertPerBlock`` in ``csrc/denoise_median.cu``): the step's default
#: share, and the insert's one layout
VECTOR_PASS = 512
#: pixels of one vector on the insert's vector path, per wire format: the
#: one-shot's vector (``denoise_stream.ONESHOT_VECTOR``)
INSERT_VECTOR_PX = {"u16": 8, "u8": 16, "p12": 16}
#: static shared memory of the insert's vector path (bytes): the warps'
#: staging buffers of its float32 instances from u8 and p12 wire, the most
#: of its instances (8 warps x 32 lanes x four 16-byte words)
INSERT_VECTOR_SMEM = 16384


@dataclasses.dataclass(frozen=True)
class DeviceLimits:
    """What bounds a launch on one card. The defaults are the H100 SXM's
    (NVIDIA's data sheet), used where no card is present."""

    sms: int = 132
    threads_per_block: int = 1024
    threads_per_sm: int = 2048
    blocks_per_sm: int = 32
    registers_per_sm: int = 65536
    smem_per_block_optin: int = 232448  # 227 KB
    smem_per_sm: int = 233472  # 228 KB


def device_limits(device=None) -> DeviceLimits:
    """The limits of ``device``'s card from ``torch.cuda.get_device_properties``,
    or the H100's defaults for a CPU device (the tests)."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return DeviceLimits()
    props = torch.cuda.get_device_properties(dev)
    base = DeviceLimits()
    return DeviceLimits(
        sms=props.multi_processor_count,
        threads_per_sm=getattr(props, "max_threads_per_multi_processor", base.threads_per_sm),
        registers_per_sm=getattr(props, "regs_per_multiprocessor", base.registers_per_sm),
        smem_per_block_optin=getattr(
            props, "shared_memory_per_block_optin", base.smem_per_block_optin),
        smem_per_sm=getattr(props, "shared_memory_per_multiprocessor", base.smem_per_sm),
    )


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """The launch of one family's timed kernel: threads a block, registers
    a thread and static shared memory a block (``nvcc -Xptxas -v`` for
    sm_90a, ``scripts/torch_kernel_regs.py``), and the blocks an SM must
    hold at once for the kernel's design (``min_blocks``)."""

    kernel: str
    threads: int
    registers: int
    smem: int = 0
    min_blocks: int = 1


def _threads_for(items: int) -> int:
    """``threads_for`` of ``csrc/quant.cuh``: whole warps, at most 256."""
    return min(256, (items + 31) // 32 * 32)


def family_launch(family: str, w: int, *, stream_dtype: str = "u16",
                  vector: bool = True) -> LaunchSpec:
    """The kernel ``family``'s timer launches for planes of width ``w``:
    the step (B2) and the insert (B6) on their vector path or their scalar
    layout, the combine (B7), the EMA step (B8), the 3x3 filter (B9)."""
    _family(family)
    items = _items(w, stream_dtype)
    if family == "stream":
        if _vector(family, stream_dtype, vector):
            return LaunchSpec("stream_step_vec_kernel", 256, REGISTERS["stream_vector"])
        return LaunchSpec("stream_step_kernel", _threads_for(items), REGISTERS["stream_scalar"])
    if family == "median_insert":
        if _vector(family, stream_dtype, vector):
            return LaunchSpec("insert_vec_kernel", 256, REGISTERS["median_insert_vector"],
                              smem=INSERT_VECTOR_SMEM)
        return LaunchSpec("insert_kernel", _threads_for(items), REGISTERS["median_insert"])
    if family == "median_combine":
        return LaunchSpec("combine_kernel", 256, REGISTERS["median_combine"])
    if family == "ema":
        p12 = stream_dtype == "p12"
        return LaunchSpec("ema_kernel", 256, REGISTERS["ema"], smem=8192 if p12 else 4096,
                          min_blocks=3 if p12 else 5)
    return LaunchSpec("spatial_tile_kernel", 256, REGISTERS["spatial"], smem=SPATIAL_SMEM)


#: registers a thread of each family's timed kernel, the most of the
#: instances a plan's launch takes (the tiled forms of the row kernels; the
#: u16/u8 EMA instances with pair_tile <= 8; the 3x3 tile kernel's bilateral
#: mode), as ``scripts/torch_kernel_regs.py`` (``nvcc -Xptxas -v``, sm_90a,
#: CUDA 12.8) read them for this tree on an NVIDIA H100 80GB HBM3
REGISTERS = {
    "stream_vector": 57,
    "stream_scalar": 32,
    "median_insert": 32,
    "median_insert_vector": 64,
    "median_combine": 32,
    "ema": 48,
    "spatial": 58,
}
#: static shared memory of the 3x3 tile kernel's bilateral instance (bytes,
#: the same reading): the staged tile, its halo and the edge weights
SPATIAL_SMEM = 46784


def _family(family: str) -> None:
    if family not in KERNEL_FAMILIES:
        raise ValueError(f"kernel family must be one of {KERNEL_FAMILIES}, got {family!r}")


def blocks_per_sm(spec: LaunchSpec, limits: DeviceLimits) -> int:
    """Blocks of ``spec`` an SM holds at once: the least of what its
    threads, registers (allocated per warp, in units of 256), shared
    memory and the 32-block cap allow."""
    warps = math.ceil(spec.threads / 32)
    regs_per_warp = math.ceil(spec.registers * 32 / 256) * 256
    by_regs = limits.registers_per_sm // max(1, regs_per_warp * warps)
    by_smem = limits.smem_per_sm // spec.smem if spec.smem else limits.blocks_per_sm
    return min(limits.threads_per_sm // spec.threads, by_regs, by_smem, limits.blocks_per_sm)


def launch_blocks(family: str, p: int, h: int, w: int, row_tile: int | None,
                  pair_tile: int | None, *, stream_dtype: str = "u16",
                  vector: bool = True) -> int:
    """The blocks one launch of ``family``'s timed kernel makes at this
    geometry (``None``: the kernel's default layout)."""
    _family(family)
    items = _items(w, stream_dtype)
    if family == "median_insert" and vector:  # one layout
        return math.ceil(h * w / INSERT_VECTOR_PX[stream_dtype] / VECTOR_PASS) * p
    if _vector(family, stream_dtype, vector):
        share = (row_tile * items + 7) // 8 if row_tile else VECTOR_PASS
        return math.ceil(h * items / 8 / share) * math.ceil(p / (pair_tile or 1))
    if family in TILED_FAMILIES:
        return math.ceil(h / (row_tile or 1)) * math.ceil(p / (pair_tile or 1))
    if family == "median_combine":
        return math.ceil(p * h * w / 256)
    if family == "ema":
        return math.ceil(h * items / 32)
    return math.ceil(w / 128) * math.ceil(h / 16) * p  # spatial


def reject_reason(family: str, p: int, h: int, w: int, row_tile: int | None,
                  pair_tile: int | None, *, stream_dtype: str = "u16", vector: bool = True,
                  limits: DeviceLimits | None = None) -> str | None:
    """Why this geometry cannot or should not launch, or ``None`` when the
    model admits it. Checked before any launch: the search never times a
    geometry the model rejects."""
    limits = limits or DeviceLimits()
    spec = family_launch(family, w, stream_dtype=stream_dtype, vector=vector)
    try:
        resolve_tiles(family, p, h, w, row_tile, pair_tile)
    except ValueError as err:
        return str(err)
    if _one_geometry(family, vector) and (row_tile, pair_tile) != _default(family, p, h, w):
        return f"{spec.kernel} has one geometry, {_default(family, p, h, w)}"
    if spec.threads > limits.threads_per_block:
        return f"{spec.threads} threads a block > {limits.threads_per_block}"
    if spec.smem > limits.smem_per_block_optin:
        return f"{spec.smem} B of shared memory > {limits.smem_per_block_optin} a block"
    resident = blocks_per_sm(spec, limits)
    if resident < spec.min_blocks:
        return (f"{spec.registers} registers x {spec.threads} threads hold {resident} blocks "
                f"an SM, the design needs {spec.min_blocks}")
    blocks = launch_blocks(family, p, h, w, row_tile, pair_tile, stream_dtype=stream_dtype,
                           vector=vector)
    if blocks > 0x7FFFFFFF:
        return f"{blocks} blocks > the grid's 2^31 - 1"
    if family in TILED_FAMILIES and (row_tile, pair_tile) != (None, None):
        wave = limits.sms * resident
        if blocks < wave:
            return f"{blocks} blocks fill less than one wave ({wave})"
        if row_tile and _vector(family, stream_dtype, vector):
            share = (row_tile * _items(w, stream_dtype) + 7) // 8
            if share < VECTOR_PASS:
                return (f"a share of {share} vectors leaves threads of the block idle "
                        f"(one pass is {VECTOR_PASS})")
    return None


def launch_shape(family: str, p: int, h: int, w: int, row_tile: int | None,
                 pair_tile: int | None, *, stream_dtype: str = "u16",
                 vector: bool = True) -> tuple:
    """What a launch at this geometry runs: its blocks and each block's
    work (rows, or vectors on the step's vector path, times pairs). Two
    geometries with one shape are one launch (``row_tile=1, pair_tile=1``
    is the scalar layout's default)."""
    blocks = launch_blocks(family, p, h, w, row_tile, pair_tile, stream_dtype=stream_dtype,
                           vector=vector)
    if _one_geometry(family, vector):
        return (family, blocks, pair_tile if family == "ema" else None)
    if _vector(family, stream_dtype, vector):
        share = (row_tile * _items(w, stream_dtype) + 7) // 8 if row_tile else VECTOR_PASS
        return (family, blocks, share, pair_tile or 1)
    return (family, blocks, row_tile or 1, pair_tile or 1)


def model_candidates(family: str, p: int, h: int, w: int, *, stream_dtype: str = "u16",
                     vector: bool = True, limits: DeviceLimits | None = None,
                     cap: int = 6) -> list[tuple]:
    """The measured search's candidates, around the model's point: the
    default layout first (the heuristic), then the model's point (the
    admitted geometry whose last wave is fullest, the fewest blocks among
    equals, rows before pairs), the point with half and with twice the
    work a block (halving or doubling rows, else pairs), its work laid
    along one axis (pairs, else rows), and the fewest-blocks geometry whose
    last wave is at least 3/4 full. Each is admitted by
    :func:`reject_reason`, and no two make the same launch
    (:func:`launch_shape`). A family with one geometry has one candidate."""
    kw = dict(stream_dtype=stream_dtype, vector=vector)
    admitted = admitted_tiles(family, p, h, w, limits=limits, **kw)
    out, shapes = [], set()

    def add(*options) -> None:
        """Add the first of ``options`` the model admits that is a new launch."""
        for geom in options:
            shape = launch_shape(family, p, h, w, *geom, **kw)
            if geom in admitted and shape not in shapes and len(out) < cap:
                out.append(geom)
                shapes.add(shape)
                return

    add(admitted[0])
    rest = [g for g in admitted[1:] if launch_shape(family, p, h, w, *g, **kw) not in shapes]
    if not rest:
        return out
    fill = {g: score(family, p, h, w, *g, limits=limits, **kw) for g in rest}
    th, tp = min(rest, key=lambda g: (-fill[g]["fill"], fill[g]["blocks"]))
    add((th, tp))
    add(*[g for g in ((th // 2, tp), (th, tp // 2)) if 0 not in g])  # half the work
    add((th * 2, tp), (th, tp * 2))  # twice the work
    add((1, th * tp), (th * tp, 1))  # the same work along one axis
    full = [g for g in rest if fill[g]["fill"] >= 0.75]
    if full:
        add(min(full, key=lambda g: fill[g]["blocks"]))
    return out


def _items(w: int, stream_dtype: str) -> int:
    return w // 2 if stream_dtype == "p12" else w


def _one_geometry(family: str, vector: bool) -> bool:
    """Whether ``family``'s launch takes no plan geometry: the untiled
    families, and the insert's vector path."""
    return family not in TILED_FAMILIES or (family == "median_insert" and vector)


def _vector(family: str, stream_dtype: str, vector: bool) -> bool:
    """Whether ``family`` launches a vector path: the step's takes u16 and
    u8 wire, the insert's every format."""
    if family == "median_insert":
        return vector
    return family == "stream" and vector and stream_dtype != "p12"


def score(family: str, p: int, h: int, w: int, row_tile: int | None,
          pair_tile: int | None, *, stream_dtype: str = "u16", vector: bool = True,
          limits: DeviceLimits | None = None) -> dict:
    """Waves of an admitted geometry: ``waves`` (blocks over what the card
    holds at once) and ``fill``, the share of the launched waves' block
    slots that hold a block (1.0: the last wave is full)."""
    limits = limits or DeviceLimits()
    spec = family_launch(family, w, stream_dtype=stream_dtype, vector=vector)
    slots = limits.sms * blocks_per_sm(spec, limits)
    blocks = launch_blocks(family, p, h, w, row_tile, pair_tile, stream_dtype=stream_dtype,
                           vector=vector)
    waves = blocks / slots
    return {"blocks": blocks, "waves": waves, "fill": waves / math.ceil(waves)}


def admitted_tiles(family: str, p: int, h: int, w: int, *, stream_dtype: str = "u16",
                   vector: bool = True, limits: DeviceLimits | None = None) -> list[tuple]:
    """Every geometry the model admits for a (p, h, w) problem: the
    default layout first, then each (row_tile, pair_tile) of exact
    divisors of H and N/2 that :func:`reject_reason` passes. A family with
    one geometry admits that one."""
    out = [_default(family, p, h, w)]
    if not _one_geometry(family, vector):
        for th in _divisors(h):
            for tp in _divisors(p):
                if reject_reason(family, p, h, w, th, tp, stream_dtype=stream_dtype,
                                 vector=vector, limits=limits) is None:
                    out.append((th, tp))
    return out


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _default(family: str, p: int, h: int, w: int) -> tuple:
    return resolve_tiles(family, p, h, w) if family == "ema" else (None, None)


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


def _check_divides(th: int | None, tp: int | None, *, p: int, h: int) -> None:
    if th is not None and (th < 1 or h % th):
        raise ValueError(f"row_tile {th} must divide H={h}")
    if tp is not None and (tp < 1 or p % tp):
        raise ValueError(f"pair_tile {tp} must divide N/2={p}")


def resolve_tiles(
    family: str, p: int, h: int, w: int,
    row_tile: int | None = None, pair_tile: int | None = None,
) -> tuple:
    """``(row_tile, pair_tile)`` for a (p, h, w) problem of ``family``.

    Explicit tiles win but must divide exactly (``ValueError``, as the
    reference's). The ``"ema"`` default is the reference's pinned legacy
    pick, whose ``pair_tile`` sets the kernel's merge chunks; every other
    family's default is ``None``, the kernel's own layout."""
    _family(family)
    if family == "ema":
        row_tile = row_tile or legacy_pick_row_tile(h, w)
        pair_tile = pair_tile or legacy_pick_pair_tile(p, row_tile, w)
    _check_divides(row_tile, pair_tile, p=p, h=h)
    return row_tile, pair_tile


def launch_tiles(p: int, h: int, row_tile: int | None = None,
                 pair_tile: int | None = None) -> tuple[int, int]:
    """A launcher's ``(row_tile, pair_tile)``: explicit tiles must divide
    H and N/2 (``ValueError``); ``None`` becomes 0, the default layout."""
    _check_divides(row_tile, pair_tile, p=p, h=h)
    return row_tile or 0, pair_tile or 0
