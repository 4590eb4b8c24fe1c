"""Plain PyTorch oracles for the PRISM subtract-and-average kernels
(counterpart of ``repro.kernels.ref``).

Paper semantics (§4.1, Fig. 2): ``G`` groups of ``N`` frames (``N`` even)
alternate control and excitation::

    diff[g, k] = frame[g, 2k+1] - frame[g, 2k] + offset      (0-based)
    out[k]     = (1/G) * sum_g diff[g, k]                    k in [0, N/2)

``divide_last`` (Alg 1/2/3) divides the sum once; ``divide_first``
(Alg 3 v2) divides every diff before it is added.

**Rounding contract.** The streaming oracle (``ref_stream_step``,
:func:`fold`, :func:`scale_reciprocal`) reproduces the reference's
*jitted* entry points bit for bit, because those are what the kernels
replace. Inside ``jit`` XLA turns ``x / G`` into ``x * f32(1/G)`` and
contracts ``s + d * f32(1/G)`` into one FMA, so ``divide_first`` folds
``fma(d, 1/G, s)`` (see :func:`fma_f32`) and the one-shot ``divide_last``
scales by the reciprocal. Outside ``jit`` the reference divides truly:
``ref_stream_finalize`` and ``ref_subtract_average`` here do the same,
through :func:`true_divide`, which never lets PyTorch's CUDA scalar
division swap in a reciprocal.

**Half-precision accumulators** follow what XLA's CPU compiler makes of
the same jitted expressions, which depends on the type:

* ``float16`` keeps the float32 rules in float16: every operation is
  rounded to float16, ``x / G`` becomes ``x * f16(1/G)``, and a
  contracted ``a * b + c`` is one float16 FMA, rounded once
  (:func:`fma`, ``__hfma`` on the card);
* ``bfloat16`` rounds every operation to bfloat16 and contracts nothing:
  ``x / G`` is a true division (:func:`contracts` is False).

Each single operation on two half values, computed in float32 and rounded
once, is the correctly rounded half result, so PyTorch's CPU half
arithmetic and the CUDA kernels' float arithmetic with ``_rn`` rounding
agree on it.

Integer containers (``torch.uint16``, ``torch.int32``) compute in int32
and wrap back (``quant.widen``/``quant.narrow``): PyTorch has no
arithmetic on ``uint16``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import quant

__all__ = [
    "as_torch_dtype",
    "true_divide",
    "reciprocal",
    "fma_f32",
    "fma",
    "contracts",
    "round_const",
    "fold",
    "scale_reciprocal",
    "ref_subtract_average",
    "ref_stream_init",
    "ref_stream_step",
    "ref_stream_finalize",
    "ref_numpy",
]


#: what ``jax.dtypes.canonicalize_dtype`` makes of a 64-bit type with x64 off
_CANONICAL = {
    "float64": "float32", "int64": "int32", "uint64": "uint32", "complex128": "complex64",
}


def as_torch_dtype(dtype) -> torch.dtype:
    """``"float32"``, ``np.float32``, ``torch.float32``... -> ``torch.float32``.

    A name or numpy dtype resolves as the reference's
    ``jnp.dtype`` under its default (x64 off): ``"float64"`` gives float32,
    ``"int64"`` int32 and ``"uint64"`` uint32. A torch dtype keeps its type.
    """
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, _CANONICAL.get(name, name), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"not a dtype: {dtype!r}")
    return out


def _is_int(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex


def contracts(dtype: torch.dtype) -> bool:
    """Whether XLA's CPU compiler applies the float32 rules to ``dtype``:
    ``x / G`` as a reciprocal multiply and ``a * b + c`` as one FMA. True
    for float32 and float16; bfloat16 rounds each operation on its own."""
    return dtype in (torch.float32, torch.float16)


def true_divide(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x / k`` as a true division on every device (floor for integers).

    The divisor is a 0-dim tensor on ``x``'s device: PyTorch's CUDA
    division by a *host* scalar multiplies by its reciprocal instead.
    """
    if _is_int(x.dtype):
        return quant.narrow(quant.widen(x) // k, x.dtype)
    return x / torch.tensor(k, dtype=x.dtype, device=x.device)


def reciprocal(num_groups: int, dtype: torch.dtype = torch.float32) -> float:
    """``dtype(1) / dtype(G)``: the constant XLA multiplies by for ``/ G``
    (float32 for every type that is not float16)."""
    if dtype == torch.float16:
        return float(np.float16(1) / np.float16(num_groups))
    return float(np.float32(1) / np.float32(num_groups))


def round_const(value: float, dtype: torch.dtype) -> float:
    """A host constant ``jnp.asarray(value, dtype)``: the Python float
    rounded once to float16 or float32; to bfloat16 through float32, as
    JAX converts it."""
    if dtype == torch.float16:
        return float(np.float16(value))
    f = float(np.float32(value))
    return float(torch.tensor(f).to(torch.bfloat16)) if dtype == torch.bfloat16 else f


def _fma_odd_f64(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded to odd in float64, for float32 or narrower
    operands: ``a * b`` is exact in float64 (24 + 24 significant bits),
    TwoSum gives the exact error of the sum, and an inexact sum with an
    even last bit is nudged toward the exact value."""
    x = a.to(torch.float64) * torch.as_tensor(b, dtype=torch.float64)
    y = c.to(torch.float64)
    s = x + y
    bb = s - x
    err = (x - (s - bb)) + (y - bb)
    return _to_odd(s, err != 0, err > 0, torch.int64)


def _to_odd(s: torch.Tensor, inexact, up, int_type) -> torch.Tensor:
    """``s`` with its last bit set where it is inexact and even, moved one
    step toward the exact value (``up``: the exact value is larger)."""
    even = (s.view(int_type) & 1) == 0
    toward = torch.where(up, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(inexact & even, torch.nextafter(s, toward), s)


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``round_f32(a * b + c)`` with a single rounding, like ``fmaf``: the
    float64 sum rounded to odd, then to nearest float32 (with 53 >= 24 + 2
    bits that double rounding is exact)."""
    return _fma_odd_f64(a, b, c).to(torch.float32)


def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """A contracted ``a * b + c`` in ``c``'s type with one rounding:
    :func:`fma_f32`, and for float16 the float16 FMA XLA computes
    (``__hfma`` on the card): the sum rounded to odd in float32 (24 >= 11
    + 2 bits), then to nearest float16."""
    if c.dtype == torch.float32:
        return fma_f32(a, b, c)
    s = _fma_odd_f64(a, b, c)
    f = s.to(torch.float32)
    back = f.to(torch.float64)
    return _to_odd(f, back != s, s > back, torch.int32).to(c.dtype)


def fold(
    sum_frame: torch.Tensor, diff: torch.Tensor, *, divide_first: bool, num_groups: int
) -> torch.Tensor:
    """One running-sum update, rounded as the reference's jitted step."""
    acc = sum_frame.dtype
    if _is_int(acc):
        d = quant.widen(diff)
        if divide_first:
            d = d // num_groups
        return quant.narrow(quant.widen(sum_frame) + d, acc)
    if not divide_first:
        return sum_frame + diff
    if not contracts(acc):
        return sum_frame + true_divide(diff, num_groups)
    return fma(diff, reciprocal(num_groups, acc), sum_frame)


def scale_reciprocal(total: torch.Tensor, num_groups: int) -> torch.Tensor:
    """The jitted ``total / G``: a reciprocal multiply where XLA makes one
    (:func:`contracts`), else a true division (floor for integers)."""
    if _is_int(total.dtype) or not contracts(total.dtype):
        return true_divide(total, num_groups)
    return total * torch.tensor(reciprocal(num_groups, total.dtype), dtype=total.dtype)


#: XLA's CPU compiler sums a reduction over more than this many elements
#: in windows of this many (its tree reduction rewrite)
XLA_REDUCE_WINDOW = 32


def xla_windows(n: int) -> list[tuple[int, int]]:
    """The windows ``[lo, hi)`` in which XLA's CPU compiler sums a reduction
    over ``n`` elements: one, up to :data:`XLA_REDUCE_WINDOW`; above it, the
    axis padded with zeros to a multiple of the window (half the padding,
    rounded down, before it) and cut into windows."""
    w = XLA_REDUCE_WINDOW
    if n <= w:
        return [(0, n)]
    low = (-n % w) // 2
    return [(max(k, 0), min(k + w, n)) for k in range(-low, n, w)]


def xla_sum(terms: list[torch.Tensor]) -> torch.Tensor:
    """``sum(terms)`` in the order XLA's CPU compiler sums a reduction over
    them, each add rounded to their type: each window (:func:`xla_windows`)
    from zero in order, then the window sums the same way."""
    while True:
        sums = []
        for lo, hi in xla_windows(len(terms)):
            total = torch.zeros_like(terms[0])
            for t in terms[lo:hi]:
                total = total + t
            sums.append(total)
        if len(sums) == 1:
            return sums[0]
        terms = sums


# XLA's CPU compiler on the banked one-shot's group sum at up to 32 groups
# (``jnp.sum`` over G of the fused differences, one fusion). Everything below
# is read off that fusion's ``*.ir-with-opt.ll`` (``XLA_FLAGS=--xla_dump_to=DIR``,
# jaxlib 0.9.0, a 2 x 4 x 4 x 64 plane) and held bitwise to the reference's
# outputs in ``tests/test_torch_accumulators.py``.

#: LLVM's vector width in XLA's CPU fusions: ``"prefer-vector-width"="256"``
#: in the attributes of every function of the fusion's ``ir-with-opt.ll``
XLA_VECTOR_BITS = 256

#: the loop vectorizer's lanes for a float32 or float16 group loop: float32
#: lanes of :data:`XLA_VECTOR_BITS` (float16 is computed in float32 on the
#: host CPU); ``<8 x float>`` and ``<8 x half>`` adds in the IR
XLA_LANES = XLA_VECTOR_BITS // 32

#: How the group loop is summed from the first G at which LLVM stops
#: unrolling it and vectorizes it instead; below that G it is unrolled and
#: summed in order. Keyed by (accumulator, wire format, divide_first): rows of
#: (first G, last G, even pixels' (lanes, epilogue), odd pixels'), the
#: parities differing for p12, whose two pixels of a triplet unpack on
#: separate branches. ``lanes`` is :data:`XLA_LANES` (``<8 x ...>`` adds
#: into one accumulator) or twice it (two interleaved ``<8 x ...>``
#: accumulators, or ``<16 x half>``), ``epilogue`` the lanes of the
#: vectorized remainder loop (``vec.epilog.vector.body``), 0 for none
#: (:func:`xla_lane_sum`). u16 Alg 3 sums in order at every G: LLVM
#: vectorizes the pixel loop around it. bfloat16 is never vectorized. These
#: rows hold for a nonzero offset (read at offset 100; the tests hold them
#: at 100.5, 4094, 4095, 4096, 16383 and 16384).
XLA_GROUP_LOOPS = {
    ("float32", "u16", True): ((30, 32, (8, 0), (8, 0)),),
    ("float32", "u8", False): ((28, 32, (8, 0), (8, 0)),),
    ("float32", "u8", True): ((25, 32, (8, 0), (8, 0)),),
    ("float32", "p12", False): ((17, 27, (8, 4), (8, 4)), (28, 32, (8, 0), (8, 0))),
    ("float32", "p12", True): ((17, 27, (8, 4), (8, 4)), (28, 32, (8, 0), (8, 0))),
    ("float16", "u16", True): ((30, 31, (8, 0), (8, 0)), (32, 32, (16, 0), (16, 0))),
    ("float16", "u8", False): ((28, 31, (8, 0), (8, 0)), (32, 32, (16, 0), (16, 0))),
    ("float16", "u8", True): ((25, 31, (8, 0), (8, 0)), (32, 32, (16, 0), (16, 0))),
    ("float16", "p12", False): (
        (16, 23, (8, 0), (8, 4)), (24, 31, (16, 8), (8, 0)), (32, 32, (16, 0), (16, 0))),
    ("float16", "p12", True): (
        (16, 23, (16, 4), (16, 4)), (24, 31, (8, 0), (8, 0)), (32, 32, (16, 0), (16, 0))),
}

#: :data:`XLA_GROUP_LOOPS` at offset 0, read off the IR at offset 0: the
#: loop body has no offset add, so LLVM unrolls it up to a larger G
XLA_GROUP_LOOPS_NO_OFFSET = {
    ("float32", "u8", False): ((30, 32, (8, 0), (8, 0)),),
    ("float32", "u8", True): ((28, 32, (8, 0), (8, 0)),),
    ("float32", "p12", False): ((17, 17, (1, 0), (8, 4)), (18, 27, (8, 4), (8, 4)),
                                (28, 32, (8, 0), (8, 0))),
    ("float32", "p12", True): ((17, 17, (1, 0), (8, 4)), (18, 27, (8, 4), (8, 4)),
                               (28, 32, (8, 0), (8, 0))),
    ("float16", "u8", False): ((30, 31, (8, 0), (8, 0)), (32, 32, (16, 0), (16, 0))),
    ("float16", "u8", True): ((28, 31, (8, 0), (8, 0)), (32, 32, (16, 0), (16, 0))),
    ("float16", "p12", False): ((16, 16, (1, 0), (16, 8)), (17, 32, (16, 0), (16, 8))),
    ("float16", "p12", True): (
        (16, 23, (16, 8), (16, 4)), (24, 31, (16, 8), (8, 0)), (32, 32, (16, 0), (16, 0))),
}

#: float32 p12 Alg 3 v2 with an integer offset in this range: the
#: difference is computed in i16 and converted by ``uitofp nneg``, so LLVM
#: drops the sum's ``+ 0.0`` start and the first two terms' products meet in
#: one add, which contracts as ``fma(d0, 1/G, f32(d1 / G))``
XLA_NONNEG_P12_OFFSETS = (4095, 16383)

#: ... except on the one branch that LLVM leaves a rolled loop from 0.0:
#: the odd pixels at this G
XLA_ROLLED_P12_ODD_G = 15


def xla_lane_sum(n: int, lanes: int, epilogue: int, step) -> torch.Tensor:
    """The sum of ``n`` terms as LLVM's loop vectorizer orders it.

    ``lanes`` strided accumulators (lane k takes terms k, k + lanes, ...)
    over the whole multiples of ``lanes``, halved into one (lanes k and
    k + lanes/2 added, and again); then an ``epilogue`` of that many lanes,
    the running sum in its lane 0, over the whole multiples left; then the
    rest in order. ``lanes`` 1 sums in order. ``step(acc, k)`` adds term k
    to ``acc`` (``None`` at a lane's first term), rounded as the caller's
    type rounds it.
    """

    def halve(acc):
        while len(acc) > 1:
            h = len(acc) // 2
            acc = [acc[i] + acc[i + h] for i in range(h)]
        return acc[0]

    total, pos = None, 0
    if lanes > 1 and n >= lanes:
        acc = [None] * lanes
        for pos in range(0, n - n % lanes, lanes):
            acc = [step(acc[k], pos + k) for k in range(lanes)]
        pos += lanes
        total = halve(acc)
        if epilogue and n - pos >= epilogue:
            acc = [total] + [None] * (epilogue - 1)
            for pos in range(pos, n - (n - pos) % epilogue, epilogue):
                acc = [step(acc[k], pos + k) for k in range(epilogue)]
            pos += epilogue
            total = halve(acc)
    for k in range(pos, n):
        total = step(total, k)
    return total


def xla_group_sum(
    diffs: torch.Tensor, *, divide_first: bool, stream_dtype: str, offset: float
) -> torch.Tensor:
    """The reference's banked one-shot over 1-32 groups of differences
    ``diffs`` (``B, G, N/2, H, W``, float32 or float16) as XLA's CPU
    compiler sums them (:data:`XLA_GROUP_LOOPS`,
    :data:`XLA_GROUP_LOOPS_NO_OFFSET`): Alg 3 v2 as
    ``fma(d, 1/G, acc)`` at every add of a term, Alg 3 scaled by 1/G last."""
    g, acc = diffs.shape[1], diffs.dtype
    terms = list(diffs.unbind(1))
    name = str(acc).removeprefix("torch.")
    loops = XLA_GROUP_LOOPS if offset else XLA_GROUP_LOOPS_NO_OFFSET
    rows = loops.get((name, stream_dtype, divide_first), ())
    even = odd = (1, 0)
    for lo, hi, e, o in rows:
        if lo <= g <= hi:
            even, odd = e, o
    r = reciprocal(g, acc)
    lo, hi = XLA_NONNEG_P12_OFFSETS
    swap = (acc == torch.float32 and stream_dtype == "p12" and divide_first
            and offset == int(offset) and lo <= offset <= hi)

    def step(total, k):
        if not divide_first:
            return terms[k].clone() if total is None else total + terms[k]
        return terms[k] * r if total is None else fma(terms[k], r, total)

    def layout(lanes, epilogue, swapped):
        if not (swapped and lanes == 1 and g > 1):
            return xla_lane_sum(g, lanes, epilogue, step)
        total = fma(terms[0], r, terms[1] * r)
        for k in range(2, g):
            total = step(total, k)
        return total

    odd_swap = swap and g != XLA_ROLLED_P12_ODD_G
    total = layout(*even, swap)
    if (odd, odd_swap) != (even, swap):
        total[..., 1::2] = layout(*odd, odd_swap)[..., 1::2]
    return total if divide_first else scale_reciprocal(total, g)


def _split_pairs(frames: torch.Tensor) -> torch.Tensor:
    """(..., N, H, W) -> (..., N/2, 2, H, W) pairs view."""
    n = frames.shape[-3]
    if n % 2 != 0:
        raise ValueError(f"N must be even, got {n}")
    return frames.reshape(frames.shape[:-3] + (n // 2, 2) + frames.shape[-2:])


def pair_diff(frames, *, offset, accum_dtype, stream_dtype="u16") -> torch.Tensor:
    """(..., N, H, wire_W) -> (..., N/2, H, W): ``exc - ctl + offset``."""
    return quant.pair_diff_block(
        _split_pairs(frames), offset=offset,
        accum_dtype=as_torch_dtype(accum_dtype), stream_dtype=stream_dtype,
    )


def ref_subtract_average(
    frames: torch.Tensor,
    *,
    offset: int | float = 0,
    variant: str = "divide_last",
    accum_dtype=None,
) -> torch.Tensor:
    """One-shot oracle. frames: (G, N, H, W) -> (N/2, H, W).

    The counterpart of the reference's *eager* oracle: groups summed in
    order, true division. ``accum_dtype`` defaults to float32 for float
    inputs and int32 for integer inputs; ``torch.uint16`` reproduces the
    paper's container overflow for G > 8.
    """
    if frames.ndim != 4:
        raise ValueError(f"expected (G, N, H, W), got shape {tuple(frames.shape)}")
    if variant not in ("divide_last", "divide_first"):
        raise ValueError(f"unknown variant {variant!r}")
    g = frames.shape[0]
    if accum_dtype is None:
        accum_dtype = torch.float32 if frames.dtype.is_floating_point else torch.int32
    acc = as_torch_dtype(accum_dtype)
    diff = pair_diff(frames, offset=offset, accum_dtype=acc)
    if variant == "divide_first":
        diff = true_divide(diff, g)
    total = diff[0]
    for k in range(1, g):
        total = quant.narrow(quant.widen(total) + quant.widen(diff[k]), acc)
    out = total if variant == "divide_first" else true_divide(total, g)
    return out if acc == frames.dtype else out.to(acc)


# ---------------------------------------------------------------------------
# Streaming oracle: one group of frames per step (paper Algorithm 3).
# ---------------------------------------------------------------------------


def ref_stream_init(n: int, h: int, w: int, accum_dtype=torch.float32, *, device="cpu"):
    """Running-sum state: (N/2, H, W) zeros."""
    return torch.zeros((n // 2, h, w), dtype=as_torch_dtype(accum_dtype), device=device)


def ref_stream_step(
    sum_frame: torch.Tensor,
    group_frames: torch.Tensor,
    *,
    offset: int | float = 0,
    variant: str = "divide_last",
    num_groups: int | None = None,
    stream_dtype: str = "u16",
) -> torch.Tensor:
    """Fold one group (N, H, wire_W) into the running sum (N/2, H, W).

    Returns a new tensor (the in-place update is ``ops.stream_step``'s);
    leading bank axes pass through, as in the reference.
    """
    if variant == "divide_first" and num_groups is None:
        raise ValueError("divide_first needs num_groups")
    diff = pair_diff(
        group_frames, offset=offset, accum_dtype=sum_frame.dtype,
        stream_dtype=stream_dtype,
    )
    return fold(
        sum_frame, diff, divide_first=variant == "divide_first",
        num_groups=num_groups or 1,
    )


def ref_stream_finalize(
    sum_frame: torch.Tensor, num_groups: int, *, variant: str = "divide_last"
) -> torch.Tensor:
    """Final average; a fresh tensor, never the running sum itself."""
    if variant == "divide_first":
        return sum_frame.clone()
    return true_divide(sum_frame, num_groups)


def ref_numpy(frames: np.ndarray, offset: float = 0.0) -> np.ndarray:
    """Plain-numpy oracle (float64)."""
    g, n, h, w = frames.shape
    ctl = frames[:, 0::2].astype(np.float64)
    exc = frames[:, 1::2].astype(np.float64)
    return ((exc - ctl + offset).sum(axis=0) / g).astype(np.float64)
