"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where there is no CUDA device (the CPU
suite holds the plain versions to the JAX reference instead). Run them on
a machine with the card (``--noconftest``: the repo's ``conftest.py``
imports the JAX package, which that machine need not have)::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bitwise (the kernels round as the plain versions do), except
the bilateral mode of the spatial kernel on float32 frames, whose ``expf``
is held to the plain version's ``torch.exp`` within
``denoise_spatial.BILATERAL_RTOL``. On half-type frames each weight is
rounded to that type, and bilateral too is held bitwise.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.core import banks, streaming
from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser
from repro_torch.data.prism import PrismSource
from repro_torch.kernels import (
    denoise_ema,
    denoise_median,
    denoise_multibank,
    denoise_spatial,
    denoise_stream,
    denoise_tmpframe,
    ops,
    quant,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _wire(shape, fmt, seed, width=256):
    px = np.random.default_rng(seed).integers(0, 4096, shape + (width,)).astype(np.uint16)
    return torch.from_numpy(np.ascontiguousarray(quant.encode(px, fmt)))


def _shifted(t, device):
    """``t`` on ``device`` in storage that starts one element into a buffer:
    a contiguous view whose planes are not aligned for vector loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("divide_first", [False, True])
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
@pytest.mark.parametrize("g", [3, 8])
def test_kernels_bitwise_equal_plain(cuda, g, fmt, divide_first):
    kw = dict(offset=4096.0, divide_first=divide_first, stream_dtype=fmt)
    frames = _wire((2, g, 16, 80), fmt, seed=g)
    got = denoise_multibank.multibank_subtract_average(frames.to(cuda), **kw).cpu()
    assert torch.equal(got, denoise_multibank.multibank_subtract_average_plain(frames, **kw))
    got = denoise_stream.alg3_subtract_average(frames[0].to(cuda), **kw).cpu()
    assert torch.equal(got, denoise_stream.alg3_subtract_average_plain(frames[0], **kw))
    s, sc = torch.zeros(2, 8, 80, 256, device=cuda), torch.zeros(2, 8, 80, 256)
    for k in range(g):
        chunk = frames[:, k].contiguous()
        denoise_multibank.multibank_stream_step(chunk.to(cuda), s, num_groups=g, **kw)
        sc = denoise_multibank.multibank_stream_step_plain(chunk, sc, num_groups=g, **kw)
        denoise_stream.alg3_stream_step(chunk[0].to(cuda), s[0], num_groups=g, **kw)
        sc[0] = denoise_stream.alg3_stream_step_plain(chunk[0], sc[0], num_groups=g, **kw)
    assert torch.equal(s.cpu(), sc)


@pytest.mark.parametrize("divide_first", [False, True])
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
@pytest.mark.parametrize(
    "shape, shift, path",
    [((80, 256), False, "vector"), ((8, 136), False, "vector"), ((40, 136), False, "vector"),
     ((80, 256), True, "scalar"), ((7, 130), False, "scalar")],
    ids=["80x256", "8x136", "40x136", "80x256-unaligned-view", "ragged-7x130"],
)
def test_step_kernels_take_the_path_their_planes_allow(cuda, shape, shift, path, fmt,
                                                       divide_first):
    # 8 x 136 is 136 vectors, a partial warp in one partial block; 40 x 136 is
    # 680, a full block and a partial one. p12 has no vector path.
    h, w = shape
    path = "scalar" if fmt == "p12" else path
    g, n = 3, 12
    frames = _wire((2, g, n, h), fmt, seed=h + g, width=w)
    kw = dict(offset=4096.0, divide_first=divide_first, stream_dtype=fmt, num_groups=g)
    b2, b4 = denoise_stream.alg3_stream_step, denoise_multibank.multibank_stream_step
    before = [(f.launches, f.vector_launches, f.scalar_launches) for f in (b2, b4)]
    place = (lambda t: _shifted(t, cuda)) if shift else (lambda t: t.to(cuda))
    s1, s2 = place(torch.zeros(n // 2, h, w)), place(torch.zeros(2, n // 2, h, w))
    c1, c2 = torch.zeros(n // 2, h, w), torch.zeros(2, n // 2, h, w)
    for k in range(g):
        fin = k == g - 1  # the in-kernel final division on the last group
        chunk = frames[:, k].contiguous()
        denoise_stream.alg3_stream_step(place(chunk[0]), s1, final=fin, **kw)
        c1 = denoise_stream.alg3_stream_step_plain(chunk[0], c1, final=fin, **kw)
        denoise_multibank.multibank_stream_step(place(chunk), s2, final=fin, **kw)
        c2 = denoise_multibank.multibank_stream_step_plain(chunk, c2, final=fin, **kw)
    assert torch.equal(s1.cpu(), c1) and torch.equal(s2.cpu(), c2)
    for f, (n0, v0, s0) in zip((b2, b4), before):
        assert f.launches - n0 == g
        assert (f.vector_launches - v0, f.scalar_launches - s0) == (
            (g, 0) if path == "vector" else (0, g))


def test_step_kernel_refuses_a_vector_launch_its_planes_do_not_allow(cuda, monkeypatch):
    # the path is the host's choice; the kernel raises on a wrong one, never reroutes
    monkeypatch.setattr(denoise_stream, "step_path", lambda *a: "vector")
    frames = _wire((12, 7), "u16", seed=3, width=130).to(cuda)
    with pytest.raises(RuntimeError, match="alg3_stream_step: CUDA launch failed"):
        denoise_stream.alg3_stream_step(frames, torch.zeros(6, 7, 130, device=cuda),
                                        num_groups=2)


FLOATS = (torch.float32, torch.float16, torch.bfloat16)


def _extreme_wire(shape, fmt, seed, width):
    """Seeded wire frames with one pixel in eight at the format's largest
    value and one in eight at 0: a float16 sum of u16 wire then meets inf
    (65535 rounds up) and inf - inf."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 4096, shape + (width,)).astype(np.uint16)
    pick = rng.random(px.shape)
    px[pick < 0.125] = 4095
    px[pick > 0.875] = 0
    wire = quant.encode(px, fmt)
    if fmt == "u16":
        wire = np.where(wire == 4095, np.uint16(65535), wire)
    return torch.from_numpy(np.ascontiguousarray(wire))


_BITS = {torch.float32: torch.int32, torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _same_bits(got, want):
    """Bitwise equal (the sign of a zero included), NaN held to NaN in the
    same places: a NaN's payload is the arithmetic's, not the contract's."""
    got = got.cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    nan = torch.isnan(want)
    bits = _BITS[want.dtype]
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(bits), want[~nan].view(bits)))


def _oneshots(frames, place, acc, kw):
    """B3 on bank 0 and B5 on both banks of ``frames`` (B, G, N, H, wire_W),
    placed on the card by ``place``; each result beside its plain version."""
    b3, b5 = denoise_stream.alg3_subtract_average, denoise_multibank.multibank_subtract_average
    return [(b3(place(frames[0]), accum_dtype=acc, **kw),
             denoise_stream.alg3_subtract_average_plain(frames[0], accum_dtype=acc, **kw)),
            (b5(place(frames), accum_dtype=acc, **kw),
             denoise_multibank.multibank_subtract_average_plain(frames, accum_dtype=acc, **kw))]


def _oneshot_paths():
    fns = (denoise_stream.alg3_subtract_average, denoise_multibank.multibank_subtract_average)
    return [(f.vector_launches, f.scalar_launches) for f in fns]


#: (accumulator, G) of the one-shot's vector-path cases: every float sum at
#: G = 5 and 8, and bfloat16 at G = 65 and 100, where the vector path divides
#: truly instead of by x * f32(1/G) (bf16_quotient)
ONESHOT_VECTOR_CASES = [(acc, g) for acc in FLOATS for g in (5, 8)] + [
    (torch.bfloat16, 65), (torch.bfloat16, 100)]


@pytest.mark.parametrize("acc, g", ONESHOT_VECTOR_CASES,
                         ids=[f"{str(a).split('.')[-1]}-{g}" for a, g in ONESHOT_VECTOR_CASES])
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
def test_oneshot_vector_path_bitwise_equal_plain(cuda, fmt, acc, g):
    # 40 x 136 is 680 u16 vectors (a full block of 256 and a partial one, a
    # partial warp) and 340 u8 / p12 vectors (one full block, one partial);
    # extreme wire values; G = 5 exposes the rounding of x / G; bfloat16 at
    # G = 65 and 100 runs the vector path's true division
    frames = _extreme_wire((2, g, 4, 40), fmt, seed=g, width=136)
    before = _oneshot_paths()
    for offset in (0.0, 4096.0):
        for divide_first in (False, True):
            kw = dict(offset=offset, divide_first=divide_first, stream_dtype=fmt)
            for got, want in _oneshots(frames, lambda t: t.to(cuda), acc, kw):
                assert _same_bits(got, want), (offset, divide_first)
    assert [(v - v0, s - s0) for (v, s), (v0, s0) in zip(_oneshot_paths(), before)] == [(4, 0)] * 2


@pytest.mark.parametrize("acc", FLOATS, ids=["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
@pytest.mark.parametrize(
    "hw, shift_bytes",
    [((1, 8), 0), ((1, 16), 0), ((7, 130), 0), ((40, 136), 2), ((40, 136), 8)],
    ids=["one-u16-vector", "one-vector", "ragged-7x130", "view-2-bytes-in", "view-8-bytes-in"],
)
def test_oneshot_takes_the_path_its_planes_allow(cuda, fmt, acc, hw, shift_bytes):
    # a plane of one vector (8 u16 pixels, 16 u8/p12 ones), a ragged plane and
    # views 2 and 8 bytes into a buffer: p12's three 8-byte loads take a view
    # 8 bytes in, the 16-byte u16 and u8 loads do not
    h, w = hw
    if fmt == "p12" and shift_bytes == 2:
        shift_bytes = 3  # a whole p12 item in; 3 bytes is not 8-aligned either
    frames = _extreme_wire((2, 5, 4, h), fmt, seed=h * w + shift_bytes, width=w)
    plane_px = h * w
    want_path = denoise_stream.oneshot_path(plane_px, fmt, 4096 + shift_bytes, 4096)
    assert want_path == ("vector" if plane_px % denoise_stream.ONESHOT_VECTOR[fmt][0] == 0
                         and shift_bytes % denoise_stream.ONESHOT_VECTOR[fmt][1] == 0
                         else "scalar")

    def place(t):
        n = shift_bytes // t.element_size()
        buf = torch.empty(t.numel() + n, dtype=t.dtype, device=cuda)
        view = buf[n:].view(t.shape)
        view.copy_(t)
        return view

    before = _oneshot_paths()
    for divide_first in (False, True):
        kw = dict(offset=4096.0, divide_first=divide_first, stream_dtype=fmt)
        for got, want in _oneshots(frames, place, acc, kw):
            assert _same_bits(got, want), divide_first
    took = [(v - v0, s - s0) for (v, s), (v0, s0) in zip(_oneshot_paths(), before)]
    assert took == [(2, 0) if want_path == "vector" else (0, 2)] * 2


@pytest.mark.parametrize("acc", FLOATS, ids=["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
def test_oneshot_every_tile_bitwise_equal_default(cuda, fmt, acc):
    # every (row_tile, pair_tile) a plan may name at 40 x 136 with 6 pairs
    # (exact divisors) launches, on the vector path (which keeps its one
    # layout under any plan), bitwise the default launch
    frames = _extreme_wire((2, 3, 12, 40), fmt, seed=7, width=136).to(cuda)
    b3, b5 = denoise_stream.alg3_subtract_average, denoise_multibank.multibank_subtract_average
    kw = dict(offset=4096.0, stream_dtype=fmt, accum_dtype=acc)
    want3 = denoise_stream.alg3_subtract_average_plain(frames[0].cpu(), **kw)
    want5 = denoise_multibank.multibank_subtract_average_plain(frames.cpu(), **kw)
    assert _same_bits(b3(frames[0], **kw), want3) and _same_bits(b5(frames, **kw), want5)
    before = _oneshot_paths()
    geoms = [(th, tp) for th in (1, 2, 4, 5, 8, 10, 20, 40) for tp in (1, 2, 3, 6)]
    for th, tp in geoms:
        tiles = dict(row_tile=th, pair_tile=tp)
        assert _same_bits(b3(frames[0], **tiles, **kw), want3), tiles
        assert _same_bits(b5(frames, **tiles, **kw), want5), tiles
    took = [(v - v0, s - s0) for (v, s), (v0, s0) in zip(_oneshot_paths(), before)]
    assert took == [(len(geoms), 0)] * 2


def test_bf16_quotient_rule_equals_true_division_on_every_bfloat16(cuda):
    # the vector path's bfloat16 x / G (x * f32(1/G) for G <= 64) against
    # round_bf16(__fdiv_rn(x, G)) and the CPU's float32 division, for all
    # 65,536 bfloat16 values (NaNs held to NaN) and G = 1..64
    d = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    dc = d.to(cuda)
    for g in range(1, 65):
        want = denoise_stream.bf16_quotient_probe(dc, g, true_division=True)
        assert _same_bits(want, (d.float() / g).to(torch.bfloat16)), g
        assert _same_bits(denoise_stream.bf16_quotient_probe(dc, g), want.cpu()), g


def test_oneshot_kernel_refuses_a_vector_launch_its_planes_do_not_allow(cuda, monkeypatch):
    # the path is the host's choice; the kernel raises on a wrong one, never reroutes
    monkeypatch.setattr(denoise_stream, "oneshot_path", lambda *a: "vector")
    frames = _wire((2, 12, 7), "u16", seed=3, width=130).to(cuda)
    with pytest.raises(RuntimeError, match="alg3_subtract_average: CUDA launch failed"):
        denoise_stream.alg3_subtract_average(frames)


def _insert_paths():
    fn = denoise_median.median_window_insert
    return fn.vector_launches, fn.scalar_launches


@pytest.mark.parametrize("acc", FLOATS, ids=["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
@pytest.mark.parametrize(
    "n, hw, shift_bytes",
    [(64, (80, 256), 0), (12, (40, 136), 0), (12, (1, 16), 0), (12, (7, 130), 0),
     (12, (40, 136), 2), (12, (40, 136), 8)],
    ids=["paper-plane", "partial-block", "one-vector", "ragged-7x130", "view-2-bytes-in",
         "view-8-bytes-in"],
)
def test_median_insert_takes_the_path_its_operands_allow(cuda, fmt, acc, n, hw, shift_bytes):
    # B6 into a 5-slot window that wraps (8 groups), offset 0 and 4096, the
    # wire formats' extreme values: 80 x 256 (the paper's plane) and 40 x 136
    # (a partial block and warp) on the vector path; one vector a plane; a
    # ragged 7 x 130 plane and views 2 (3 for p12) and 8 bytes in, where only
    # p12's 8-byte loads take the vector path
    h, w = hw
    if fmt == "p12" and shift_bytes == 2:
        shift_bytes = 3
    frames = _extreme_wire((8, n, h), fmt, seed=n * h + shift_bytes, width=w)
    want_path = denoise_median.insert_path(h * w, fmt, 4096 + shift_bytes, 4096)
    assert want_path == ("vector" if h * w % denoise_stream.ONESHOT_VECTOR[fmt][0] == 0
                         and shift_bytes % denoise_stream.ONESHOT_VECTOR[fmt][1] == 0
                         else "scalar")

    def place(t):
        k = shift_bytes // t.element_size()
        buf = torch.empty(t.numel() + k, dtype=t.dtype, device=cuda)
        view = buf[k:].view(t.shape)
        view.copy_(t)
        return view

    before = _insert_paths()
    for offset in (0.0, 4096.0):
        window = torch.zeros(5, n // 2, h, w, dtype=acc, device=cuda)
        wc = window.cpu()
        for g in range(8):
            kw = dict(slot=g % 5, offset=offset, stream_dtype=fmt)
            denoise_median.median_window_insert(window, place(frames[g]), **kw)
            denoise_median.median_window_insert_plain(wc, frames[g], **kw)
        assert _same_bits(window, wc), offset
    took = tuple(a - b for a, b in zip(_insert_paths(), before))
    assert took == ((16, 0) if want_path == "vector" else (0, 16))


@pytest.mark.parametrize("acc", FLOATS, ids=["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
def test_median_insert_every_tile_bitwise_equal_default(cuda, fmt, acc):
    # every (row_tile, pair_tile) a plan may name at 40 x 136 with 6 pairs
    # (exact divisors) launches, on the vector path (which keeps its one
    # layout under any plan), bitwise the default launch
    frames = _extreme_wire((2, 12, 40), fmt, seed=9, width=136).to(cuda)
    kw = dict(slot=1, offset=4096.0, stream_dtype=fmt)
    want = torch.zeros(2, 6, 40, 136, dtype=acc)
    denoise_median.median_window_insert_plain(want, frames[0].cpu(), **kw)
    before = _insert_paths()
    geoms = [(None, None)] + [(th, tp) for th in (1, 2, 4, 5, 8, 10, 20, 40) for tp in (1, 2, 3, 6)]
    for th, tp in geoms:
        window = torch.zeros(2, 6, 40, 136, dtype=acc, device=cuda)
        denoise_median.median_window_insert(window, frames[0], row_tile=th, pair_tile=tp, **kw)
        assert _same_bits(window, want), (th, tp)
    assert tuple(a - b for a, b in zip(_insert_paths(), before)) == (len(geoms), 0)


def test_median_insert_refuses_a_vector_launch_its_operands_do_not_allow(cuda, monkeypatch):
    # the path is the host's choice; the kernel raises on a wrong one, never reroutes
    monkeypatch.setattr(denoise_median, "insert_path", lambda *a: "vector")
    frames = _wire((1, 12, 7), "u16", seed=3, width=130)[0].to(cuda)
    with pytest.raises(RuntimeError, match="median_window_insert: CUDA launch failed"):
        denoise_median.median_window_insert(torch.zeros(2, 6, 7, 130, device=cuda), frames,
                                            slot=0)


@pytest.mark.parametrize(
    "pairs, pair_tile, hw, groups",
    [(500, 1, (16, 256), 2), (40, 40, (80, 256), 2), (60, 4, (7, 130), 3)]
    + [(168, t, (16, 256), 2) for t in (2, 3, 6, 7, 8)],
    ids=["500-chunks", "one-chunk", "ragged-7x130"] + [f"pair_tile-{t}" for t in (2, 3, 6, 7, 8)],
)
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
def test_ema_kernel_chunk_rounds_bitwise_equal_plain(cuda, fmt, pairs, pair_tile, hw, groups):
    # 500 chunks: 63 rounds of 8, the last one short; one chunk: longer than
    # the register cap, one round; ragged: a partial last tile of pixels;
    # pair_tile 2-8: every register tile the other cases do not launch
    h, w = hw
    frames = _wire((groups, 2 * pairs, h), fmt, seed=pairs, width=w)
    gpu = [torch.zeros(pairs, h, w, device=cuda), torch.zeros(h, w, device=cuda),
           torch.zeros(h, w, device=cuda)]
    cpu = [t.cpu() for t in gpu]
    before = denoise_ema.ema_welford_step.launches
    for g in range(groups):
        kw = dict(alpha=0.3, offset=4096.0, prior_count=11 + pairs * g, pair_tile=pair_tile,
                  stream_dtype=fmt)
        denoise_ema.ema_welford_step(*gpu, frames[g].to(cuda), **kw)
        cpu = list(denoise_ema.ema_welford_step_plain(*cpu, frames[g], **kw))
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu(), b)
    assert denoise_ema.ema_welford_step.launches - before == groups


@pytest.mark.parametrize(
    "pairs, pair_tile",
    [(96, 24), (100, 25), (112, 28), (480, 32), (500, 50), (500, 100), (500, 250), (500, 500)],
    ids=["chain-24", "lanes-25", "lanes-28", "lanes-32", "windows-50", "windows-100",
         "windows-250", "windows-500"],
)
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
def test_ema_kernel_long_chunks_bitwise_equal_plain(cuda, fmt, pairs, pair_tile):
    # above the register cap the long tile sums a chunk in the reference's
    # order for its length: one chain up to 24 pairs, 8 lanes up to 32,
    # windows of 32 beyond (denoise_ema.chunk_sums)
    frames = _wire((2, 2 * pairs, 16), fmt, seed=pair_tile)
    gpu = [torch.zeros(pairs, 16, 256, device=cuda), torch.zeros(16, 256, device=cuda),
           torch.zeros(16, 256, device=cuda)]
    cpu = [t.cpu() for t in gpu]
    for g in range(2):
        kw = dict(alpha=0.3, offset=4096.0, prior_count=7 + pairs * g, pair_tile=pair_tile,
                  stream_dtype=fmt)
        denoise_ema.ema_welford_step(*gpu, frames[g].to(cuda), **kw)
        cpu = list(denoise_ema.ema_welford_step_plain(*cpu, frames[g], **kw))
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu(), b)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    s = torch.zeros(4, 8, 256, device=cuda)
    with pytest.raises(NotImplementedError, match="float32, float16 and bfloat16"):
        denoise_stream.alg3_stream_step(
            torch.zeros(8, 8, 256, dtype=torch.uint16, device=cuda),
            s.to(torch.float64), num_groups=2)
    with pytest.raises(NotImplementedError, match="u8 wire"):  # no integer sum of u8 wire
        denoise_stream.alg3_stream_step(
            torch.zeros(8, 8, 256, dtype=torch.uint8, device=cuda),
            s.to(torch.int32), num_groups=2, stream_dtype="u8")
    with pytest.raises(NotImplementedError, match="float32"):  # the median window is a float
        denoise_median.median_window_insert(
            torch.zeros(2, 4, 8, 256, dtype=torch.int32, device=cuda),
            torch.zeros(8, 8, 256, dtype=torch.uint16, device=cuda), slot=0)
    with pytest.raises(TypeError):
        denoise_stream.alg3_stream_step(torch.zeros(8, 8, 256, device=cuda), s, num_groups=2)


@pytest.mark.parametrize("offset", [0.0, 4096.0], ids=["offset0", "offset4096"])
@pytest.mark.parametrize("divide_first", [False, True])
@pytest.mark.parametrize("accum", [torch.int32, torch.uint16], ids=["int32", "uint16"])
def test_integer_sums_bitwise_equal_plain(cuda, accum, divide_first, offset):
    # G = 10: a uint16 divide-last sum wraps past G = 8; offset 0 makes half the
    # differences negative, where a truncating division would differ from //
    g, n, h, w = 10, 12, 9, 132
    frames = _wire((2, g, n, h), "u16", seed=21, width=w)
    kw = dict(offset=offset, divide_first=divide_first, accum_dtype=accum)
    assert torch.equal(
        denoise_multibank.multibank_subtract_average(frames.to(cuda), **kw).cpu(),
        denoise_multibank.multibank_subtract_average_plain(frames, **kw))
    assert torch.equal(denoise_stream.alg3_subtract_average(frames[0].to(cuda), **kw).cpu(),
                       denoise_stream.alg3_subtract_average_plain(frames[0], **kw))
    kw = dict(offset=offset, divide_first=divide_first, num_groups=g)
    s = torch.zeros(2, n // 2, h, w, dtype=accum, device=cuda)
    sc = torch.zeros(2, n // 2, h, w, dtype=accum)
    before = denoise_stream.alg3_stream_step.scalar_launches
    for k in range(g):
        fin = k == g - 1  # the in-kernel final division on the last group
        chunk = frames[:, k].contiguous()
        denoise_multibank.multibank_stream_step(chunk.to(cuda), s, final=fin, **kw)
        sc = denoise_multibank.multibank_stream_step_plain(chunk, sc, final=fin, **kw)
        denoise_stream.alg3_stream_step(chunk[0].to(cuda), s[0], final=fin, **kw)
        sc[0] = denoise_stream.alg3_stream_step_plain(chunk[0], sc[0], final=fin, **kw)
    assert torch.equal(s.cpu(), sc)
    assert denoise_stream.alg3_stream_step.scalar_launches - before == g
    if not divide_first:  # B10: Alg 1 and Alg 2 with the same sums
        want = denoise_tmpframe.alg1_subtract_average_plain(frames[0], offset=offset,
                                                            accum_dtype=accum)
        for fn in (denoise_tmpframe.alg1_subtract_average,
                   denoise_tmpframe.alg2_subtract_average):
            got = fn(frames[0].to(cuda), offset=offset, accum_dtype=accum)
            assert got.dtype == accum and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("algorithm", ["alg3", "alg3_v2", "alg1"])
def test_uint16_pair_average_executors_match_cpu(cuda, algorithm):
    # the paper's u16-container stream on the card: every plain step left on
    # the executors' path (init, finalize's floor division) runs on uint16
    cfg = DenoiseConfig(num_groups=10, frames_per_group=16, height=80, width=256,
                        accum_dtype="uint16", algorithm=algorithm)
    groups = list(PrismSource(cfg, seed=2).groups())
    want = StreamingDenoiser(cfg, device="cpu").run(groups)
    assert want.dtype == torch.uint16
    for depth in (1, 2):
        out, _ = streaming.run_pipelined(cfg, iter(groups), num_slots=depth)
        assert out.dtype == torch.uint16 and torch.equal(out.cpu(), want)
    oneshot = StreamingDenoiser(cfg)(np.stack(groups)).cpu()
    assert torch.equal(oneshot, StreamingDenoiser(cfg, device="cpu")(np.stack(groups)))


@pytest.mark.parametrize("k", [65, 66, 100])
def test_median_combine_above_the_network_window(cuda, k):
    # integer-valued slots give ties; a fractional part makes (lo + hi) / 2 round
    rng = np.random.default_rng(k)
    window = rng.integers(4000, 4040, (k, 3, 7, 130)) + (rng.random((k, 3, 7, 130)) < 0.5) * 0.75
    window = torch.from_numpy(window.astype(np.float32))
    before = denoise_median.median_combine.select_launches
    got = denoise_median.median_combine(window.to(cuda))
    assert torch.equal(got.cpu(), denoise_median.median_combine_plain(window))
    assert denoise_median.median_combine.select_launches - before == 1


def test_spatial_kernel_refuses_a_float4_launch_its_rows_do_not_allow(cuda, monkeypatch):
    # the path is the host's choice; the kernel raises on a wrong one, never reroutes
    monkeypatch.setattr(denoise_spatial, "tile_path", lambda *a: "vector")
    with pytest.raises(RuntimeError, match="spatial_filter_3x3: CUDA launch failed"):
        denoise_spatial.spatial_filter_3x3(torch.zeros(2, 7, 130, device=cuda))


@pytest.mark.parametrize(
    "shape, shift, path",
    [((3, 80, 256), False, "vector"), ((2, 20, 132), False, "vector"),
     ((2, 1, 256), False, "vector"), ((2, 2, 8), False, "vector"),
     ((2, 7, 130), False, "scalar"), ((2, 80, 256), True, "scalar"),
     ((2, 5, 1), False, "scalar"), ((1, 17, 3), False, "scalar")],
    ids=["80x256", "partial-tiles-20x132", "H1", "H2-W8", "ragged-7x130",
         "80x256-unaligned-view", "W1", "17x3"],
)
def test_spatial_tiles_edges_and_paths(cuda, shape, shift, path):
    x = torch.from_numpy(
        (4096 + 40 * np.random.default_rng(sum(shape)).standard_normal(shape)).astype(np.float32))
    x[:, 0, -1] += 900.0  # a hot pixel on the tile edge
    fn = denoise_spatial.spatial_filter_3x3
    before = (fn.vector_launches, fn.scalar_launches)
    xd = _shifted(x, cuda) if shift else x.to(cuda)
    assert torch.equal(fn(xd, mode="box").cpu(), denoise_spatial.spatial_filter_3x3_plain(x))
    kw = dict(mode="bilateral", range_sigma=60.0)
    torch.testing.assert_close(fn(xd, **kw).cpu(), denoise_spatial.spatial_filter_3x3_plain(x, **kw),
                               rtol=denoise_spatial.BILATERAL_RTOL, atol=0)
    assert (fn.vector_launches - before[0], fn.scalar_launches - before[1]) == (
        (2, 0) if path == "vector" else (0, 2))


def test_executors_on_the_card_match_cpu(cuda):
    cfg = DenoiseConfig(num_groups=3, frames_per_group=16, height=80, width=256)
    want = StreamingDenoiser(cfg, device="cpu").run(PrismSource(cfg, seed=1).groups())
    before = denoise_stream.alg3_stream_step.launches
    for depth in (1, 2, 3):
        out, _ = streaming.run_pipelined(cfg, PrismSource(cfg, seed=1).groups(), num_slots=depth)
        assert torch.equal(out.cpu(), want)
    assert denoise_stream.alg3_stream_step.launches - before == 3 * cfg.num_groups


@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
def test_median_kernels_bitwise_equal_plain(cuda, fmt):
    frames = _wire((5, 16, 80), fmt, seed=11)
    w_gpu, w_cpu = torch.zeros(4, 8, 80, 256, device=cuda), torch.zeros(4, 8, 80, 256)
    for g in range(5):
        kw = dict(slot=g % 4, offset=4096.0, stream_dtype=fmt)
        denoise_median.median_window_insert(w_gpu, frames[g].to(cuda), **kw)
        denoise_median.median_window_insert_plain(w_cpu, frames[g], **kw)
        assert torch.equal(w_gpu.cpu(), w_cpu)
    for k in (1, 2, 3, 4):
        got = denoise_median.median_combine(w_gpu[:k])
        assert torch.equal(got.cpu(), denoise_median.median_combine_plain(w_cpu[:k]))
    wide = torch.randn(13, 8, 80, 256)  # a window longer than the unrolled kernels
    got = denoise_median.median_combine(wide.to(cuda))
    assert torch.equal(got.cpu(), denoise_median.median_combine_plain(wide))


@pytest.mark.parametrize("pair_tile", [1, 5, 8])
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
def test_ema_kernel_bitwise_equal_plain(cuda, fmt, pair_tile):
    frames = _wire((3, 80, 80), fmt, seed=12)
    gpu = [torch.zeros(40, 80, 256, device=cuda), torch.zeros(80, 256, device=cuda),
           torch.zeros(80, 256, device=cuda)]
    cpu = [t.cpu() for t in gpu]
    for g in range(3):
        kw = dict(alpha=0.3, offset=4096.0, prior_count=40 * g, pair_tile=pair_tile,
                  stream_dtype=fmt)
        denoise_ema.ema_welford_step(*gpu, frames[g].to(cuda), **kw)
        cpu = list(denoise_ema.ema_welford_step_plain(*cpu, frames[g], **kw))
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu(), b)


def test_spatial_kernel_matches_plain(cuda):
    x = 4096 + 40 * torch.randn(6, 80, 256)
    got = denoise_spatial.spatial_filter_3x3(x.to(cuda), mode="box")
    assert torch.equal(got.cpu(), denoise_spatial.spatial_filter_3x3_plain(x, mode="box"))
    got = denoise_spatial.spatial_filter_3x3(x.to(cuda), mode="bilateral", range_sigma=60.0)
    want = denoise_spatial.spatial_filter_3x3_plain(x, mode="bilateral", range_sigma=60.0)
    torch.testing.assert_close(got.cpu(), want, rtol=denoise_spatial.BILATERAL_RTOL, atol=0)


@pytest.mark.parametrize(
    "extra",
    [dict(filter_name="temporal_median", median_window=2),
     dict(filter_name="ema_variance", ema_mask_sigma=1.5),
     dict(filter_name="spatial_box", spatial_mode="box")],
    ids=["temporal_median", "ema_variance", "spatial_box"],
)
def test_filter_executors_on_the_card_match_cpu(cuda, extra):
    cfg = DenoiseConfig(num_groups=3, frames_per_group=16, height=80, width=256, **extra)
    want = StreamingDenoiser(cfg, device="cpu").run(PrismSource(cfg, seed=1).groups())
    for depth in (1, 2, 3):
        out, _ = streaming.run_pipelined(cfg, PrismSource(cfg, seed=1).groups(), num_slots=depth)
        assert torch.equal(out.cpu(), want)
    frames = torch.from_numpy(PrismSource(cfg, seed=1).all_frames()).to(cuda)
    assert torch.equal(StreamingDenoiser(cfg)(frames).cpu(), want)


def _tmpframe_paths():
    passes = (denoise_tmpframe.subtract_pass, denoise_tmpframe.reduce_pass)
    return [(f.vector_launches, f.scalar_launches) for f in passes]


#: B10's planes (N, H, W) and the path both passes take on them: 80 x 256,
#: whole vectors; 40 x 132 (a half row of 16 vectors and 4 pixels over, the
#: next row starting mid-vector: a scalar head and tail; 17 vectors, a
#: partial warp); 8 x 130 (partial vectors in every type); 7 x 130, whose
#: H*W = 910 is no multiple of a vector: the scalar paths
TMPFRAME_SHAPES = {"80x256": ((16, 80, 256), "vector"), "ragged": ((6, 7, 130), "scalar"),
                   "partial": ((14, 40, 132), "vector"), "rows-130": ((6, 8, 130), "vector")}


@pytest.mark.parametrize("g", [3, 5, 8, 65, 100])
@pytest.mark.parametrize("acc", FLOATS, ids=["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(TMPFRAME_SHAPES))
def test_tmpframe_kernels_bitwise_equal_plain(cuda, shape, acc, g):
    # G = 3 and 5: a division by G instead of the multiply by f32(1/G) would
    # differ; G = 65 and 100: bfloat16's true division on the vector path.
    # Seeded frames, and for G <= 8 also frames with 65535 and 0 (a float16
    # tmpFrame meets inf and inf - inf)
    (n, h, w), path = TMPFRAME_SHAPES[shape]
    f32 = acc == torch.float32
    inputs = [torch.from_numpy(
        np.random.default_rng(13 + g).integers(0, 4096, (g, n, h, w)).astype(np.uint16))]
    if g <= 8:
        inputs.append(_extreme_wire((g, n, h), "u16", seed=g, width=w))
    before = [denoise_tmpframe.alg1_subtract_average.launches,
              denoise_tmpframe.alg2_subtract_average.launches]
    paths = _tmpframe_paths()
    for frames in inputs:
        kw = dict(offset=4096.0, accum_dtype=acc)
        want = denoise_tmpframe.alg1_subtract_average_plain(frames, **kw)
        got1 = denoise_tmpframe.alg1_subtract_average(frames.to(cuda), **kw)
        got2 = denoise_tmpframe.alg2_subtract_average(frames.to(cuda), **kw)
        assert _same_bits(got1, want) and _same_bits(got2, want)
        tmp = denoise_tmpframe.subtract_pass(frames.to(cuda), burst=True, **kw)
        want_tmp = denoise_tmpframe.subtract_pass_plain(frames, **kw)
        assert _same_bits(tmp, want_tmp)
        # a tmpFrame view one element (2 bytes in a half type) into its buffer
        assert _same_bits(denoise_tmpframe.reduce_pass(_shifted(want_tmp, cuda)), want)
    assert [denoise_tmpframe.alg1_subtract_average.launches,
            denoise_tmpframe.alg2_subtract_average.launches] == [
                b + 2 * len(inputs) for b in before]
    k = len(inputs)
    took = [(v - v0, s - s0) for (v, s), (v0, s0) in zip(_tmpframe_paths(), paths)]
    assert took[0] == ((3 * k, 0) if path == "vector" else (0, 3 * k))  # pass A
    assert took[1] == ((2 * k, k) if path == "vector" else (0, 3 * k))  # pass B, the view scalar
    if f32 and g == 5 and shape == "80x256":
        frames = inputs[0]
        with pytest.raises(ValueError, match="'u8' ingest"):
            ops.subtract_average(frames[:, :, :, :128].to(torch.uint8).to(cuda),
                                 algorithm="alg1", stream_dtype="u8")
        with pytest.raises(NotImplementedError, match="float32, float16 and bfloat16"):
            denoise_tmpframe.alg1_subtract_average(frames.to(cuda), accum_dtype=torch.float64)


def test_tmpframe_kernels_refuse_a_vector_launch_their_operands_do_not_allow(cuda, monkeypatch):
    # the path is the host's choice; the kernels raise on a wrong one, never reroute
    monkeypatch.setattr(denoise_tmpframe, "tmpframe_path", lambda *a: "vector")
    frames = _wire((3, 6, 7), "u16", seed=3, width=130).to(cuda)
    for burst in (False, True):
        with pytest.raises(RuntimeError, match="tmpframe_subtract: CUDA launch failed"):
            denoise_tmpframe.subtract_pass(frames, burst=burst)
    tmp = torch.zeros(3, 3, 7, 130, device=cuda)
    with pytest.raises(RuntimeError, match="tmpframe_reduce: CUDA launch failed"):
        denoise_tmpframe.reduce_pass(tmp)
    with pytest.raises(RuntimeError, match="tmpframe_reduce: CUDA launch failed"):
        denoise_tmpframe.reduce_pass(tmp.to(torch.int32))


@pytest.mark.parametrize(
    "extra",
    [dict(), dict(filter_name="temporal_median", median_window=2),
     dict(filter_name="ema_variance"), dict(filter_name="spatial_box", spatial_mode="box")],
    ids=["pair_average", "temporal_median", "ema_variance", "spatial_box"],
)
def test_two_shard_banked_executor_on_one_card_matches_cpu(cuda, extra):
    cfg = DenoiseConfig(num_groups=3, frames_per_group=16, height=80, width=256,
                        num_banks=2, **extra)
    sources = [list(s) for s in PrismSource(cfg, seed=4).bank_sources(2)]
    want, _ = banks.run_pipelined_banked(cfg, [iter(s) for s in sources],
                                         banks.BankMesh(("cpu", "cpu")))
    got, rep = banks.run_pipelined_banked(cfg, [iter(s) for s in sources],
                                          banks.BankMesh(("cuda:0", "cuda:0")))
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    assert rep.frames == 2 * cfg.num_groups * cfg.frames_per_group


def _gated(groups, gate):
    gate.wait(60)
    yield from groups


@pytest.mark.parametrize(
    "extra",
    [dict(), dict(filter_name="temporal_median", median_window=2),
     dict(filter_name="ema_variance"), dict(filter_name="spatial_box", spatial_mode="box")],
    ids=["pair_average", "temporal_median", "ema_variance", "spatial_box"],
)
def test_one_session_service_on_the_card_equals_run_pipelined(cuda, extra):
    from repro_torch.serve import Session, SessionScheduler

    cfg = DenoiseConfig(num_groups=3, frames_per_group=16, height=80, width=256, **extra)
    groups = list(PrismSource(cfg, seed=2).groups())
    want, _ = streaming.run_pipelined(cfg, iter(groups))
    b2, b4 = denoise_stream.alg3_stream_step, denoise_multibank.multibank_stream_step
    before = (b2.launches, b4.launches)
    with SessionScheduler(slots_per_executor=1, max_executors=1) as sched:
        out, rep = sched.submit(Session(config=cfg, source=iter(groups))).result(timeout=120)
    assert out.device.type == "cuda" and torch.equal(out.cpu(), want.cpu())
    assert rep.groups == cfg.num_groups
    if cfg.filter_name in ("pair_average", "spatial_box"):  # the lone-slot path: B2 only
        assert (b2.launches - before[0], b4.launches - before[1]) == (cfg.num_groups, 0)


def test_four_session_full_cohort_on_the_card_equals_run_pipelined(cuda):
    import threading

    from repro_torch.serve import Session, SessionScheduler

    cfg = DenoiseConfig(num_groups=4, frames_per_group=64, height=80, width=256)
    base = list(PrismSource(cfg, seed=3).groups())
    per_session = [[g + np.uint16(16 * s) for g in base] for s in range(4)]
    wants = [streaming.run_pipelined(cfg, iter(g))[0].cpu() for g in per_session]
    b2, b4 = denoise_stream.alg3_stream_step, denoise_multibank.multibank_stream_step
    before = (b2.launches, b4.launches)
    gate = threading.Event()
    with SessionScheduler(slots_per_executor=4, max_executors=1, coalesce_ms=30_000) as sched:
        hs = [sched.submit(Session(config=cfg, source=_gated(g, gate), name=f"t{s}"))
              for s, g in enumerate(per_session)]
        deadline = time.monotonic() + 60
        while not all(h.status == "active" for h in hs):
            assert time.monotonic() < deadline, "sessions never joined"
            time.sleep(1e-3)
        gate.set()
        outs = [h.result(timeout=120)[0] for h in hs]
    for out, want in zip(outs, wants):
        assert torch.equal(out.cpu(), want)
    # every group one full-cohort step at B = 4, and no lone-slot step
    assert (b2.launches - before[0], b4.launches - before[1]) == (0, cfg.num_groups)


FLEET_FILTERS = pytest.mark.parametrize(
    "extra",
    [dict(), dict(filter_name="temporal_median", median_window=3),
     dict(filter_name="ema_variance"), dict(filter_name="spatial_box")],
    ids=["pair_average", "temporal_median", "ema_variance", "spatial_box"],
)


def _fleet_cfg(**extra):
    return DenoiseConfig(num_groups=5, frames_per_group=16, height=80, width=256, **extra)


@FLEET_FILTERS
@pytest.mark.parametrize("every", [1, 3])
def test_fleet_crash_recovery_on_the_card_equals_run_pipelined(cuda, tmp_path, extra, every):
    """Two sessions in full cohorts on ``ex0``, which crashes before its
    5th cohort; both restore (``every=1``: the checkpoint of fold 4;
    ``every=3``: that of fold 3 and a replay of one group) on ``ex1``."""
    import threading

    from repro_torch.serve import FaultPlan, FleetScheduler, Session

    cfg = _fleet_cfg(**extra)
    sources = [list(PrismSource(cfg, seed=s).groups()) for s in (1, 2)]
    wants = [streaming.run_pipelined(cfg, iter(g))[0].cpu() for g in sources]
    plan, gate = FaultPlan().crash("ex0", at_step=4), threading.Event()
    with FleetScheduler(checkpoint_dir=str(tmp_path), checkpoint_every=every, faults=plan,
                        slots_per_executor=2, max_executors=2, coalesce_ms=30_000) as fleet:
        hs = [fleet.submit(Session(config=cfg, source=_gated(g, gate), name=f"s{i}"))
              for i, g in enumerate(sources)]
        # one beat after ex0's next join pass: both sessions hold a slot
        # before any group exists, so every cohort is a full one
        assert fleet.check_faults(probe_timeout_s=60)["evicted"] == []
        gate.set()
        outs = [h.result(timeout=120) for h in hs]
    assert plan.crashed("ex0")
    for (out, rep), want in zip(outs, wants):
        assert out.device.type == "cuda" and torch.equal(out.cpu(), want)
        assert rep.restarts == 1 and rep.groups == cfg.num_groups
    resumed = "steps=4+0" if every == 1 else "steps=3+1"
    assert sorted(fleet.events) == ["dead@ex0:InjectedExecutorFailure",
                                    f"recover@s0->ex1:{resumed}", f"recover@s1->ex1:{resumed}"]


@FLEET_FILTERS
def test_fleet_migration_on_the_card_lands_on_it_and_equals_run_pipelined(cuda, tmp_path,
                                                                          extra):
    import threading

    from repro_torch.denoise.base import tree_leaves
    from repro_torch.serve import FleetScheduler, Session

    arrived = []

    class Recording(FleetScheduler):
        def _on_migrate(self, ex, act):
            super()._on_migrate(ex, act)
            arrived.extend(t.device for t in tree_leaves(act.resume_state)[0])

    cfg = _fleet_cfg(**extra)
    groups, other = (list(PrismSource(cfg, seed=s).groups()) for s in (4, 5))
    wants = [streaming.run_pipelined(cfg, iter(g))[0].cpu() for g in (groups, other)]
    gate, fed = threading.Event(), threading.Event()

    def src():
        yield from groups[:2]
        fed.set()
        assert gate.wait(60)
        yield from groups[2:]

    with Recording(checkpoint_dir=str(tmp_path), slots_per_executor=2,
                   max_executors=2) as fleet:
        h = fleet.submit(Session(config=cfg, source=src(), name="m0"))
        hb = fleet.submit(Session(config=cfg, source=iter(other), name="m1"))
        assert fed.wait(60)
        assert fleet.migrate(h, timeout=60) == "ex1"
        gate.set()
        outs = [h.result(timeout=120), hb.result(timeout=120)]
    assert arrived and all(d == torch.device("cuda", 0) for d in arrived)
    assert [rep.migrations for _, rep in outs] == [1, 0]
    for (out, _), want in zip(outs, wants):
        assert torch.equal(out.cpu(), want)


@FLEET_FILTERS
def test_fleet_checkpoint_at_fold_k_is_the_state_of_fold_k(cuda, tmp_path, extra):
    """Every checkpoint the fleet takes on its executor thread holds the
    state the step of that fold wrote on the card, bitwise."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.denoise.base import tree_leaves
    from repro_torch.serve import FleetScheduler, Session

    cfg = _fleet_cfg(**extra)
    groups = list(PrismSource(cfg, seed=6).groups())
    with FleetScheduler(checkpoint_dir=str(tmp_path), checkpoint_keep=cfg.num_groups,
                        slots_per_executor=1, max_executors=1) as fleet:
        fleet.submit(Session(config=cfg, source=iter(groups), name="c")).result(timeout=120)
    mgr = CheckpointManager(str(tmp_path / "c"), keep=cfg.num_groups)
    assert mgr.steps() == list(range(1, cfg.num_groups + 1))
    filt, state = banks.banked_filter_init(cfg, None, banks=1)
    sub = filt.slot_extract(state, 0)
    for k, g in enumerate(groups, start=1):
        sub = filt.step(sub, torch.from_numpy(g).to(cuda), step_index=k - 1)
        saved, step = mgr.restore(k, device="cuda")
        assert step == k
        for got, want in zip(tree_leaves(saved)[0], tree_leaves(sub)[0]):
            assert got.device.type == "cuda" and got.dtype == want.dtype
            assert torch.equal(got, want)


def test_elastic_reshard_on_the_card_is_bit_exact(cuda):
    from repro_torch.runtime.elastic import available_mesh, elastic_reshard, state_spec_tree

    rng = np.random.default_rng(9)
    state = {"mean": torch.from_numpy(rng.standard_normal((8, 80, 256)).astype(np.float32))
             .to(cuda), "count": torch.tensor(7, dtype=torch.int32, device=cuda)}
    mesh = available_mesh()
    assert mesh.devices[0] == torch.device("cuda", 0)
    moved = elastic_reshard(state, state_spec_tree(state), banks.BankMesh(("cuda:0",)))
    for k in state:
        assert moved[k].device == torch.device("cuda", 0) and torch.equal(moved[k], state[k])
    banked = torch.arange(4 * 6, dtype=torch.float32, device=cuda).reshape(4, 6)
    shards = elastic_reshard(banked, state_spec_tree(banked, axes={0: "bank"}),
                             banks.BankMesh(("cuda:0", "cuda:0")))
    assert torch.equal(torch.cat(shards), banked)


# ---------------------------------------------------------------------------
# Launch geometry: every tile a plan can give a row-tiled launcher.
# ---------------------------------------------------------------------------

#: kernel path -> (family in the launch model, wire format, vector path)
GEOMETRY_CASES = {
    "B2-vector-u16": ("stream", "u16", True),
    "B2-scalar-p12": ("stream", "p12", False),
    "B2-scalar-unaligned-u8": ("stream", "u8", False),
    "B2-int32": ("stream", "u16", False),
    "B4-vector-u8": ("stream", "u8", True),
    "B3-u16": ("stream", "u16", False),
    "B3-int32": ("stream", "u16", False),
    "B5-p12": ("stream", "p12", False),
    "B6-u16": ("median_insert", "u16", False),
    "B6-p12": ("median_insert", "p12", False),
    "B6-scalar-unaligned-u8": ("median_insert", "u8", False),
    "B10-alg1": ("stream", "u16", False),
    "B10-alg2": ("stream", "u16", False),
    "B10-alg1-float16": ("stream", "u16", False),
    "B10-alg1-bfloat16": ("stream", "u16", False),
    "B10-alg2-float16": ("stream", "u16", False),
    "B10-alg2-bfloat16": ("stream", "u16", False),
}


def _geometry_call(case, frames, device, tiles):
    """Run ``case``'s kernel (``device`` = "cpu": its plain version) at
    ``tiles`` on a fresh state; returns the result."""
    kw = dict(offset=4096.0, stream_dtype=GEOMETRY_CASES[case][1], **tiles)
    f = frames.to(device)
    if case.startswith(("B2", "B4")):
        one = f[0, 0] if case.startswith("B2") else f[:, 0].contiguous()
        if case.endswith("unaligned-u8") and device != "cpu":
            one = _shifted(one, device)
        n, h, wp = one.shape[-3:]
        acc = torch.int32 if case.endswith("int32") else torch.float32
        s = torch.zeros(one.shape[:-3] + (n // 2, h, quant.logical_width(wp, kw["stream_dtype"])),
                        dtype=acc, device=device)
        fn = denoise_stream.alg3_stream_step if case.startswith("B2") else \
            denoise_multibank.multibank_stream_step
        return fn(one, s, num_groups=3, final=True, **kw)
    if case.startswith("B3"):
        acc = torch.int32 if case.endswith("int32") else torch.float32
        return denoise_stream.alg3_subtract_average(f[0], accum_dtype=acc, **kw)
    if case.startswith("B5"):
        return denoise_multibank.multibank_subtract_average(f, **kw)
    if case.startswith("B6"):
        one = f[0, 0]
        if case.endswith("unaligned-u8") and device != "cpu":
            one = _shifted(one, device)
        n, h, wp = one.shape
        window = torch.zeros(2, n // 2, h, quant.logical_width(wp, kw["stream_dtype"]),
                             device=device)
        return denoise_median.median_window_insert(window, one, slot=1, **kw)
    kw.pop("stream_dtype")
    fn = denoise_tmpframe.alg1_subtract_average if case.startswith("B10-alg1") else \
        denoise_tmpframe.alg2_subtract_average
    acc = {"float16": torch.float16, "bfloat16": torch.bfloat16}.get(case.split("-")[-1],
                                                                     torch.float32)
    return fn(f[0], accum_dtype=acc, **kw)


@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
@pytest.mark.parametrize("shape", [(1000, 80, 256), (14, 40, 132)], ids=["paper", "partial"])
def test_every_admitted_geometry_bitwise_equal_plain(cuda, case, shape):
    # At the paper's shape every geometry the launch model admits; on 40 x
    # 132 (660 vectors a plane: a share of row_tile x 132 pixels leaves the
    # last block of a plane partial, and 132 columns a partial warp) every
    # pair of exact divisors, as a plan file may name them.
    from repro_torch.tune import budget

    family, fmt, vector = GEOMETRY_CASES[case]
    n, h, w = shape
    px = np.random.default_rng(n + h).integers(0, 4096, (2, 3, n, h, w)).astype(np.uint16)
    frames = torch.from_numpy(np.ascontiguousarray(quant.encode(px, fmt)))
    want = _geometry_call(case, frames, "cpu", {}).to(cuda)
    if shape[0] == 1000:
        geoms = budget.admitted_tiles(family, n // 2, h, w, stream_dtype=fmt, vector=vector,
                                      limits=budget.device_limits(cuda))
    else:
        geoms = [(None, None)] + [(th, tp) for th in range(1, h + 1) if h % th == 0
                                  for tp in range(1, n // 2 + 1) if (n // 2) % tp == 0]
    assert len(geoms) > 1
    b2 = denoise_stream.alg3_stream_step
    paths = (b2.vector_launches, b2.scalar_launches)
    b10_paths = _tmpframe_paths()
    b6_paths = _insert_paths()
    for th, tp in geoms:
        got = _geometry_call(case, frames, cuda, dict(row_tile=th, pair_tile=tp))
        assert torch.equal(got, want), (case, shape, th, tp)
    if case.startswith("B2"):  # every geometry on the path the case names
        taken = (b2.vector_launches - paths[0], b2.scalar_launches - paths[1])
        assert taken == ((len(geoms), 0) if vector else (0, len(geoms)))
    if case.startswith("B6"):  # the vector path validates the tiles, keeps its layout
        taken = tuple(a - b for a, b in zip(_insert_paths(), b6_paths))
        assert taken == ((0, len(geoms)) if case.endswith("unaligned-u8") else (len(geoms), 0))
    if case.startswith("B10"):  # both passes on their vector paths in every geometry
        taken = [(v - v0, s - s0) for (v, s), (v0, s0) in zip(_tmpframe_paths(), b10_paths)]
        assert taken == [(len(geoms), 0)] * 2


# ---------------------------------------------------------------------------
# Half-precision accumulators and p12 wire into integer sums.
# ---------------------------------------------------------------------------

HALF = (torch.float16, torch.bfloat16)


def _equal(a, b):
    return torch.equal(a.cpu(), b) or (
        a.dtype.is_floating_point and torch.allclose(a.cpu(), b, rtol=0, atol=0, equal_nan=True))


@pytest.mark.parametrize("shape", [(2, 16, 80, 256), (2, 8, 7, 130)], ids=["80x256", "ragged"])
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
@pytest.mark.parametrize("acc", HALF, ids=["float16", "bfloat16"])
@pytest.mark.parametrize("g", [5, 8, 65, 100])
def test_half_accumulator_kernels_b2_b5_b10_bitwise_equal_plain(cuda, g, acc, fmt, shape):
    b, n, h, w = shape
    frames = _wire((b, g, n, h), fmt, seed=g, width=w)
    for divide_first in (False, True):
        kw = dict(offset=4096.0, divide_first=divide_first, stream_dtype=fmt)
        got = denoise_multibank.multibank_subtract_average(frames.to(cuda), accum_dtype=acc, **kw)
        want = denoise_multibank.multibank_subtract_average_plain(frames, accum_dtype=acc, **kw)
        assert got.dtype == acc and _equal(got, want)
        s = torch.zeros(b, n // 2, h, w, dtype=acc, device=cuda)
        sc = s.cpu()
        for k in range(g):
            chunk = frames[:, k].contiguous()
            denoise_multibank.multibank_stream_step(chunk.to(cuda), s, num_groups=g, **kw)
            sc = denoise_multibank.multibank_stream_step_plain(chunk, sc, num_groups=g, **kw)
        assert _equal(s, sc)
    if fmt == "u16":  # B10: 7 x 130 (H*W = 910) takes pass A's scalar path
        x = frames[0]
        want = denoise_tmpframe.alg1_subtract_average_plain(x, offset=4096.0, accum_dtype=acc)
        paths = _tmpframe_paths()
        for fn in (denoise_tmpframe.alg1_subtract_average, denoise_tmpframe.alg2_subtract_average):
            assert _equal(fn(x.to(cuda), offset=4096.0, accum_dtype=acc), want)
        took = [(v - v0, s - s0) for (v, s), (v0, s0) in zip(_tmpframe_paths(), paths)]
        assert took == [(2, 0) if px % 8 == 0 else (0, 2) for px in (h * w, n // 2 * h * w)]


@pytest.mark.parametrize("accum", [torch.int32, torch.uint16], ids=["int32", "uint16"])
def test_p12_integer_sums_bitwise_equal_plain(cuda, accum):
    g = 10  # uint16 sums of 12-bit differences plus the offset wrap
    frames = _wire((2, g, 8, 16), "p12", seed=3, width=130)
    for divide_first in (False, True):
        kw = dict(offset=4096.0, divide_first=divide_first, stream_dtype="p12")
        got = denoise_multibank.multibank_subtract_average(frames.to(cuda), accum_dtype=accum, **kw)
        assert torch.equal(got.cpu(), denoise_multibank.multibank_subtract_average_plain(
            frames, accum_dtype=accum, **kw))
        s = torch.zeros(2, 4, 16, 130, dtype=accum, device=cuda)
        sc = s.cpu()
        for k in range(g):
            chunk = frames[:, k].contiguous()
            denoise_multibank.multibank_stream_step(chunk.to(cuda), s, num_groups=g, **kw)
            sc = denoise_multibank.multibank_stream_step_plain(chunk, sc, num_groups=g, **kw)
            denoise_stream.alg3_stream_step(chunk[0].to(cuda), s[0], num_groups=g, **kw)
            sc[0] = denoise_stream.alg3_stream_step_plain(chunk[0], sc[0], num_groups=g, **kw)
        assert torch.equal(s.cpu(), sc)


@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
@pytest.mark.parametrize("acc", HALF, ids=["float16", "bfloat16"])
def test_half_accumulator_kernels_b6_to_b9_bitwise_equal_plain(cuda, acc, fmt):
    frames = _wire((3, 12, 7), fmt, seed=5, width=130)
    window = torch.zeros(4, 6, 7, 130, dtype=acc, device=cuda)
    wc = window.cpu()
    for g in range(3):
        denoise_median.median_window_insert(window, frames[g].to(cuda), slot=g, offset=4096.0,
                                            stream_dtype=fmt)
        denoise_median.median_window_insert_plain(wc, frames[g], slot=g, offset=4096.0,
                                                  stream_dtype=fmt)
    assert _equal(window, wc)
    for k in (1, 2, 3, 65):
        win = window[:min(k, 3)] if k < 65 else window[torch.arange(k) % 3].contiguous()
        assert _equal(denoise_median.median_combine(win),
                      denoise_median.median_combine_plain(win.cpu()))
    for pair_tile in (1, 2, 6):
        gpu = [torch.zeros(6, 7, 130, dtype=acc, device=cuda),
               torch.zeros(7, 130, dtype=acc, device=cuda), torch.zeros(7, 130, dtype=acc, device=cuda)]
        cpu = [t.cpu() for t in gpu]
        for g in range(3):
            kw = dict(alpha=0.3, offset=4096.0, prior_count=6 * g, pair_tile=pair_tile,
                      stream_dtype=fmt)
            denoise_ema.ema_welford_step(*gpu, frames[g].to(cuda), **kw)
            cpu = list(denoise_ema.ema_welford_step_plain(*cpu, frames[g], **kw))
        for a, b in zip(gpu, cpu):
            assert _equal(a, b)
    avg = denoise_stream.alg3_subtract_average_plain(frames, offset=4096.0, accum_dtype=acc,
                                                     stream_dtype=fmt)
    assert _equal(denoise_spatial.spatial_filter_3x3(avg.to(cuda), mode="box"),
                  denoise_spatial.spatial_filter_3x3_plain(avg, mode="box"))
    rng = np.random.default_rng(30)
    smooth = (300 + 20 * torch.from_numpy(rng.standard_normal((4, 7, 130)))).to(acc)
    for x in (avg, smooth):  # around 300 the range weights are far from 0 and 1
        for sigma in (10.0, 60.0):
            got = denoise_spatial.spatial_filter_3x3(x.to(cuda), mode="bilateral", range_sigma=sigma)
            want = denoise_spatial.spatial_filter_3x3_plain(x, mode="bilateral", range_sigma=sigma)
            assert got.dtype == acc and _equal(got, want)


def _near_pairs(shape, seed, width=130, spread=12):
    """u16 frames whose control and excitation differ by at most ``spread``:
    at offset 0 a float16 M2 of their differences stays finite."""
    rng = np.random.default_rng(seed)
    px = rng.integers(64, 4032, shape + (width,)).astype(np.int32)
    px[..., 1::2, :, :] = px[..., 0::2, :, :] + rng.integers(-spread, spread + 1,
                                                             px[..., 1::2, :, :].shape)
    return px.astype(np.uint16)


@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
@pytest.mark.parametrize("acc", HALF, ids=["float16", "bfloat16"])
def test_half_ema_welford_step_finite_m2_bitwise_equal_plain(cuda, acc, fmt):
    frames = torch.from_numpy(np.ascontiguousarray(quant.encode(_near_pairs((3, 12, 7), 6), fmt)))
    for pair_tile in (1, 2, 6):
        gpu = [torch.zeros(6, 7, 130, dtype=acc, device=cuda),
               torch.zeros(7, 130, dtype=acc, device=cuda), torch.zeros(7, 130, dtype=acc, device=cuda)]
        cpu = [t.cpu().clone() for t in gpu]
        for g in range(3):
            kw = dict(alpha=0.3, offset=0.0, prior_count=6 * g, pair_tile=pair_tile,
                      stream_dtype=fmt)
            denoise_ema.ema_welford_step(*gpu, frames[g].to(cuda), **kw)
            cpu = list(denoise_ema.ema_welford_step_plain(*cpu, frames[g], **kw))
        for a, b in zip(gpu, cpu):
            assert _equal(a, b)
        assert torch.isfinite(cpu[2]).all() and bool((cpu[2] > 0).any())


@pytest.mark.parametrize("acc", HALF, ids=["float16", "bfloat16"])
@pytest.mark.parametrize(
    "extra",
    [dict(), dict(algorithm="alg3_v2", stream_dtype="u8"),
     dict(filter_name="temporal_median", median_window=2, stream_dtype="p12"),
     dict(filter_name="ema_variance", pair_tile=2), dict(filter_name="spatial_box", spatial_mode="box")],
    ids=["pair_average", "v2_u8", "median_p12", "ema", "box"],
)
def test_half_accumulator_filters_on_the_card_match_cpu(cuda, acc, extra):
    kw = dict(num_groups=5, frames_per_group=8, height=16, width=128,
              accum_dtype=str(acc).replace("torch.", ""), **extra)
    cfg = DenoiseConfig(**kw)
    frames = PrismSource(cfg, seed=2).all_frames()
    got = StreamingDenoiser(cfg, device=cuda)(frames)
    assert _equal(got, StreamingDenoiser(cfg, device="cpu")(frames))


def _ema_half_run(frames, acc, fmt, pair_tile, offset, hw, cuda):
    pairs = frames.shape[1] // 2
    gpu = [torch.zeros(pairs, *hw, dtype=acc, device=cuda), torch.zeros(hw, dtype=acc, device=cuda),
           torch.zeros(hw, dtype=acc, device=cuda)]
    cpu = [t.cpu().clone() for t in gpu]
    for g in range(frames.shape[0]):
        kw = dict(alpha=0.3, offset=offset, prior_count=pairs * g, pair_tile=pair_tile,
                  stream_dtype=fmt)
        denoise_ema.ema_welford_step(*gpu, frames[g].to(cuda), **kw)
        cpu = list(denoise_ema.ema_welford_step_plain(*cpu, frames[g], **kw))
    for a, b in zip(gpu, cpu):
        assert a.dtype == acc and _equal(a, b)
    return cpu


@pytest.mark.parametrize("pair_tile", [1, 2, 3, 4, 5, 6, 7, 8, 12, 27, 40])
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
@pytest.mark.parametrize("acc", HALF, ids=["float16", "bfloat16"])
def test_half_ema_kernel_every_tile_and_order_bitwise_equal_plain(cuda, acc, fmt, pair_tile):
    """Every register tile (1-8) and each long order (12: the chain, 27: the
    8 lanes, 40: the windows) of the one EMA body in a half type, on the
    paper's plane and a ragged one: at offset 4096 (a float16 M2 is NaN,
    as in the reference, held NaN to NaN) and on near pairs at offset 0 (a
    finite M2)."""
    chunks = 9 if pair_tile <= 8 else 2  # two chunk rounds, or two long chunks
    n = 2 * chunks * pair_tile
    for (h, w), seed in (((80, 256), 1), ((7, 130), 2)):
        frames = _wire((2, n, h), fmt, seed=seed + pair_tile, width=w)
        _ema_half_run(frames, acc, fmt, pair_tile, 4096.0, (h, w), cuda)
        near = torch.from_numpy(np.ascontiguousarray(quant.encode(
            _near_pairs((2, n, h), seed + 7 * pair_tile, width=w), fmt)))
        cpu = _ema_half_run(near, acc, fmt, pair_tile, 0.0, (h, w), cuda)
        assert torch.isfinite(cpu[2]).all() and bool((cpu[2] > 0).any())


@pytest.mark.parametrize(
    "shape, shift, path",
    [((3, 80, 256), 0, "vector"), ((2, 20, 132), 0, "vector"), ((2, 1, 256), 0, "vector"),
     ((2, 80, 256), 4, "vector"), ((2, 7, 130), 0, "scalar"), ((2, 80, 256), 1, "scalar"),
     ((2, 80, 256), 2, "scalar"), ((2, 5, 1), 0, "scalar")],
    ids=["80x256", "partial-tiles-20x132", "H1", "80x256-view-8-bytes-in", "ragged-7x130",
         "80x256-view-2-bytes-in", "80x256-view-4-bytes-in", "W1"],
)
@pytest.mark.parametrize("acc", HALF, ids=["float16", "bfloat16"])
def test_half_spatial_kernel_paths_bitwise_equal_plain(cuda, acc, shape, shift, path):
    """The one B9 tile body on half frames: four-pixel loads and stores
    where W % 4 == 0 and both planes are 8-byte aligned, scalar ones
    otherwise (W = 130, views 2 and 4 bytes off alignment); box and
    bilateral bitwise equal to the plain version on both paths."""
    rng = np.random.default_rng(sum(shape) + shift)
    fn = denoise_spatial.spatial_filter_3x3
    for base, noise in ((4096, 40), (300, 20)):
        x = (base + noise * torch.from_numpy(rng.standard_normal(shape))).to(acc)
        x[:, 0, -1] += 900.0  # a hot pixel on the tile edge
        buf = torch.empty(x.numel() + shift, dtype=acc, device=cuda)
        xd = buf[shift:].view(shape)
        xd.copy_(x)
        before = (fn.vector_launches, fn.scalar_launches)
        assert _equal(fn(xd, mode="box"), denoise_spatial.spatial_filter_3x3_plain(x, mode="box"))
        for sigma in (10.0, 60.0):
            kw = dict(mode="bilateral", range_sigma=sigma)
            got = fn(xd, **kw)
            assert got.dtype == acc and _equal(got, denoise_spatial.spatial_filter_3x3_plain(x, **kw))
        assert (fn.vector_launches - before[0], fn.scalar_launches - before[1]) == (
            (3, 0) if path == "vector" else (0, 3))


@pytest.mark.parametrize("every", [1, 3])
def test_bfloat16_fleet_session_recovers_on_the_card(cuda, tmp_path, every):
    """A bfloat16 session checkpoints on the card, its executor crashes, and
    it restores (through the host's ``V2`` leaves) and finishes bitwise
    equal to its run on the CPU."""
    from repro_torch.serve import FaultPlan, FleetScheduler, Session

    cfg = _fleet_cfg(filter_name="ema_variance", accum_dtype="bfloat16", pair_tile=4)
    groups = list(PrismSource(cfg, seed=3).groups())
    want = streaming.run_pipelined(cfg, iter(groups), device="cpu")[0]
    plan = FaultPlan().crash("ex0", at_step=3)
    with FleetScheduler(checkpoint_dir=str(tmp_path), checkpoint_every=every, faults=plan,
                        slots_per_executor=1, max_executors=2) as fleet:
        out, rep = fleet.submit(Session(config=cfg, source=iter(groups), name="b")).result(
            timeout=120)
    assert plan.crashed("ex0") and rep.restarts == 1
    assert out.device.type == "cuda" and out.dtype == torch.bfloat16
    assert torch.equal(out.cpu().view(torch.int16), want.view(torch.int16))
