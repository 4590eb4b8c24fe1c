"""Port parity of the Hopper kernels' plain versions (B2-B5) against the
reference's ``repro.kernels.ops``, run as the reference's own tests run it
on the CPU: ``backend="pallas"`` (interpret mode) and ``backend="xla"``.

Tolerance: **bitwise**, for every wire format, both variants and
G in {3, 8}. That holds because the port follows the rounding of the
reference's jitted kernels (``repro_torch.kernels.ref`` docstring): the
u8 FMA prologue, ``x * f32(1/G)`` for ``x / G``, and
``fma(d, f32(1/G), s)`` for the divide-first fold. G = 3 is where those
differ from naive arithmetic; the kernels on the card are held to these
same plain versions by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro_torch.kernels import denoise_median, denoise_multibank, denoise_stream, ops, quant, ref

FORMATS = ("u16", "u8", "p12")
VARIANTS = ("divide_last", "divide_first")
OFFSET = 4096.0
N, H = 8, 8


def _wire(shape, fmt, seed):
    rng = np.random.default_rng(seed)
    w = 256 if fmt == "p12" else 128
    px = rng.integers(0, 4096, shape + (w,)).astype(np.uint16)
    return jquant.encode(px, fmt), w


def _algorithm(variant):
    return "alg3_v2" if variant == "divide_first" else "alg3"


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want), float(np.abs(got - want).max())


@pytest.mark.parametrize("g", [3, 8])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_stream_step_b2_bitwise(fmt, variant, g):
    wire, w = _wire((g, N, H), fmt, seed=g)
    for backend in ("pallas", "xla"):
        js = jops.stream_init(N, H, w)
        ts = ops.stream_init(N, H, w, device="cpu")
        for k in range(g):
            js = jops.stream_step(
                js, jnp.asarray(wire[k]), num_groups=g, offset=OFFSET,
                variant=variant, backend=backend, stream_dtype=fmt,
            )
            out = ops.stream_step(
                ts, torch.from_numpy(wire[k]), num_groups=g, offset=OFFSET,
                variant=variant, backend=backend, stream_dtype=fmt,
            )
            assert out is ts  # in place, as the reference donates
            _same(ts, js)
        _same(ops.stream_finalize(ts, g, variant=variant),
              jops.stream_finalize(js, g, variant=variant))


@pytest.mark.parametrize("g", [3, 8])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_subtract_average_b3_bitwise(fmt, variant, g):
    wire, _ = _wire((g, N, H), fmt, seed=10 + g)
    for backend in ("pallas", "xla"):
        want = jops.subtract_average(
            jnp.asarray(wire), offset=OFFSET, algorithm=_algorithm(variant),
            backend=backend, stream_dtype=fmt,
        )
        got = ops.subtract_average(
            torch.from_numpy(wire), offset=OFFSET, algorithm=_algorithm(variant),
            backend=backend, stream_dtype=fmt,
        )
        _same(got, want)


@pytest.mark.parametrize("g", [3, 8])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_multibank_stream_step_b4_bitwise(fmt, variant, g):
    wire, w = _wire((2, g, N, H), fmt, seed=20 + g)
    for backend in ("pallas", "xla"):
        js = jops.multibank_stream_init(2, N, H, w)
        ts = ops.multibank_stream_init(2, N, H, w, device="cpu")
        for k in range(g):
            js = jops.multibank_stream_step(
                js, jnp.asarray(wire[:, k]), num_groups=g, offset=OFFSET,
                variant=variant, backend=backend, stream_dtype=fmt,
            )
            ops.multibank_stream_step(
                ts, torch.from_numpy(np.ascontiguousarray(wire[:, k])),
                num_groups=g, offset=OFFSET, variant=variant, backend=backend,
                stream_dtype=fmt,
            )
            _same(ts, js)


@pytest.mark.parametrize("g", [3, 8])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_multibank_subtract_average_b5_bitwise(fmt, variant, g):
    wire, _ = _wire((2, g, N, H), fmt, seed=30 + g)
    for backend in ("pallas", "xla"):
        want = jops.multibank_subtract_average(
            jnp.asarray(wire), offset=OFFSET, algorithm=_algorithm(variant),
            backend=backend, stream_dtype=fmt,
        )
        got = ops.multibank_subtract_average(
            torch.from_numpy(wire), offset=OFFSET,
            algorithm=_algorithm(variant), backend=backend, stream_dtype=fmt,
        )
        # p12 + divide_first on "xla": the reference's compiler contracts the
        # first two groups' products the other way round (ref.xla_group_sum)
        _same(got, want)


@pytest.mark.parametrize("algorithm", ["alg1", "alg2"])
def test_tmpframe_baselines_on_cpu_match_xla(algorithm):
    wire, _ = _wire((3, N, H), "u16", seed=40)
    want = jops.subtract_average(
        jnp.asarray(wire), offset=OFFSET, algorithm=algorithm, backend="xla"
    )
    got = ops.subtract_average(
        torch.from_numpy(wire), offset=OFFSET, algorithm=algorithm, backend="xla"
    )
    _same(got, want)
    banked, _ = _wire((2, 3, N, H), "u16", seed=41)
    want = jops.multibank_subtract_average(
        jnp.asarray(banked), offset=OFFSET, algorithm=algorithm, backend="xla"
    )
    got = ops.multibank_subtract_average(
        torch.from_numpy(banked), offset=OFFSET, algorithm=algorithm, backend="xla"
    )
    _same(got, want)


@pytest.mark.parametrize("accum", ["int32", "uint16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_integer_accumulators_match_xla(accum, variant):
    g = 10  # divide-last overflows the u16 container past G = 8
    wire, w = _wire((g, N, H), "u16", seed=50)
    js = jops.stream_init(N, H, w, jnp.dtype(accum))
    ts = ops.stream_init(N, H, w, accum, device="cpu")
    for k in range(g):
        js = jops.stream_step(js, jnp.asarray(wire[k]), num_groups=g,
                              offset=OFFSET, variant=variant, backend="xla")
        ops.stream_step(ts, torch.from_numpy(wire[k]), num_groups=g,
                        offset=OFFSET, variant=variant, backend="xla")
    _same(ts, js)
    _same(ops.stream_finalize(ts, g, variant=variant),
          jops.stream_finalize(js, g, variant=variant))


# ---------------------------------------------------------------------------
# Dispatch: same error texts as the reference; no silent substitutes.
# ---------------------------------------------------------------------------

FRAMES = np.zeros((2, 4, 8, 32), np.uint16)
BANKED = np.zeros((2, 2, 4, 8, 32), np.uint16)
STATE = np.zeros((2, 8, 32), np.float32)
BANKED_STATE = np.zeros((2, 2, 8, 32), np.float32)

ERROR_CALLS = {
    "subtract_average_algorithm": lambda o, x: o.subtract_average(x(FRAMES), algorithm="alg9"),
    "subtract_average_backend": lambda o, x: o.subtract_average(x(FRAMES), backend="fpga"),
    "multibank_algorithm": lambda o, x: o.multibank_subtract_average(x(BANKED), algorithm="alg0"),
    "multibank_backend": lambda o, x: o.multibank_subtract_average(x(BANKED), backend="hls"),
    "multibank_pallas_alg1": lambda o, x: o.multibank_subtract_average(
        x(BANKED), algorithm="alg1", backend="pallas"),
    "alg1_pallas_u8": lambda o, x: o.subtract_average(
        x(FRAMES.astype(np.uint8)), algorithm="alg1", backend="pallas", stream_dtype="u8"),
    "stream_step_backend": lambda o, x: o.stream_step(
        x(STATE), x(FRAMES[0]), num_groups=2, backend="verilog"),
    "multibank_step_backend": lambda o, x: o.multibank_stream_step(
        x(BANKED_STATE), x(BANKED[:, 0]), num_groups=2, backend="axi"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CALLS))
def test_dispatch_errors_match_reference(case):
    call = ERROR_CALLS[case]
    with pytest.raises(ValueError) as want:
        call(jops, jnp.asarray)
    with pytest.raises(ValueError) as got:
        call(ops, torch.from_numpy)
    assert str(got.value) == str(want.value)


def test_dispatch_constants_match_reference():
    for name in ("ALGORITHMS", "BACKENDS", "SPATIAL_MODES", "STREAM_DTYPES", "TILE_PLANS"):
        assert getattr(ops, name) == getattr(jops, name)


def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    wire, w = _wire((3, N, H), "u16", seed=60)
    counters = [
        denoise_stream.alg3_stream_step, denoise_stream.alg3_subtract_average,
        denoise_multibank.multibank_stream_step,
        denoise_multibank.multibank_subtract_average,
    ]
    before = [f.launches for f in counters]
    frames = torch.from_numpy(wire)
    out = denoise_stream.alg3_subtract_average(frames, offset=OFFSET)
    plain = denoise_stream.alg3_subtract_average_plain(frames, offset=OFFSET)
    assert torch.equal(out, plain)
    s = torch.zeros(N // 2, H, w)
    denoise_stream.alg3_stream_step(frames[0], s, num_groups=3, offset=OFFSET)
    assert [f.launches for f in counters] == before


def test_wrappers_reject_bad_shapes_and_mixed_devices():
    s = torch.zeros(4, 8, 32)
    with pytest.raises(ValueError):
        ops.stream_step(s, torch.zeros(8, 8, 16, dtype=torch.uint16), num_groups=2)
    with pytest.raises(ValueError):
        denoise_stream.on_cuda(s, torch.zeros(1, device="meta"))


def test_ignored_tile_arguments_do_not_change_results():
    wire, _ = _wire((3, N, H), "u8", seed=70)
    frames = torch.from_numpy(wire)
    a = ops.subtract_average(frames, offset=OFFSET, stream_dtype="u8")
    b = ops.subtract_average(frames, offset=OFFSET, stream_dtype="u8",
                             row_tile=4, pair_tile=2, placement="compiler")
    assert torch.equal(a, b)


@pytest.mark.parametrize(
    "plane_px, fmt, frames_ptr, sum_ptr, want",
    [
        (80 * 256, "u16", 0x1000, 0x2000, "vector"),   # the paper's plane, allocator-aligned
        (80 * 256, "u8", 0x1008, 0x2000, "vector"),    # u8 loads need 8-byte starts
        (80 * 256, "p12", 0x1000, 0x2000, "scalar"),   # p12 has no vector path
        (7 * 130, "u16", 0x1000, 0x2000, "scalar"),    # ragged: H*W not a multiple of 8
        (7 * 130, "p12", 0x1000, 0x2000, "scalar"),
        (80 * 256, "u16", 0x1008, 0x2000, "scalar"),   # a u16 view 8 bytes in
        (80 * 256, "u8", 0x1004, 0x2000, "scalar"),
        (80 * 256, "u8", 0x1008, 0x2004, "scalar"),    # u8 with the sum a float in
        (8 * 136, "u8", 0x1000, 0x2000, "vector"),     # 136 vectors: a partial warp and block
        (80 * 256, "u16", 0x1000, 0x2004, "scalar"),   # the sum a float in
        (8, "u16", 0x1000, 0x2000, "vector"),          # one vector per plane
    ],
)
def test_step_path_takes_vectors_only_where_every_plane_allows(
        plane_px, fmt, frames_ptr, sum_ptr, want):
    assert denoise_stream.step_path(plane_px, fmt, frames_ptr, sum_ptr) == want


@pytest.mark.parametrize(
    "plane_px, fmt, frames_ptr, out_ptr, want",
    [
        (80 * 256, "u16", 0x1000, 0x2000, "vector"),   # the paper's plane, allocator-aligned
        (80 * 256, "u8", 0x1000, 0x2000, "vector"),
        (80 * 256, "p12", 0x1000, 0x2000, "vector"),
        (80 * 256, "p12", 0x1008, 0x2000, "vector"),   # p12's 8-byte loads: 8-byte starts
        (80 * 256, "p12", 0x1004, 0x2000, "scalar"),
        (80 * 256, "p12", 0x1003, 0x2000, "scalar"),   # a view one p12 item in
        (80 * 256, "u8", 0x1008, 0x2000, "scalar"),    # u8's 16-byte loads: 16-byte starts
        (80 * 256, "u16", 0x1008, 0x2000, "scalar"),   # a u16 view 8 bytes in
        (80 * 256, "u16", 0x1002, 0x2000, "scalar"),   # a u16 view one pixel in
        (80 * 256, "u16", 0x1000, 0x2008, "scalar"),   # the output 8 bytes in
        (80 * 256, "p12", 0x1000, 0x2004, "scalar"),
        (7 * 130, "u16", 0x1000, 0x2000, "scalar"),    # ragged: H*W not a multiple of 8
        (7 * 130, "p12", 0x1000, 0x2000, "scalar"),
        (4 * 130, "u16", 0x1000, 0x2000, "vector"),    # 65 vectors of 8
        (4 * 130, "u8", 0x1000, 0x2000, "scalar"),     # 520 is no multiple of 16
        (4 * 130, "p12", 0x1000, 0x2000, "scalar"),
        (40 * 136, "u8", 0x1000, 0x2000, "vector"),    # 340 vectors: a partial block and warp
        (8, "u16", 0x1000, 0x2000, "vector"),          # one vector per plane
        (8, "u8", 0x1000, 0x2000, "scalar"),           # half a u8 vector
        (16, "p12", 0x1000, 0x2000, "vector"),
    ],
)
def test_oneshot_path_takes_vectors_only_where_every_plane_allows(
        plane_px, fmt, frames_ptr, out_ptr, want):
    assert denoise_stream.oneshot_path(plane_px, fmt, frames_ptr, out_ptr) == want


def test_oneshot_path_of_real_tensors_follows_their_storage():
    # every plane of a contiguous (G, N, H, wire_W) tensor starts where the
    # first does plus a multiple of the vector's bytes, so the base pointer
    # decides; PyTorch's allocators align a fresh tensor to 64 bytes or more
    out = torch.zeros(4, 80, 256)
    for fmt, elements_in, want in (("u16", 8, "vector"), ("u16", 4, "scalar"),
                                   ("u8", 16, "vector"), ("u8", 8, "scalar"),
                                   ("p12", 8, "vector"), ("p12", 3, "scalar")):
        wire_w = quant.wire_width(256, fmt)
        dtype = quant.container_torch_dtype(fmt)
        frames = torch.zeros(3, 8, 80, wire_w, dtype=dtype)
        assert denoise_stream.oneshot_path(80 * 256, fmt, frames.data_ptr(),
                                           out.data_ptr()) == "vector"
        view = torch.zeros(frames.numel() + elements_in, dtype=dtype)[elements_in:]
        view = view.view(frames.shape)
        assert denoise_stream.oneshot_path(80 * 256, fmt, view.data_ptr(), out.data_ptr()) == want
    with pytest.raises(ValueError):
        denoise_stream.oneshot_path(80 * 256, "u12", 0, 0)


@pytest.mark.parametrize(
    "plane_px, fmt, frames_ptr, slot_ptr, want",
    [
        (80 * 256, "u16", 0x1000, 0x2000, "vector"),   # the paper's plane, allocator-aligned
        (80 * 256, "u8", 0x1000, 0x2000, "vector"),
        (80 * 256, "p12", 0x1000, 0x2000, "vector"),
        (80 * 256, "p12", 0x1008, 0x2000, "vector"),   # p12's 8-byte loads: 8-byte starts
        (80 * 256, "p12", 0x1003, 0x2000, "scalar"),   # a view one p12 item in
        (80 * 256, "u8", 0x1008, 0x2000, "scalar"),    # u8's 16-byte loads: 16-byte starts
        (80 * 256, "u16", 0x1002, 0x2000, "scalar"),   # a u16 view one pixel in
        (80 * 256, "u16", 0x1000, 0x2008, "scalar"),   # a slot 8 bytes in
        (80 * 256, "u8", 0x1000, 0x2002, "scalar"),    # a half slot one pixel in
        (7 * 130, "u16", 0x1000, 0x2000, "scalar"),    # ragged: H*W not a multiple of 8
        (7 * 130, "p12", 0x1000, 0x2000, "scalar"),
        (4 * 130, "u16", 0x1000, 0x2000, "vector"),    # 65 vectors of 8
        (4 * 130, "u8", 0x1000, 0x2000, "scalar"),     # 520 is no multiple of 16
        (16, "p12", 0x1000, 0x2000, "vector"),         # one vector per plane
    ],
)
def test_insert_path_takes_vectors_only_where_every_plane_allows(
        plane_px, fmt, frames_ptr, slot_ptr, want):
    assert denoise_median.insert_path(plane_px, fmt, frames_ptr, slot_ptr) == want


@pytest.mark.parametrize("acc", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["float32", "float16", "bfloat16"])
def test_insert_path_of_real_windows_follows_the_slot_and_the_frames(acc):
    # every slot of a contiguous (K, N/2, H, W) window starts a whole number
    # of vectors in, for every window type, where H*W takes the vector; a
    # window or frames one element into their storage do not
    for fmt, (h, w), want in (("u16", (80, 256), "vector"), ("u8", (80, 256), "vector"),
                              ("p12", (80, 256), "vector"), ("u16", (4, 130), "vector"),
                              ("u8", (4, 130), "scalar"), ("p12", (7, 130), "scalar")):
        window = torch.zeros(5, 4, h, w, dtype=acc)
        frames = torch.zeros(8, h, quant.wire_width(w, fmt), dtype=quant.container_torch_dtype(fmt))
        for slot in range(5):
            assert denoise_median.insert_path(h * w, fmt, frames.data_ptr(),
                                              window[slot].data_ptr()) == want, (fmt, slot)
        moved = torch.zeros(window.numel() + 1, dtype=acc)[1:].view(window.shape)
        assert denoise_median.insert_path(h * w, fmt, frames.data_ptr(),
                                          moved[2].data_ptr()) == "scalar"
        moved = torch.zeros(frames.numel() + 1, dtype=frames.dtype)[1:].view(frames.shape)
        assert denoise_median.insert_path(h * w, fmt, moved.data_ptr(),
                                          window[2].data_ptr()) == "scalar"


def test_bf16_reciprocal_product_rounds_as_the_true_division():
    # the rule the one-shot's vector path divides bfloat16 values by: for
    # G <= 64, round_bf16(x * f32(1/G)) == round_bf16(f32(x / G)) for every
    # one of the 65,536 bfloat16 x (NaN to NaN), in IEEE float32 arithmetic
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    x = x.float()
    nan = torch.isnan(x)
    for g in range(1, 65):
        rcp = torch.tensor(ref.reciprocal(g, torch.bfloat16), dtype=torch.float32)
        got = (x * rcp).to(torch.bfloat16)
        want = (x / torch.tensor(g, dtype=torch.float32)).to(torch.bfloat16)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int16), want[~nan].view(torch.int16)), g


@pytest.mark.parametrize(
    "acc, fmt, integer_sums, ok",
    [
        (torch.float32, "u16", False, True),
        (torch.float32, "p12", True, True),
        (torch.int32, "u16", True, True),     # the Alg 1-3 kernels' integer sums
        (torch.uint16, "u16", True, True),
        (torch.int32, "u16", False, False),   # a kernel without them (B6, B8)
        (torch.int32, "u8", True, False),     # no integer sum of u8 wire
        (torch.uint16, "p12", True, True),    # integer sums take u16 and p12 wire
        (torch.float64, "u16", True, False),
        (torch.float16, "u8", False, True),   # every kernel takes the half types
        (torch.bfloat16, "p12", True, True),
    ],
)
def test_kernel_operands_take_integer_sums_only_from_u16_wire(acc, fmt, integer_sums, ok):
    w = 8
    frames = torch.zeros(4, 2, quant.wire_width(w, fmt), dtype=quant.container_torch_dtype(fmt))
    out = torch.zeros(2, 2, w, dtype=acc)
    if ok:
        assert denoise_stream.check_kernel_operands(frames, out, fmt, integer_sums=integer_sums)
    else:
        with pytest.raises(NotImplementedError, match="run on the CPU"):
            denoise_stream.check_kernel_operands(frames, out, fmt, integer_sums=integer_sums)


def test_step_path_rejects_unknown_wire_format():
    with pytest.raises(ValueError):
        denoise_stream.step_path(80 * 256, "u12", 0, 0)


def test_step_path_of_real_tensors_follows_their_storage():
    # every plane of a contiguous (P, H, W) tensor starts where the first does
    # plus a multiple of 8 pixels, so the base pointer decides; PyTorch's
    # allocators align a fresh tensor to 64 bytes or more
    frames = torch.zeros(8, 80, 256, dtype=torch.uint16)
    s = torch.zeros(4, 80, 256)
    assert denoise_stream.step_path(80 * 256, "u16", frames.data_ptr(), s.data_ptr()) == "vector"
    view = torch.zeros(8 * 80 * 256 + 1, dtype=torch.uint16)[1:].view(8, 80, 256)
    assert denoise_stream.step_path(80 * 256, "u16", view.data_ptr(), s.data_ptr()) == "scalar"
