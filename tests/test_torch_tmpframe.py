"""Port parity of the paper's Alg 1/2 baselines (B10,
``repro_torch.kernels.denoise_tmpframe``) against the JAX reference, on
the CPU.

The port's ``backend="auto"``/``"pallas"`` on a CPU tensor runs B10's
plain version and is held to the reference's ``backend="pallas"``
(Pallas interpret mode); ``"xla"`` is held to the reference's ``"xla"``.

Tolerance: **bitwise** everywhere. The reference's pass B sums the G
tmpFrames from zero in order and multiplies by ``f32(1/G)`` (XLA's rewrite
of the kernel's ``/ G``); a true division differs from that for G = 3 and
5, so those sizes are tested beside the paper's G = 8, and
``test_division_by_g_would_fail_these_tests`` shows that they tell the two
apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.denoise import DenoiseConfig as JConfig
from repro.core.denoise import StreamingDenoiser as JDenoiser
from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser
from repro_torch.kernels import denoise_tmpframe, ops

OFFSET = 4096.0
N, H, W = 16, 8, 128
ALGORITHMS = ("alg1", "alg2")


def _frames(g, seed, shape=(N, H, W)):
    return np.random.default_rng(seed).integers(0, 4096, (g,) + shape).astype(np.uint16)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want), float(np.abs(got - want).max())


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("g", [3, 5, 8])
def test_b10_plain_matches_reference_pallas_bitwise(g, algorithm, backend):
    x = _frames(g, seed=g)
    want = jops.subtract_average(
        jnp.asarray(x), offset=OFFSET, algorithm=algorithm, backend="pallas"
    )
    got = ops.subtract_average(
        torch.from_numpy(x), offset=OFFSET, algorithm=algorithm, backend=backend
    )
    _same(got, want)


@pytest.mark.parametrize("g", [3, 5])
def test_division_by_g_would_fail_these_tests(g):
    x = _frames(g, seed=g)
    want = np.asarray(jops.subtract_average(
        jnp.asarray(x), offset=OFFSET, algorithm="alg1", backend="pallas"))
    tmp = denoise_tmpframe.subtract_pass_plain(torch.from_numpy(x), offset=OFFSET)
    total = torch.zeros(tmp.shape[1:])
    for k in range(g):
        total = total + tmp[k]
    assert not np.array_equal((total / g).numpy(), want)
    _same(denoise_tmpframe.reduce_pass_plain(tmp), want)


@pytest.mark.parametrize("fmt", ["u16", "u8", "p12"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_xla_backend_matches_reference_xla(algorithm, fmt):
    px = _frames(5, seed=21, shape=(N, H, 2 * W))
    wire = jquant.encode(px, fmt)
    want = jops.subtract_average(
        jnp.asarray(wire), offset=OFFSET, algorithm=algorithm, backend="xla",
        stream_dtype=fmt,
    )
    got = ops.subtract_average(
        torch.from_numpy(wire), offset=OFFSET, algorithm=algorithm, backend="xla",
        stream_dtype=fmt,
    )
    _same(got, want)


@pytest.mark.parametrize("g", [5, 8])
def test_alg1_equals_alg2_and_alg3(g):
    x = torch.from_numpy(_frames(g, seed=30 + g))
    a1 = ops.subtract_average(x, offset=OFFSET, algorithm="alg1")
    a2 = ops.subtract_average(x, offset=OFFSET, algorithm="alg2")
    a3 = ops.subtract_average(x, offset=OFFSET, algorithm="alg3")
    assert torch.equal(a1, a2) and torch.equal(a1, a3)
    assert torch.equal(denoise_tmpframe.alg2_subtract_average(x, offset=OFFSET), a1)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_streaming_denoiser_one_shot_matches_reference(algorithm, backend):
    kw = dict(num_groups=5, frames_per_group=N, height=H, width=W, algorithm=algorithm)
    x = _frames(5, seed=40)
    want = JDenoiser(JConfig(**kw, backend="pallas"))(jnp.asarray(x))
    den = StreamingDenoiser(DenoiseConfig(**kw, backend=backend), device="cpu")
    before = denoise_tmpframe.alg1_subtract_average.launches
    _same(den(x), want)
    assert denoise_tmpframe.alg1_subtract_average.launches == before  # plain on the CPU
    # the streaming path of an Alg 1/2 config folds groups as Alg 3 does
    _same(den.run(list(x)), JDenoiser(JConfig(**kw, backend="pallas")).run(
        jnp.asarray(g) for g in x))


@pytest.mark.parametrize("fmt", ["u8", "p12"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_narrow_wire_with_pallas_raises_in_both_packages(algorithm, fmt):
    wire = jquant.encode(_frames(2, seed=50), fmt)
    with pytest.raises(ValueError) as want:
        jops.subtract_average(jnp.asarray(wire), algorithm=algorithm, backend="pallas",
                              stream_dtype=fmt)
    for backend in ("pallas", "auto"):  # the kernel's wire is u16 only
        with pytest.raises(ValueError) as got:
            ops.subtract_average(torch.from_numpy(wire), algorithm=algorithm,
                                 backend=backend, stream_dtype=fmt)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_banked_composite_matches_reference(algorithm, backend):
    x = np.stack([_frames(5, seed=60), _frames(5, seed=61)])
    want = jops.multibank_subtract_average(
        jnp.asarray(x), offset=OFFSET, algorithm=algorithm, backend=backend
    )
    got = ops.multibank_subtract_average(
        torch.from_numpy(x), offset=OFFSET, algorithm=algorithm, backend=backend
    )
    _same(got, want)


def test_wrappers_check_shapes_and_leave_launch_counts_on_the_cpu():
    counters = (denoise_tmpframe.alg1_subtract_average, denoise_tmpframe.alg2_subtract_average)
    before = [f.launches for f in counters]
    x = torch.from_numpy(_frames(3, seed=70))
    for f in counters:
        assert torch.equal(f(x, offset=OFFSET),
                           denoise_tmpframe.alg1_subtract_average_plain(x, offset=OFFSET))
        with pytest.raises(ValueError, match="N even"):
            f(x[:, :7])
        with pytest.raises(ValueError, match="G >= 1"):
            f(x[:0])
    assert [f.launches for f in counters] == before
    tmp = denoise_tmpframe.subtract_pass_plain(x, offset=OFFSET)
    assert tmp.shape == (3, N // 2, H, W) and tmp.dtype == torch.float32
    passes = (denoise_tmpframe.subtract_pass, denoise_tmpframe.reduce_pass)
    assert all(f.launches == f.vector_launches + f.scalar_launches for f in passes)


@pytest.mark.parametrize(
    "dtype, plane_px, ptrs, path",
    [(torch.float32, 80 * 256, (4096, 4096), "vector"),
     (torch.float16, 40 * 132, (4096, 8192), "vector"),
     (torch.bfloat16, 8 * 130, (0, 16), "vector"),
     (torch.float32, 7 * 130, (4096, 4096), "scalar"),  # 910: no whole float4s
     (torch.float16, 2 * 130, (4096, 4096), "scalar"),  # 260: no whole vectors of 8
     (torch.float32, 80 * 256, (4100, 4096), "scalar"),  # a view one float in
     (torch.bfloat16, 80 * 256, (4096, 4098), "scalar"),  # a view one half in
     (torch.int32, 80 * 256, (4096, 4096), "scalar"),
     (torch.uint16, 80 * 256, (4096, 4096), "scalar")],
    ids=["f32", "f16-40x132", "bf16-8x130", "f32-ragged", "f16-ragged", "f32-view",
         "bf16-view", "int32", "uint16"],
)
def test_tmpframe_path_takes_the_vector_path_where_every_plane_allows_it(
        dtype, plane_px, ptrs, path):
    # pass A's and pass B's vector: 16 bytes of tmpFrame, four float32 pixels
    # or eight half ones; integer tmpFrames have none
    assert denoise_tmpframe.VECTOR_PIXELS.get(dtype, 0) * dtype.itemsize in (0, 16)
    assert denoise_tmpframe.tmpframe_path(plane_px, dtype, *ptrs) == path
