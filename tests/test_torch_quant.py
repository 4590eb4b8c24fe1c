"""Port parity of the wire formats and the shared dequant prologue:
``repro_torch.kernels.quant`` against ``repro.kernels.quant``.

Tolerance: bitwise everywhere. The u8 prologue is compared with the
reference's *jitted* ``pair_diff_block`` (what its kernels compute), whose
first product XLA contracts into an FMA; the port reproduces that
rounding exactly (module docstring of ``repro_torch.kernels.quant``).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jquant
from repro_torch.kernels import quant, ref

FORMATS = ("u16", "u8", "p12")


def _pixels(shape, seed=0):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 4096, shape).astype(np.uint16)
    px.reshape(-1)[:4] = [0, 4095, 1, 4094]  # range endpoints round-trip
    return px


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", [(4, 8, 128), (2, 3, 5, 6)])
def test_encode_decode_byte_identical(fmt, shape):
    px = _pixels(shape)
    wire = quant.encode(px, fmt)
    ref_wire = jquant.encode(px, fmt)
    assert wire.dtype == ref_wire.dtype and np.array_equal(wire, ref_wire)
    back, ref_back = quant.decode(wire, fmt), jquant.decode(ref_wire, fmt)
    assert back.dtype == ref_back.dtype and np.array_equal(back, ref_back)


@pytest.mark.parametrize("fmt", FORMATS)
def test_width_helpers_match(fmt):
    for w in (2, 128, 256):
        assert quant.wire_width(w, fmt) == jquant.wire_width(w, fmt)
        wp = quant.wire_width(w, fmt)
        assert quant.logical_width(wp, fmt) == jquant.logical_width(wp, fmt)
    assert quant.wire_pixel_bytes(fmt) == jquant.wire_pixel_bytes(fmt)
    assert quant.container_dtype(fmt) == jquant.container_dtype(fmt)
    assert quant.container_name(fmt) == jquant.container_name(fmt)
    assert np.dtype(str(quant.container_torch_dtype(fmt)).split(".")[1]) == (
        jquant.container_dtype(fmt)
    )


def test_validation_errors_match():
    for call in (
        lambda q: q.validate_stream_dtype("u4"),
        lambda q: q.wire_width(7, "p12"),
        lambda q: q.logical_width(7, "p12"),
    ):
        with pytest.raises(ValueError) as a:
            call(quant)
        with pytest.raises(ValueError) as b:
            call(jquant)
        assert str(a.value) == str(b.value)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("offset", [0.0, 4096.0, 17.5])
def test_pair_diff_block_bitwise_vs_jitted(fmt, offset):
    w = 256 if fmt == "p12" else 128
    wire = quant.encode(_pixels((8, 8, w), seed=1), fmt)
    pairs = wire.reshape(4, 2, 8, -1)
    want = np.asarray(jax.jit(
        lambda b: jquant.pair_diff_block(
            b, offset=offset, accum_dtype=jnp.float32, stream_dtype=fmt
        )
    )(pairs))
    got = quant.pair_diff_block(
        torch.from_numpy(pairs), offset=offset, accum_dtype=torch.float32,
        stream_dtype=fmt,
    ).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("fmt", ["u16", "p12"])
def test_dequant_exact_formats_match(fmt):
    w = 256 if fmt == "p12" else 128
    wire = quant.encode(_pixels((3, 8, w), seed=2), fmt)
    want = np.asarray(jquant.dequant(jnp.asarray(wire), fmt, jnp.float32))
    got = quant.dequant(torch.from_numpy(wire), fmt, torch.float32).numpy()
    assert np.array_equal(got, want)


def test_uint16_containers_wrap_like_the_reference():
    x = np.array([0, 1, 4095, 65535], np.uint16)
    t = quant.widen(torch.from_numpy(x))
    assert t.dtype == torch.int32 and t.tolist() == [0, 1, 4095, 65535]
    wrapped = quant.narrow(t + 65530, torch.uint16)
    want = (jnp.asarray(x) + jnp.asarray(65530, jnp.uint16))
    assert np.array_equal(wrapped.numpy(), np.asarray(want))


def _exact_fma_ok(a, b, c, r) -> bool:
    """``r`` is the float32 nearest a*b+c (ties to even), checked exactly."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(r)
    lo = np.nextafter(r, np.float32(-np.inf))
    hi = np.nextafter(r, np.float32(np.inf))
    err = abs(exact - Fraction(float(r)))
    for nb in (lo, hi):
        d = abs(exact - Fraction(float(nb)))
        if d < err or (d == err and int(np.float32(nb).view(np.int32)) % 2 == 0):
            return False
    return True


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(3)
    a = (rng.integers(-4096, 8192, 3000) + rng.random(3000)).astype(np.float32)
    b = np.full(3000, np.float32(1) / np.float32(3), np.float32)
    b[1000:2000] = np.float32(1) / np.float32(5)
    b[2000:] = rng.random(1000).astype(np.float32)
    c = (rng.random(3000) * 6e4).astype(np.float32)
    # near-midpoint cases: c chosen so a*b+c sits close to a float32 tie
    c[:200] = (-(a[:200].astype(np.float64) * b[:200]) + 2.0**20 + 0.0625).astype(np.float32)
    r = ref.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    bad = [i for i in range(3000) if not _exact_fma_ok(a[i], b[i], c[i], r[i])]
    assert not bad, bad[:5]
