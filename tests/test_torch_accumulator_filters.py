"""Port parity of the other three filters (``temporal_median``,
``ema_variance``, ``spatial_box``) and their kernels' plain versions
(B6-B9) with float16, bfloat16 and 64-bit accumulators, against the
reference on the CPU. The kernels are held to the reference's Pallas
interpret mode and its XLA path; the filters to its ``StreamingDenoiser``
on the init/ingest/finalize path, the one-shot call and the banked path.

Tolerance: **bitwise**, output dtype included, except B9 ``bilateral``
in float32, within ``denoise_spatial.BILATERAL_RTOL`` (``exp`` differs
between XLA and PyTorch in the last float32 bit). A half type rounds each
weight to that type, where the two agree, and is held bitwise.

B8 in a half type sums each chunk in float32 (``jnp.mean`` and
``jnp.sum`` upcast), in XLA's order for the chunk's length; the lengths
here cover the chain (up to 24 pairs), the 8 lanes (25-32) and the
windows (above 32).
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
from repro_torch.kernels import denoise_spatial, ops

OFFSET = 4096.0
HALF = ("float16", "bfloat16")
FORMATS = ("u16", "u8", "p12")
H, W = 8, 64


def _wire(shape, fmt, seed):
    px = np.random.default_rng(seed).integers(0, 4096, shape + (W,)).astype(np.uint16)
    return jquant.encode(px, fmt)


def _near_pairs(lead, seed, *, spread=12, wide=48):
    """u16 frames ``lead + (H, W)`` whose control and excitation differ by at
    most ``spread`` (``wide`` on a few pixels): at offset 0 a float16 M2 of
    their differences stays finite."""
    rng = np.random.default_rng(seed)
    px = rng.integers(64, 4032, lead + (H, W)).astype(np.int32)
    step = np.full((H, W), spread)
    step[1::5, 2::9] = wide
    px[..., 1::2, :, :] = px[..., 0::2, :, :] + rng.integers(-step, step + 1, px[..., 1::2, :, :].shape)
    return px.astype(np.uint16)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy(), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x, x.dtype.name


def _same(got, want):
    (g, gd), (w, wd) = _np(got), _np(want)
    assert gd == wd and g.shape == w.shape, (gd, wd, g.shape, w.shape)
    assert np.array_equal(g, w, equal_nan=True), float(np.nanmax(np.abs(g.astype(np.float64) - w)))


def _close_bilateral(got, want):
    (g, gd), (w, wd) = _np(got), _np(want)
    assert gd == wd and g.shape == w.shape, (gd, wd, g.shape, w.shape)
    if gd == "float32":
        np.testing.assert_allclose(g, w, rtol=denoise_spatial.BILATERAL_RTOL, atol=0)
    else:
        _same(got, want)


def _torch(x, acc):
    return torch.from_numpy(np.asarray(jnp.asarray(x).astype(jnp.float32))).to(getattr(torch, acc))


# ---------------------------------------------------------------------------
# B6 / B7 / B8 / B9 at the kernel level.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("acc", HALF)
def test_median_kernels_b6_b7_half(acc, fmt):
    wire = _wire((4, 12, H), fmt, seed=1)
    for backend in ("pallas", "xla"):
        jw, tw = jnp.zeros((4, 6, H, W), acc), torch.zeros(4, 6, H, W, dtype=getattr(torch, acc))
        for g, slot in enumerate((2, 0, 1, 3)):
            jw = jops.median_window_insert(jw, jnp.asarray(wire[g]), slot=slot, offset=OFFSET,
                                           backend=backend, stream_dtype=fmt)
            ops.median_window_insert(tw, torch.from_numpy(wire[g]), slot=slot, offset=OFFSET,
                                     backend=backend, stream_dtype=fmt)
            _same(tw, jw)
        for k in (1, 2, 3, 4):  # even K averages the two middle ranks in the half type
            _same(ops.median_combine(tw[:k], backend=backend),
                  jops.median_combine(jw[:k], backend=backend))


def _ema_stream(pkg, x, wire, acc, *, backend, pair_tile, alpha=0.3, fmt="u16", offset=OFFSET):
    p = wire.shape[1] // 2
    state = tuple(x(np.zeros(s, np.float32), acc) for s in ((p, H, W), (H, W), (H, W)))
    for g in range(wire.shape[0]):
        state = pkg.ema_welford_step(
            *state, x(wire[g], None), alpha=alpha, offset=offset, prior_count=g * p,
            backend=backend, stream_dtype=fmt, pair_tile=pair_tile,
        )
    return state


def _jx(a, acc):
    return jnp.asarray(a) if acc is None else jnp.asarray(a).astype(acc)


def _tx(a, acc):
    return torch.from_numpy(a) if acc is None else torch.from_numpy(a).to(getattr(torch, acc))


@pytest.mark.parametrize(
    "pairs, pair_tile",
    [(10, None), (10, 1), (10, 2), (10, 5), (24, None), (27, None), (40, None), (40, 1)],
)
@pytest.mark.parametrize("acc", HALF)
def test_ema_welford_step_b8_half(acc, pairs, pair_tile):
    # at offset 4096 the first merge squares a delta near 4096, past
    # float16's 65504, and multiplies the inf by 0: M2 is NaN, as in the
    # reference, held with equal_nan (finite M2: the test below)
    for fmt in (FORMATS if pairs == 10 else ("u16",)):
        wire = _wire((3, 2 * pairs, H), fmt, seed=pairs)
        for backend in ("pallas", "xla"):
            if backend == "xla" and pair_tile:
                continue
            kw = dict(backend=backend, pair_tile=pair_tile, fmt=fmt)
            want = _ema_stream(jops, _jx, wire, acc, **kw)
            got = _ema_stream(ops, _tx, wire, acc, **kw)
            for g, w in zip(got, want):
                _same(g, w)


@pytest.mark.parametrize("pairs, pair_tile", [(10, None), (10, 2), (27, None), (40, None)])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("acc", HALF)
def test_ema_welford_step_b8_half_finite_m2(acc, fmt, pairs, pair_tile):
    # pair differences within +-12 (+-24 on a few pixels) and offset 0: the
    # float16 chunk sums of squares, the merges and M2 stay finite, so their
    # values are held and not only NaN against NaN
    wire = jquant.encode(_near_pairs((3, 2 * pairs), seed=pairs, wide=24), fmt)
    for backend in ("pallas", "xla"):
        if backend == "xla" and pair_tile:
            continue
        kw = dict(backend=backend, pair_tile=pair_tile, fmt=fmt, offset=0.0)
        want = _ema_stream(jops, _jx, wire, acc, **kw)
        got = _ema_stream(ops, _tx, wire, acc, **kw)
        for g, w in zip(got, want):
            _same(g, w)
        assert torch.isfinite(got[2]).all() and bool((got[2] > 0).any())


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("acc", HALF)
@pytest.mark.parametrize("name", ["ema_pallas", "ema_xla"])
def test_ema_variance_half_mask_on_finite_m2(name, acc, fmt):
    # finite M2 in float16 too, so the variance mask fires: the few wide
    # pixels are masked, and a mask that never fires gives another output
    kw = dict(num_groups=4, frames_per_group=8, height=H, width=W, accum_dtype=acc,
              stream_dtype=fmt, offset=0.0, **FILTERS[name])
    frames = jquant.encode(_near_pairs((4, 8), seed=7), fmt)
    den, jden = StreamingDenoiser(DenoiseConfig(**kw), device="cpu"), JDenoiser(JConfig(**kw))
    st = den.init()
    for k in range(4):
        st = den.ingest(st, torch.from_numpy(np.ascontiguousarray(frames[k])))
    assert torch.isfinite(st["wm2"]).all()
    got = den.finalize(st)
    _same(got, jden(jnp.asarray(frames)))
    unmasked = StreamingDenoiser(DenoiseConfig(**{**kw, "ema_mask_sigma": 1e3}), device="cpu")
    assert not torch.equal(got, unmasked(torch.from_numpy(frames)))


@pytest.mark.parametrize("acc", HALF + ("float32",))
def test_spatial_filter_b9_half(acc):
    # around 300 a half ulp is small beside the noise and the range weights
    # are far from 0 and 1, so a dropped neighbour or a wrong sigma moves
    # many outputs by several ulps
    for base, noise in ((4096, 40), (300, 20)):
        rng = np.random.default_rng(30)
        frames = (base + noise * rng.standard_normal((4, 16, W))).astype(np.float32)
        frames[:, 3, 5] += 900.0  # a hot pixel
        jf = jnp.asarray(frames).astype(acc)
        tf = _torch(jf, acc)
        for backend in ("pallas", "xla"):
            _same(ops.spatial_filter(tf, mode="box", backend=backend),
                  jops.spatial_filter(jf, mode="box", backend=backend))
            for sigma in (10.0, 60.0, 200.0):
                _close_bilateral(
                    ops.spatial_filter(tf, mode="bilateral", range_sigma=sigma, backend=backend),
                    jops.spatial_filter(jf, mode="bilateral", range_sigma=sigma, backend=backend))


# ---------------------------------------------------------------------------
# The filters through StreamingDenoiser.
# ---------------------------------------------------------------------------

FILTERS = {
    "temporal_median": dict(filter_name="temporal_median", median_window=4),
    "ema_pallas": dict(filter_name="ema_variance", backend="pallas", ema_alpha=0.3,
                       pair_tile=2, ema_mask_sigma=1.5),
    "ema_xla": dict(filter_name="ema_variance", backend="xla", ema_alpha=0.3,
                    ema_mask_sigma=1.5),
    "box": dict(filter_name="spatial_box", spatial_mode="box"),
    "bilateral": dict(filter_name="spatial_box", spatial_mode="bilateral",
                      spatial_range_sigma=30.0),
}


@pytest.mark.parametrize("g", [4, 5])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("acc", HALF + ("float64",))
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filters_with_accumulators(name, acc, fmt, g):
    check = _close_bilateral if name == "bilateral" else _same
    kw = dict(num_groups=g, frames_per_group=8, height=H, width=W, accum_dtype=acc,
              stream_dtype=fmt, **FILTERS[name])
    for banks in (None, 2):
        cfg = {**kw, "num_banks": banks or 1}
        den, jden = StreamingDenoiser(DenoiseConfig(**cfg), device="cpu"), JDenoiser(JConfig(**cfg))
        lead = (banks,) if banks else ()
        px = np.random.default_rng(g).integers(0, 4096, lead + (g, 8, H, W)).astype(np.uint16)
        frames = jquant.encode(px, fmt)
        st, jst = den.init(), jden.init()
        for k in range(g):
            chunk = np.ascontiguousarray(frames[:, k] if banks else frames[k])
            st = den.ingest(st, torch.from_numpy(chunk))
            jst = jden.ingest(jst, jnp.asarray(chunk))
        check(den.finalize(st), jden.finalize(jst))
        check(den(torch.from_numpy(frames)), jden(jnp.asarray(frames)))
