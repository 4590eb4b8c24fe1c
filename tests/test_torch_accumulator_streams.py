"""Port parity of the ``pair_average`` filter with float16, bfloat16 and
64-bit accumulators against the reference's ``StreamingDenoiser``, on the
CPU: init/ingest/partial/finalize, the one-shot call, and the banked path
(``num_banks=2``), for Alg 1-3 and every wire format.

Rounding rules and tolerance as in ``test_torch_accumulators.py``:
**bitwise**, output dtype included, but for the reference's declared
float32 band of its banked XLA path (p12, Alg 3 v2, G = 5). The one-shot
Alg 1/2 calls are held on ``pallas`` and ``xla`` in both packages: for a
half type the reference's two paths differ from each other (its XLA path
sums the tmpFrame in float32, its Pallas baseline in the half type), and
its ``auto`` on the CPU is the XLA path while the port's is the kernels'
plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.denoise import DenoiseConfig as JConfig
from repro.core.denoise import StreamingDenoiser as JDenoiser
from repro.kernels import quant as jquant
from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser

HALF = ("float16", "bfloat16")
FORMATS = ("u16", "u8", "p12")
N, H, W = 8, 8, 128


def _np(x):
    """A reference or port array as numpy, bfloat16 as ``"bfloat16"``."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy(), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x, x.dtype.name


def _same(got, want, rtol=0.0):
    (g, gd), (w, wd) = _np(got), _np(want)
    assert gd == wd and g.shape == w.shape, (gd, wd, g.shape, w.shape)
    if rtol:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0)
    else:
        assert np.array_equal(g, w, equal_nan=True), float(np.nanmax(np.abs(
            g.astype(np.float64) - w)))


def _frames(kw, seed, banks=None):
    lead = (banks,) if banks else ()
    px = np.random.default_rng(seed).integers(
        0, 4096, lead + (kw["num_groups"], N, H, W)).astype(np.uint16)
    return jquant.encode(px, kw["stream_dtype"])


def _stream_paths(kw, seed, oneshot_backends=(None,), rtol=0.0):
    """Hold the three paths of one config to the reference's."""
    for banks in (None, 2):
        cfg = {**kw, "num_banks": banks or 1}
        den, jden = StreamingDenoiser(DenoiseConfig(**cfg), device="cpu"), JDenoiser(JConfig(**cfg))
        frames = _frames(kw, seed, banks)
        st, jst = den.init(), jden.init()
        for g in range(kw["num_groups"]):
            chunk = np.ascontiguousarray(frames[:, g] if banks else frames[g])
            st = den.ingest(st, torch.from_numpy(chunk))
            jst = jden.ingest(jst, jnp.asarray(chunk))
            _same(den.partial(st, g), jden.partial(jst, g))
        _same(den.finalize(st), jden.finalize(jst))
        for backend in oneshot_backends:
            if banks and backend == "pallas":
                continue  # no banked Alg 1/2 kernel, in either package
            one = {**cfg, "backend": backend} if backend else cfg
            _same(StreamingDenoiser(DenoiseConfig(**one), device="cpu")(torch.from_numpy(frames)),
                  JDenoiser(JConfig(**one))(jnp.asarray(frames)), rtol=rtol if banks else 0.0)


@pytest.mark.parametrize("g", [4, 5, 8])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("algorithm", ["alg3", "alg3_v2"])
@pytest.mark.parametrize("acc", HALF + ("float64",))
def test_pair_average_alg3_accumulators(acc, algorithm, fmt, g):
    kw = dict(num_groups=g, frames_per_group=N, height=H, width=W, accum_dtype=acc,
              algorithm=algorithm, stream_dtype=fmt)
    # the reference's banked XLA one-shot sits one float32 ulp off its own
    # Pallas path for p12, Alg 3 v2 and G not a power of two (declared)
    declared = acc == "float64" and fmt == "p12" and algorithm == "alg3_v2" and g == 5
    _stream_paths(kw, seed=g, rtol=2.0 ** -23 if declared else 0.0)


@pytest.mark.parametrize("fmt", ["u16", "p12"])
@pytest.mark.parametrize("algorithm", ["alg1", "alg2"])
@pytest.mark.parametrize("acc", HALF + ("float64",))
def test_pair_average_alg1_alg2_accumulators(acc, algorithm, fmt):
    kw = dict(num_groups=5, frames_per_group=N, height=H, width=W, accum_dtype=acc,
              algorithm=algorithm, stream_dtype=fmt)
    # the reference's Pallas baselines take no 64-bit accumulator (they
    # store its float32 values into a float64 ref) and no narrow wire
    pallas = fmt == "u16" and acc != "float64"
    _stream_paths(kw, seed=30, oneshot_backends=("xla", "pallas") if pallas else ("xla",))


@pytest.mark.parametrize("fmt", ["u16", "p12"])
@pytest.mark.parametrize("acc", ["int64", "int32", "uint16"])
def test_pair_average_integer_accumulators(acc, fmt):
    # G = 10: a uint16 sum of 12-bit differences plus the offset wraps
    kw = dict(num_groups=10, frames_per_group=N, height=H, width=W, accum_dtype=acc,
              stream_dtype=fmt)
    for algorithm in ("alg3", "alg3_v2"):
        _stream_paths({**kw, "algorithm": algorithm}, seed=40)
