"""B8 (``ema_welford_step``) against the JAX reference at the edges of each
order its chunk sums take, on the CPU (``tests/test_torch_ema_long.py``
holds the long chunks of the paper's 500 pairs).

``tests/test_torch_filters.py`` holds B8 at 10 pairs a group. Here a chunk
(``pair_tile`` pairs, or the whole group on ``backend="xla"``) is long
enough that XLA's CPU compiler reorders the reference's
``diff.mean(0)`` and ``((diff - mean) ** 2).sum(0)``: 8 vector lanes from
25 pairs, windows of 32 above 32 pairs
(``repro_torch.kernels.denoise_ema.chunk_sums``).

Tolerance: **bitwise** in ``ema``, ``wmean`` and ``wm2`` at every length
outside 22-27 pairs, for every wire format. Between 22 and 27 pairs XLA
picks the chain or the lanes by the size of the fused loop body, which
differs by format and by path; there the port keeps its rule and is held
within ``MID_BAND_ULPS`` float32 ulps (measured: at most 5, on 80 x 256
planes over 4 groups; the declared tolerance in ``ROADMAP.md``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro_torch.kernels import ops

OFFSET = 4096.0
FORMATS = ("u16", "u8", "p12")
H, W = 8, 64
MID_BAND_ULPS = 8


def _wire(groups, pairs, fmt, seed):
    px = np.random.default_rng(seed).integers(0, 4096, (groups, 2 * pairs, H, W))
    return jquant.encode(px.astype(np.uint16), fmt)


def _stream(o, x, wire, *, fmt, backend, pair_tile=None):
    pairs = wire.shape[1] // 2
    state = (x(np.zeros((pairs, H, W), np.float32)), x(np.zeros((H, W), np.float32)),
             x(np.zeros((H, W), np.float32)))
    kw = {} if pair_tile is None else {"pair_tile": pair_tile}
    for g in range(wire.shape[0]):
        state = o.ema_welford_step(
            *state, x(wire[g]), alpha=0.3, offset=OFFSET, prior_count=g * pairs,
            backend=backend, stream_dtype=fmt, **kw,
        )
    return [s.numpy() if isinstance(s, torch.Tensor) else np.asarray(s) for s in state]


def _ulps(got, want):
    a = got.view(np.int32).astype(np.int64)
    b = want.view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _both(wire, **kw):
    return (_stream(ops, torch.from_numpy, wire, **kw),
            _stream(jops, jnp.asarray, wire, **kw))


# Each order's edges: the chain's last length (21 is the last for u8's
# Pallas path), the lanes' first and last, the windows' first (one
# window with a low pad of 15) and a length of two padded windows.
@pytest.mark.parametrize("backend, length", [
    ("pallas", 21), ("pallas", 25), ("pallas", 28), ("pallas", 32), ("pallas", 33),
    ("pallas", 40), ("xla", 21), ("xla", 28), ("xla", 32), ("xla", 33), ("xla", 40),
])
@pytest.mark.parametrize("fmt", FORMATS)
def test_ema_welford_step_b8_each_chunk_order_bitwise(fmt, backend, length):
    pairs = 2 * length if backend == "pallas" else length
    wire = _wire(2, pairs, fmt, seed=length)
    tile = length if backend == "pallas" else None
    got, want = _both(wire, fmt=fmt, backend=backend, pair_tile=tile)
    for g, w in zip(got, want):
        assert np.array_equal(g, w), _ulps(g, w)


@pytest.mark.parametrize("backend, length", [
    ("pallas", 22), ("pallas", 24), ("xla", 23), ("xla", 25), ("xla", 27),
])
@pytest.mark.parametrize("fmt", FORMATS)
def test_ema_welford_step_b8_mid_band_within_declared_ulps(fmt, backend, length):
    pairs = 2 * length if backend == "pallas" else length
    wire = _wire(2, pairs, fmt, seed=length + 100)
    tile = length if backend == "pallas" else None
    got, want = _both(wire, fmt=fmt, backend=backend, pair_tile=tile)
    assert np.array_equal(got[0], want[0])  # the EMA has no sum in it
    for g, w in zip(got[1:], want[1:]):
        assert _ulps(g, w) <= MID_BAND_ULPS
