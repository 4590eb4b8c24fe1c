"""B8 (``ema_welford_step``) against the JAX reference where one merge sums
many pairs, on the CPU.

``tests/test_torch_filters.py`` holds B8 at 10 pairs a group. Here a chunk
(``pair_tile`` pairs, or the whole group on ``backend="xla"``) is long
enough that XLA's CPU compiler reorders the reference's
``diff.mean(0)`` and ``((diff - mean) ** 2).sum(0)``: 8 vector lanes from
25 pairs, windows of 32 above 32 pairs
(``repro_torch.kernels.denoise_ema.chunk_sums``).

Tolerance: **bitwise** in ``ema``, ``wmean`` and ``wm2``, for every wire
format (``tests/test_torch_ema_orders.py`` holds the lengths 22-27, where
the port has a declared tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro_torch.kernels import denoise_ema, ops

OFFSET = 4096.0
FORMATS = ("u16", "u8", "p12")
H, W = 8, 64


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


# 32 does not divide 500: its chunks of 32 run over 480 pairs
@pytest.mark.parametrize("pair_tile, pairs", [(32, 480), (50, 500), (100, 500),
                                              (250, 500), (500, 500)])
@pytest.mark.parametrize("fmt", FORMATS)
def test_ema_welford_step_b8_long_chunks_pallas_bitwise(fmt, pair_tile, pairs):
    wire = _wire(2, pairs, fmt, seed=pair_tile)
    got, want = _both(wire, fmt=fmt, backend="pallas", pair_tile=pair_tile)
    for g, w in zip(got, want):
        assert np.array_equal(g, w), _ulps(g, w)


@pytest.mark.parametrize("fmt", FORMATS)
def test_ema_welford_step_b8_xla_500_pairs_bitwise(fmt):
    wire = _wire(2, 500, fmt, seed=7)
    got, want = _both(wire, fmt=fmt, backend="xla")
    for g, w in zip(got, want):
        assert np.array_equal(g, w), _ulps(g, w)


def test_chunk_sums_order_by_length():
    rcp = torch.tensor(np.float32(1) / np.float32(3))
    d = torch.arange(1.0, 101.0).reshape(100, 1)
    for m, windowed in ((24, False), (25, False), (32, False), (33, True), (100, True)):
        s, m2, w = denoise_ema.chunk_sums(d[:m], rcp)
        assert w is windowed and float(s) == m * (m + 1) / 2  # integers sum exactly
        assert m2.shape == (1,) and float(m2) > 0
