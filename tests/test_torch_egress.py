"""Port parity of the compressed egress (``repro_torch.core.egress``) and its
compressors (``repro_torch.optim.compress``) against the reference, on the
CPU: the same numpy inputs, made from a seed, through the reference's
jitted compressors and through the port.

Tolerance: bitwise (int8 values and scales, top-k values and indices,
decoded packets, error-feedback residuals), including inputs built with
exact rounding ties (``x / scale`` on a half) and tied magnitudes (top-k
breaks them lower index first), and an ``amax`` whose ``/ 127`` differs
from ``* f32(1/127)`` (the reference's jitted form multiplies).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.denoise import DenoiseConfig as JConfig
from repro.core.egress import CompressedEgress as JEgress
from repro.core.egress import _jit_int8, _jit_topk
from repro.core.streaming import run_pipelined as j_run_pipelined
from repro.optim import compress as jcompress
from repro_torch.core import EGRESS_KINDS, CompressedEgress, EgressPacket
from repro_torch.core.denoise import DenoiseConfig
from repro_torch.core.streaming import run_pipelined
from repro_torch.data.prism import PrismSource
from repro_torch.optim import compress
from repro_torch.serve import Session, SessionScheduler

WAIT = 30
SMALL = dict(num_groups=4, frames_per_group=20, height=16, width=64)


def _inputs(seed):
    """Partial-like float32 frames: noise around the 4096 offset, then
    centred, in three flavours that each stress one rounding rule."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((10, 16, 64)) * 37.3).astype(np.float32)
    ties = np.clip(np.round(x * 2) / 2, -126.5, 126.5)  # every value on a half or a whole
    ties.flat[0] = 127.0  # amax 127: scale exactly 1.0, so x / scale keeps the halves
    recip = x.copy()
    recip.flat[3] = np.float32(1385.1791)  # amax / 127 != amax * f32(1/127)
    mags = np.round(x / 8) * 8  # many equal magnitudes, of both signs
    return {"noise": x, "half_ties": ties, "scale_reciprocal": recip, "tied_magnitudes": mags}


CASES = [(seed, kind) for seed in (0, 1) for kind in
         ("noise", "half_ties", "scale_reciprocal", "tied_magnitudes")]


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed,kind", CASES)
def test_int8_compress_bitwise_equal_jitted_reference(seed, kind):
    x = _inputs(seed)[kind]
    q, scale = compress.int8_compress(torch.from_numpy(x))
    jq, jscale = _jit_int8(jnp.asarray(x))
    _equal(q, jq)
    _equal(scale, jscale)
    _equal(compress.int8_decompress(q, scale),
           jcompress.int8_decompress(jq, jscale))
    if kind == "half_ties":  # round half to even really was exercised
        assert float(scale) == 1.0 and np.any(np.abs(x - np.trunc(x)) == 0.5)
    if kind == "scale_reciprocal":
        amax = np.float32(np.abs(x).max())
        assert np.float32(amax / np.float32(127)) != float(scale)


@pytest.mark.parametrize("k", [1, 7, 512, 10 * 16 * 64])
@pytest.mark.parametrize("seed,kind", CASES)
def test_topk_compress_bitwise_equal_jitted_reference(seed, kind, k):
    flat = _inputs(seed)[kind].reshape(-1)
    vals, idx = compress.topk_compress(torch.from_numpy(flat), k)
    jvals, jidx = _jit_topk(jnp.asarray(flat), k)
    _equal(vals, jvals)
    _equal(idx, jidx)
    shape = (10, 16, 64)
    _equal(compress.topk_decompress(vals, idx, shape),
           jcompress.topk_decompress(jvals, jidx, shape))


def test_topk_breaks_ties_lower_index_first():
    x = torch.tensor([1.0, -3.0, 3.0, 2.0, -3.0, 3.0])
    vals, idx = compress.topk_compress(x, 3)
    assert idx.tolist() == [1, 2, 4] and vals.tolist() == [-3.0, 3.0, -3.0]
    jvals, jidx = _jit_topk(jnp.asarray(x.numpy()), 3)
    assert np.asarray(jidx).tolist() == [1, 2, 4]


def _to_torch(tree):
    """The same nested dict/list/tuple with tensors for its numpy leaves."""
    leaves, rebuild = compress._leaves(tree)
    return rebuild([torch.from_numpy(a) for a in leaves])


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_error_feedback_rounds_equal(kind):
    rng = np.random.default_rng(4)
    shapes = {"a": (8, 16), "b": [(32,), (4, 4, 4)], "c": ((5,), (3, 7))}

    def make(fn):
        return {"a": fn(shapes["a"]), "b": [fn(s) for s in shapes["b"]],
                "c": tuple(fn(s) for s in shapes["c"])}

    rounds = [make(lambda s: rng.standard_normal(s).astype(np.float32)) for _ in range(3)]
    # the reference jitted, as it runs inside a training step (its eager
    # form divides amax by 127 truly; XLA multiplies by f32(1/127))
    jef_step = jax.jit(functools.partial(jcompress.ef_step, kind=kind, k_fraction=0.2))
    res = compress.ef_init(make(lambda s: torch.zeros(s)))
    jres = jcompress.ef_init(make(lambda s: jnp.zeros(s)))
    for grads in rounds:
        sent, res = compress.ef_step(_to_torch(grads), res, kind=kind, k_fraction=0.2)
        jsent, jres = jef_step(jax.tree.map(jnp.asarray, grads), jres)
        for a, b in zip(compress._leaves(sent)[0], jax.tree.leaves(jsent)):
            _equal(a, b)
        for a, b in zip(compress._leaves(res)[0], jax.tree.leaves(jres)):
            _equal(a, b)
        assert isinstance(sent["c"], tuple) and isinstance(sent["b"], list)
    for wire in ("none", "int8", "topk"):
        assert compress.wire_bytes(_to_torch(rounds[0]), kind=wire, k_fraction=0.2) == (
            jcompress.wire_bytes(jax.tree.map(jnp.asarray, rounds[0]), kind=wire, k_fraction=0.2))
    with pytest.raises(ValueError):
        compress.ef_step(torch.zeros(3), torch.zeros(3), kind="zstd")


def test_egress_validation_equal():
    assert EGRESS_KINDS == ("none", "int8", "topk")
    for kind, kw in (("zstd", {}), ("topk", dict(k_fraction=0.0)), ("topk", dict(k_fraction=1.5))):
        with pytest.raises(ValueError) as want:
            JEgress(kind, **kw)
        with pytest.raises(ValueError) as got:
            CompressedEgress(kind, **kw)
        assert str(got.value) == str(want.value)


def _assert_packets_equal(port: CompressedEgress, ref: JEgress) -> None:
    assert len(port.packets) == len(ref.packets)
    for a, b in zip(port.packets, ref.packets):
        assert isinstance(a, EgressPacket)
        assert (a.step, a.kind, a.shape, a.scale, a.center) == (b.step, b.kind, b.shape, b.scale,
                                                                 b.center)
        assert len(a.payload) == len(b.payload)
        for u, v in zip(a.payload, b.payload):
            assert isinstance(u, np.ndarray) and u.dtype == v.dtype and np.array_equal(u, v)
        assert a.raw_bytes == b.raw_bytes and a.wire_bytes == b.wire_bytes
        assert np.array_equal(a.decompress(), b.decompress())
    assert (port.raw_bytes, port.wire_bytes, port.reduction) == (
        ref.raw_bytes, ref.wire_bytes, ref.reduction)


@pytest.mark.parametrize("kind", EGRESS_KINDS)
@pytest.mark.parametrize("k_fraction", [0.05, 0.5])
def test_compressed_egress_packets_equal(kind, k_fraction):
    port = CompressedEgress(kind, center=4096.0, k_fraction=k_fraction)
    ref = JEgress(kind, center=4096.0, k_fraction=k_fraction)
    for step, (seed, flavour) in enumerate(CASES):
        x = _inputs(seed)[flavour] + np.float32(4096)
        port(step, torch.from_numpy(x))
        ref(step, jnp.asarray(x))
    _assert_packets_equal(port, ref)
    for i in range(len(CASES)):
        assert np.array_equal(port.decompress(i), ref.decompress(i))


@pytest.mark.parametrize("kind", EGRESS_KINDS)
def test_egress_as_run_pipelined_consumer_equal(kind):
    cfg, jcfg = DenoiseConfig(**SMALL), JConfig(**SMALL)
    groups = list(PrismSource(cfg, seed=3).groups())
    port = CompressedEgress(kind, center=cfg.offset)
    ref = JEgress(kind, center=jcfg.offset)
    out, _ = run_pipelined(cfg, iter(groups), consumer=port, device="cpu")
    jout, _ = j_run_pipelined(jcfg, (jnp.asarray(g) for g in groups), consumer=ref)
    assert np.array_equal(out.numpy(), np.asarray(jout))
    _assert_packets_equal(port, ref)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_egress_as_session_consumer(kind):
    """Two sessions co-batched on one executor, each with its own egress:
    every packet equals the reference egress over the reference's
    ``run_pipelined`` partials of the same groups."""
    cfg, jcfg = DenoiseConfig(**SMALL), JConfig(**SMALL)
    sources = [list(PrismSource(cfg, seed=s).groups()) for s in (5, 6)]
    ports = [CompressedEgress(kind, center=cfg.offset) for _ in sources]
    with SessionScheduler(slots_per_executor=2, max_executors=1, device="cpu") as sched:
        handles = [sched.submit(Session(config=cfg, source=iter(g), name=f"e{i}", consumer=eg))
                   for i, (g, eg) in enumerate(zip(sources, ports))]
        outs = [h.result(timeout=WAIT)[0] for h in handles]
    for groups, port, out in zip(sources, ports, outs):
        ref = JEgress(kind, center=jcfg.offset)
        jout, _ = j_run_pipelined(jcfg, (jnp.asarray(g) for g in groups), consumer=ref)
        assert np.array_equal(out.numpy(), np.asarray(jout))
        assert [p.step for p in port.packets] == list(range(cfg.num_groups))
        _assert_packets_equal(port, ref)
        assert port.reduction > 1.0
