"""The port's model substrate against the JAX reference, on the CPU: the
configs, the parameter and cache specs, the layers and every attention
path (the blocks of ``tests/test_blocked_attention.py`` among them).

Inputs are numpy draws from fixed seeds, fed to both packages.

Tolerances (float32 throughout; the products run in each framework's own
matmul order, ``exp``/``tanh``/``rsqrt`` in its own libm):

* configs, specs, parameter counts and the mesh-axis metadata: equal;
* each layer and attention path against the reference's: ``LAYER_RTOL``
  of the largest output magnitude (measured: at most 3.6e-6, the
  attention paths with random projections, whose logits are large);
* the port's blocked attention against its naive path: ``atol`` 2e-5,
  and the whole model 3e-4 / rtol 1e-3, the reference's own limits in
  ``tests/test_blocked_attention.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.distributed import sharding as jsh
from repro.launch import inputs as jinputs
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import context, sharding
from repro_torch.launch import inputs
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

DENSE = ("h2o-danube-1.8b", "qwen2.5-32b", "command-r-35b", "gemma3-1b")
LAYER_RTOL = 1e-5


def _close(got, want, rtol=LAYER_RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _cfg(**kw):
    base = dict(name="t", family="dense", num_layers=1, d_model=64, num_heads=4,
                num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64, dtype="float32")
    base.update(kw)
    return ArchConfig(**base)


def _jcfg(cfg):
    return jconfigs.base.ArchConfig(**dataclasses.asdict(cfg))


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# 1. Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_field_by_field(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for smoke in (False, True):
        got = dataclasses.asdict(configs.get_config(arch, smoke=smoke))
        want = dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke))
        assert got == want
    assert configs.long_context_ok(arch) == jconfigs.long_context_ok(arch)


def test_shapes_equal_and_unknown_arch_raises_the_same_key_error():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(KeyError) as got:
        configs.get_config("gpt-5")
    with pytest.raises(KeyError) as want:
        jconfigs.get_config("gpt-5")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# 2. Specs
# ---------------------------------------------------------------------------


def _spec_rows(tree, port: bool):
    """(path, shape, axes, init, scale, dtype name) of every spec leaf."""
    if port:
        flat = list(_flatten(tree))
    else:
        flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=jsh.is_spec)[0]
        flat = [(jax.tree_util.keystr(p), s) for p, s in flat]
    out = []
    for path, s in flat:
        dt = str(s.dtype).replace("torch.", "") if port else np.dtype(s.dtype).name
        out.append((s.shape, s.axes, s.init, s.scale, dt))
    return out


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", DENSE)
def test_model_and_cache_specs_equal(arch, smoke):
    cfg = configs.get_config(arch, smoke=smoke)
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    assert T.stack_plan(cfg) == [
        (n, [T.BlockDesc(**dataclasses.asdict(d)) for d in p]) for n, p in JT.stack_plan(jcfg)]
    assert _spec_rows(T.model_spec(cfg), True) == _spec_rows(JT.model_spec(jcfg), False)
    assert (_spec_rows(T.cache_spec_tree(cfg, 4, 160), True)
            == _spec_rows(JT.cache_spec_tree(jcfg, 4, 160), False))


@pytest.mark.parametrize("arch", DENSE)
def test_full_config_counts_and_bytes_equal_without_allocating(arch):
    spec, jspec = T.model_spec(configs.get_config(arch)), JT.model_spec(jconfigs.get_config(arch))
    assert sharding.count_params(spec) == jsh.count_params(jspec) > 10 ** 8
    assert sharding.spec_bytes(spec) == jsh.spec_bytes(jspec)
    assert sharding.spec_bytes(spec, 2) == jsh.spec_bytes(jspec, 2)
    model = build_model(configs.get_config(arch))
    assert model.param_count() == model.active_param_count() == sharding.count_params(spec)
    meta = sharding.abstract_params(spec)
    assert all(t.device.type == "meta" for t in (meta["embed"]["embedding"],))


@pytest.mark.parametrize("arch", DENSE)
def test_partition_spec_metadata_equals_the_reference(arch):
    mesh = {"pod": 2, "data": 4, "model": 16}
    jmesh = AbstractMesh((2, 4, 16), ("pod", "data", "model"))
    rules = dict(sharding.DEFAULT_RULES, cache_seq="data")
    assert sharding.DEFAULT_RULES == jsh.DEFAULT_RULES
    cfg = configs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    trees = [(T.model_spec(cfg), JT.model_spec(jcfg)),
             (T.cache_spec_tree(cfg, 128, 32768), JT.cache_spec_tree(jcfg, 128, 32768))]
    for spec, jspec in trees:
        ports = [s for _, s in _flatten(spec)]
        refs = jax.tree_util.tree_leaves(jspec, is_leaf=jsh.is_spec)
        for s, js in zip(ports, refs, strict=True):
            for r in (None, rules):
                want = tuple(jsh.partition_spec(js.shape, js.axes, jmesh, r))
                want = want + (None,) * (len(js.shape) - len(want))
                assert sharding.partition_spec(s.shape, s.axes, mesh, r) == want


def test_activation_context_records_and_constrain_is_identity():
    x = torch.ones(2, 3)
    assert context.constrain(x, ("a",)) is x  # no context: nothing checked
    with context.activation_sharding("mesh", {"act_batch": "data"}):
        assert context.active() == ("mesh", {"act_batch": "data"})
        assert context.constrain(x, ("act_batch", None)) is x
        with pytest.raises(ValueError):
            context.constrain(x, ("act_batch",))
    assert context.active() is None


def test_init_params_follows_the_reference_rules():
    spec = {"w": sharding.ParamSpec((400, 300), ("embed", "mlp"), init="fan_in"),
            "n": sharding.ParamSpec((300,), ("norm",), init="normal", scale=0.5),
            "z": sharding.ParamSpec((3,), ("norm",), init="zeros"),
            "o": sharding.ParamSpec((3,), ("norm",), init="ones"),
            "c": sharding.ParamSpec((3,), ("norm",), init="const", scale=-1, dtype=torch.int32)}
    gen = torch.Generator().manual_seed(0)
    p = sharding.init_params(spec, generator=gen, device="cpu")
    assert abs(float(p["w"].std()) - 1 / 20) < 2e-3  # N(0, 1) / sqrt(400)
    assert abs(float(p["n"].std()) - 0.5) < 0.05
    assert p["z"].tolist() == [0, 0, 0] and p["o"].tolist() == [1, 1, 1]
    assert p["c"].dtype == torch.int32 and p["c"].tolist() == [-1, -1, -1]
    again = sharding.init_params(spec, generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["w"], p["w"])  # seeded: the same draws in the same order


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_batches_are_byte_identical_and_specs_equal(arch, dtype):
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True), dtype=dtype)
    pairs = [(inputs.make_train_batch(cfg, 4, 6, seed=3, microbatches=2, device="cpu"),
              jinputs.make_train_batch(jcfg, 4, 6, seed=3, microbatches=2)),
             (inputs.make_decode_batch(cfg, 3, seed=4, device="cpu"),
              jinputs.make_decode_batch(jcfg, 3, seed=4)),
             (inputs.train_batch_spec(cfg, 4, 6, microbatches=2),
              jinputs.train_batch_spec(jcfg, 4, 6, microbatches=2)),
             (inputs.decode_batch_spec(cfg, 3), jinputs.decode_batch_spec(jcfg, 3))]
    for got, want in pairs:
        assert set(got) == set(want)
        assert inputs.batch_logical_axes(got) == jinputs.batch_logical_axes(want)
        for k, t in got.items():
            assert str(t.dtype).replace("torch.", "") == np.dtype(want[k].dtype).name
            if t.device.type == "meta":
                assert tuple(t.shape) == tuple(want[k].shape)
            else:
                assert np.array_equal(_bits(t), _bits(want[k]))


# ---------------------------------------------------------------------------
# 3. Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norms_match(norm_type):
    cfg = _cfg(norm_type=norm_type)
    x, scale, bias = _rng_arrays(1, (2, 5, 64), (64,), (64,))
    p = {"scale": scale, "bias": bias} if norm_type == "layernorm" else {"scale": scale}
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), cfg)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), _jcfg(cfg))
    _close(got, want)


@pytest.mark.parametrize("act, gated", [("silu", True), ("gelu", True), ("gelu", False)])
def test_mlp_matches(act, gated):
    cfg = _cfg(act=act, gated_mlp=gated)
    x, wi, wg, wo = _rng_arrays(2, (2, 5, 64), (64, 64), (64, 64), (64, 64))
    p = {"wi": wi, "wo": wo} | ({"wg": wg} if gated else {})
    got = L.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), cfg)
    want = JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), _jcfg(cfg))
    _close(got, want)


@pytest.mark.parametrize("tied", [False, True])
def test_embed_unembed_match(tied):
    cfg = _cfg(tie_embeddings=tied)
    emb, unemb, x = _rng_arrays(3, (64, 64), (64, 64), (2, 5, 64))
    tokens = np.random.default_rng(4).integers(0, 64, (2, 5)).astype(np.int32)
    p = {"embedding": emb} | ({} if tied else {"unembed": unemb})
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got = L.embed_tokens(tp, torch.from_numpy(tokens), cfg)
    assert np.array_equal(got.numpy(), np.asarray(JL.embed_tokens(jp, jnp.asarray(tokens), _jcfg(cfg))))
    _close(L.unembed(tp, torch.from_numpy(x), cfg), JL.unembed(jp, jnp.asarray(x), _jcfg(cfg)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches(theta):
    pos = np.arange(0, 4200, 7, dtype=np.int32)
    cos, sin = L.rope_angles(torch.from_numpy(pos), 80, theta)
    jcos, jsin = JL.rope_angles(jnp.asarray(pos), 80, theta)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=2e-6)
    (x,) = _rng_arrays(5, (1, 6, 2, 80))
    c, s = L.rope_angles(torch.arange(6), 80, theta)
    jc, js = JL.rope_angles(jnp.arange(6), 80, theta)
    _close(L.apply_rope(torch.from_numpy(x), c, s), JL.apply_rope(jnp.asarray(x), jc, js))


# ---------------------------------------------------------------------------
# 4. Attention paths, against the reference's and against the port's naive
# ---------------------------------------------------------------------------


def _qkv(b, s, h, kv, d, seed=0):
    return [torch.from_numpy(a) for a in _rng_arrays(seed, (b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def _naive(q, k, v, window, cfg):
    pos = torch.arange(q.shape[1])
    return A._sdpa(q, k, v, A._causal_window_mask(pos, pos, window)[None][:, None], cfg)


def _jnaive(q, k, v, window, cfg):
    pos = jnp.arange(q.shape[1])
    return JA._sdpa(q, k, v, JA._causal_window_mask(pos, pos, window)[None][:, None], cfg)


def _j(*ts):
    return [jnp.asarray(t.numpy()) for t in ts]


@pytest.mark.parametrize("s", [16, 48, 64, 100])
@pytest.mark.parametrize("window", [8, 16, 24])
def test_banded_matches_naive_and_the_reference(s, window):
    cfg = _cfg()
    q, k, v = _qkv(2, s, 4, 2, 16)
    out = A._banded_sdpa(q, k, v, window, cfg)
    np.testing.assert_allclose(out.numpy(), _naive(q, k, v, window, cfg).numpy(), atol=2e-5)
    _close(out, JA._banded_sdpa(*_j(q, k, v), window, _jcfg(cfg)))


@pytest.mark.parametrize("s", [16, 64, 100])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("q_chunk", [8, 32, 128])
def test_qchunk_matches_naive_and_the_reference(s, window, q_chunk):
    cfg = _cfg()
    q, k, v = _qkv(2, s, 4, 2, 16, seed=3)
    out = A._qchunk_sdpa(q, k, v, window, cfg, q_chunk=q_chunk)
    np.testing.assert_allclose(out.numpy(), _naive(q, k, v, window, cfg).numpy(), atol=2e-5)
    _close(out, JA._qchunk_sdpa(*_j(q, k, v), window, _jcfg(cfg), q_chunk=q_chunk))
    _close(_naive(q, k, v, window, cfg), _jnaive(*_j(q, k, v), window, _jcfg(cfg)))


@pytest.mark.parametrize("kv_heads", [1, 2, 4])
def test_gqa_grouping(kv_heads):
    cfg = _cfg(num_kv_heads=kv_heads)
    q, k, v = _qkv(1, 64, 4, kv_heads, 16, seed=5)
    ref = _naive(q, k, v, 16, cfg).numpy()
    np.testing.assert_allclose(A._banded_sdpa(q, k, v, 16, cfg).numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(A._qchunk_sdpa(q, k, v, 16, cfg, q_chunk=16).numpy(), ref,
                               atol=2e-5)
    _close(torch.from_numpy(ref), _jnaive(*_j(q, k, v), 16, _jcfg(cfg)))


def test_soft_cap_applies_in_blocked_paths():
    cfg = _cfg(logit_soft_cap=5.0)
    q, k, v = _qkv(1, 64, 4, 2, 16, seed=9)
    ref = _naive(q, k, v, 16, cfg)
    np.testing.assert_allclose(A._banded_sdpa(q, k, v, 16, cfg).numpy(), ref.numpy(), atol=2e-5)
    _close(ref, _jnaive(*_j(q, k, v), 16, _jcfg(cfg)))


def test_full_model_blocked_vs_naive():
    """The whole model equal under both attention implementations, at a
    length past the blocked paths' threshold."""
    cfg_b = _cfg(num_layers=2, sliding_window=16)
    cfg_n = dataclasses.replace(cfg_b, attention_impl="naive")
    params = build_model(cfg_b).init(torch.Generator().manual_seed(0), device="cpu")
    batch = make_train_batch(cfg_b, 1, 2048 + 32, device="cpu")
    lb = build_model(cfg_b).forward(params, batch)
    ln = build_model(cfg_n).forward(params, batch)
    np.testing.assert_allclose(lb.numpy(), ln.numpy(), atol=3e-4, rtol=1e-3)


def _attn_params(cfg, seed):
    spec = A.attn_spec(cfg)
    shapes = [s.shape for s in spec.values()]
    return dict(zip(spec, _rng_arrays(seed, *shapes)))


@pytest.mark.parametrize("bias", [False, True])
def test_attention_prefill_and_decode_match_the_reference(bias):
    cfg = _cfg(qkv_bias=bias)
    p = _attn_params(cfg, 11)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    (x,) = _rng_arrays(12, (2, 10, 64))
    for window in (0, 4):
        _close(A.attention(tp, torch.from_numpy(x), cfg, window=window),
               JA.attention(jp, jnp.asarray(x), _jcfg(cfg), window=window))
        # the ring cache (window 4 < 10 tokens) is rolled, the full one padded
        cache_len = 4 if window else 13
        y, cache = A.prefill_attention(tp, torch.from_numpy(x), cfg, window=window,
                                       cache_len=cache_len)
        jy, jcache = JA.prefill_attention(jp, jnp.asarray(x), _jcfg(cfg), window=window,
                                          cache_len=cache_len)
        _close(y, jy)
        assert np.array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
        _close(cache["k"], jcache["k"])
        for step in range(3):
            (xt,) = _rng_arrays(20 + step, (2, 1, 64))
            y, cache = A.decode_attention(tp, torch.from_numpy(xt), cache, 10 + step, cfg,
                                          window=window)
            jy, jcache = JA.decode_attention(jp, jnp.asarray(xt), jcache,
                                             jnp.asarray(10 + step, jnp.int32), _jcfg(cfg),
                                             window=window)
            _close(y, jy)
            assert np.array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
