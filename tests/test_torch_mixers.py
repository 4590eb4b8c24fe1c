"""The port's mixers and blocks of the non-dense families against the JAX
reference, on the CPU: ``moe``, ``mla``, ``rglru``, ``ssd`` (module by
module), and the model and cache specs of every architecture.

Parameters are the reference's (``init_params`` from
``jax.random.PRNGKey(0)``), carried with ``convert.params_from_reference``;
inputs are numpy draws from fixed seeds, fed to both packages; the smoke
configs (``get_config(arch, smoke=True)``), float32.

Tolerances, as fractions of the largest reference magnitude (measured in
brackets):

* ``apply_moe``: output ``MIXER_RTOL`` 1e-5 (2.8e-7), aux loss relative
  ``AUX_RTOL`` 1e-6 (9.3e-8). The expert choices and the dropped (token,
  choice) pairs are **equal** to the reference's, on every seed here: a
  near tie that flipped a choice would fail the test, not widen it.
* ``mla_attention`` (plain and q-chunked), ``mla_decode``: ``MIXER_RTOL``
  (3.0e-7 plain, 4.7e-7 q-chunked, 3.2e-7 decoding from an empty cache);
  the latent caches the same, their positions equal.
* ``apply_rglru``, ``rglru_decode``: ``MIXER_RTOL`` (1.1e-7 at L = 11,
  1.6e-7 at L = 300). The reference's ``associative_scan`` and the port's
  Hillis-Steele scan combine in different trees, both O(log L) deep.
* ``apply_ssd`` (L a multiple of the chunk and not), ``ssd_decode``:
  ``MIXER_RTOL`` (5.9e-7 at L = 16, 2.8e-7 at L = 13), the states too.
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
from repro.models import build_model as jbuild_model
from repro.models import mla as JM
from repro.models import moe as JMOE
from repro.models import rglru as JR
from repro.models import ssd as JS
from repro_torch import configs, convert
from repro_torch.checkpoint.checkpoint import _flatten, flat_leaves
from repro_torch.distributed import sharding
from repro_torch.models import build_model
from repro_torch.models import mla as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from repro_torch.models import ssd as S

MIXER_RTOL = 1e-5
AUX_RTOL = 1e-6
NEW = ("mixtral-8x7b", "deepseek-v2-lite-16b", "recurrentgemma-9b", "mamba2-780m",
       "llama-3.2-vision-11b", "whisper-large-v3")


def _cfgs(arch, **kw):
    return (dataclasses.replace(configs.get_config(arch, smoke=True), **kw),
            dataclasses.replace(jconfigs.get_config(arch, smoke=True), **kw))


def _params(jspec):
    jp = jax.tree_util.tree_map(np.asarray, jsh.init_params(jax.random.PRNGKey(0), jspec))
    return jp, convert.params_from_reference(jp, device="cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _close_tree(got, want, rtol=MIXER_RTOL):
    g, w = flat_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        if b.dtype.kind in "iu":
            assert np.array_equal(a.numpy(), b)
        else:
            assert _rel(a, b) <= rtol


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _jax_routing(jp, x, jcfg):
    """The reference's routing (``repro.models.moe.apply_moe``, lines
    computing ``expert_idx`` and ``within``), on the reference's ops."""
    b, s, d = x.shape
    e, k = jcfg.num_experts, jcfg.num_experts_per_tok
    gs = JMOE._group_size(b * s, jcfg)
    ng, cap = b * s // gs, JMOE._capacity(gs, jcfg)
    xt = jnp.asarray(x).reshape(ng, gs, d)
    logits = jnp.einsum("gtd,de->gte", xt, jp["router"]).astype(jnp.float32)
    _, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    onehot = jax.nn.one_hot(expert_idx, e, dtype=jnp.int32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(ng, k * gs, e)
    pos_in = (jnp.cumsum(flat, axis=1) - flat).reshape(ng, k, gs, e).transpose(0, 2, 1, 3)
    pos = (pos_in * onehot).sum(-1)
    return np.asarray(expert_idx), np.asarray((pos < cap) & (onehot.sum(-1) > 0)), cap


@pytest.mark.parametrize("arch, over, shape, drops", [
    ("mixtral-8x7b", {}, (2, 10, 64), None),
    ("deepseek-v2-lite-16b", {}, (2, 10, 64), None),
    # groups of 8 and the published factor's neighbour 0.5: capacity 4 of
    # 16 pairs, so experts overflow and pairs drop
    ("mixtral-8x7b", dict(moe_group_size=8, capacity_factor=0.5), (3, 8, 64), True),
    ("deepseek-v2-lite-16b", dict(moe_group_size=24, capacity_factor=0.5), (2, 12, 64), True),
    ("mixtral-8x7b", dict(capacity_factor=64.0), (2, 10, 64), False),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_moe_matches_routing_drops_output_and_aux(arch, over, shape, drops, seed):
    cfg, jcfg = _cfgs(arch, **over)
    jp, p = _params(JMOE.moe_spec(jcfg))
    x = _x(shape, seed)
    want, jaux = JMOE.apply_moe(jp, jnp.asarray(x), jcfg)
    with MOE.recording_routes() as routes:
        got, aux = MOE.apply_moe(p, torch.from_numpy(x), cfg)
    assert len(routes) == 1
    idx, kept, cap = _jax_routing(jp, x, jcfg)
    assert routes[0]["capacity"] == cap
    assert np.array_equal(routes[0]["expert_idx"].numpy(), idx), "an expert choice differs"
    assert np.array_equal(routes[0]["kept"].numpy(), kept), "the dropped set differs"
    if drops is not None:
        assert (not kept.all()) == drops
    assert _rel(got, want) <= MIXER_RTOL
    assert aux.dtype == torch.float32 and aux.ndim == 0
    assert abs(float(aux) - float(jaux)) <= AUX_RTOL * abs(float(jaux))


def test_moe_routes_are_recorded_only_inside_the_block():
    cfg, jcfg = _cfgs("mixtral-8x7b")
    _, p = _params(JMOE.moe_spec(jcfg))
    x = torch.from_numpy(_x((1, 4, 64)))
    with MOE.recording_routes() as outer:
        MOE.apply_moe(p, x, cfg)
        with MOE.recording_routes() as inner:
            MOE.apply_moe(p, x, cfg)
        MOE.apply_moe(p, x, cfg)
    MOE.apply_moe(p, x, cfg)
    assert len(outer) == 2 and len(inner) == 1


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b, s", [(2, 10), (1, 2100)])  # plain; q-chunked, padded
def test_mla_attention_and_decode_match(b, s):
    cfg, jcfg = _cfgs("deepseek-v2-lite-16b")
    jp, p = _params(JM.mla_spec(jcfg))
    x = _x((b, s + 3, cfg.d_model))
    want = JM.mla_attention(jp, jnp.asarray(x[:, :s]), jcfg)
    assert _rel(M.mla_attention(p, torch.from_numpy(x[:, :s]), cfg), want) <= MIXER_RTOL

    y, cache = M.mla_attention(p, torch.from_numpy(x[:, :s]), cfg, return_cache=True,
                               cache_len=s + 4)
    jy, jcache = JM.mla_attention(jp, jnp.asarray(x[:, :s]), jcfg, return_cache=True,
                                  cache_len=s + 4)
    assert _rel(y, jy) <= MIXER_RTOL
    _close_tree(cache, jcache)
    assert cache["pos"][-1] == -1 and cache["pos"].dtype == torch.int32
    for i in range(s, s + 3):
        y, out = M.mla_decode(p, torch.from_numpy(x[:, i:i + 1]), cache, i, cfg)
        jy, jcache = JM.mla_decode(jp, jnp.asarray(x[:, i:i + 1]), jcache,
                                   jnp.asarray(i, jnp.int32), jcfg)
        assert out["c_kv"] is cache["c_kv"]  # written in place
        assert _rel(y, jy) <= MIXER_RTOL
        _close_tree(cache, jcache)


def test_mla_decode_from_an_empty_cache():
    cfg, jcfg = _cfgs("deepseek-v2-lite-16b")
    jp, p = _params(JM.mla_spec(jcfg))
    spec = M.mla_cache_spec(cfg, 2, 4, dtype=torch.float32)
    cache = sharding.init_params(spec, generator=torch.Generator(), device="cpu")
    jcache = jsh.init_params(jax.random.PRNGKey(1), JM.mla_cache_spec(jcfg, 2, 4,
                                                                      dtype=jnp.float32))
    assert cache["pos"].tolist() == [-1] * 4
    x = _x((2, 6, cfg.d_model), 3)
    for i in range(6):  # past the cache's length: slot i mod 4
        y, cache = M.mla_decode(p, torch.from_numpy(x[:, i:i + 1]), cache, i, cfg)
        jy, jcache = JM.mla_decode(jp, jnp.asarray(x[:, i:i + 1]), jcache,
                                   jnp.asarray(i, jnp.int32), jcfg)
        assert _rel(y, jy) <= MIXER_RTOL
        _close_tree(cache, jcache)
    assert cache["pos"].tolist() == [4, 5, 2, 3]


# ---------------------------------------------------------------------------
# RG-LRU and SSD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq", [11, 300])
def test_rglru_prefill_state_and_decode_match(seq):
    cfg, jcfg = _cfgs("recurrentgemma-9b")
    jp, p = _params(JR.rglru_spec(jcfg))
    x = _x((2, seq + 3, cfg.d_model), 1)
    assert _rel(R.apply_rglru(p, torch.from_numpy(x[:, :seq]), cfg),
                JR.apply_rglru(jp, jnp.asarray(x[:, :seq]), jcfg)) <= MIXER_RTOL
    y, state = R.apply_rglru(p, torch.from_numpy(x[:, :seq]), cfg, return_state=True)
    jy, jstate = JR.apply_rglru(jp, jnp.asarray(x[:, :seq]), jcfg, return_state=True)
    assert _rel(y, jy) <= MIXER_RTOL
    _close_tree(state, jstate)
    for i in range(seq, seq + 3):
        y, out = R.rglru_decode(p, torch.from_numpy(x[:, i:i + 1]), state, cfg)
        jy, jstate = JR.rglru_decode(jp, jnp.asarray(x[:, i:i + 1]), jstate, jcfg)
        assert out["lru"] is state["lru"]  # updated in place
        assert _rel(y, jy) <= MIXER_RTOL
        _close_tree(state, jstate)


def test_linear_scan_equals_the_sequential_recurrence():
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 37, 5), generator=g, dtype=torch.float64)
    b = torch.randn((2, 37, 5), generator=g, dtype=torch.float64)
    h, want = torch.zeros_like(b[:, 0]), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    assert torch.allclose(R._linear_scan(a, b), torch.stack(want, 1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seq", [16, 13])  # a multiple of the chunk (8), and not: padded
def test_ssd_prefill_state_and_decode_match(seq):
    cfg, jcfg = _cfgs("mamba2-780m")
    jp, p = _params(JS.ssd_spec(jcfg))
    # nonzero A_log and dt_bias, so decays and steps vary by head
    for k in ("A_log", "dt_bias"):
        jp[k] = _x(jp[k].shape, 7)
    p = convert.params_from_reference(jp, device="cpu")
    x = _x((2, seq + 3, cfg.d_model), 2)
    assert _rel(S.apply_ssd(p, torch.from_numpy(x[:, :seq]), cfg),
                JS.apply_ssd(jp, jnp.asarray(x[:, :seq]), jcfg)) <= MIXER_RTOL
    y, state = S.apply_ssd(p, torch.from_numpy(x[:, :seq]), cfg, return_state=True)
    jy, jstate = JS.apply_ssd(jp, jnp.asarray(x[:, :seq]), jcfg, return_state=True)
    assert _rel(y, jy) <= MIXER_RTOL
    _close_tree(state, jstate)
    for i in range(seq, seq + 3):
        y, out = S.ssd_decode(p, torch.from_numpy(x[:, i:i + 1]), state, cfg)
        jy, jstate = JS.ssd_decode(jp, jnp.asarray(x[:, i:i + 1]), jstate, jcfg)
        assert out["ssm"] is state["ssm"]  # updated in place
        assert _rel(y, jy) <= MIXER_RTOL
        _close_tree(state, jstate)


def test_ssd_gradient_stays_finite_where_masked_segments_overflow():
    # mamba2's chunk of 128 at its init (A = -1, dt ~ softplus(0)): the
    # masked segments' exp overflows. The reference's gradient is NaN
    # there (0 * inf through its mask); the port's is finite and its
    # forward the reference's
    cfg, jcfg = _cfgs("mamba2-780m", ssm_chunk=128)
    jp, p = _params(JS.ssd_spec(jcfg))
    x = _x((1, 128, cfg.d_model), 3) * 4
    assert _rel(S.apply_ssd(p, torch.from_numpy(x), cfg),
                JS.apply_ssd(jp, jnp.asarray(x), jcfg)) <= MIXER_RTOL
    jgrad = jax.grad(lambda q: JS.apply_ssd(q, jnp.asarray(x), jcfg).sum())(jp)
    assert not all(np.isfinite(np.asarray(g)).all() for g in jax.tree_util.tree_leaves(jgrad))
    live = {k: v.clone().requires_grad_() for k, v in p.items()}
    grads = torch.autograd.grad(S.apply_ssd(live, torch.from_numpy(x), cfg).sum(),
                                list(live.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ---------------------------------------------------------------------------
# Every architecture's specs
# ---------------------------------------------------------------------------


def _spec_rows(tree, port: bool):
    if port:
        flat = [s for _, s in _flatten(tree)]
    else:
        flat = jax.tree_util.tree_leaves(tree, is_leaf=jsh.is_spec)
    return [(s.shape, s.axes, s.init, s.scale,
             str(s.dtype).replace("torch.", "") if port else np.dtype(s.dtype).name)
            for s in flat]


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", NEW)
def test_model_and_cache_specs_equal(arch, smoke):
    m = build_model(configs.get_config(arch, smoke=smoke))
    jm = jbuild_model(jconfigs.get_config(arch, smoke=smoke))
    assert _spec_rows(m.spec(), True) == _spec_rows(jm.spec(), False)
    assert _spec_rows(m.cache_spec(4, 160), True) == _spec_rows(jm.cache_spec(4, 160), False)
    assert m.param_count() == jm.param_count()
    assert m.active_param_count() == jm.active_param_count()


@pytest.mark.parametrize("arch", NEW)
def test_partition_spec_metadata_equals_the_reference(arch):
    mesh = {"pod": 2, "data": 4, "model": 16}
    jmesh = AbstractMesh((2, 4, 16), ("pod", "data", "model"))
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    rules = dict(sharding.DEFAULT_RULES, **(cfg.rules_override or {}))
    m, jm = build_model(cfg), jbuild_model(jcfg)
    for spec, jspec in ((m.spec(), jm.spec()), (m.cache_spec(8, 4096), jm.cache_spec(8, 4096))):
        for (_, s), js in zip(_flatten(spec), jax.tree_util.tree_leaves(jspec, is_leaf=jsh.is_spec),
                              strict=True):
            want = tuple(jsh.partition_spec(js.shape, js.axes, jmesh, rules))
            want = want + (None,) * (len(js.shape) - len(want))
            assert sharding.partition_spec(s.shape, s.axes, mesh, rules) == want
