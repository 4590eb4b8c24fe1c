"""Port parity of the optimizer (``repro_torch.optim.adamw``) against the
reference's (``repro.optim.adamw``), on the CPU: ``AdamW.init``,
``state_spec`` and three ``update`` steps, with and without clipping,
with a constant rate and with ``cosine_schedule``; the schedule itself
and ``global_norm``. Both packages get the same seeded numpy trees.

Tolerance: float32 within ``RTOL`` 1e-6 of the reference, relative to
each leaf's largest magnitude. The two round alike (the bias corrections
as ``1 - b ** f32(step)``, the update formed in float32 and cast back to
the parameter's dtype) but XLA may contract a product and a sum into one
fused multiply-add, and ``cos``/``pow``/``sqrt`` come from two libms: a
few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as J
from repro_torch import convert
from repro_torch.checkpoint.checkpoint import flat_leaves
from repro_torch.distributed import sharding
from repro_torch.optim import AdamW, cosine_schedule, global_norm

RTOL = 1e-6


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads for this file's tests, the caller's count after."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tree(rng, scale=1.0):
    """A nested dict/list tree of float32 leaves of several shapes."""
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"embed": {"embedding": f(16, 8)}, "final_norm": {"scale": f(8)},
            "segments": [[{"mlp": {"wi": f(2, 8, 12), "wo": f(2, 12, 8)}}],
                         [{"mixer": {"wq": f(1, 8, 2, 4)}, "gate": f()}]]}


def _close(got, want, what):
    for g, w in zip(flat_leaves(got), jax.tree_util.tree_leaves(want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, what
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= RTOL * scale, (what, float(np.abs(g - w).max()))


@pytest.mark.parametrize("clip_norm", [None, 1.0, 1e3])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adamw_updates_match_reference(clip_norm, schedule):
    rng = np.random.default_rng(5)
    params_np = _tree(rng)
    if schedule == "cosine":
        lr, jlr = cosine_schedule(3e-3, 2, 6), J.cosine_schedule(3e-3, 2, 6)
    else:
        lr = jlr = 3e-3
    opt = AdamW(learning_rate=lr, clip_norm=clip_norm)
    jopt = J.AdamW(learning_rate=jlr, clip_norm=clip_norm)
    params = convert.params_from_reference(params_np, device="cpu")
    state = opt.init(params)
    jparams, jstate = params_np, jopt.init(params_np)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    update = jax.jit(jopt.update)
    for step in range(3):
        # clip 1.0 clips every step (gradient norm ~ 30), 1e3 never does
        grads_np = _tree(rng, scale=3.0)
        grads = convert.params_from_reference(grads_np, device="cpu")
        params, state = opt.update(grads, state, params)
        jparams, jstate = update(grads_np, jstate, jparams)
        _close(params, jparams, f"params at step {step}")
        _close(state["mu"], jstate["mu"], f"mu at step {step}")
        _close(state["nu"], jstate["nu"], f"nu at step {step}")
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        assert state["step"].dtype == torch.int32


def test_adamw_updates_in_place_and_keeps_the_parameter_dtype():
    rng = np.random.default_rng(6)
    params = convert.params_from_reference(_tree(rng), device="cpu")
    params["final_norm"]["scale"] = params["final_norm"]["scale"].to(torch.bfloat16)
    opt = AdamW(learning_rate=1e-2)
    state = opt.init(params)
    before = [t.data_ptr() for t in flat_leaves(params) + flat_leaves(state["mu"])]
    grads = convert.params_from_reference(_tree(rng), device="cpu")
    new, state = opt.update(grads, state, params)
    assert [t.data_ptr() for t in flat_leaves(new) + flat_leaves(state["mu"])] == before
    assert new["final_norm"]["scale"].dtype == torch.bfloat16
    assert state["mu"]["final_norm"]["scale"].dtype == torch.float32


def test_cosine_schedule_and_global_norm_match_reference():
    steps = np.arange(0, 40, dtype=np.int32)
    for args in ((3e-3, 5, 20), (1e-2, 0, 8), (3e-4, 100, 10000, 0.2)):
        got = cosine_schedule(*args)(torch.from_numpy(steps)).numpy()
        want = np.asarray(jax.jit(J.cosine_schedule(*args))(jnp.asarray(steps)))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    tree = _tree(np.random.default_rng(7), scale=2.0)
    got = float(global_norm(convert.params_from_reference(tree, device="cpu")))
    want = float(jax.jit(J.global_norm)(tree))
    assert abs(got - want) <= RTOL * want


def test_state_spec_mirrors_reference():
    from repro.distributed import sharding as jsh

    spec = {"w": sharding.ParamSpec((4, 6), ("embed", "mlp")),
            "b": [sharding.ParamSpec((6,), ("mlp",))]}
    jspec = {"w": jsh.ParamSpec((4, 6), ("embed", "mlp")),
             "b": [jsh.ParamSpec((6,), ("mlp",))]}
    got = AdamW().state_spec(spec)
    want = J.AdamW().state_spec(jspec)
    g_leaves = flat_leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want, is_leaf=jsh.is_spec)
    assert [(s.shape, s.axes, s.init) for s in g_leaves] == \
        [(s.shape, s.axes, s.init) for s in w_leaves]
    assert [str(s.dtype).replace("torch.", "") for s in g_leaves] == \
        [jnp.dtype(s.dtype).name for s in w_leaves]
