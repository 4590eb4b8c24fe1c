"""Port parity of the training path (``repro_torch.data.pipeline``,
``launch.mesh``, ``launch.steps``, ``launch.train`` and remat in the
models) against the reference's, on the CPU, at smoke sizes (batch <= 4,
seq <= 32).

* ``DataPipeline``: the four cases of ``tests/test_data_pipeline.py``,
  tokens and labels equal to the reference's.
* One ``build_train_step`` step at M = 1 and M = 2 on smoke danube and
  smoke gemma3, from the reference's parameters (carried by
  ``convert.params_from_reference``), against the reference's jitted
  step. Loss within ``LOSS_RTOL`` 1e-6. The gradients are float32 sums
  whose rounding the random smoke models amplify: each package's gradient
  lies up to 2.6e-3 (port) and 4.0e-3 (reference) of a leaf's largest
  |g| from a float64 gradient of the same model on gemma3's 12 layers
  (1e-5 on danube's 2), so ``grad_norm`` is held to ``GN_RTOL`` (measured
  9.7e-6 danube, 4.3e-4 gemma3) and the moments ``mu``/``nu`` to
  ``MOMENT_RTOL`` of each leaf's largest magnitude (``nu``, a square,
  twice that; measured mu 3.6e-5 / 4.6e-3, nu 5.3e-5 / 8.9e-3). New
  parameters are held within 2 lr: the first Adam step moves each
  element by lr * g / (|g| + eps) + lr * wd * p, about +-lr whatever |g|,
  so an element whose gradient is rounding noise (|g| near eps, or of
  either sign) may step either way in the two packages (measured 0.15 lr
  danube, 1.9994 lr gemma3). The step's own composition is held tightly
  instead: the reference's ``AdamW.update`` fed the port's gradients
  gives the port's new parameters and moments within ``OPT_RTOL`` 4e-6
  (measured 1.1e-6 on gemma3's moments: the clipping scale divides by a
  float32 norm over a million squares, summed in each library's order).
* Remat on and off give bitwise equal gradients (``cfg.remat=True``
  forced on smoke configs, both policies, every backbone kind), and
  serving never rematerializes.
* ``train.main(..., "--device", "cpu")``: the counterparts of
  ``tests/test_train_integration.py`` (resume equal to the uninterrupted
  run within rtol 1e-4; M = 1 against M = 2 within rtol 2e-3), and a
  resume across packages both ways: the reference trains 5 steps, the
  port resumes to 8 and its last losses match the reference's
  uninterrupted 8 steps, and the reverse, within ``RESUME_RTOL`` 1e-5
  (measured 8.4e-7 and 1.8e-7).
* ``launch.mesh`` and ``launch.steps`` on a shape larger than one device
  raise naming item 13(d); on one device the steps run.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jget_config
from repro.data.pipeline import DataPipeline as JPipeline
from repro.distributed import sharding as jsh
from repro.launch import steps as JS
from repro.launch import train as JT
from repro.models import build_model as jbuild_model
from repro.optim import AdamW as JAdamW
from repro_torch import convert
from repro_torch.checkpoint.checkpoint import flat_leaves, map_tree
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as S
from repro_torch.launch import train as T
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models import build_model
from repro_torch.models import transformer
from repro_torch.optim import AdamW

LOSS_RTOL = 1e-6
GN_RTOL = {"h2o-danube-1.8b": 5e-5, "gemma3-1b": 2e-3}
MOMENT_RTOL = {"h2o-danube-1.8b": 2e-4, "gemma3-1b": 2e-2}
OPT_RTOL = 4e-6
RESUME_RTOL = 1e-5
LR = 1e-3
DANUBE = ["--arch", "h2o-danube-1.8b", "--smoke", "--batch", "4", "--seq", "32",
          "--lr", "1e-2"]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads for this file's tests, the caller's count after."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(t):
    return t.numpy()


# ---------------------------------------------------------------------------
# DataPipeline: the cases of tests/test_data_pipeline.py
# ---------------------------------------------------------------------------


def _pipes(**kw):
    arch = "h2o-danube-1.8b"
    return (DataPipeline(get_config(arch, smoke=True), device="cpu", **kw),
            JPipeline(jget_config(arch, smoke=True), **kw))


def _same_batch(b, jb):
    assert set(b) == set(jb)
    for k in jb:
        assert b[k].dtype == torch.int32
        np.testing.assert_array_equal(_np(b[k]), np.asarray(jb[k]))


def test_pipeline_batch_is_pure_function_of_step():
    pipe, jpipe = _pipes(batch=4, seq=16)
    again = DataPipeline(pipe.cfg, batch=4, seq=16, device="cpu")
    for step in (0, 3, 17):
        _same_batch(pipe.batch_at(step), jpipe.batch_at(step))
        np.testing.assert_array_equal(_np(pipe.batch_at(step)["tokens"]),
                                      _np(again.batch_at(step)["tokens"]))


def test_pipeline_labels_are_next_token():
    pipe, jpipe = _pipes(batch=2, seq=8)
    b = pipe.batch_at(0)
    _same_batch(b, jpipe.batch_at(0))
    np.testing.assert_array_equal(_np(b["labels"])[:, :-1], _np(b["tokens"])[:, 1:])


def test_pipeline_resume_replays_identical_stream():
    pipe, jpipe = _pipes(batch=2, seq=8)
    full = [pipe.batch_at(i) for i in range(6)]
    for i in range(3, 6):
        b = pipe.batch_at(i)
        _same_batch(b, jpipe.batch_at(i))
        np.testing.assert_array_equal(_np(full[i]["tokens"]), _np(b["tokens"]))
    cycled, jcycled = _pipes(batch=2, seq=8, cycle=4)
    _same_batch(cycled.batch_at(5), jcycled.batch_at(5))
    np.testing.assert_array_equal(_np(cycled.batch_at(5)["tokens"]), _np(full[1]["tokens"]))


def test_pipeline_microbatched_shapes_and_sample_fn():
    pipe, jpipe = _pipes(batch=8, seq=16, microbatches=4)
    b = pipe.batch_at(0)
    assert b["tokens"].shape == (4, 2, 16)
    _same_batch(b, jpipe.batch_at(0))
    seen = []
    fn = lambda cfg, batch, seq, seed, m: seen.append((batch, seq, seed, m)) or {"seed": seed}
    pipe = DataPipeline(pipe.cfg, batch=8, seq=16, microbatches=4, cycle=3, sample_fn=fn,
                        device="cpu")
    assert pipe.batch_at(7) == {"seed": 1} and seen == [(8, 16, 1, 4)]


# ---------------------------------------------------------------------------
# One train step against the reference's jitted step
# ---------------------------------------------------------------------------


class _Recording:
    """An optimizer that keeps the gradients the step hands it."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def update(self, grads, state, params):
        self.grads = [g.clone() for g in flat_leaves(grads)]
        return self.opt.update(grads, state, params)


def _within(got, want, rtol, what):
    for g, w in zip(flat_leaves(got), jax.tree_util.tree_leaves(want)):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, what
        err = float(np.abs(g - w).max())
        assert err <= rtol * max(float(np.abs(w).max()), 1e-30), (what, err)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma3-1b"])
def test_train_step_matches_reference(arch, m):
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    model, jmodel = build_model(cfg), jbuild_model(jcfg)
    jp = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    opt, jopt = AdamW(learning_rate=LR), JAdamW(learning_rate=LR)
    batch = DataPipeline(cfg, batch=4, seq=32, microbatches=m, device="cpu").batch_at(0)
    jbatch = JPipeline(jcfg, batch=4, seq=32, microbatches=m).batch_at(0)
    _same_batch(batch, jbatch)

    jnew, jstate, jmet = jax.jit(JS.build_train_step(jmodel, jopt, microbatches=m))(
        jp, jopt.init(jp), jbatch)
    rec = _Recording(opt)
    params = convert.params_from_reference(jp, device="cpu")
    new, state, met = S.build_train_step(model, rec, microbatches=m)(
        params, opt.init(params), batch)

    assert new is params  # updated in place
    loss, jloss = float(met["loss"]), float(jmet["loss"])
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)
    gn, jgn = float(met["grad_norm"]), float(jmet["grad_norm"])
    assert abs(gn - jgn) <= GN_RTOL[arch] * jgn, (gn, jgn)
    _within(state["mu"], jstate["mu"], MOMENT_RTOL[arch], "mu")
    _within(state["nu"], jstate["nu"], 2 * MOMENT_RTOL[arch], "nu")
    for p, jp_new in zip(flat_leaves(new), jax.tree_util.tree_leaves(jnew)):
        assert float(np.abs(_np(p) - np.asarray(jp_new)).max()) <= 2 * LR * (1 + 1e-5)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == int(jstate["step"]) == 1

    # the step's composition: the reference's AdamW on the port's gradients
    grads = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp),
                                         [_np(g) for g in rec.grads])
    assert abs(float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                                 for g in jax.tree_util.tree_leaves(grads)))) - gn) <= 1e-6 * gn
    cnew, cstate = jax.jit(jopt.update)(grads, jopt.init(jp), jp)
    _within(new, cnew, OPT_RTOL, "params")
    _within(state["mu"], cstate["mu"], OPT_RTOL, "mu")
    _within(state["nu"], cstate["nu"], OPT_RTOL, "nu")


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,policy", [
    ("h2o-danube-1.8b", "minimal"), ("gemma3-1b", "minimal"), ("gemma3-1b", "dots"),
    ("mixtral-8x7b", "minimal"), ("llama-3.2-vision-11b", "minimal"),
    ("whisper-large-v3", "minimal"),
])
def test_remat_gives_the_gradients_of_no_remat(arch, policy, monkeypatch):
    calls = []
    real = transformer.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw.get("context_fn"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counting)
    off = dataclasses.replace(get_config(arch, smoke=True), remat=False)
    on = dataclasses.replace(off, remat=True, remat_policy=policy)
    params = build_model(off).init(torch.Generator().manual_seed(0), device="cpu")
    if "cross_layers" in params:  # open the vlm's gates, zero at init
        for k in ("gate_attn", "gate_mlp"):
            params["cross_layers"][k].fill_(0.7)
    batch = make_train_batch(off, 2, 16, device="cpu")

    def grads(cfg):
        tracked = map_tree(lambda t: t.detach().requires_grad_(), params)
        loss = build_model(cfg).loss(tracked, batch)
        return loss.detach(), torch.autograd.grad(loss, flat_leaves(tracked))

    loss_off, g_off = grads(off)
    assert not calls
    loss_on, g_on = grads(on)
    assert calls, "remat=True never checkpointed a layer"
    # the vision stack always saves its products (the reference's "dots")
    dots = policy == "dots" or arch == "llama-3.2-vision-11b"
    assert all(isinstance(c, functools.partial) == dots for c in calls)
    assert torch.equal(loss_on, loss_off)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)
    calls.clear()
    with torch.no_grad():
        build_model(on).loss(params, batch)
    assert not calls  # serving (no autograd) never rematerializes


# ---------------------------------------------------------------------------
# launch/train.main
# ---------------------------------------------------------------------------


def test_train_main_resume_reproduces_uninterrupted_run(tmp_path):
    base = DANUBE + ["--ckpt-every", "2", "--device", "cpu"]
    ref = T.main(base + ["--steps", "8", "--ckpt-dir", str(tmp_path / "ref")])
    first = T.main(base + ["--steps", "5", "--ckpt-dir", str(tmp_path / "resume")])
    second = T.main(base + ["--steps", "8", "--ckpt-dir", str(tmp_path / "resume")])
    assert len(first) == 5 and len(second) == 3
    assert len(ref.step_s) == len(ref.grad_norms) == 8
    assert np.all(np.isfinite(ref)) and np.all(np.isfinite(second))
    np.testing.assert_allclose(second[-2:], ref[-2:], rtol=1e-4)


def test_train_main_microbatched_equals_unmicrobatched():
    argv = DANUBE + ["--steps", "3", "--device", "cpu"]
    a = T.main(argv + ["--microbatches", "1"])
    b = T.main(argv + ["--microbatches", "2"])
    np.testing.assert_allclose(a, b, rtol=2e-3)


def test_train_main_compress_runs():
    for kind in ("int8", "topk"):
        losses = T.main(DANUBE + ["--steps", "2", "--device", "cpu", "--compress", kind])
        assert len(losses) == 2 and np.all(np.isfinite(losses))


def test_port_resumes_the_reference_checkpoint(tmp_path):
    base = DANUBE + ["--ckpt-every", "2"]
    jref = JT.main(base + ["--steps", "8", "--ckpt-dir", str(tmp_path / "jref")])
    JT.main(base + ["--steps", "5", "--ckpt-dir", str(tmp_path / "run")])
    resumed = T.main(base + ["--steps", "8", "--ckpt-dir", str(tmp_path / "run"),
                             "--device", "cpu"])
    assert len(resumed) == 3
    np.testing.assert_allclose(resumed, jref[-3:], rtol=RESUME_RTOL)


def test_reference_resumes_the_port_checkpoint(tmp_path):
    base = DANUBE + ["--ckpt-every", "2"]
    ref = T.main(base + ["--steps", "8", "--ckpt-dir", str(tmp_path / "ref"),
                         "--device", "cpu"])
    T.main(base + ["--steps", "5", "--ckpt-dir", str(tmp_path / "run"), "--device", "cpu"])
    resumed = JT.main(base + ["--steps", "8", "--ckpt-dir", str(tmp_path / "run")])
    assert len(resumed) == 3
    np.testing.assert_allclose(resumed, ref[-3:], rtol=RESUME_RTOL)


def test_opt_state_carries_from_the_reference():
    jp = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": [np.ones(3, np.float32)]}
    jstate = jax.tree_util.tree_map(np.asarray, JAdamW().init(jp))
    state = convert.opt_state_from_reference(jstate, device="cpu")
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    for a, b in zip(flat_leaves(state), jax.tree_util.tree_leaves(jstate)):
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="int32"):
        convert.opt_state_from_reference(dict(jstate, step=np.zeros((), np.int64)),
                                         device="cpu")


# ---------------------------------------------------------------------------
# launch/mesh and launch/steps
# ---------------------------------------------------------------------------


def test_larger_meshes_raise_naming_item_13d():
    # the production meshes are still item 13(d), and so are the vlm and
    # audio families over a mesh of several ranks, whose steps raise before
    # anything is placed; the moe, ssm and hybrid families build their
    # steps over it, as the dense family does; a mesh of several ranks
    # needs a process group of its size and never falls back to one device
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    model = build_model(cfg)
    assert not torch.distributed.is_initialized()
    for multi_pod in (False, True):
        with pytest.raises(NotImplementedError, match=r"item 13\(d\)"):
            M.make_production_mesh(multi_pod=multi_pod)
    four = M.Mesh((2, 2), ("data", "model"), torch.device("cpu"))
    for arch in ("mixtral-8x7b", "deepseek-v2-lite-16b", "mamba2-780m", "recurrentgemma-9b",
                 "llama-3.2-vision-11b", "whisper-large-v3"):
        other = build_model(get_config(arch, smoke=True))
        rules = S.resolve_rules(other.cfg, four)
        builds = (lambda: S.jit_train_step(other, AdamW(), four, rules, batch=4, seq=8),
                  lambda: S.jit_prefill_step(other, four, rules, batch=4, seq=8),
                  lambda: S.jit_decode_step(other, four, rules, batch=4, seq=8))
        for build in builds:
            if other.cfg.family in ("vlm", "audio"):
                with pytest.raises(NotImplementedError, match=r"item 13\(d\)"):
                    build()
            else:
                step, _ = build()
                assert callable(step)
    for call in (lambda: M.make_mesh((2, 1), ("data", "model"), device="cpu"),
                 lambda: M.make_mesh((2, 2), ("data", "model"), device="cpu"),
                 lambda: T.main(DANUBE + ["--steps", "1", "--mesh", "2x1", "--device", "cpu"])):
        with pytest.raises(RuntimeError, match="process group"):
            call()
    # the shardings are the reference's PartitionSpecs as DTensor placements
    big = M.Mesh((2, 2), ("data", "model"), torch.device("cpu"))
    rules = S.resolve_rules(cfg, big)
    params_sh, opt_sh = S.train_state_shardings(model, AdamW(), big, rules)
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    jmodel = jbuild_model(jget_config("h2o-danube-1.8b", smoke=True))
    jparams_sh, jopt_sh = JS.train_state_shardings(jmodel, JAdamW(), jmesh,
                                                   JS.resolve_rules(jmodel.cfg, jmesh))
    for got, want in ((params_sh, jparams_sh), (opt_sh, jopt_sh)):
        assert [tuple(s.spec) for s in flat_leaves(got)] == \
            [tuple(s.spec) for s in jax.tree_util.tree_leaves(want)]
    bsh = S.batch_shardings(S.train_batch_spec(cfg, 4, 8), big, rules)
    assert {k: v.placements for k, v in bsh.items()} == {
        k: (Shard(0), Replicate()) for k in ("tokens", "labels")}


def test_one_device_steps_run_and_mirror_the_reference():
    cfg = get_config("gemma3-1b", smoke=True)
    model, jmodel = build_model(cfg), jbuild_model(jget_config("gemma3-1b", smoke=True))
    mesh = M.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.size == 1 and mesh.device == torch.device("cpu")
    for kw in (dict(), dict(long_context=True), dict(overrides={"cache_seq": "model"})):
        assert S.resolve_rules(cfg, mesh, **kw) == JS.resolve_rules(jmodel.cfg, None, **kw)
    rules = S.resolve_rules(cfg, mesh)

    step, abstract = S.jit_train_step(model, AdamW(), mesh, rules, microbatches=2, batch=4,
                                      seq=8)
    jabstract = (jsh.abstract_params(jmodel.spec()),
                 jsh.abstract_params(JAdamW().state_spec(jmodel.spec())),
                 JS.train_batch_spec(jmodel.cfg, 4, 8, 2))
    for got, want in zip(abstract, jabstract):
        shapes = [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in flat_leaves(got)]
        assert shapes == [(tuple(s.shape), jnp.dtype(s.dtype).name)
                          for s in jax.tree_util.tree_leaves(want)]
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = make_train_batch(cfg, 4, 8, microbatches=2, device="cpu")
    _, opt_state, met = step(params, AdamW().init(params), batch)
    assert int(opt_state["step"]) == 1 and np.isfinite(float(met["loss"]))

    prefill, _ = S.jit_prefill_step(model, mesh, rules, batch=2, seq=8)
    decode, dabstract = S.jit_decode_step(model, mesh, rules, batch=2, seq=8)
    assert dabstract[3].dtype == torch.int32
    tokens = make_train_batch(cfg, 2, 8, device="cpu")["tokens"]
    logits, caches = prefill(params, {"tokens": tokens[:, :6]})
    with torch.no_grad():
        want, _ = model.prefill(params, {"tokens": tokens[:, :6]})
    assert torch.equal(logits, want)
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": tokens[:, :6]}, max_len=8)
        want = model.forward(params, {"tokens": tokens[:, :7]})[:, 6]
    step_logits, _ = decode(params, caches, {"token": tokens[:, 6:7]}, 6)
    assert step_logits.shape == want.shape
    assert float((step_logits - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_hw_holds_the_h100s_numbers():
    assert M.HW.CARD == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert (M.HW.PEAK_BF16_FLOPS, M.HW.PEAK_F32_FLOPS, M.HW.HBM_BW, M.HW.HBM_BYTES) == \
        (989e12, 67e12, 3.35e12, 80e9)
