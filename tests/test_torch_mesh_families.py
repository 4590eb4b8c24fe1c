"""Port parity of the ``moe``, ``ssm`` and ``hybrid`` families' steps over
a ``(2, 2)`` mesh of four ranks (``launch.mesh.make_mesh``, DTensor
placements) against the reference's ``jit_*_step`` on its ``(2, 2)`` mesh
of four host devices and against the port's one-device steps, on the CPU.

Four configurations at their ``smoke=True`` sizes in float32:
``mixtral-8x7b`` (experts replicated, each expert's hidden width split
over ``model``), ``deepseek-v2-lite-16b`` (MLA with its latent rank over
``model``; routed experts split over ``model``, expert parallelism),
``mamba2-780m`` (SSD) and ``recurrentgemma-9b`` (RG-LRU and local
attention with one KV head), the last two with tied embeddings.
mixtral's MoE groups are cut to 32 tokens (``moe_group_size``, in both
packages) so that its prefill and train steps split the groups over
``data`` while decode's one group of 4 tokens is replicated; deepseek
keeps its groups of 2048, one group in every step but the long prefill.

The parameters are the reference's (``model.init(PRNGKey(0))``), written
by the test process in the reference's checkpoint format. The reference
then runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` while the port runs
this file as a script in four processes beside it, the ranks of a gloo
group met through a ``FileStore`` under the fixture's directory, each with
one intra-op thread; every process waits at most ``RANK_TIMEOUT_S``. A rank
imports no ``jax`` and nothing of ``repro``.

Tolerances (ROADMAP.md queue C), as fractions of the largest |logit| of
the reference's forward over the prompt unless a unit is given, with the
worst measured gap of mixtral, deepseek and mamba2 in brackets:

* prefill logits within ``SERVE_RTOL`` 3e-5 of the reference's mesh step
  (7.4e-6) and of the port's one-device step (9.5e-7); each decode step
  within ``MESH_SERVE_RTOL`` 6e-5 of the reference's mesh step (5.3e-6)
  and within ``SERVE_RTOL`` of the port's one-device step (3.8e-6). The
  greedy tokens are equal. smoke deepseek's prefill of 2048 tokens (MLA's
  query-chunked path, two MoE groups split over ``data``) within
  ``SERVE_RTOL`` of the port's one-device prefill (4.4e-7).
* MoE: every layer's expert choices and kept pairs of every prefill,
  decode and train call are equal to the port's one-device run and to the
  reference's mesh run.
* one train step at M = 1 and 2: the loss (the aux loss included) within
  ``LOSS_RTOL`` 1e-6 (1.6e-7); ``grad_norm`` within ``GN_RTOL`` 5e-5 of
  the port's one-device step (1.7e-6) and of the reference's one-device
  step (3.2e-5), and of the reference's mesh step plus that step's own gap
  to its one-device step; every new parameter within 2 lr of the
  reference's mesh step and of the port's one-device step; AdamW's
  moments leaf by leaf, as fractions of each leaf's largest, within
  ``MOMENT_RTOL`` 2e-4 of the reference's mesh step (mu 1.29e-4, nu
  1.31e-4 against twice it) and ``MESH_MOMENT_RTOL`` 5e-5 of the port's
  one-device step (mu 2.9e-5, nu 4.2e-5 against twice it), the values of
  ``tests/test_torch_mesh.py``.
* recurrentgemma's float32 random weights amplify rounding (queue C: 1e-3
  between the frameworks in serving; a parameter moved by one float32 ulp
  at random moves its one-device moments by 5.5e-3 of a leaf's largest
  and its ``grad_norm`` by 4.4e-4). Against the port's one device it
  holds the tolerances above (serving 5.0e-6, loss 0, ``grad_norm``
  2.3e-5), except the moments, within ``RG["mesh_moments"]`` 5e-4 (mu
  2.4e-4, nu 4.7e-4 against twice it; the reference's own mesh lies
  9.8e-4 and 1.6e-3 from its one device). Against the reference's mesh
  its gaps are the frameworks' own on one device (port against
  reference, each on one device, in brackets): serving within
  ``RG["serve"]`` 1e-3 (prefill 1.7e-4, decode 3.9e-4), the loss within
  ``RG["loss"]`` 1e-5 (7.2e-6; 7.2e-6), ``grad_norm`` within ``RG["gn"]``
  1e-3 (5.4e-4; 5.0e-4) and the moments within ``RG["moments"]`` 0.1 (mu
  6.8e-2, nu 0.136 against twice it; 6.7e-2, 0.135), all at M = 2.
* a checkpoint written from the mesh restores bitwise on one device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
RANKS = 4
RANK_TIMEOUT_S = 480.0
B, P, N = 4, 16, 3          # serving: batch, prompt, decode steps
TS = 32                     # training: sequence; 4 rows a microbatch
LONG = (2, 2048)            # deepseek's long prefill: batch, prompt
LR = 1e-3
#: configuration -> (tag, overrides of its smoke config, float32 in both)
CONFIGS = {
    "mixtral-8x7b": ("mixtral", {"moe_group_size": 32}),
    "deepseek-v2-lite-16b": ("deepseek", {}),
    "mamba2-780m": ("mamba2", {}),
    "recurrentgemma-9b": ("rgemma", {}),
}
SERVE_RTOL = 3e-5
MESH_SERVE_RTOL = 6e-5
LOSS_RTOL = 1e-6
GN_RTOL = 5e-5
MOMENT_RTOL = 2e-4
MESH_MOMENT_RTOL = 5e-5
#: recurrentgemma's own (see the module docstring)
RG = {"serve": 1e-3, "loss": 1e-5, "gn": 1e-3, "moments": 1e-1, "mesh_moments": 5e-4}
DEEPSEEK_MAIN = ["--arch", "deepseek-v2-lite-16b", "--smoke", "--batch", "4", "--seq", "32",
                 "--lr", "1e-2"]

_REFERENCE = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.nice(10)  # yield the cores to the suite's other workers
    import jax, jax.numpy as jnp, numpy as np
    import repro.models.moe as JMOE
    from repro.configs import get_config
    from repro.models import build_model
    from repro.data.pipeline import DataPipeline
    from repro.launch import steps as JS
    from repro.launch.mesh import make_mesh
    from repro.optim import AdamW

    out, configs = sys.argv[1], json.loads(sys.argv[2])
    B, P, N, TS, LR = *map(int, sys.argv[3:7]), float(sys.argv[7])
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    mesh = make_mesh((2, 2), ("data", "model"))
    res = {}

    # every MoE call's expert choices and kept pairs (the reference's
    # apply_moe, lines computing expert_idx and within), out of the jitted
    # steps through a debug callback
    ROUTES = []
    moe = JMOE.apply_moe

    def recorded(params, x, cfg):
        b, s, d = x.shape
        e, k = cfg.num_experts, cfg.num_experts_per_tok
        gs = JMOE._group_size(b * s, cfg)
        ng, cap = b * s // gs, JMOE._capacity(gs, cfg)
        xt = x.reshape(ng, gs, d)
        logits = jnp.einsum("gtd,de->gte", xt, params["router"].astype(x.dtype))
        _, idx = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), -1), k)
        onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
        flat = onehot.transpose(0, 2, 1, 3).reshape(ng, k * gs, e)
        pos = ((jnp.cumsum(flat, axis=1) - flat).reshape(ng, k, gs, e)
               .transpose(0, 2, 1, 3) * onehot).sum(-1)
        jax.debug.callback(lambda i, w: ROUTES.append((np.asarray(i), np.asarray(w))),
                           idx, (pos < cap) & (onehot.sum(-1) > 0))
        return moe(params, x, cfg)

    JMOE.apply_moe = recorded

    def routes(tag, phase=None):
        jax.effects_barrier()
        for j, (i, w) in enumerate(ROUTES if phase else ()):
            res[f"{tag}.route.{phase}.{j}.idx"], res[f"{tag}.route.{phase}.{j}.kept"] = i, w
        ROUTES.clear()

    for arch, (tag, over) in configs.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **over)
        model = build_model(cfg)
        params = host(model.init(jax.random.PRNGKey(0)))
        rules = JS.resolve_rules(cfg, mesh)
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P), dtype=np.int32)
        prefill, _ = JS.jit_prefill_step(model, mesh, rules, batch=B, seq=P)
        logits, caches = prefill(params, {"tokens": tokens})
        res[f"{tag}.prefill"] = np.asarray(logits)
        routes(tag, "prefill")
        # queue C's scale: the largest |logit| of the forward over the prompt
        res[f"{tag}.scale"] = np.abs(np.asarray(
            jax.jit(model.forward)(params, {"tokens": tokens}))).max()
        routes(tag)
        # the caches as prefill(max_len=P+N) gives them: unwritten slots hold
        # zeros and position -1
        spec = model.cache_spec(B, P + N)
        def pad(a, s):
            widths = [(0, w - n) for n, w in zip(a.shape, s.shape)]
            return np.pad(a, widths, constant_values=s.scale if s.init == "const" else 0)
        caches = jax.tree_util.tree_map(pad, host(caches), spec)
        decode, _ = JS.jit_decode_step(model, mesh, rules, batch=B, seq=P + N)
        tok = res[f"{tag}.prefill"].argmax(-1).astype(np.int32)
        for i in range(N):
            res[f"{tag}.token{i}"] = tok
            logits, caches = decode(params, caches, {"token": tok[:, None]}, jnp.int32(P + i))
            res[f"{tag}.decode{i}"] = np.asarray(logits)
            routes(tag, f"decode{i}")
            tok = res[f"{tag}.decode{i}"].argmax(-1).astype(np.int32)
        for m in (1, 2):
            opt = AdamW(learning_rate=LR)
            batch = DataPipeline(cfg, batch=4 * m, seq=TS, microbatches=m).batch_at(0)
            _, state, met = jax.jit(JS.build_train_step(model, opt, microbatches=m))(
                params, opt.init(params), batch)
            res[f"{tag}.one_loss{m}"], res[f"{tag}.one_gn{m}"] = (np.asarray(met["loss"]),
                                                                  np.asarray(met["grad_norm"]))
            for key in ("mu", "nu"):
                for i, leaf in enumerate(jax.tree_util.tree_leaves(state[key])):
                    res[f"{tag}.one_{key}{m}_{i}"] = np.asarray(leaf)
            routes(tag)
            step, _ = JS.jit_train_step(model, opt, mesh, rules, microbatches=m,
                                        batch=4 * m, seq=TS)
            new, state, met = step(params, opt.init(params), batch)
            res[f"{tag}.loss{m}"], res[f"{tag}.gn{m}"] = (np.asarray(met["loss"]),
                                                          np.asarray(met["grad_norm"]))
            routes(tag, f"train{m}")
            for i, leaf in enumerate(jax.tree_util.tree_leaves(new)):
                res[f"{tag}.new{m}_{i}"] = np.asarray(leaf)
            for key in ("mu", "nu"):
                for i, leaf in enumerate(jax.tree_util.tree_leaves(state[key])):
                    res[f"{tag}.{key}{m}_{i}"] = np.asarray(leaf)
    np.savez(out, **res)
    print("REFERENCE_OK")
""")


# ---------------------------------------------------------------------------
# One rank (this file run as a script): nothing here imports jax or repro
# ---------------------------------------------------------------------------


def _rank(rank: int, root: str) -> None:
    import torch

    torch.set_num_threads(1)
    from repro_torch.checkpoint.checkpoint import flat_leaves, map_tree, restore_tree, \
        save_tree, to_host
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh, start_group
    from repro_torch.models import build_model
    from repro_torch.models import moe as MOE
    from repro_torch.optim import AdamW

    ref, out = os.path.join(root, "ref"), os.path.join(root, "port")
    start_group(os.path.join(root, "store"), rank, RANKS, timeout_s=RANK_TIMEOUT_S)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    lead = rank == 0
    res: dict[str, np.ndarray] = {}

    def pad(t, s):
        widths = [w for n, m in reversed(list(zip(t.shape, s.shape))) for w in (0, m - n)]
        return torch.nn.functional.pad(t, tuple(widths),
                                       value=s.scale if s.init == "const" else 0)

    def record(tag, phase, routes):
        for j, r in enumerate(routes):
            res[f"{tag}.route.{phase}.{j}.idx"] = to_host(r["expert_idx"])
            res[f"{tag}.route.{phase}.{j}.kept"] = to_host(r["kept"])

    for arch, (tag, over) in CONFIGS.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **over)
        model = build_model(cfg)
        rules = steps.resolve_rules(cfg, mesh)
        shardings = sh.named_shardings(model.spec(), mesh, rules)
        params, _ = restore_tree(os.path.join(ref, tag), device="cpu", shardings=shardings)
        one, _ = restore_tree(os.path.join(ref, tag), device="cpu")
        tokens = torch.from_numpy(
            np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P), dtype=np.int32))
        prefill, _ = steps.jit_prefill_step(model, mesh, rules, batch=B, seq=P)
        decode, _ = steps.jit_decode_step(model, mesh, rules, batch=B, seq=P + N)
        spec = model.cache_spec(B, P + N)

        # serving over the mesh and (rank 0) on one device
        for kind in ("mesh", "one"):
            if kind == "one" and not lead:
                break
            pre = f"{tag}.{kind}"
            with torch.no_grad():
                with MOE.recording_routes() as routes:
                    if kind == "mesh":
                        logits, caches = prefill(params, {"tokens": tokens})
                        caches = map_tree(lambda t: torch.from_numpy(to_host(t)), caches)
                    else:
                        logits, caches = model.prefill(one, {"tokens": tokens})
                record(pre, "prefill", routes)
                res[f"{pre}_prefill"] = to_host(logits)
                caches = map_tree(pad, caches, spec)
                tok = torch.from_numpy(res[f"{pre}_prefill"].argmax(-1).astype(np.int32))
                for i in range(N):
                    res[f"{pre}_token{i}"] = tok.numpy()
                    with MOE.recording_routes() as routes:
                        if kind == "mesh":
                            logits, caches = decode(params, caches, {"token": tok[:, None]},
                                                    P + i)
                        else:
                            logits, caches = model.decode_step(one, caches,
                                                               {"token": tok[:, None]}, P + i)
                    record(pre, f"decode{i}", routes)
                    res[f"{pre}_decode{i}"] = to_host(logits)
                    tok = torch.from_numpy(res[f"{pre}_decode{i}"].argmax(-1).astype(np.int32))

        # training at M = 1 and 2, over the mesh and (rank 0) on one device
        for m in (1, 2):
            batch = DataPipeline(cfg, batch=4 * m, seq=TS, microbatches=m,
                                 device="cpu").batch_at(0)
            opt = AdamW(learning_rate=LR)
            step, _ = steps.jit_train_step(model, opt, mesh, rules, microbatches=m,
                                           batch=4 * m, seq=TS)
            start, _ = restore_tree(os.path.join(ref, tag), device="cpu")
            with MOE.recording_routes() as routes:
                new, state, met = step(start, opt.init(start), batch)
            record(f"{tag}.mesh", f"train{m}", routes)
            res[f"{tag}.mesh_loss{m}"] = to_host(met["loss"])
            res[f"{tag}.mesh_gn{m}"] = to_host(met["grad_norm"])
            res[f"{tag}.loss_placements{m}"] = np.array(str(met["loss"].placements))
            res[f"{tag}.param_placements{m}"] = np.array(
                [str(t.placements) for t in flat_leaves(new)])
            host = map_tree(to_host, {"params": new, "opt": state})
            for i, leaf in enumerate(flat_leaves(host["params"])):
                res[f"{tag}.mesh_new{m}_{i}"] = leaf
            for key in ("mu", "nu"):
                for i, leaf in enumerate(flat_leaves(host["opt"][key])):
                    res[f"{tag}.mesh_{key}{m}_{i}"] = leaf
            if m == 1 and lead:
                save_tree(os.path.join(out, f"{tag}_ckpt"), host, step=1)
            if lead:
                start, _ = restore_tree(os.path.join(ref, tag), device="cpu")
                with MOE.recording_routes() as routes:
                    new, state, met = steps.build_train_step(model, opt, microbatches=m)(
                        start, opt.init(start), batch)
                record(f"{tag}.one", f"train{m}", routes)
                res[f"{tag}.one_loss{m}"] = to_host(met["loss"])
                res[f"{tag}.one_gn{m}"] = to_host(met["grad_norm"])
                for i, leaf in enumerate(flat_leaves(new)):
                    res[f"{tag}.one_new{m}_{i}"] = to_host(leaf)
                for key in ("mu", "nu"):
                    for i, leaf in enumerate(flat_leaves(state[key])):
                        res[f"{tag}.one_{key}{m}_{i}"] = to_host(leaf)

        if tag == "deepseek":
            # 2048 tokens: MLA's query-chunked prefill, two MoE groups split
            # over "data"
            long_tokens = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab_size, LONG, dtype=np.int32))
            long_prefill, _ = steps.jit_prefill_step(model, mesh, rules, batch=LONG[0],
                                                     seq=LONG[1])
            with torch.no_grad(), MOE.recording_routes() as routes:
                logits, _ = long_prefill(params, {"tokens": long_tokens})
                res["deepseek.long_groups"] = np.array(
                    [str(r["expert_idx"].placements) for r in routes])
                res["deepseek.long_mesh"] = to_host(logits)
                if lead:
                    logits, _ = model.prefill(one, {"tokens": long_tokens})
                    res["deepseek.long_one"] = to_host(logits)
                    res["deepseek.long_scale"] = np.abs(
                        model.forward(one, {"tokens": long_tokens}).numpy()).max()
        del params, one

    # the launcher: two steps of smoke deepseek over the mesh
    losses = T.main(DEEPSEEK_MAIN + ["--steps", "2", "--mesh", "2x2", "--device", "cpu"])
    res["main_losses"] = np.array(losses)
    res["main_grad_norms"] = np.array(losses.grad_norms)
    res["jax_loaded"] = np.array(sorted(
        k for k in sys.modules if k == "jax" or k.startswith(("jax.", "repro."))))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


def _start(args, log, env):
    return subprocess.Popen([sys.executable, *args], env=env, stdout=log,
                            stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's (2, 2) runs and the port's four ranks, side by side,
    once for the four configurations."""
    return _run_all(tmp_path_factory.mktemp("mesh_families"))


def _run_all(root: Path):
    import jax

    from repro.checkpoint.checkpoint import save_tree
    from repro.configs import get_config
    from repro.models import build_model

    for d in ("ref", "port"):
        (root / d).mkdir()
    for arch, (tag, over) in CONFIGS.items():
        model = build_model(dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                                                **over))
        params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0)))
        save_tree(str(root / "ref" / tag), params)

    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref_env = dict(os.environ, PYTHONPATH=SRC,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    logs = {"reference": open(root / "reference.log", "w")}
    procs = {"reference": _start(["-c", _REFERENCE, str(root / "ref" / "reference.npz"),
                                  json.dumps(CONFIGS), str(B), str(P), str(N), str(TS),
                                  str(LR)], logs["reference"], ref_env)}
    for r in range(RANKS):
        logs[f"rank{r}"] = open(root / f"rank{r}.log", "w")
        procs[f"rank{r}"] = _start([__file__, str(r), str(root)], logs[f"rank{r}"], env)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs.values():
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    bad = [name for name, p in procs.items() if p.returncode != 0]
    assert not bad, {name: (root / f"{name}.log").read_text()[-3000:] for name in bad}
    assert "REFERENCE_OK" in (root / "reference.log").read_text()
    ranks = [dict(np.load(root / "port" / f"rank{r}.npz")) for r in range(RANKS)]
    return dict(np.load(root / "ref" / "reference.npz")), ranks, root


def _close(got, want, rtol, scale):
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, (err, rtol)


TAGS = [tag for tag, _ in CONFIGS.values()]


def _rg(tag, key, default):
    return RG[key] if tag == "rgemma" else default


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_shardings_are_the_reference_partition_specs(arch):
    # parameters, AdamW's state and the decode caches: the reference's
    # PartitionSpecs over its (2, 2) mesh, with mixtral's rules override
    # and RG-LRU's ("mlp", "mlp") gates split on their first axis only
    import jax
    import torch
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget_config
    from repro.launch import steps as JS
    from repro.models import build_model as jbuild_model
    from repro.optim import AdamW as JAdamW
    from repro_torch.checkpoint.checkpoint import flat_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW

    _, over = CONFIGS[arch]
    four = M.Mesh((2, 2), ("data", "model"), torch.device("cpu"))
    model = build_model(dataclasses.replace(get_config(arch, smoke=True), **over))
    rules = steps.resolve_rules(model.cfg, four)
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    jmodel = jbuild_model(dataclasses.replace(jget_config(arch, smoke=True), **over))
    jrules = JS.resolve_rules(jmodel.cfg, jmesh)
    got = (*steps.train_state_shardings(model, AdamW(), four, rules),
           steps._cache_shardings(model, four, rules, B, P + N))
    want = (*JS.train_state_shardings(jmodel, JAdamW(), jmesh, jrules),
            JS._cache_shardings(jmodel, jmesh, jrules, B, P + N))
    for g, w in zip(got, want):
        assert [tuple(s.spec) for s in flat_leaves(g)] == \
            [tuple(s.spec) for s in jax.tree_util.tree_leaves(w)]
    if arch == "recurrentgemma-9b":
        gate = model.spec()["segments"][0][0]["mixer"]["w_a"]
        assert steps.sh.partition_spec(gate.shape, gate.axes, four.axis_sizes, rules) == (
            None, "model", None)


def test_remat_recomputes_under_the_callers_activation_sharding():
    # the backward of CUDA tensors runs on autograd's own thread, where the
    # caller's activation sharding is not active: the recomputation must
    # place activations as the forward did (here: see the same context)
    import threading

    import torch

    from repro_torch.distributed.context import activation_sharding, active
    from repro_torch.models.transformer import remat

    seen, grads = [], []

    def block(x):
        seen.append(active())
        return torch.sin(x * 2)

    x = torch.ones(3, requires_grad=True)
    ctx = (object(), {"act_mlp": "model"})
    with activation_sharding(*ctx):
        y = remat(block, x).sum()
    worker = threading.Thread(target=lambda: grads.append(torch.autograd.grad(y, x)))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and len(grads) == 1
    assert seen == [ctx, ctx]


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", TAGS)
def test_mesh_prefill_and_decode_match_the_reference_mesh_and_one_device(runs, tag):
    ref, ranks, _ = runs
    port, scale = ranks[0], float(ref[f"{tag}.scale"])
    _close(port[f"{tag}.mesh_prefill"], ref[f"{tag}.prefill"], _rg(tag, "serve", SERVE_RTOL),
           scale)
    _close(port[f"{tag}.mesh_prefill"], port[f"{tag}.one_prefill"], SERVE_RTOL, scale)
    for i in range(N):
        np.testing.assert_array_equal(port[f"{tag}.mesh_token{i}"], ref[f"{tag}.token{i}"])
        np.testing.assert_array_equal(port[f"{tag}.one_token{i}"], ref[f"{tag}.token{i}"])
        _close(port[f"{tag}.mesh_decode{i}"], port[f"{tag}.one_decode{i}"], SERVE_RTOL, scale)
        _close(port[f"{tag}.mesh_decode{i}"], ref[f"{tag}.decode{i}"],
               _rg(tag, "serve", MESH_SERVE_RTOL), scale)
    for r in ranks[1:]:  # every rank gathers the same outputs
        for i in range(N):
            np.testing.assert_array_equal(r[f"{tag}.mesh_decode{i}"], port[f"{tag}.mesh_decode{i}"])


@pytest.mark.parametrize("tag", ["mixtral", "deepseek"])
def test_moe_expert_choices_and_dropped_pairs_are_equal(runs, tag):
    # every MoE layer's call in prefill, each decode step and each train
    # step: the port's mesh against its one device and the reference's mesh
    ref, ranks, _ = runs
    port = ranks[0]
    phases = ["prefill"] + [f"decode{i}" for i in range(N)] + ["train1", "train2"]
    layers = 2
    for phase in phases:
        n = sum(k.startswith(f"{tag}.route.{phase}.") and k.endswith(".idx") for k in ref)
        want_calls = layers * (2 if phase == "train2" else 1)
        assert n == want_calls, (phase, n)
        for j in range(n):
            for what in ("idx", "kept"):
                want = ref[f"{tag}.route.{phase}.{j}.{what}"]
                for kind in ("mesh", "one"):
                    got = port[f"{tag}.{kind}.route.{phase}.{j}.{what}"]
                    np.testing.assert_array_equal(got.astype(want.dtype), want,
                                                  err_msg=f"{kind} {phase} call {j} {what}")
        for r in ranks[1:]:
            for j in range(n):
                np.testing.assert_array_equal(r[f"{tag}.mesh.route.{phase}.{j}.idx"],
                                              port[f"{tag}.mesh.route.{phase}.{j}.idx"])


def test_moe_groups_split_over_data_where_they_divide(runs):
    # mixtral's prefill (2 groups of 32) and train steps (4 groups) route
    # each data rank's own groups; decode (one group of 4) and deepseek's
    # one group of 64 are replicated
    ref, ranks, _ = runs
    port = ranks[0]
    assert port["mixtral.mesh.route.prefill.0.idx"].shape == (2, 32, 2)
    assert port["mixtral.mesh.route.train1.0.idx"].shape == (4, 32, 2)
    assert port["mixtral.mesh.route.decode0.0.idx"].shape == (1, 4, 2)
    assert port["deepseek.mesh.route.prefill.0.idx"].shape == (1, 64, 2)
    assert not port["mixtral.mesh.route.train1.0.kept"].all()  # pairs drop
    from torch.distributed.tensor import Replicate, Shard

    assert set(port["deepseek.long_groups"]) == {str((Shard(0), Replicate()))}


def test_deepseek_long_prefill_takes_the_chunked_path_over_the_mesh(runs):
    port = runs[1][0]
    _close(port["deepseek.long_mesh"], port["deepseek.long_one"], SERVE_RTOL,
           float(port["deepseek.long_scale"]))
    for r in runs[1][1:]:
        np.testing.assert_array_equal(r["deepseek.long_mesh"], port["deepseek.long_mesh"])


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _leaf_rel(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("tag", TAGS)
def test_mesh_train_step_matches_the_reference_mesh_and_one_device(runs, tag, m):
    from torch.distributed.tensor import Replicate

    ref, ranks, _ = runs
    port = ranks[0]
    assert port[f"{tag}.loss_placements{m}"] == str((Replicate(), Replicate()))
    loss, jloss, one = (float(x) for x in (port[f"{tag}.mesh_loss{m}"], ref[f"{tag}.loss{m}"],
                                           port[f"{tag}.one_loss{m}"]))
    assert abs(loss - one) <= LOSS_RTOL * abs(one), (loss, one)
    assert abs(loss - jloss) <= _rg(tag, "loss", LOSS_RTOL) * abs(jloss), (loss, jloss)
    # queue C's grad_norm tolerance holds against the reference's one-device
    # step; against its mesh the reference's own gap between the two adds
    gn, jgn, jgn_one, one_gn = (float(x) for x in (
        port[f"{tag}.mesh_gn{m}"], ref[f"{tag}.gn{m}"], ref[f"{tag}.one_gn{m}"],
        port[f"{tag}.one_gn{m}"]))
    gn_rtol = _rg(tag, "gn", GN_RTOL)
    assert abs(gn - one_gn) <= GN_RTOL * one_gn, (gn, one_gn)
    assert abs(gn - jgn_one) <= gn_rtol * jgn_one, (gn, jgn_one)
    assert abs(gn - jgn) <= gn_rtol * jgn_one + abs(jgn - jgn_one), (gn, jgn, jgn_one)
    n = sum(k.startswith(f"{tag}.new{m}_") for k in ref)
    assert n == len(port[f"{tag}.param_placements{m}"]) > 0
    assert any("Shard" in p for p in port[f"{tag}.param_placements{m}"])
    for i in range(n):
        got = port[f"{tag}.mesh_new{m}_{i}"]
        for want in (ref[f"{tag}.new{m}_{i}"], port[f"{tag}.one_new{m}_{i}"]):
            assert got.shape == want.shape and got.dtype == want.dtype
            assert float(np.abs(got - want).max()) <= 2 * LR * (1 + 1e-5)
    for r in ranks[1:]:
        assert float(r[f"{tag}.mesh_loss{m}"]) == loss and float(r[f"{tag}.mesh_gn{m}"]) == gn


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("tag", TAGS)
def test_mesh_train_moments_match_the_reference_mesh_and_one_device(runs, tag, m):
    # after one step mu is (1 - b1) times the clipped gradient and nu
    # (1 - b2) times its square, leaf by leaf: a gradient reduced twice,
    # over the wrong axis or with its shards out of order shows here
    ref, ranks, _ = runs
    port = ranks[0]
    ref_rtol = _rg(tag, "moments", MOMENT_RTOL)
    one_rtol = _rg(tag, "mesh_moments", MESH_MOMENT_RTOL)
    for key, k in (("mu", 1), ("nu", 2)):
        n = sum(x.startswith(f"{tag}.{key}{m}_") for x in ref)
        assert n == sum(x.startswith(f"{tag}.mesh_{key}{m}_") for x in port) > 0
        assert n == sum(x.startswith(f"{tag}.one_{key}{m}_") for x in port)
        for i in range(n):
            got = port[f"{tag}.mesh_{key}{m}_{i}"]
            err = _leaf_rel(got, ref[f"{tag}.{key}{m}_{i}"])
            assert err <= k * ref_rtol, (key, i, err)
            err = _leaf_rel(got, port[f"{tag}.one_{key}{m}_{i}"])
            assert err <= k * one_rtol, (key, i, err)
            for r in ranks[1:]:  # every rank gathers the same state
                np.testing.assert_array_equal(r[f"{tag}.mesh_{key}{m}_{i}"], got)


# ---------------------------------------------------------------------------
# Checkpoints, the launcher, isolation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", TAGS)
def test_mesh_checkpoint_restores_bitwise_on_one_device(runs, tag):
    import torch

    from repro_torch.checkpoint.checkpoint import flat_leaves, restore_tree

    _, ranks, root = runs
    state, step = restore_tree(str(root / "port" / f"{tag}_ckpt"), device="cpu")
    assert step == 1
    params, opt = flat_leaves(state["params"]), flat_leaves(state["opt"])
    assert all(isinstance(t, torch.Tensor) for t in params + opt)
    for i, t in enumerate(params):
        np.testing.assert_array_equal(t.numpy(), ranks[0][f"{tag}.mesh_new1_{i}"])
    for key in ("mu", "nu"):
        for i, t in enumerate(flat_leaves(state["opt"][key])):
            np.testing.assert_array_equal(t.numpy(), ranks[0][f"{tag}.mesh_{key}1_{i}"])
    assert int(opt[-1]) == 1  # AdamW's step


def test_train_main_takes_two_deepseek_steps_over_the_mesh(runs):
    from repro_torch.launch import train as T

    ranks = runs[1]
    losses = ranks[0]["main_losses"]
    assert losses.shape == (2,) and np.all(np.isfinite(losses))
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["main_losses"], losses)
    one = T.main(DEEPSEEK_MAIN + ["--steps", "2", "--device", "cpu"])
    np.testing.assert_allclose(losses, one, rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks[0]["main_grad_norms"], one.grad_norms, rtol=GN_RTOL)


def test_ranks_load_no_jax(runs):
    for r in runs[1]:
        assert list(r["jax_loaded"]) == []


if __name__ == "__main__":
    os.nice(10)  # yield the cores to the suite's other workers
    sys.path.insert(0, SRC)
    _rank(int(sys.argv[1]), sys.argv[2])
