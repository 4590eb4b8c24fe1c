"""Port parity of the steps over a ``(2, 2)`` mesh of four ranks
(``launch.mesh.make_mesh``, DTensor placements) against the reference's
``jit_*_step`` on its ``(2, 2)`` mesh of four host devices, on the CPU.

The reference runs once in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (as
``tests/test_launch_steps.py`` runs it) and writes its parameters (its
checkpoint format) and outputs to files, read back as host copies: a
sharded ``jax.Array`` is never indexed. The port runs this file as a
script in four processes, the ranks of a gloo group met through a
``FileStore`` under ``tmp_path``, each with one intra-op thread and a
lower priority than the suite's workers; every rank waits at most
``RANK_TIMEOUT_S``. A rank imports no ``jax`` and
nothing of ``repro``.

Tolerances (ROADMAP.md queue C), as fractions of the largest |logit| of
the reference's forward over the prompt (measured in brackets):

* gemma3's float32 prefill logits within ``SERVE_RTOL`` 3e-5 of the
  reference's mesh run (5.6e-6) and of the port's one-device run (7.6e-6);
  each decode step within ``SERVE_RTOL`` of the port's one-device step
  (7.5e-6) and within ``MESH_SERVE_RTOL`` 6e-5 of the reference's mesh step
  (3.5e-5). That is queue C's 3e-5 between the two frameworks on one
  device, which the first decode step takes nearly whole (2.9e-5 here),
  plus 3e-5 for the two meshes' own reduction orders (the port's 7.5e-6,
  the reference's 5.5e-6). The greedy tokens are equal.
* danube's train step at M = 1 and 2 (bfloat16): the loss within
  ``LOSS_RTOL`` 1e-6; ``grad_norm`` within ``GN_RTOL`` 5e-5 of the
  reference's one-device step and of the port's one-device step (6e-6,
  3.6e-6), and of the reference's mesh step plus that step's own gap to
  its one-device step (7.0e-5 at M = 1); every new parameter within 2 lr
  of the reference's and of the port's one-device step (AdamW's first
  step moves each by lr times the sign of its gradient, so this passes
  any gradient). The gradients are held leaf by leaf through AdamW's
  moments (mu is 0.1 times the clipped gradient, nu 0.001 times its
  square), as fractions of each leaf's largest: within ``MOMENT_RTOL``
  2e-4 of the reference's mesh step (nu twice that; measured 1.27e-4,
  2.55e-4) and within ``MESH_MOMENT_RTOL`` 5e-5 of the port's one-device
  step (nu twice; measured 1.85e-5, 2.24e-5).
* The embedding lookup on the blocks of a table split over both axes
  (``layers._rows``) gives the one-device rows and table gradient bitwise.
* ``launch.mesh``'s gloo all-gather for CUDA tensors serves gloo groups
  only: a group of another backend (PyTorch's ``fake``) raises.

A checkpoint written from the mesh restores bitwise on one device and on
the mesh.
"""

from __future__ import annotations

import dataclasses
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
REF_TIMEOUT_S = 300.0
B, P, N = 4, 16, 3          # serving: batch, prompt, decode steps
TS = 32                     # training: sequence; 4 rows a microbatch
LR = 1e-3
SERVE_RTOL = 3e-5
MESH_SERVE_RTOL = 6e-5
LOSS_RTOL = 1e-6
GN_RTOL = 5e-5
MOMENT_RTOL = 2e-4
MESH_MOMENT_RTOL = 5e-5
DANUBE = ["--arch", "h2o-danube-1.8b", "--smoke", "--batch", "4", "--seq", "32",
          "--lr", "1e-2"]

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.nice(10)  # yield the cores to the suite's other workers
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.checkpoint import save_tree
    from repro.configs import get_config
    from repro.data.pipeline import DataPipeline
    from repro.launch import steps as JS
    from repro.launch.mesh import make_mesh
    from repro.models import build_model
    from repro.optim import AdamW

    out, B, P, N, TS, LR = sys.argv[1], *map(int, sys.argv[2:6]), float(sys.argv[6])
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    mesh = make_mesh((2, 2), ("data", "model"))
    res = {}

    cfg = dataclasses.replace(get_config("gemma3-1b", smoke=True), dtype="float32")
    model = build_model(cfg)
    params = host(model.init(jax.random.PRNGKey(0)))
    save_tree(os.path.join(out, "gemma"), params)
    rules = JS.resolve_rules(cfg, mesh)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P), dtype=np.int32)
    prefill, _ = JS.jit_prefill_step(model, mesh, rules, batch=B, seq=P)
    logits, caches = prefill(params, {"tokens": tokens})
    res["tokens"], res["prefill"] = tokens, np.asarray(logits)
    # queue C's scale: the largest |logit| of the forward over the prompt
    res["scale"] = np.abs(np.asarray(jax.jit(model.forward)(params, {"tokens": tokens}))).max()
    caches = host(caches)
    save_tree(os.path.join(out, "gemma_caches"), caches)
    # the caches as prefill(max_len=P+N) gives them: unwritten slots hold
    # zeros and position -1
    spec = model.cache_spec(B, P + N)
    def pad(a, s):
        widths = [(0, w - n) for n, w in zip(a.shape, s.shape)]
        return np.pad(a, widths, constant_values=s.scale if s.init == "const" else 0)
    caches = jax.tree_util.tree_map(pad, caches, spec)
    decode, _ = JS.jit_decode_step(model, mesh, rules, batch=B, seq=P + N)
    one_caches = caches
    tok = res["prefill"].argmax(-1).astype(np.int32)
    for i in range(N):
        res[f"token{i}"] = tok
        logits, caches = decode(params, caches, {"token": tok[:, None]}, jnp.int32(P + i))
        res[f"decode{i}"] = np.asarray(logits)
        tok = res[f"decode{i}"].argmax(-1).astype(np.int32)
    # the same on one device: the reference's own gap between meshes
    res["one_prefill"] = np.asarray(jax.jit(model.prefill)(params, {"tokens": tokens})[0])
    one_decode = jax.jit(model.decode_step)
    for i in range(N):
        logits, one_caches = one_decode(params, one_caches, {"token": res[f"token{i}"][:, None]},
                                        jnp.int32(P + i))
        res[f"one_decode{i}"] = np.asarray(logits)

    cfg = get_config("h2o-danube-1.8b", smoke=True)
    model = build_model(cfg)
    params = host(model.init(jax.random.PRNGKey(0)))
    save_tree(os.path.join(out, "danube"), params)
    rules = JS.resolve_rules(cfg, mesh)
    for m in (1, 2):
        opt = AdamW(learning_rate=LR)
        batch = DataPipeline(cfg, batch=4 * m, seq=TS, microbatches=m).batch_at(0)
        _, _, met = jax.jit(JS.build_train_step(model, opt, microbatches=m))(
            params, opt.init(params), batch)
        res[f"one_loss{m}"], res[f"one_gn{m}"] = np.asarray(met["loss"]), np.asarray(met["grad_norm"])
        step, _ = JS.jit_train_step(model, opt, mesh, rules, microbatches=m, batch=4 * m, seq=TS)
        new, state, met = step(params, opt.init(params), batch)
        res[f"loss{m}"], res[f"gn{m}"] = np.asarray(met["loss"]), np.asarray(met["grad_norm"])
        for i, leaf in enumerate(jax.tree_util.tree_leaves(new)):
            res[f"new{m}_{i}"] = np.asarray(leaf)
        for key in ("mu", "nu"):
            for i, leaf in enumerate(jax.tree_util.tree_leaves(state[key])):
                res[f"{key}{m}_{i}"] = np.asarray(leaf)
    np.savez(os.path.join(out, "reference.npz"), **res)
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
    from repro_torch.optim import AdamW

    ref, out = os.path.join(root, "ref"), os.path.join(root, "port")
    start_group(os.path.join(root, "store"), rank, RANKS, timeout_s=RANK_TIMEOUT_S)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    lead = rank == 0
    res: dict[str, np.ndarray] = {}
    want = np.load(os.path.join(ref, "reference.npz"))

    # serving: gemma3, float32, over the mesh and (rank 0) on one device
    cfg = dataclasses.replace(get_config("gemma3-1b", smoke=True), dtype="float32")
    model = build_model(cfg)
    rules = steps.resolve_rules(cfg, mesh)
    params, _ = restore_tree(os.path.join(ref, "gemma"), device="cpu",
                             shardings=sh.named_shardings(model.spec(), mesh, rules))
    one, _ = restore_tree(os.path.join(ref, "gemma"), device="cpu")
    tokens = torch.from_numpy(want["tokens"])
    prefill, _ = steps.jit_prefill_step(model, mesh, rules, batch=B, seq=P)
    decode, _ = steps.jit_decode_step(model, mesh, rules, batch=B, seq=P + N)
    spec = model.cache_spec(B, P + N)

    def pad(t, s):
        widths = [w for n, m in reversed(list(zip(t.shape, s.shape))) for w in (0, m - n)]
        return torch.nn.functional.pad(t, tuple(widths),
                                       value=s.scale if s.init == "const" else 0)

    for tag in ("mesh", "one"):
        if tag == "one" and not lead:
            break
        with torch.no_grad():
            if tag == "mesh":
                logits, caches = prefill(params, {"tokens": tokens})
                res["prefill_placements"] = np.array(str(logits.placements))
                caches = map_tree(lambda t: torch.from_numpy(to_host(t)), caches)
            else:
                logits, caches = model.prefill(one, {"tokens": tokens})
            res[f"{tag}_prefill"] = to_host(logits)
            for i, leaf in enumerate(flat_leaves(caches)):
                res[f"{tag}_cache_{i}"] = leaf.numpy()
            caches = map_tree(pad, caches, spec)
            tok = torch.from_numpy(res[f"{tag}_prefill"].argmax(-1).astype(np.int32))
            for i in range(N):
                res[f"{tag}_token{i}"] = tok.numpy()
                if tag == "mesh":
                    logits, caches = decode(params, caches, {"token": tok[:, None]}, P + i)
                else:
                    logits, caches = model.decode_step(one, caches, {"token": tok[:, None]},
                                                       P + i)
                res[f"{tag}_decode{i}"] = to_host(logits)
                tok = torch.from_numpy(res[f"{tag}_decode{i}"].argmax(-1).astype(np.int32))

    # the attention core on each rank's shard, where one k head serves the
    # q heads split over "model" (gemma3's case): its gradients
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import attention as A

    g = torch.Generator().manual_seed(3)
    q, k, v, w = (torch.randn(s, generator=g) for s in
                  ((4, 6, 4, 16), (4, 6, 1, 16), (4, 6, 1, 16), (4, 6, 4, 16)))
    mask = A._causal_window_mask(torch.arange(6), torch.arange(6), 0)[None, None]
    dm = mesh.device_mesh
    placed = [distribute_tensor(t, dm, p, src_data_rank=None).requires_grad_()
              for t, p in ((q, (Shard(0), Shard(2))), (k, (Shard(0), Replicate())),
                           (v, (Shard(0), Replicate())))]
    with implicit_replication():
        att = A._on_shards(A._sdpa, *placed, mask, cfg)
        grads = torch.autograd.grad((att * w).sum(), placed)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad((A._sdpa(*plain, mask, cfg) * w).sum(), plain)
    res["attn_grad_err"] = np.array([float((a.full_tensor() - b).abs().max())
                                     for a, b in zip(grads, want)])
    res["attn_out_err"] = np.array(float((att.full_tensor() - A._sdpa(q, k, v, mask, cfg))
                                         .abs().max()))

    # the embedding lookup on each rank's block of the table: rows and the
    # table's gradient against the one-device lookup
    from repro_torch.models import layers as L

    table, ids, w = (torch.randn(16, 8, generator=g), torch.randint(0, 16, (4, 3), generator=g,
                     dtype=torch.int32), torch.randn(4, 3, 8, generator=g))
    placed_table = distribute_tensor(table, dm, (Shard(1), Shard(0)),
                                     src_data_rank=None).requires_grad_()
    placed_ids = distribute_tensor(ids, dm, (Shard(0), Replicate()), src_data_rank=None)
    with implicit_replication():
        rows = L._rows(placed_table, placed_ids)
        (grad,) = torch.autograd.grad((rows * w).sum(), [placed_table])
    res["rows_placements"] = np.array(str(rows.placements))
    res["rows_grad_placements"] = np.array(str(grad.placements))
    plain = table.clone().requires_grad_()
    want_rows = L._rows(plain, ids)
    (want_grad,) = torch.autograd.grad((want_rows * w).sum(), [plain])
    res["rows_err"] = np.array([float((rows.full_tensor() - want_rows).abs().max()),
                                float((grad.full_tensor() - want_grad).abs().max())])

    # AdamW on placed leaves against the same update on full ones, and the
    # reference's leaves carried across onto the mesh
    from repro_torch import convert

    host_tree, _ = restore_tree(os.path.join(ref, "danube"))
    dcfg = get_config("h2o-danube-1.8b", smoke=True)
    dshard = sh.named_shardings(build_model(dcfg).spec(), mesh,
                                steps.resolve_rules(dcfg, mesh))
    carried = convert.params_from_reference(host_tree, device="cpu", shardings=dshard)
    res["carried_equal"] = np.array(all(
        np.array_equal(to_host(t), a) for t, a in zip(flat_leaves(carried),
                                                      flat_leaves(host_tree))))
    full = convert.params_from_reference(host_tree, device="cpu")
    grads = map_tree(lambda t: torch.randn(t.shape, generator=g) * 0.1, full)
    opt = AdamW(learning_rate=LR)
    placed_grads = sh.place(grads, dshard)
    new, _ = opt.update(placed_grads, opt.init(carried), carried)
    want, _ = opt.update(grads, opt.init(full), full)
    res["adamw_err"] = np.array(max(
        float(np.abs(to_host(a) - b.numpy()).max() / max(float(b.abs().max()), 1e-30))
        for a, b in zip(flat_leaves(new), flat_leaves(want))))

    # training: danube at M = 1 and 2, over the mesh and (rank 0) on one device
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    model = build_model(cfg)
    rules = steps.resolve_rules(cfg, mesh)
    for m in (1, 2):
        batch = DataPipeline(cfg, batch=4 * m, seq=TS, microbatches=m,
                             device="cpu").batch_at(0)
        opt = AdamW(learning_rate=LR)
        step, _ = steps.jit_train_step(model, opt, mesh, rules, microbatches=m,
                                       batch=4 * m, seq=TS)
        params, _ = restore_tree(os.path.join(ref, "danube"), device="cpu")
        new, state, met = step(params, opt.init(params), batch)
        res[f"mesh_loss{m}"], res[f"mesh_gn{m}"] = to_host(met["loss"]), to_host(met["grad_norm"])
        res[f"loss_placements{m}"] = np.array(str(met["loss"].placements))
        res[f"param_placements{m}"] = np.array(
            [str(t.placements) for t in flat_leaves(new)])
        host = map_tree(to_host, {"params": new, "opt": state})
        for i, leaf in enumerate(flat_leaves(host["params"])):
            res[f"mesh_new{m}_{i}"] = leaf
        for key in ("mu", "nu"):
            for i, leaf in enumerate(flat_leaves(host["opt"][key])):
                res[f"mesh_{key}{m}_{i}"] = leaf
        if m == 1:
            if lead:
                save_tree(os.path.join(out, "ckpt"), host, step=1)
            # the same state restored onto the mesh's placements, gathered
            for i, leaf in enumerate(flat_leaves(host["opt"])):
                res[f"mesh_opt_{i}"] = leaf
        if lead:
            params, _ = restore_tree(os.path.join(ref, "danube"), device="cpu")
            new, state, met = steps.build_train_step(model, opt, microbatches=m)(
                params, opt.init(params), batch)
            res[f"one_loss{m}"], res[f"one_gn{m}"] = to_host(met["loss"]), to_host(met["grad_norm"])
            for i, leaf in enumerate(flat_leaves(new)):
                res[f"one_new{m}_{i}"] = to_host(leaf)
            for key in ("mu", "nu"):
                for i, leaf in enumerate(flat_leaves(state[key])):
                    res[f"one_{key}{m}_{i}"] = to_host(leaf)
    torch.distributed.barrier()
    opt_sh = steps.train_state_shardings(model, AdamW(), mesh, rules)
    back, _ = restore_tree(os.path.join(out, "ckpt"), device="cpu",
                           shardings={"params": opt_sh[0], "opt": opt_sh[1]})
    for i, leaf in enumerate(flat_leaves(back["opt"])):
        res[f"restored_opt_{i}"] = to_host(leaf)

    # the launcher: two steps over the mesh, rank 0 writing the checkpoint
    losses = T.main(DANUBE + ["--steps", "2", "--mesh", "2x2", "--device", "cpu",
                              "--ckpt-dir", os.path.join(root, "main")])
    res["main_losses"] = np.array(losses)
    res["main_grad_norms"] = np.array(losses.grad_norms)
    res["jax_loaded"] = np.array(sorted(
        k for k in sys.modules if k == "jax" or k.startswith(("jax.", "repro."))))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


def _run_ranks(root: Path) -> None:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    logs = [open(root / f"rank{r}.log", "w") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(root)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(RANKS)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, {r: (root / f"rank{r}.log").read_text()[-3000:] for r in bad}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's (2, 2) run and the port's four ranks, run once."""
    root = tmp_path_factory.mktemp("mesh")
    (root / "ref").mkdir()
    (root / "port").mkdir()
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(root / "ref"), str(B), str(P), str(N),
         str(TS), str(LR)],
        capture_output=True, text=True, timeout=REF_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=SRC),
    )
    assert "REFERENCE_OK" in out.stdout, out.stderr[-3000:]
    _run_ranks(root)
    ranks = [dict(np.load(root / "port" / f"rank{r}.npz")) for r in range(RANKS)]
    return dict(np.load(root / "ref" / "reference.npz")), ranks, root


def _close(got, want, rtol, scale=None):
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max()) if scale is None else scale
    assert err <= rtol * scale, (err / scale, rtol)


# ---------------------------------------------------------------------------
# Serving: gemma3 prefill and decode
# ---------------------------------------------------------------------------


def test_mesh_prefill_and_decode_match_the_reference_mesh_and_one_device(runs):
    from torch.distributed.tensor import Shard

    ref, ranks, _ = runs
    port, scale = ranks[0], float(ref["scale"])
    assert port["prefill_placements"] == str((Shard(0), Shard(1)))
    _close(port["mesh_prefill"], ref["prefill"], SERVE_RTOL, scale)
    _close(port["mesh_prefill"], port["one_prefill"], SERVE_RTOL, scale)
    for i in range(N):
        np.testing.assert_array_equal(port[f"mesh_token{i}"], ref[f"token{i}"])
        np.testing.assert_array_equal(port[f"one_token{i}"], ref[f"token{i}"])
        _close(port[f"mesh_decode{i}"], port[f"one_decode{i}"], SERVE_RTOL, scale)
        _close(port[f"mesh_decode{i}"], ref[f"decode{i}"], MESH_SERVE_RTOL, scale)
    for r in ranks[1:]:  # every rank gathers the same outputs
        for i in range(N):
            np.testing.assert_array_equal(r[f"mesh_decode{i}"], port[f"mesh_decode{i}"])


def test_mesh_prefill_caches_match_the_reference(runs):
    from repro_torch.checkpoint.checkpoint import flat_leaves, restore_tree

    _, ranks, root = runs
    caches, _ = restore_tree(str(root / "ref" / "gemma_caches"))
    leaves = flat_leaves(caches)
    assert len(leaves) == sum(k.startswith("mesh_cache_") for k in ranks[0]) > 0
    for i, want in enumerate(leaves):
        got = ranks[0][f"mesh_cache_{i}"]
        assert got.shape == want.shape and got.dtype == want.dtype
        if want.dtype.kind in "iu":  # positions
            np.testing.assert_array_equal(got, want)


def test_attention_on_shards_is_the_one_device_attention(runs):
    # q's heads split over "model", the one k head on every rank: the
    # output and the gradients of q, k and v (each rank's share of k's) are
    # the one-device ones
    for r in runs[1]:
        assert float(r["attn_out_err"]) <= 1e-6
        assert all(e <= 1e-5 for e in r["attn_grad_err"]), r["attn_grad_err"]


def test_embedding_rows_on_shards_are_the_one_device_rows(runs):
    # the table split over both axes, the tokens over "data": each rank's
    # block looked up, summed over "model" and moved to the tokens'
    # placements; the table's gradient stays on its own placements
    from torch.distributed.tensor import Replicate, Shard

    for r in runs[1]:
        assert r["rows_placements"] == str((Shard(0), Replicate()))
        assert r["rows_grad_placements"] == str((Shard(1), Shard(0)))
        assert list(r["rows_err"]) == [0.0, 0.0], r["rows_err"]


def test_placed_adamw_and_carried_leaves_match_one_device(runs):
    # convert places the reference's leaves bitwise; AdamW on placed leaves
    # (its global norm reduced over the mesh) stays within queue C's 1e-6
    for r in runs[1]:
        assert bool(r["carried_equal"])
        assert float(r["adamw_err"]) <= 1e-6, float(r["adamw_err"])


def test_placements_take_split_axes_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding

    axes = ("pod", "data", "model")
    assert sharding.placements((("pod", "data"), "model"), axes) == (Shard(0), Shard(0),
                                                                    Shard(1))
    assert sharding.placements((None, "data"), axes) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        sharding.placements((("data", "pod"),), axes)


# ---------------------------------------------------------------------------
# Training: danube's step at M = 1 and 2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 2])
def test_mesh_train_step_matches_the_reference_mesh(runs, m):
    from torch.distributed.tensor import Replicate

    ref, ranks, _ = runs
    port = ranks[0]
    assert port[f"loss_placements{m}"] == str((Replicate(), Replicate()))
    loss, jloss = float(port[f"mesh_loss{m}"]), float(ref[f"loss{m}"])
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    # queue C's grad_norm tolerance holds against the reference's one-device
    # step; against its mesh the reference's own gap between the two adds
    gn, jgn, jgn_one = (float(x) for x in (port[f"mesh_gn{m}"], ref[f"gn{m}"],
                                           ref[f"one_gn{m}"]))
    assert abs(gn - jgn_one) <= GN_RTOL * jgn_one, (gn, jgn_one)
    assert abs(gn - jgn) <= GN_RTOL * jgn_one + abs(jgn - jgn_one), (gn, jgn, jgn_one)
    n = sum(k.startswith(f"new{m}_") for k in ref)
    assert n == len(port[f"param_placements{m}"]) > 0
    assert any("Shard" in p for p in port[f"param_placements{m}"])
    for i in range(n):
        got, want = port[f"mesh_new{m}_{i}"], ref[f"new{m}_{i}"]
        assert got.shape == want.shape and got.dtype == want.dtype
        assert float(np.abs(got - want).max()) <= 2 * LR * (1 + 1e-5)
    for r in ranks[1:]:
        assert float(r[f"mesh_loss{m}"]) == loss and float(r[f"mesh_gn{m}"]) == gn


def _leaf_rel(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("m", [1, 2])
def test_mesh_train_moments_match_the_reference_mesh_and_one_device(runs, m):
    # after one step mu is (1 - b1) times the clipped gradient and nu
    # (1 - b2) times its square, leaf by leaf: a gradient reduced twice,
    # over the wrong axis or with its shards out of order shows here, as
    # the new parameters (about lr from the old, whatever the gradient)
    # cannot show it
    ref, ranks, _ = runs
    port = ranks[0]
    for key, k in (("mu", 1), ("nu", 2)):
        n = sum(x.startswith(f"{key}{m}_") for x in ref)
        assert n == sum(x.startswith(f"mesh_{key}{m}_") for x in port) > 0
        assert n == sum(x.startswith(f"one_{key}{m}_") for x in port)
        for i in range(n):
            got = port[f"mesh_{key}{m}_{i}"]
            err = _leaf_rel(got, ref[f"{key}{m}_{i}"])
            assert err <= k * MOMENT_RTOL, (key, i, err)
            err = _leaf_rel(got, port[f"one_{key}{m}_{i}"])
            assert err <= k * MESH_MOMENT_RTOL, (key, i, err)
            for r in ranks[1:]:  # every rank gathers the same state
                np.testing.assert_array_equal(r[f"mesh_{key}{m}_{i}"], got)


@pytest.mark.parametrize("m", [1, 2])
def test_mesh_train_step_matches_the_port_on_one_device(runs, m):
    port = runs[1][0]
    loss, one = float(port[f"mesh_loss{m}"]), float(port[f"one_loss{m}"])
    assert abs(loss - one) <= LOSS_RTOL * abs(one), (loss, one)
    gn, one_gn = float(port[f"mesh_gn{m}"]), float(port[f"one_gn{m}"])
    assert abs(gn - one_gn) <= GN_RTOL * one_gn, (gn, one_gn)
    i = 0
    while f"one_new{m}_{i}" in port:
        got, want = port[f"mesh_new{m}_{i}"], port[f"one_new{m}_{i}"]
        assert float(np.abs(got - want).max()) <= 2 * LR * (1 + 1e-5)
        i += 1
    assert i > 0


# ---------------------------------------------------------------------------
# Checkpoints, the launcher, isolation
# ---------------------------------------------------------------------------


def test_mesh_checkpoint_restores_bitwise_on_one_device_and_on_the_mesh(runs):
    import torch

    from repro_torch.checkpoint.checkpoint import flat_leaves, restore_tree

    _, ranks, root = runs
    state, step = restore_tree(str(root / "port" / "ckpt"), device="cpu")
    assert step == 1
    params, opt = flat_leaves(state["params"]), flat_leaves(state["opt"])
    assert all(isinstance(t, torch.Tensor) for t in params + opt)
    for i, t in enumerate(params):
        np.testing.assert_array_equal(t.numpy(), ranks[0][f"mesh_new1_{i}"])
    for r in ranks:
        for i, t in enumerate(opt):
            np.testing.assert_array_equal(t.numpy(), r[f"mesh_opt_{i}"])
            np.testing.assert_array_equal(t.numpy(), r[f"restored_opt_{i}"])
    assert int(opt[-1]) == 1  # AdamW's step


def test_train_main_takes_two_steps_over_the_mesh(runs):
    from repro_torch.checkpoint.checkpoint import restore_tree
    from repro_torch.launch import train as T

    _, ranks, root = runs
    losses = ranks[0]["main_losses"]
    assert losses.shape == (2,) and np.all(np.isfinite(losses))
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["main_losses"], losses)
    one = T.main(DANUBE + ["--steps", "2", "--device", "cpu"])
    np.testing.assert_allclose(losses, one, rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["main_grad_norms"], one.grad_norms, rtol=GN_RTOL)
    # one checkpoint a save, written by rank 0, in the reference's format
    assert sorted(os.listdir(root / "main")) == ["step_0000000000", "step_0000000001"]
    state, step = restore_tree(str(root / "main" / "step_0000000001"))
    assert step == 1 and set(state) == {"params", "opt"}


_OVERRIDE = textwrap.dedent("""
    import os, sys
    import torch, torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # registers the "fake" backend
    from repro_torch.launch import mesh as M

    M.start_group(os.path.join(sys.argv[1], "store"), 0, 1)
    fake = dist.new_group([0], backend="fake")
    M._gloo_cuda_all_gather()
    x = torch.arange(6.0).reshape(2, 3)
    gloo = dist.group.WORLD.group_name
    assert torch.equal(M._gloo_all_gather_into_tensor(x, 1, gloo), x)
    try:
        M._gloo_all_gather_into_tensor(x, 1, fake.group_name)
    except RuntimeError as e:
        assert "'fake'" in str(e), e
    else:
        raise AssertionError("a fake group reached gloo's all-gather")
    # the CPU kernel of the op is PyTorch's own for either group
    f = torch.ops._c10d_functional
    assert torch.equal(f.wait_tensor(f.all_gather_into_tensor(x, 1, gloo)), x)
    f.wait_tensor(f.all_gather_into_tensor(x, 1, fake.group_name))
    dist.destroy_process_group()
    print("OVERRIDE_OK")
""")


def test_gloo_all_gather_override_serves_gloo_groups_only(tmp_path):
    out = subprocess.run([sys.executable, "-c", _OVERRIDE, str(tmp_path)], capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=SRC))
    assert "OVERRIDE_OK" in out.stdout, out.stderr[-3000:]


def test_ranks_load_no_jax(runs):
    for r in runs[1]:
        assert list(r["jax_loaded"]) == []


if __name__ == "__main__":
    os.nice(10)  # yield the cores to the suite's other workers
    sys.path.insert(0, SRC)
    _rank(int(sys.argv[1]), sys.argv[2])
