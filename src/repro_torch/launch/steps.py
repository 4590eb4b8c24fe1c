"""Step builders: train / prefill / decode (counterpart of
``repro.launch.steps``).

``build_train_step`` applies the paper's Algorithm-3 idea at the training
level: gradients over M microbatches are folded into ONE float32 running
sum instead of keeping M gradients apart — the same bounded working set
that lets the denoise kernel keep ``sumFrame`` in fast memory. Each
microbatch's gradients come from autograd, are added to the sum and
dropped; the sum is divided by M once.

The reference jits each step with shardings over a device mesh. Here the
``jit_*_step`` counterparts return the step (PyTorch runs it eagerly: no
``torch.compile``) with the reference's abstract inputs. On a one-device
mesh it is the plain step. Over a mesh of several ranks
(``launch.mesh.make_mesh``) the step places its inputs by the
in-shardings (:func:`batch_shardings`, :func:`train_state_shardings`,
DTensor placements), runs the model on DTensors, and returns its outputs
in the out-shardings, the loss and ``grad_norm`` replicated. The
decoder-only families (:data:`MESH_FAMILIES`: dense, MoE, SSM and hybrid)
run over such a mesh; the vlm and audio families raise naming ROADMAP.md
queue A item 13(d).
"""

from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.checkpoint.checkpoint import flat_leaves, map_tree
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.context import activation_sharding
from repro_torch.launch.inputs import decode_batch_spec, train_batch_spec
from repro_torch.optim import AdamW


def _with_act_context(fn, mesh, rules):
    """Wrap a step so activation constraints act while it runs. Over a
    mesh of several ranks, plain tensors the model makes (positions,
    masks, RoPE angles) count as replicated beside the DTensors."""

    @functools.wraps(fn)
    def wrapped(*args):
        replicate = contextlib.nullcontext()
        if mesh.size > 1:
            from torch.distributed.tensor.experimental import implicit_replication

            replicate = implicit_replication()
        with activation_sharding(mesh, rules), replicate:
            return fn(*args)

    return wrapped


def _placed(fn, in_shardings, out_shardings):
    """``fn`` with its arguments placed by ``in_shardings`` and its results
    by ``out_shardings`` (trees of ``NamedSharding``; ``None`` leaves an
    argument as it is)."""

    @functools.wraps(fn)
    def wrapped(*args):
        args = [a if s is None else sh.place(a, s) for a, s in zip(args, in_shardings)]
        return sh.place(fn(*args), out_shardings)

    return wrapped


__all__ = [
    "resolve_rules",
    "build_train_step",
    "build_prefill_step",
    "build_decode_step",
    "batch_shardings",
    "train_state_shardings",
    "jit_train_step",
    "jit_prefill_step",
    "jit_decode_step",
    "MESH_FAMILIES",
]


def resolve_rules(cfg, mesh, *, long_context: bool = False, overrides=None):
    rules = dict(sh.DEFAULT_RULES)
    if cfg.rules_override:
        rules.update(cfg.rules_override)
    if long_context:
        # batch=1: batch sharding is useless; shard the KV/cache sequence
        # axis over `data` instead (context parallelism).
        rules["cache_seq"] = "data"
        rules["act_cache_seq"] = "data"
    if overrides:
        rules.update(overrides)
    return rules


def batch_shardings(batch_spec, mesh, rules, *, microbatched: bool = False):
    def one(name, leaf):
        nd = len(leaf.shape)
        if name in ("frames", "image_embeds"):
            axes = ("batch", None, None)
        else:
            axes = ("batch", "seq")[:nd]
        if microbatched:
            axes = (None,) + axes  # leading microbatch dim is unsharded
        return sh.logical_sharding(leaf.shape, axes, mesh, rules)

    return {k: one(k, v) for k, v in batch_spec.items()}


def train_state_shardings(model, optimizer, mesh, rules):
    pspec = model.spec()
    params_sh = sh.named_shardings(pspec, mesh, rules)
    opt_sh = sh.named_shardings(optimizer.state_spec(pspec), mesh, rules)
    return params_sh, opt_sh


#: the families whose steps run over a mesh of several ranks
MESH_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _mesh_family(model, mesh, what: str) -> None:
    """Over a mesh of several ranks the decoder-only families run
    (:data:`MESH_FAMILIES`): raise for the others before anything is
    placed."""
    if mesh.size > 1 and model.cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"{what} of the {model.cfg.family} family over a mesh of shape "
            f"{mesh.shape}: ROADMAP.md queue A item 13(d); the families "
            f"{', '.join(MESH_FAMILIES)} run over a mesh of several ranks"
        )


def _like(g, p):
    """A gradient at its parameter's placements (a DTensor's partial sums
    are reduced, and scattered where the parameter is sharded)."""
    if hasattr(g, "redistribute"):
        return g.redistribute(p.device_mesh, p.placements)
    return g


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def build_train_step(model, optimizer: AdamW, *, microbatches: int | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``. With M > 1 the batch carries a leading
    microbatch dim (M, B/M, ...). The loss is the mean of the microbatch
    losses; ``grad_norm`` is the float32 norm of the averaged gradients
    (before clipping). ``params`` and ``opt_state`` are updated in place
    and returned."""
    cfg = model.cfg
    m = microbatches if microbatches is not None else max(cfg.microbatches, 1)

    def train_step(params, opt_state, batch):
        # autograd leaves that share the parameters' storage: the step's
        # graph never marks the caller's tensors
        live = map_tree(lambda p: p.detach().requires_grad_(), params)
        inputs = flat_leaves(live)

        def grads_of(mb):
            with torch.enable_grad():
                loss = model.loss(live, mb)
                grads = torch.autograd.grad(loss, inputs)
            return loss.detach(), [_like(g, p) for g, p in zip(grads, inputs)]

        if m == 1:
            loss, grads = grads_of(batch)
        else:
            # running-sum gradient accumulation (paper Alg 3 at train level)
            gsum = [torch.zeros_like(p, dtype=torch.float32) for p in inputs]
            losses = []
            for i in range(m):
                l, g = grads_of({k: v[i] for k, v in batch.items()})
                for a, gi in zip(gsum, g):
                    a.add_(gi.float())
                del g
                losses.append(l)
            grads = [a.div_(m) for a in gsum]
            loss = torch.stack(losses).mean()

        new_params, new_opt = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            grad_norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        return new_params, new_opt, {"loss": loss, "grad_norm": grad_norm}

    return train_step


def jit_train_step(model, optimizer, mesh, rules, *, microbatches=None,
                   batch: int = 8, seq: int = 128):
    """The train step on ``mesh`` with the abstract inputs (``meta``
    tensors) the reference lowers it with: it places params, optimizer
    state and batch by their shardings and returns them so placed, the
    loss and ``grad_norm`` replicated."""
    _mesh_family(model, mesh, "the train step")
    cfg = model.cfg
    m = microbatches if microbatches is not None else max(cfg.microbatches, 1)
    step = build_train_step(model, optimizer, microbatches=m)
    bspec = train_batch_spec(cfg, batch, seq, microbatches=m)
    abstract = (
        sh.abstract_params(model.spec()),
        sh.abstract_params(optimizer.state_spec(model.spec())),
        bspec,
    )
    if mesh.size > 1:
        params_sh, opt_sh = train_state_shardings(model, optimizer, mesh, rules)
        bsh = batch_shardings(bspec, mesh, rules, microbatched=(m > 1))
        rep = sh.NamedSharding(mesh, ())
        step = _placed(step, (params_sh, opt_sh, bsh),
                       (params_sh, opt_sh, {"loss": rep, "grad_norm": rep}))
    return _with_act_context(step, mesh, rules), abstract


# ---------------------------------------------------------------------------
# Serve: prefill + decode
# ---------------------------------------------------------------------------


def build_prefill_step(model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def build_decode_step(model):
    def decode_step(params, caches, batch, index):
        return model.decode_step(params, caches, batch, index)

    return decode_step


def _logits_sharding(cfg, mesh, rules, batch):
    return sh.logical_sharding((batch, cfg.vocab_size), ("batch", "vocab"), mesh, rules)


def _cache_shardings(model, mesh, rules, batch, seq):
    return sh.named_shardings(model.cache_spec(batch, seq), mesh, rules)


def jit_prefill_step(model, mesh, rules, *, batch: int, seq: int):
    """The prefill step on ``mesh``: over several ranks it places params
    and batch and returns the logits and caches in their shardings."""
    _mesh_family(model, mesh, "the prefill step")
    bspec = train_batch_spec(model.cfg, batch, seq)
    bspec.pop("labels")
    step = torch.no_grad()(build_prefill_step(model))
    if mesh.size > 1:
        step = _placed(
            step,
            (sh.named_shardings(model.spec(), mesh, rules),
             batch_shardings(bspec, mesh, rules)),
            (_logits_sharding(model.cfg, mesh, rules, batch),
             _cache_shardings(model, mesh, rules, batch, seq)),
        )
    return _with_act_context(step, mesh, rules), (sh.abstract_params(model.spec()), bspec)


def jit_decode_step(model, mesh, rules, *, batch: int, seq: int):
    """The decode step on ``mesh``; it updates the caches in place (the
    reference donates them). Over several ranks it places its inputs and
    returns the logits and caches in their shardings."""
    _mesh_family(model, mesh, "the decode step")
    bspec = decode_batch_spec(model.cfg, batch)
    abstract = (
        sh.abstract_params(model.spec()),
        sh.abstract_params(model.cache_spec(batch, seq)),
        bspec,
        torch.empty((), dtype=torch.int32, device="meta"),
    )
    step = torch.no_grad()(build_decode_step(model))
    if mesh.size > 1:
        cache_sh = _cache_shardings(model, mesh, rules, batch, seq)
        step = _placed(
            step,
            (sh.named_shardings(model.spec(), mesh, rules), cache_sh,
             batch_shardings(bspec, mesh, rules), None),
            (_logits_sharding(model.cfg, mesh, rules, batch), cache_sh),
        )
    return _with_act_context(step, mesh, rules), abstract
