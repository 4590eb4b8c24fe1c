"""Decoder-only transformer assembly with segment/pattern layer stacks
(counterpart of ``repro.models.transformer``).

A model is a list of **segments**; each segment repeats a **pattern** of
blocks (pattern length 1 = a plain homogeneous stack):

  qwen2.5-32b        [(64, [attn-global + mlp])]
  command-r-35b      [(40, [parallel attn+mlp])]
  h2o-danube-1.8b    [(24, [attn-swa + mlp])]
  gemma3-1b          [(4, [5x local, global])] + [(2, [local])]
  deepseek-v2-lite   [(1, [mla + dense-mlp])] + [(26, [mla + moe])]
  mixtral-8x7b       [(32, [attn-swa + moe])]
  recurrentgemma-9b  [(12, [rec, rec, attn-local])] + [(2, [rec])]
  mamba2-780m        [(48, [ssd])]

The parameters of a pattern position are stacked over its repeats (a
leading ``layers`` axis), caches likewise, as in the reference. The
reference scans the stack (``jax.lax.scan``); here a loop walks the
leading axis, each layer reading views of the stacked tensors (one
``unbind`` per stacked leaf, :func:`_layers`), and decode updates the
caller's caches (KV caches, MLA latents, SSD and RG-LRU states) in place.
Every mixer (``attn``, ``mla``, ``ssd``, ``rec``) and block (``mlp``,
``moe``) serves and trains.

Training with ``cfg.remat`` recomputes each layer's activations in the
backward (:func:`remat`, the counterpart of the reference's
``jax.checkpoint`` of its scan body): ``remat_policy="minimal"`` saves
only the layer's input, ``"dots"`` also its products with no batch
dimension. Serving (no autograd) never rematerializes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.checkpoint.checkpoint import flat_leaves, map_tree
from repro_torch.distributed.context import activation_sharding, active, constrain
from repro_torch.distributed.sharding import stack_spec
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from repro_torch.models import ssd as S

__all__ = ["BlockDesc", "stack_plan", "model_spec", "cache_spec_tree",
           "forward", "prefill", "decode_step"]


@dataclasses.dataclass(frozen=True)
class BlockDesc:
    mixer: str                 # attn | mla | ssd | rec
    ffn: str | None = "mlp"    # mlp | moe | None
    window: int = 0            # 0 = global attention
    d_ff: int | None = None    # per-block MLP width override
    parallel: bool = False     # command-r style parallel residual


# ---------------------------------------------------------------------------
# Stack plans per architecture family
# ---------------------------------------------------------------------------


def stack_plan(cfg) -> list[tuple[int, list[BlockDesc]]]:
    if cfg.family == "ssm":
        return [(cfg.num_layers, [BlockDesc("ssd", ffn=None)])]

    if cfg.family == "hybrid":
        pat = list(cfg.block_pattern) or ["rec", "rec", "attn"]
        descs = [
            BlockDesc("rec") if p == "rec"
            else BlockDesc("attn", window=cfg.local_window or 2048)
            for p in pat
        ]
        groups = cfg.num_layers // len(pat)
        rem = cfg.num_layers - groups * len(pat)
        plan = [(groups, descs)]
        if rem:
            plan.append((rem, [BlockDesc("rec")]))
        return plan

    ffn = "moe" if cfg.num_experts else "mlp"
    mixer = "mla" if cfg.use_mla else "attn"
    window = cfg.sliding_window or 0

    plan: list[tuple[int, list[BlockDesc]]] = []
    n = cfg.num_layers
    if cfg.first_dense_layers:
        plan.append((cfg.first_dense_layers, [BlockDesc(mixer, ffn="mlp", d_ff=cfg.d_ff)]))
        n -= cfg.first_dense_layers

    if cfg.local_global_ratio:
        r = cfg.local_global_ratio
        local = BlockDesc(mixer, ffn=ffn, window=cfg.local_window or 1024,
                          parallel=cfg.parallel_block)
        glob = BlockDesc(mixer, ffn=ffn, window=0, parallel=cfg.parallel_block)
        groups = n // (r + 1)
        plan.append((groups, [local] * r + [glob]))
        rem = n - groups * (r + 1)
        if rem:
            plan.append((rem, [local]))
        return plan

    plan.append((n, [BlockDesc(mixer, ffn=ffn, window=window, parallel=cfg.parallel_block)]))
    return plan


# ---------------------------------------------------------------------------
# One block: spec + apply
# ---------------------------------------------------------------------------


def block_spec(cfg, desc: BlockDesc):
    spec: dict[str, Any] = {"ln1": L.norm_spec(cfg)}
    if desc.mixer == "attn":
        spec["mixer"] = A.attn_spec(cfg)
    elif desc.mixer == "mla":
        spec["mixer"] = M.mla_spec(cfg)
    elif desc.mixer == "ssd":
        spec["mixer"] = S.ssd_spec(cfg)
    elif desc.mixer == "rec":
        spec["mixer"] = R.rglru_spec(cfg)
    else:
        raise ValueError(desc.mixer)
    if desc.ffn == "mlp":
        spec["mlp"] = L.mlp_spec(cfg, d_ff=desc.d_ff)
        if not desc.parallel:
            spec["ln2"] = L.norm_spec(cfg)
    elif desc.ffn == "moe":
        spec["moe"] = MOE.moe_spec(cfg)
        spec["ln2"] = L.norm_spec(cfg)
    return spec


def block_cache_spec(cfg, desc: BlockDesc, batch: int, seq_len: int):
    """Decode-time cache for one block. Ring caches for windowed layers."""
    if desc.mixer == "attn":
        cache_len = min(desc.window, seq_len) if desc.window else seq_len
        return A.cache_spec(cfg, batch, cache_len, dtype=L.compute_dtype(cfg))
    if desc.mixer == "mla":
        return M.mla_cache_spec(cfg, batch, seq_len, dtype=L.compute_dtype(cfg))
    if desc.mixer == "ssd":
        return S.ssd_state_spec(cfg, batch)
    if desc.mixer == "rec":
        return R.rglru_state_spec(cfg, batch)
    raise ValueError(desc.mixer)


def _mixer(params, h, cfg, desc: BlockDesc, *, mode, cache, index, max_len):
    """The block's mixer -> (output, cache)."""
    target = max_len or h.shape[1]
    if desc.mixer == "attn":
        if mode == "decode":
            return A.decode_attention(params, h, cache, index, cfg, window=desc.window)
        if mode == "prefill":
            cache_len = min(desc.window, target) if desc.window else target
            return A.prefill_attention(params, h, cfg, window=desc.window, cache_len=cache_len)
        return A.attention(params, h, cfg, window=desc.window), cache
    if desc.mixer == "mla":
        if mode == "decode":
            return M.mla_decode(params, h, cache, index, cfg)
        if mode == "prefill":
            return M.mla_attention(params, h, cfg, return_cache=True, cache_len=target)
        return M.mla_attention(params, h, cfg), cache
    if desc.mixer == "ssd":
        if mode == "decode":
            return S.ssd_decode(params, h, cache, cfg)
        if mode == "prefill":
            return S.apply_ssd(params, h, cfg, return_state=True)
        return S.apply_ssd(params, h, cfg), cache
    if desc.mixer == "rec":
        if mode == "decode":
            return R.rglru_decode(params, h, cache, cfg)
        if mode == "prefill":
            return R.apply_rglru(params, h, cfg, return_state=True)
        return R.apply_rglru(params, h, cfg), cache
    raise ValueError(desc.mixer)


def apply_block(params, x, cfg, desc: BlockDesc, *, mode: str, cache=None, index=None,
                max_len=None):
    """x -> (x, new_cache, aux_loss). ``decode`` updates ``cache`` in place;
    aux_loss is the MoE block's, else ``None`` (no loss)."""
    h = L.apply_norm(params["ln1"], x, cfg)
    att, new_cache = _mixer(params["mixer"], h, cfg, desc, mode=mode, cache=cache,
                            index=index, max_len=max_len)
    if desc.parallel and desc.ffn == "mlp":
        # command-r: attn and mlp read the same norm, summed residual
        return x + att + L.apply_mlp(params["mlp"], h, cfg), new_cache, None
    x = x + att
    aux = None
    if desc.ffn == "mlp":
        x = x + L.apply_mlp(params["mlp"], L.apply_norm(params["ln2"], x, cfg), cfg)
    elif desc.ffn == "moe":
        out, aux = MOE.apply_moe(params["moe"], L.apply_norm(params["ln2"], x, cfg), cfg)
        x = x + out
    return x, new_cache, aux


def _train_block(params, x, *, cfg, desc: BlockDesc):
    """One block in training mode -> (x, aux): what :func:`remat` wraps."""
    x, _, aux = apply_block(params, x, cfg, desc, mode="train")
    return x, aux


# ---------------------------------------------------------------------------
# Whole-model spec
# ---------------------------------------------------------------------------


def model_spec(cfg):
    segments = [
        [stack_spec(block_spec(cfg, d), repeat) for d in pattern]
        for repeat, pattern in stack_plan(cfg)
    ]
    return {"embed": L.embed_spec(cfg), "final_norm": L.norm_spec(cfg), "segments": segments}


def cache_spec_tree(cfg, batch: int, seq_len: int):
    return [
        [stack_spec(block_cache_spec(cfg, d, batch, seq_len), repeat) for d in pattern]
        for repeat, pattern in stack_plan(cfg)
    ]


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree: views of its tensors (the caches,
    which decode updates in place)."""
    return map_tree(lambda t: t[i], tree)


def _layers(tree, n: int | None = None) -> list:
    """The ``n`` layers of a stacked tree (default: its leading size), each
    a tree of views. One ``unbind`` per leaf, so a backward stacks each
    leaf's layer gradients once; ``t[i]`` per layer would write a
    zero-filled gradient the size of the whole stack for every layer."""
    if n is None:
        n = flat_leaves(tree)[0].shape[0]
    rows: dict[int, tuple] = {}

    def row(t, i):
        if id(t) not in rows:
            rows[id(t)] = t.unbind(0)
        return rows[id(t)][i]

    return [map_tree(lambda t, i=i: row(t, i), tree) for i in range(n)]


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpoint policy, the counterpart of
    ``dots_with_no_batch_dims_saveable``: keep the products with no batch
    dimension (``einsum`` over a weight runs as ``bmm`` with a batch of 1,
    or ``mm``), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, *args, policy: str = "minimal"):
    """``fn(*args)``, its activations recomputed in the backward
    (``jax.checkpoint``): ``minimal`` keeps only the inputs, ``dots`` also
    the products with no batch dimension (:func:`_save_dots`). The
    recomputation runs under the activation sharding of the call (the
    backward of CUDA tensors runs on autograd's own thread, where the
    caller's context is not active), so it places every activation as the
    forward did."""
    context_fn = noop_context_fn
    if policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    ctx = active()
    if ctx is not None:
        fn = functools.partial(_under, ctx, fn)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)


def _under(ctx, fn, *args):
    with activation_sharding(*ctx):
        return fn(*args)


def training_remat(cfg, mode: str = "train") -> bool:
    """Whether a forward rematerializes: ``cfg.remat`` in training mode,
    while autograd records (never when serving)."""
    return bool(cfg.remat) and mode == "train" and torch.is_grad_enabled()


def _run_segments(params, x, cfg, *, mode, caches=None, index=None, max_len=None):
    """Run every layer in order -> (x, aux, caches); aux sums the MoE
    blocks' losses (float32). ``prefill`` returns the caches it builds,
    stacked as the reference's scan does; ``decode`` updates ``caches`` in
    place and returns them."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    rematerialize = training_remat(cfg, mode)
    for seg_i, (repeat, pattern) in enumerate(stack_plan(cfg)):
        seg_params = [_layers(p, repeat) for p in params["segments"][seg_i]]
        seg_caches = caches[seg_i] if caches is not None else None
        built = [[] for _ in pattern]
        for r in range(repeat):
            for j, desc in enumerate(pattern):
                c = _layer(seg_caches[j], r) if seg_caches is not None else None
                if rematerialize:
                    block = functools.partial(_train_block, seg_params[j][r], cfg=cfg, desc=desc)
                    x, aux = remat(block, x, policy=cfg.remat_policy)
                    nc = None
                else:
                    x, nc, aux = apply_block(seg_params[j][r], x, cfg, desc, mode=mode,
                                             cache=c, index=index, max_len=max_len)
                x = constrain(x, ("act_batch", "act_seq", "act_embed"))
                if aux is not None:
                    aux_total = aux_total + aux
                if mode == "prefill":
                    built[j].append(nc)
        if mode == "prefill":
            new_caches.append([
                {k: torch.stack([c[k] for c in layer_caches]) for k in layer_caches[0]}
                for layer_caches in built
            ])
        elif seg_caches is not None:
            new_caches.append(seg_caches)
    return x, aux_total, (new_caches or None)


def forward(params, tokens, cfg, *, mode: str = "train"):
    """tokens (B,S) -> (logits (B,S,V), aux). aux is the summed MoE loss
    (float32), 0 without MoE blocks."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x = constrain(x, ("act_batch", "act_seq", "act_embed"))
    x, aux, _ = _run_segments(params, x, cfg, mode="train")
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    return constrain(logits, ("act_batch", "act_seq", "act_vocab")), aux


def prefill(params, tokens, cfg, *, max_len=None):
    """tokens (B,S) -> (last-position logits (B,V), caches). ``max_len``
    sizes the caches for subsequent decode steps (defaults to S)."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x, _, caches = _run_segments(params, x, cfg, mode="prefill", max_len=max_len)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x[:, -1:, :], cfg)
    return logits[:, 0, :], caches


def decode_step(params, caches, token, index: int, cfg):
    """token (B,1) int; index: its position -> (logits (B,V), caches).
    ``caches`` are updated in place and returned (they are consumed)."""
    x = L.embed_tokens(params["embed"], token, cfg)
    x, _, caches = _run_segments(params, x, cfg, mode="decode", caches=caches,
                                 index=int(index))
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    return logits[:, 0, :], caches
