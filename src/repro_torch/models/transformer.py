"""Decoder-only transformer assembly with segment/pattern layer stacks
(counterpart of ``repro.models.transformer``).

A model is a list of **segments**; each segment repeats a **pattern** of
blocks (pattern length 1 = a plain homogeneous stack):

  qwen2.5-32b        [(64, [attn-global + mlp])]
  command-r-35b      [(40, [parallel attn+mlp])]
  h2o-danube-1.8b    [(24, [attn-swa + mlp])]
  gemma3-1b          [(4, [5x local, global])] + [(2, [local])]

The parameters of a pattern position are stacked over its repeats (a
leading ``layers`` axis), caches likewise, as in the reference. The
reference scans the stack (``jax.lax.scan``); here a loop walks the
leading axis, each layer reading views of the stacked tensors.

This slice runs the dense family (``attn`` mixers with a dense ``mlp``).
The plans of the other families are kept, so their layouts can be read,
but building or running an ``mla``, ``ssd`` or ``rec`` mixer or a
``moe`` block raises ``NotImplementedError`` (ROADMAP.md queue A item
13(b)). ``remat`` is a training concern and does not apply to serving.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.checkpoint.checkpoint import map_tree
from repro_torch.distributed.context import constrain
from repro_torch.distributed.sharding import stack_spec
from repro_torch.models import attention as A
from repro_torch.models import layers as L

__all__ = ["BlockDesc", "stack_plan", "model_spec", "cache_spec_tree",
           "forward", "prefill", "decode_step"]


@dataclasses.dataclass(frozen=True)
class BlockDesc:
    mixer: str                 # attn | mla | ssd | rec
    ffn: str | None = "mlp"    # mlp | moe | None
    window: int = 0            # 0 = global attention
    d_ff: int | None = None    # per-block MLP width override
    parallel: bool = False     # command-r style parallel residual


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP.md queue A item 13(b) "
        "(this slice serves the dense family)"
    )


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
    if desc.mixer != "attn":
        raise _unported(f"the {desc.mixer!r} mixer")
    if desc.ffn not in ("mlp", None):
        raise _unported(f"the {desc.ffn!r} block")
    spec: dict[str, Any] = {"ln1": L.norm_spec(cfg), "mixer": A.attn_spec(cfg)}
    if desc.ffn == "mlp":
        spec["mlp"] = L.mlp_spec(cfg, d_ff=desc.d_ff)
        if not desc.parallel:
            spec["ln2"] = L.norm_spec(cfg)
    return spec


def block_cache_spec(cfg, desc: BlockDesc, batch: int, seq_len: int):
    """Decode-time cache for one block. Ring caches for windowed layers."""
    if desc.mixer != "attn":
        raise _unported(f"the {desc.mixer!r} mixer's cache")
    cache_len = min(desc.window, seq_len) if desc.window else seq_len
    return A.cache_spec(cfg, batch, cache_len, dtype=L.compute_dtype(cfg))


def apply_block(params, x, cfg, desc: BlockDesc, *, mode: str, cache=None, index=None,
                max_len=None):
    """x -> (x, new_cache) for a block :func:`block_spec` built (an
    ``attn`` mixer). ``decode`` updates ``cache`` in place."""
    h = L.apply_norm(params["ln1"], x, cfg)
    new_cache = cache
    if mode == "decode":
        att, new_cache = A.decode_attention(params["mixer"], h, cache, index, cfg,
                                            window=desc.window)
    elif mode == "prefill":
        target = max_len or x.shape[1]
        cache_len = min(desc.window, target) if desc.window else target
        att, new_cache = A.prefill_attention(params["mixer"], h, cfg, window=desc.window,
                                             cache_len=cache_len)
    else:
        att = A.attention(params["mixer"], h, cfg, window=desc.window)

    if desc.parallel and desc.ffn == "mlp":
        # command-r: attn and mlp read the same norm, summed residual
        return x + att + L.apply_mlp(params["mlp"], h, cfg), new_cache
    x = x + att
    if desc.ffn == "mlp":
        x = x + L.apply_mlp(params["mlp"], L.apply_norm(params["ln2"], x, cfg), cfg)
    return x, new_cache


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
    """Layer ``i`` of a stacked tree: views of its tensors."""
    return map_tree(lambda t: t[i], tree)


def _run_segments(params, x, cfg, *, mode, caches=None, index=None, max_len=None):
    """Run every layer in order. ``prefill`` returns the caches it builds,
    stacked as the reference's scan does; ``decode`` updates ``caches`` in
    place and returns them."""
    new_caches = []
    for seg_i, (repeat, pattern) in enumerate(stack_plan(cfg)):
        seg_params = params["segments"][seg_i]
        seg_caches = caches[seg_i] if caches is not None else None
        built = [[] for _ in pattern]
        for r in range(repeat):
            for j, desc in enumerate(pattern):
                c = _layer(seg_caches[j], r) if seg_caches is not None else None
                x, nc = apply_block(_layer(seg_params[j], r), x, cfg, desc, mode=mode,
                                    cache=c, index=index, max_len=max_len)
                x = constrain(x, ("act_batch", "act_seq", "act_embed"))
                if mode == "prefill":
                    built[j].append(nc)
        if mode == "prefill":
            new_caches.append([
                {k: torch.stack([c[k] for c in layer_caches]) for k in layer_caches[0]}
                for layer_caches in built
            ])
        elif seg_caches is not None:
            new_caches.append(seg_caches)
    return x, (new_caches or None)


def forward(params, tokens, cfg, *, mode: str = "train"):
    """tokens (B,S) -> (logits (B,S,V), aux). aux is the MoE loss, 0 for the
    dense family."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x = constrain(x, ("act_batch", "act_seq", "act_embed"))
    x, _ = _run_segments(params, x, cfg, mode="train")
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return constrain(logits, ("act_batch", "act_seq", "act_vocab")), aux


def prefill(params, tokens, cfg, *, max_len=None):
    """tokens (B,S) -> (last-position logits (B,V), caches). ``max_len``
    sizes the caches for subsequent decode steps (defaults to S)."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x, caches = _run_segments(params, x, cfg, mode="prefill", max_len=max_len)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x[:, -1:, :], cfg)
    return logits[:, 0, :], caches


def decode_step(params, caches, token, index: int, cfg):
    """token (B,1) int; index: its position -> (logits (B,V), caches).
    ``caches`` are updated in place and returned (they are consumed)."""
    x = L.embed_tokens(params["embed"], token, cfg)
    x, caches = _run_segments(params, x, cfg, mode="decode", caches=caches, index=int(index))
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    return logits[:, 0, :], caches
