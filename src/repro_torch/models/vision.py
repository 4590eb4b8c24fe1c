"""Llama-3.2-Vision text backbone with cross-attention image layers
(counterpart of ``repro.models.vision``).

The vision tower is a stub, as in the reference: the batch carries
precomputed patch embeddings (B, T_img, D). The backbone follows the
published structure: a cross-attention layer at every 5th position (8 of
40) with tanh-gated residuals, GQA self-attention elsewhere, laid out as
groups of [self, self, self, cross, self]. Each position's parameters are
stacked over the groups, as the reference's scan takes them; a loop walks
the groups here. Decode updates the self-attention caches in place.
Training with ``cfg.remat`` recomputes each layer in the backward under
the ``dots`` policy (products with no batch dimension kept), as the
reference's ``jax.checkpoint`` of its group body does whatever
``cfg.remat_policy`` says.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.distributed.context import constrain
from repro_torch.distributed.sharding import ParamSpec, stack_spec
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer, _layers, remat, training_remat

__all__ = ["vlm_spec", "vlm_forward", "vlm_cache_spec", "vlm_prefill", "vlm_decode_step"]

GROUP = 5          # one cross-attn layer per 5 backbone positions
CROSS_POS = 3      # cross layer index within the group (matches hf layout)


def _self_layer_spec(cfg):
    return {"ln1": L.norm_spec(cfg), "attn": A.attn_spec(cfg), "ln2": L.norm_spec(cfg),
            "mlp": L.mlp_spec(cfg)}


def _cross_layer_spec(cfg):
    return {
        "ln1": L.norm_spec(cfg),
        "cross_attn": A.attn_spec(cfg, cross=True),
        "gate_attn": ParamSpec((), (), init="zeros"),
        "ln2": L.norm_spec(cfg),
        "mlp": L.mlp_spec(cfg),
        "gate_mlp": ParamSpec((), (), init="zeros"),
    }


def vlm_spec(cfg):
    groups = cfg.num_layers // GROUP
    return {
        "embed": L.embed_spec(cfg),
        "final_norm": L.norm_spec(cfg),
        "self_layers": [stack_spec(_self_layer_spec(cfg), groups) for _ in range(GROUP - 1)],
        "cross_layers": stack_spec(_cross_layer_spec(cfg), groups),
    }


def _apply_self(p, x, cfg, *, mode, cache=None, index=None, max_len=None):
    h = L.apply_norm(p["ln1"], x, cfg)
    new_cache = cache
    if mode == "decode":
        att, new_cache = A.decode_attention(p["attn"], h, cache, index, cfg)
    elif mode == "prefill":
        att, new_cache = A.prefill_attention(p["attn"], h, cfg, cache_len=max_len or x.shape[1])
    else:
        att = A.attention(p["attn"], h, cfg)
    x = x + att
    h = L.apply_norm(p["ln2"], x, cfg)
    return x + L.apply_mlp(p["mlp"], h, cfg), new_cache


def _train_self(p, x, *, cfg):
    """A self-attention layer in training mode: what :func:`remat` wraps."""
    return _apply_self(p, x, cfg, mode="train")[0]


def _apply_cross(p, x, img, cfg):
    """Tanh-gated cross-attention into precomputed image embeddings."""
    dt = x.dtype
    h = L.apply_norm(p["ln1"], x, cfg)
    att = A.attention(p["cross_attn"], h, cfg, kv_x=img, causal=False, use_rope=False)
    x = x + torch.tanh(p["gate_attn"]).to(dt) * att
    h = L.apply_norm(p["ln2"], x, cfg)
    return x + torch.tanh(p["gate_mlp"]).to(dt) * L.apply_mlp(p["mlp"], h, cfg)


def _run(params, x, img, cfg, *, mode, caches=None, index=None, max_len=None):
    """Groups of [self x3, cross, self]. ``prefill`` returns the caches it
    builds (one stack over the groups per self position); ``decode``
    updates ``caches`` in place and returns them."""
    groups = cfg.num_layers // GROUP
    cross = _layers(params["cross_layers"], groups)
    selfs = [_layers(p, groups) for p in params["self_layers"]]
    rematerialize = training_remat(cfg, mode)
    built = [[] for _ in range(GROUP - 1)]
    for g in range(groups):
        si = 0
        for pos in range(GROUP):
            if pos == CROSS_POS:
                if rematerialize:
                    x = remat(functools.partial(_apply_cross, cross[g], img=img, cfg=cfg), x,
                              policy="dots")
                else:
                    x = _apply_cross(cross[g], x, img, cfg)
                continue
            c = _layer(caches[si], g) if caches is not None else None
            if rematerialize:
                x = remat(functools.partial(_train_self, selfs[si][g], cfg=cfg), x,
                          policy="dots")
                nc = None
            else:
                x, nc = _apply_self(selfs[si][g], x, cfg, mode=mode, cache=c, index=index,
                                    max_len=max_len)
            if mode == "prefill":
                built[si].append(nc)
            si += 1
        x = constrain(x, ("act_batch", "act_seq", "act_embed"))
    if mode == "prefill":
        return x, [{k: torch.stack([c[k] for c in cs]) for k in cs[0]} for cs in built]
    return x, caches


def vlm_forward(params, tokens, image_embeds, cfg):
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x, _ = _run(params, x, image_embeds.to(x.dtype), cfg, mode="train")
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)


def vlm_cache_spec(cfg, batch: int, seq_len: int):
    groups = cfg.num_layers // GROUP
    one = A.cache_spec(cfg, batch, seq_len, dtype=L.compute_dtype(cfg))
    return [stack_spec(one, groups) for _ in range(GROUP - 1)]


def vlm_prefill(params, tokens, image_embeds, cfg, *, max_len=None):
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x, caches = _run(params, x, image_embeds.to(x.dtype), cfg, mode="prefill",
                     max_len=max_len)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x[:, -1:, :], cfg)
    return logits[:, 0, :], caches


def vlm_decode_step(params, caches, token, image_embeds, index: int, cfg):
    x = L.embed_tokens(params["embed"], token, cfg)
    x, caches = _run(params, x, image_embeds.to(x.dtype), cfg, mode="decode", caches=caches,
                     index=int(index))
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    return logits[:, 0, :], caches
