"""Whisper-style encoder-decoder backbone (counterpart of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings (B, T_enc, D). The transformer backbone:
pre-LN layernorm blocks, non-gated GELU MLPs, learned positional
embeddings, bidirectional encoder self-attention, causal decoder
self-attention plus cross-attention to the encoder output.

Training with ``cfg.remat`` recomputes each encoder and decoder layer in
the backward (``minimal``: only its input kept), as the reference's
``jax.checkpoint`` of its scan bodies. Serving: :func:`encode` runs once;
the cross-attention K/V of every decoder layer are precomputed (they
never change during decode), and the decoder's self-attention caches are
updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.context import constrain
from repro_torch.distributed.sharding import ParamSpec, stack_spec
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer, _layers, remat, training_remat

__all__ = [
    "encdec_spec",
    "encode",
    "decoder_forward",
    "encdec_forward",
    "decoder_cache_spec",
    "precompute_cross_kv",
    "encdec_decode_step",
]


def _enc_layer_spec(cfg):
    return {"ln1": L.norm_spec(cfg), "attn": A.attn_spec(cfg), "ln2": L.norm_spec(cfg),
            "mlp": L.mlp_spec(cfg)}


def _dec_layer_spec(cfg):
    return {
        "ln1": L.norm_spec(cfg),
        "self_attn": A.attn_spec(cfg),
        "ln_cross": L.norm_spec(cfg),
        "cross_attn": A.attn_spec(cfg, cross=True),
        "ln2": L.norm_spec(cfg),
        "mlp": L.mlp_spec(cfg),
    }


def encdec_spec(cfg):
    n_enc = cfg.encoder_layers or cfg.num_layers
    return {
        "embed": L.embed_spec(cfg),
        "enc_pos": ParamSpec((cfg.encoder_positions, cfg.d_model), ("seq", "embed"), scale=0.02),
        "dec_pos": ParamSpec((cfg.decoder_positions, cfg.d_model), ("seq", "embed"), scale=0.02),
        "encoder": stack_spec(_enc_layer_spec(cfg), n_enc),
        "enc_norm": L.norm_spec(cfg),
        "decoder": stack_spec(_dec_layer_spec(cfg), cfg.num_layers),
        "final_norm": L.norm_spec(cfg),
    }


def _enc_layer(p, x, cfg):
    h = L.apply_norm(p["ln1"], x, cfg)
    x = x + A.attention(p["attn"], h, cfg, causal=False, use_rope=False)
    h = L.apply_norm(p["ln2"], x, cfg)
    return x + L.apply_mlp(p["mlp"], h, cfg)


def _dec_layer(p, x, enc_out, cfg):
    h = L.apply_norm(p["ln1"], x, cfg)
    x = x + A.attention(p["self_attn"], h, cfg, causal=True, use_rope=False)
    h = L.apply_norm(p["ln_cross"], x, cfg)
    x = x + A.attention(p["cross_attn"], h, cfg, kv_x=enc_out, causal=False, use_rope=False)
    h = L.apply_norm(p["ln2"], x, cfg)
    return x + L.apply_mlp(p["mlp"], h, cfg)


def encode(params, frames, cfg):
    """frames (B, T_enc, D) precomputed embeddings -> encoder states."""
    dt = L.compute_dtype(cfg)
    x = frames.to(dt) + params["enc_pos"][: frames.shape[1]].to(dt)
    rematerialize = training_remat(cfg)
    for p in _layers(params["encoder"]):
        x = remat(_enc_layer, p, x, cfg) if rematerialize else _enc_layer(p, x, cfg)
        x = constrain(x, ("act_batch", "act_seq", "act_embed"))
    return L.apply_norm(params["enc_norm"], x, cfg)


def decoder_forward(params, tokens, enc_out, cfg):
    """Teacher-forced decoder. tokens (B,S) -> logits (B,S,V)."""
    dt = L.compute_dtype(cfg)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x = x + params["dec_pos"][: tokens.shape[1]].to(dt)
    rematerialize = training_remat(cfg)
    for p in _layers(params["decoder"]):
        if rematerialize:
            x = remat(_dec_layer, p, x, enc_out, cfg)
        else:
            x = _dec_layer(p, x, enc_out, cfg)
        x = constrain(x, ("act_batch", "act_seq", "act_embed"))
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)


def encdec_forward(params, frames, tokens, cfg):
    return decoder_forward(params, tokens, encode(params, frames, cfg), cfg)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def decoder_cache_spec(cfg, batch: int, seq_len: int):
    """Self-attn caches (stacked) + cross K/V (stacked, static)."""
    dt = L.compute_dtype(cfg)
    self_spec = stack_spec(A.cache_spec(cfg, batch, seq_len, dtype=dt), cfg.num_layers)
    shape = (cfg.num_layers, batch, cfg.encoder_positions, cfg.num_kv_heads, cfg.head_dim)
    axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    cross = {"k": ParamSpec(shape, axes, init="zeros", dtype=dt),
             "v": ParamSpec(shape, axes, init="zeros", dtype=dt)}
    return {"self": self_spec, "cross": cross}


def precompute_cross_kv(params, enc_out, cfg):
    """Every decoder layer's cross-attention K and V over ``enc_out``,
    stacked over the layers: {k, v} (layers, B, T_enc, K, D)."""
    dt = enc_out.dtype
    ca = params["decoder"]["cross_attn"]
    return {"k": torch.einsum("btd,ldhk->lbthk", enc_out, ca["wk"].to(dt)),
            "v": torch.einsum("btd,ldhk->lbthk", enc_out, ca["wv"].to(dt))}


def encdec_decode_step(params, caches, token, index: int, cfg):
    """token (B,1) -> (logits (B,V), caches). The self-attention caches are
    updated in place; the cross K/V are static."""
    index = int(index)
    dt = L.compute_dtype(cfg)
    x = L.embed_tokens(params["embed"], token, cfg)
    x = x + params["dec_pos"][index:index + 1].to(dt)
    cross_k, cross_v = caches["cross"]["k"], caches["cross"]["v"]
    for i, p in enumerate(_layers(params["decoder"])):
        self_c = _layer(caches["self"], i)
        h = L.apply_norm(p["ln1"], x, cfg)
        att, _ = A.decode_attention(p["self_attn"], h, self_c, index, cfg, use_rope=False)
        x = x + att
        h = L.apply_norm(p["ln_cross"], x, cfg)
        # cross attention over the precomputed encoder K/V (no mask, no update)
        q = torch.einsum("bsd,dhk->bshk", h, p["cross_attn"]["wq"].to(dt))
        b, s = q.shape[0], q.shape[1]
        mask = torch.ones((b, 1, s, cross_k.shape[2]), dtype=torch.bool, device=x.device)
        out = A._sdpa(q, cross_k[i].to(dt), cross_v[i].to(dt), mask, cfg)
        x = x + torch.einsum("bshk,hkd->bsd", out, p["cross_attn"]["wo"].to(dt))
        h = L.apply_norm(p["ln2"], x, cfg)
        x = x + L.apply_mlp(p["mlp"], h, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    return logits[:, 0, :], caches
