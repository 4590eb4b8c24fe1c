"""Multi-head Latent Attention, DeepSeek-V2 (counterpart of
``repro.models.mla``).

The KV cache stores only the compressed latent ``c_kv`` (kv_lora_rank)
plus the shared RoPE key ``k_pe`` (qk_rope_dim) per token. Prefill and
decode both use the *absorbed* form, so the cache is never decompressed:

  score(i,j) = (q_nope_i . W_uk) . c_kv_j + q_pe_i . k_pe_j
  out_i      = (sum_j p_ij c_kv_j) . W_uv

V2-Lite has no query LoRA, so q is a direct projection. As in
``attention``, :func:`mla_decode` writes the new token into the caller's
cache tensors in place (slot ``index mod T``) and returns them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.context import constrain
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.models.attention import NEG, _pad_seq
from repro_torch.models.layers import apply_norm, apply_rope, rope_angles

__all__ = ["mla_spec", "mla_cache_spec", "mla_attention", "mla_decode"]


def mla_spec(cfg):
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    return {
        "wq": ParamSpec((cfg.d_model, h, dn + dr), ("embed", "heads", "qk_dim"), init="fan_in"),
        "w_dkv": ParamSpec((cfg.d_model, r + dr), ("embed", "kv_lora"), init="fan_in"),
        "kv_norm": ParamSpec((r,), ("norm",), init="ones"),
        "w_uk": ParamSpec((r, h, dn), ("kv_lora", "heads", "qk_dim"), init="fan_in"),
        "w_uv": ParamSpec((r, h, dv), ("kv_lora", "heads", "v_dim"), init="fan_in"),
        "wo": ParamSpec((h, dv, cfg.d_model), ("heads", "v_dim", "embed"), init="fan_in"),
    }


def mla_cache_spec(cfg, batch: int, cache_len: int, *, dtype=torch.bfloat16):
    return {
        "c_kv": ParamSpec((batch, cache_len, cfg.kv_lora_rank),
                          ("batch", "cache_seq", "kv_lora"), init="zeros", dtype=dtype),
        "k_pe": ParamSpec((batch, cache_len, cfg.qk_rope_dim),
                          ("batch", "cache_seq", "qk_dim"), init="zeros", dtype=dtype),
        "pos": ParamSpec((cache_len,), ("cache_seq",), init="const", scale=-1,
                         dtype=torch.int32),
    }


def _latents(params, x, cfg):
    """x (B,T,Dm) -> c_kv (B,T,R) normed, k_pe (B,T,Dr) not yet roped."""
    r = cfg.kv_lora_rank
    dkv = torch.einsum("btd,dr->btr", x, params["w_dkv"].to(x.dtype))
    c_kv, k_pe = dkv[..., :r], dkv[..., r:]
    return apply_norm({"scale": params["kv_norm"]}, c_kv, cfg), k_pe


def _queries(params, x, cfg, positions):
    dt = x.dtype
    dn = cfg.qk_nope_dim
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, *rope_angles(positions, cfg.qk_rope_dim, cfg.rope_theta))
    # absorb W_uk: q_lat (B,S,H,R)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, params["w_uk"].to(dt))
    return constrain(q_lat, ("act_batch", "act_seq", "act_heads", None)), q_pe


def _rope_1d(x, positions, theta):
    """x (B,T,D) -> roped (no head axis)."""
    c, s = rope_angles(positions, x.shape[-1], theta)
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    c, s = c.to(x.dtype), s.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _scale(cfg) -> float:
    """``1 / sqrt(f32(qk_nope + qk_rope))`` in float32, as a Python float."""
    return float(np.float32(1) / np.sqrt(np.float32(cfg.qk_nope_dim + cfg.qk_rope_dim)))


def _logits(q_lat, q_pe, c_kv, k_pe, cfg):
    return (torch.einsum("bshr,btr->bhst", q_lat, c_kv)
            + torch.einsum("bshk,btk->bhst", q_pe, k_pe)).float() * _scale(cfg)


def _out(params, lat, dt):
    out = torch.einsum("bshr,rhv->bshv", lat, params["w_uv"].to(dt))
    return torch.einsum("bshv,hvd->bsd", out, params["wo"].to(dt))


def _latent(probs, c_kv):
    """probs (B,H,S,T), c_kv (B,T,R) -> (B,S,H,R). The product keeps the
    heads ahead of the queries, as ``probs`` has them: over a mesh that
    splits the heads, DTensor (torch 2.11) refuses to flatten queries and
    heads in the other order."""
    return torch.einsum("bhst,btr->bhsr", probs, c_kv).transpose(1, 2)


def _attend(params, q_lat, q_pe, c_kv, k_pe, mask, cfg):
    """mask (B or 1, S, T) bool."""
    dt = q_lat.dtype
    logits = torch.where(mask[:, None], _logits(q_lat, q_pe, c_kv, k_pe, cfg), NEG)
    probs = torch.softmax(logits, -1).to(dt)
    return _out(params, _latent(probs, c_kv), dt)


def _attend_qchunked(params, q_lat, q_pe, c_kv, k_pe, cfg, q_chunk=512):
    """Causal MLA looping over query chunks: O(C*S) live logits, the same
    bounded working set as ``attention._qchunk_sdpa``."""
    dt = q_lat.dtype
    b, s, h, r = q_lat.shape
    c = min(q_chunk, s)
    pad = (-s) % c
    q_lat, q_pe = _pad_seq(q_lat, pad), _pad_seq(q_pe, pad)
    n = q_lat.shape[1] // c
    k_pos = torch.arange(s, device=q_lat.device)
    lats = []
    for i in range(n):
        qli = constrain(q_lat[:, i * c:(i + 1) * c], ("act_batch", "act_attn_q_seq", "act_heads", None))
        qpi = constrain(q_pe[:, i * c:(i + 1) * c], ("act_batch", "act_attn_q_seq", "act_heads", None))
        q_pos = i * c + torch.arange(c, device=q_lat.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(mask[None, None], _logits(qli, qpi, c_kv, k_pe, cfg), NEG)
        probs = torch.softmax(logits, -1).to(dt)
        lats.append(_latent(probs, c_kv))
    return _out(params, torch.cat(lats, dim=1)[:, :s], dt)


def mla_attention(params, x, cfg, *, return_cache=False, cache_len=None):
    """Full-sequence MLA (train / prefill). x (B,S,Dm)."""
    s = x.shape[1]
    pos = torch.arange(s, device=x.device)
    c_kv, k_pe = _latents(params, x, cfg)
    k_pe = _rope_1d(k_pe, pos, cfg.rope_theta)
    q_lat, q_pe = _queries(params, x, cfg, pos)
    if s >= 2048 and getattr(cfg, "attention_impl", "blocked") == "blocked":
        y = _attend_qchunked(params, q_lat, q_pe, c_kv, k_pe, cfg,
                             q_chunk=getattr(cfg, "q_chunk", 512))
    else:
        mask = pos[None, :, None] >= pos[None, None, :]
        y = _attend(params, q_lat, q_pe, c_kv, k_pe, mask, cfg)
    if not return_cache:
        return y
    pad = (cache_len or s) - s
    cache = {
        "c_kv": _pad_seq(c_kv, pad),
        "k_pe": _pad_seq(k_pe, pad),
        "pos": torch.cat([pos, pos.new_full((pad,), -1)]).to(torch.int32),
    }
    return y, cache


def mla_decode(params, x, cache, index: int, cfg):
    """x (B,1,Dm); writes the token's latent, roped key and position into
    ``cache`` in place (slot ``index mod T``) and attends over the cache in
    the absorbed form. Returns ``(y, cache)``."""
    b = x.shape[0]
    t = cache["c_kv"].shape[1]
    pos = torch.full((1,), index, dtype=torch.int32, device=x.device)
    slot = index % t
    c_new, kpe_new = _latents(params, x, cfg)
    kpe_new = _rope_1d(kpe_new, pos, cfg.rope_theta)
    cache["c_kv"][:, slot] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_pe"][:, slot] = kpe_new[:, 0].to(cache["k_pe"].dtype)
    cache["pos"][slot] = index
    q_lat, q_pe = _queries(params, x, cfg, pos)
    k_pos = cache["pos"]
    valid = (k_pos <= index) & (k_pos >= 0)
    mask = valid[None, None, :].expand(b, 1, t)
    dt = x.dtype
    y = _attend(params, q_lat, q_pe, cache["c_kv"].to(dt), cache["k_pe"].to(dt), mask, cfg)
    return y, cache
