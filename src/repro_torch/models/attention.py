"""GQA/MQA attention with RoPE, sliding-window / local-global masking, and
full or ring-buffer (windowed) KV caches for serving (counterpart of
``repro.models.attention``).

The reference's formulation, op for op: the einsums, the float32 softmax
over logits masked with ``-1e30``, and its blocked paths for long
sequences (banded for windowed layers, query-chunked for global ones).
These are products XLA computes outside any Pallas kernel, so
``torch.einsum`` computes them here; no fused library attention is used,
which would change the algorithm and its rounding.

Cache kinds:

* full — ``(B, S_max, K, D)``; write at ``index``; mask ``k_pos <= q_pos``;
* ring — ``(B, W, K, D)`` for windowed layers: slot ``index mod W``, the
  stored positions give exact masking, and the cache holds O(W), not
  O(S).

**Caches are updated in place.** The reference returns new caches (its
decode step is jitted without donation). :func:`decode_attention` writes
the new token's key, value and position into the caller's cache tensors
and returns them: the caller's caches are consumed, as a donated buffer
would be. Clone them first to keep the old state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.context import constrain
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.models.layers import apply_rope, rope_angles

NEG = -1e30  # the reference's mask value, in float32

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def attn_spec(cfg, *, cross: bool = False):
    h, k, d, dm = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    spec = {
        "wq": ParamSpec((dm, h, d), ("embed", "heads", "head_dim"), init="fan_in"),
        "wk": ParamSpec((dm, k, d), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wv": ParamSpec((dm, k, d), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wo": ParamSpec((h, d, dm), ("heads", "head_dim", "embed"), init="fan_in"),
    }
    if cfg.qkv_bias and not cross:
        spec["bq"] = ParamSpec((h, d), ("heads", "head_dim"), init="zeros")
        spec["bk"] = ParamSpec((k, d), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = ParamSpec((k, d), ("kv_heads", "head_dim"), init="zeros")
    return spec


def cache_spec(cfg, batch: int, cache_len: int, *, dtype=torch.bfloat16):
    """KV cache for ONE layer. Stack with stack_spec for a layer stack."""
    k, d = cfg.num_kv_heads, cfg.head_dim
    kv_axes = ("batch", "cache_seq", "kv_heads", "head_dim")
    return {
        "k": ParamSpec((batch, cache_len, k, d), kv_axes, init="zeros", dtype=dtype),
        "v": ParamSpec((batch, cache_len, k, d), kv_axes, init="zeros", dtype=dtype),
        "pos": ParamSpec((cache_len,), ("cache_seq",), init="const", scale=-1,
                         dtype=torch.int32),
    }


# ---------------------------------------------------------------------------
# Core scaled-dot-product with GQA grouping (softmax in fp32)
# ---------------------------------------------------------------------------


# Scalars enter as Python floats holding float32 values: a scalar tensor
# made on the card would cost a host-device copy and a synchronisation.


def _sqrt_d(d: int) -> float:
    """``sqrt(f32(d))``, the reference's divisor."""
    return float(np.sqrt(np.float32(d)))


def _soft_cap(logits, cfg):
    if cfg.logit_soft_cap:
        cap = float(np.float32(cfg.logit_soft_cap))
        logits = cap * torch.tanh(logits / cap)
    return logits


def _masked_softmax(logits, mask, dtype):
    return torch.softmax(torch.where(mask, logits, NEG), dim=-1).to(dtype)


def _sdpa(q, k, v, mask, cfg):
    """q (B,S,H,D), k/v (B,T,K,D), mask (B,1,S,T) or (1,1,S,T) bool."""
    b, s, h, d = q.shape
    kv_heads = k.shape[2]
    group = h // kv_heads
    q = q.reshape(b, s, kv_heads, group, d)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    logits = _soft_cap(logits / _sqrt_d(d), cfg)
    probs = _masked_softmax(logits, mask[:, :, None], q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def _causal_window_mask(q_pos, k_pos, window):
    """bool (..., S, T). window <= 0 means unbounded (global)."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    causal = k <= q
    if window <= 0:
        return causal
    return causal & (k > q - window)


# ---------------------------------------------------------------------------
# Blocked attention (the path for long sequences): never materialize the
# O(S^2) logits.
#   * windowed layers -> BANDED: each query chunk attends to its own and the
#     previous key chunk only (chunk = window), O(S*2W) logits and flops;
#   * global layers   -> Q-CHUNKED loop, O(C*S) live logits per step.
# ---------------------------------------------------------------------------


def _gqa_logits(q, k, scale, cfg):
    """q (..., C, K, G, D), k (..., T, K, D) -> (..., K, G, C, T) fp32."""
    logits = torch.einsum("...ckgd,...tkd->...kgct", q, k).float()
    return _soft_cap(logits * scale, cfg)


def _pad_seq(x, pad):
    """Zeros appended along the sequence axis (1)."""
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], dim=1)


def _banded_sdpa(q, k, v, window: int, cfg):
    """Sliding-window attention with O(S*2W) working set. window <= chunk."""
    b, s, h, d = q.shape
    kv_heads = k.shape[2]
    g = h // kv_heads
    c = window
    pad = (-s) % c
    q, k, v = (_pad_seq(t, pad) for t in (q, k, v))
    n = q.shape[1] // c
    qc = q.reshape(b, n, c, kv_heads, g, d)
    qc = constrain(qc, ("act_batch", None, "act_attn_q_seq", "act_kv_heads", None, None))
    kc = k.reshape(b, n, c, kv_heads, d)
    vc = v.reshape(b, n, c, kv_heads, d)
    # the previous chunk (zeros before the first)
    kp = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vp = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    kk = torch.cat([kp, kc], dim=2)  # (b, n, 2c, kv, d)
    vv = torch.cat([vp, vc], dim=2)
    scale = float(np.float32(1) / np.float32(_sqrt_d(d)))
    logits = _gqa_logits(qc, kk, scale, cfg)  # (b, n, kv, g, c, 2c)
    dev = q.device
    a = torch.arange(c, device=dev)[:, None]          # in-chunk query pos
    t = torch.arange(2 * c, device=dev)[None, :]      # key slot
    delta = c + a - t
    band = (delta >= 0) & (delta < window)            # (c, 2c)
    ni = torch.arange(n, device=dev)[:, None, None]   # chunk index
    mask = band[None] & ((ni > 0) | (t >= c)[None])   # no prev before chunk 0
    mask = mask & ((ni - 1) * c + t[None] < s)        # padded keys beyond s
    probs = _masked_softmax(logits, mask[:, None, None], q.dtype)
    out = torch.einsum("bnkgct,bntkd->bnckgd", probs, vv)
    return out.reshape(b, n * c, h, d)[:, :s]


def _qchunk_sdpa(q, k, v, window, cfg, q_chunk: int = 512):
    """Causal attention looping over query chunks: O(C*S) live logits."""
    b, s, h, d = q.shape
    kv_heads = k.shape[2]
    g = h // kv_heads
    c = min(q_chunk, s)
    q = _pad_seq(q, (-s) % c)
    n = q.shape[1] // c
    qc = q.reshape(b, n, c, kv_heads, g, d)
    scale = float(np.float32(1) / np.float32(_sqrt_d(d)))
    k_pos = torch.arange(s, device=q.device)
    outs = []
    for i in range(n):
        qi = constrain(qc[:, i], ("act_batch", "act_attn_q_seq", "act_kv_heads", None, None))
        logits = _gqa_logits(qi, k, scale, cfg)  # (b, kv, g, c, s)
        q_pos = i * c + torch.arange(c, device=q.device)
        mask = _causal_window_mask(q_pos, k_pos, window)
        probs = _masked_softmax(logits, mask[None, None, None], q.dtype)
        outs.append(torch.einsum("bkgct,btkd->bckgd", probs, v))
    out = torch.stack(outs, dim=1).reshape(b, n * c, h, d)
    return out[:, :s]


# the naive path for short sequences (and the reference's "before" baseline)
_BLOCKED_MIN_SEQ = 2048


def _full_attention_core(q, k, v, window: int, cfg):
    """Dispatch naive / banded / q-chunked for full-sequence attention."""
    s = q.shape[1]
    impl = getattr(cfg, "attention_impl", "blocked")
    if impl == "blocked" and s >= _BLOCKED_MIN_SEQ:
        if window and s > 2 * window:
            return _banded_sdpa(q, k, v, window, cfg)
        return _qchunk_sdpa(q, k, v, window, cfg, q_chunk=getattr(cfg, "q_chunk", 512))
    pos = torch.arange(s, device=q.device)
    mask = _causal_window_mask(pos, pos, window)[None]
    return _sdpa(q, k, v, mask[:, None], cfg)


# ---------------------------------------------------------------------------
# Over a mesh of several ranks: the attention core on each rank's shard
# ---------------------------------------------------------------------------


def _shard_placements(q, k):
    """Placements under which each rank's attention needs nothing of the
    others: on each mesh dimension the batch split (dim 0) as it is, the
    heads split (dim 2) where q's and k's heads split alike (or k has one
    head, every q head's), anything else replicated."""
    from torch.distributed.tensor import Replicate, Shard

    qp, kp = [], []
    for a, b in zip(q.placements, k.placements):
        if a == b and (a == Shard(0) or a == Shard(2)):
            qp.append(a)
            kp.append(b)
        elif a == Shard(2) and b == Replicate() and k.shape[2] == 1:
            qp.append(a)
            kp.append(b)
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    return tuple(qp), tuple(kp)


def _on_shards(core, q, k, v, *args):
    """``core(q, k, v, *args)``; over DTensors, on each rank's batch and
    head shard (:func:`_shard_placements`) and returned at q's placements.
    Attention is independent per sequence and head, so the result is the
    one-device one, and no einsum inside flattens a sharded dimension
    (which DTensor's view rules refuse)."""
    if not hasattr(q, "device_mesh"):
        return core(q, k, v, *args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    qp, kp = _shard_placements(q, k)
    # where the q heads are split and the one k head is not, each rank's
    # gradient of k (and v) is its heads' share of the sum
    kgrad = tuple(Partial() if a == Shard(2) and b == Replicate() else b
                  for a, b in zip(qp, kp))
    # a mask over the cache's stored positions is replicated: its full value
    args = [a.full_tensor() if hasattr(a, "device_mesh") else a for a in args]
    out = core(q.redistribute(mesh, qp).to_local(),
               k.redistribute(mesh, kp).to_local(grad_placements=kgrad),
               v.redistribute(mesh, kp).to_local(grad_placements=kgrad), *args)
    return DTensor.from_local(out, mesh, qp, run_check=False, shape=q.shape,
                              stride=q.stride())


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def _project(params, x, src, dt):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", src, params["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", src, params["wv"].to(dt))
    q = constrain(q, ("act_batch", "act_seq", "act_heads", None))
    k = constrain(k, ("act_batch", "act_seq", "act_kv_heads", None))
    v = constrain(v, ("act_batch", "act_seq", "act_kv_heads", None))
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    return q, k, v


def _out(params, out, dt):
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))


# ---------------------------------------------------------------------------
# Full-sequence attention (train / prefill)
# ---------------------------------------------------------------------------


def attention(params, x, cfg, *, window=0, kv_x=None, causal=True, use_rope=True,
              positions=None):
    """x (B,S,Dm) -> (B,S,Dm). kv_x: cross-attention source (B,T,Dm)."""
    dt = x.dtype
    s = x.shape[1]
    src = kv_x if kv_x is not None else x
    t = src.shape[1]
    q, k, v = _project(params, x, src, dt)
    dev = x.device
    if use_rope:
        q_pos = positions if positions is not None else torch.arange(s, device=dev)
        k_pos = positions if positions is not None else torch.arange(t, device=dev)
        q = apply_rope(q, *rope_angles(q_pos, cfg.head_dim, cfg.rope_theta))
        k = apply_rope(k, *rope_angles(k_pos, cfg.head_dim, cfg.rope_theta))
    if causal and kv_x is None:
        out = _on_shards(_full_attention_core, q, k, v, window, cfg)
    else:
        if causal:
            mask = _causal_window_mask(torch.arange(s, device=dev),
                                       torch.arange(t, device=dev), window)[None]
        else:
            mask = torch.ones((1, s, t), dtype=torch.bool, device=dev)
        out = _on_shards(_sdpa, q, k, v, mask[:, None], cfg)
    return _out(params, out, dt)


# ---------------------------------------------------------------------------
# Prefill: full attention that also returns a populated cache
# ---------------------------------------------------------------------------


def prefill_attention(params, x, cfg, *, window=0, cache_len=None):
    dt = x.dtype
    s = x.shape[1]
    cache_len = cache_len or s
    q, k, v = _project(params, x, x, dt)
    pos = torch.arange(s, device=x.device)
    cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    y = _out(params, _on_shards(_full_attention_core, q, k, v, window, cfg), dt)
    if cache_len == s:
        ck, cv, cpos = k, v, pos
    elif cache_len < s:  # ring: keep the last cache_len positions, rotated
        start = s - cache_len
        # entry j holds pos S-T+j; decode expects it at slot pos % T, so
        # roll right by S % T
        roll = s % cache_len
        ck = torch.roll(k[:, start:], roll, dims=1)
        cv = torch.roll(v[:, start:], roll, dims=1)
        cpos = torch.roll(pos[start:], roll, dims=0)
    else:
        pad = cache_len - s
        ck = _pad_seq(k, pad)
        cv = _pad_seq(v, pad)
        cpos = torch.cat([pos, pos.new_full((pad,), -1)])
    return y, {"k": ck, "v": cv, "pos": cpos.to(torch.int32)}


# ---------------------------------------------------------------------------
# Decode: one token in, cache update + attention over the cache
# ---------------------------------------------------------------------------


def decode_attention(params, x, cache, index: int, cfg, *, window=0, use_rope=True):
    """x (B,1,Dm); cache {k, v: (B,T,K,D), pos: (T,)}; index: the token's
    position. Writes the token into ``cache`` in place (slot
    ``index mod T``; a full cache has T = max_len, a ring cache T = window)
    and returns ``(y, cache)``; masking uses the stored positions, and
    slots never written hold position -1."""
    dt = x.dtype
    t = cache["k"].shape[1]
    q, k_new, v_new = _project(params, x, x, dt)
    pos = torch.full((1,), index, dtype=torch.int32, device=x.device)
    if use_rope:
        cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    slot = index % t
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = index
    k_pos = cache["pos"]
    valid = _causal_window_mask(pos, k_pos, window) & (k_pos >= 0)[None, :]  # (1, T)
    out = _on_shards(_sdpa, q, cache["k"].to(dt), cache["v"].to(dt), valid[None, None], cfg)
    return _out(params, out, dt), cache
