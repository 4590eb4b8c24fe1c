"""Mamba-2 SSD (state-space duality) mixer (counterpart of
``repro.models.ssd``).

Train/prefill uses the chunked SSD algorithm: quadratic attention-like
compute inside chunks of length Q, a linear recurrence across the chunk
boundary states, O(L*Q) instead of O(L^2). Decode is the pure recurrence
with a constant-size state (B, H, P, N), updated in place.

Shapes follow the minimal reference implementation of the paper:
  x:  (B, L, H, P)   headdim P
  dt: (B, L, H)      softplus-ed step sizes (A multiplied in)
  B,C:(B, L, G, N)   state dim N, G groups broadcast over heads
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.context import constrain
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.models.attention import _pad_seq
from repro_torch.models.layers import apply_norm, causal_pad

__all__ = ["ssd_spec", "ssd_state_spec", "apply_ssd", "ssd_decode", "d_inner"]


def d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def _heads(cfg) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def _conv_dim(cfg) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_groups * cfg.ssm_state_dim


def ssd_spec(cfg):
    di, h = d_inner(cfg), _heads(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state_dim
    return {
        # in_proj emits [z (di), x (di), B (g*n), C (g*n), dt (h)]
        "w_in": ParamSpec((cfg.d_model, 2 * di + 2 * gn + h), ("embed", "mlp"), init="fan_in"),
        "conv_w": ParamSpec((cfg.conv_width, _conv_dim(cfg)), ("conv", "mlp"), init="fan_in"),
        "conv_b": ParamSpec((_conv_dim(cfg),), ("mlp",), init="zeros"),
        "A_log": ParamSpec((h,), ("heads",), init="zeros"),
        "D": ParamSpec((h,), ("heads",), init="ones"),
        "dt_bias": ParamSpec((h,), ("heads",), init="zeros"),
        "norm": ParamSpec((di,), ("norm",), init="ones"),
        "w_out": ParamSpec((di, cfg.d_model), ("mlp", "embed"), init="fan_in"),
    }


def ssd_state_spec(cfg, batch: int, *, dtype=torch.float32):
    """Decode state: SSM state + rolling conv window."""
    return {
        "ssm": ParamSpec((batch, _heads(cfg), cfg.ssm_head_dim, cfg.ssm_state_dim),
                         ("batch", "heads", "head_dim", "state"), init="zeros", dtype=dtype),
        "conv": ParamSpec((batch, cfg.conv_width - 1, _conv_dim(cfg)), ("batch", "conv", "mlp"),
                          init="zeros", dtype=dtype),
    }


def _split_proj(params, u, cfg):
    di = d_inner(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state_dim
    zxbcdt = torch.einsum("bld,dk->blk", u, params["w_in"].to(u.dtype))
    zxbcdt = constrain(zxbcdt, ("act_batch", "act_seq", "act_mlp"))
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn], zxbcdt[..., 2 * di + 2 * gn:]


def _out_proj(params, y):
    """y (B,L,d_inner) -> (B,L,Dm). Over a mesh ``y`` is first split on its
    channels, as the dense MLP's hidden layer is: the norm leaves it
    whole, and DTensor (torch 2.11) then asks the product's backward for a
    ``Shard(0)`` -> ``Partial`` move it does not support."""
    y = constrain(y, ("act_batch", "act_seq", "act_mlp"))
    return torch.einsum("bld,dk->blk", y, params["w_out"].to(y.dtype))


def _split_xbc(xbc, cfg):
    di = d_inner(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state_dim
    return xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]


def _causal_conv(xbc, params, cfg):
    """Depthwise causal conv1d over (B, L, C) with a width-k kernel."""
    k = cfg.conv_width
    pad = causal_pad(xbc, k - 1)
    w = params["conv_w"].to(xbc.dtype)  # (k, C)
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i][None, None, :] for i in range(k))
    return F.silu(out + params["conv_b"].to(xbc.dtype))


def _ssd_chunked(x, dt, B, C, A, cfg):
    """Chunked SSD scan. x (B,L,H,P); dt (B,L,H); B,C (B,L,G,N); A (H,) < 0.

    Returns y (B,L,H,P) and the final state (B,H,P,N). G groups are
    broadcast to H heads."""
    bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(cfg.ssm_chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q
    rep = H // G

    xs = x.reshape(bsz, nc, Q, H, P)
    dts = dt.reshape(bsz, nc, Q, H)
    Bs = torch.repeat_interleave(B.reshape(bsz, nc, Q, G, N), rep, dim=3)
    Cs = torch.repeat_interleave(C.reshape(bsz, nc, Q, G, N), rep, dim=3)

    dA = dts * A[None, None, None, :]                 # (b,c,q,h) negative
    dA_cum = torch.cumsum(dA, dim=2)                  # within-chunk cumsum

    # intra-chunk (quadratic in Q): att[i,j] = C_i.B_j exp(dA_cum_i - dA_cum_j) dt_j
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (b,c,i,j,h)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    causal = causal[None, None, :, :, None]
    # exp of the masked (j > i) segments can overflow to inf, whose gradient
    # through the mask is 0 * inf = NaN (the reference's is, from chunks of
    # 128 at its init): they are masked before the exp, the same values
    decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    att = torch.einsum("bcihn,bcjhn->bcijh", Cs, Bs) * decay
    y_intra = torch.einsum("bcijh,bcjh,bcjhp->bcihp", att, dts, xs)

    # chunk-boundary states: S_c = sum_j exp(dA_cum_Q - dA_cum_j) dt_j B_j x_j
    decay_out = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)      # (b,c,q,h)
    S = torch.einsum("bcqh,bcqh,bcqhn,bcqhp->bchpn", decay_out, dts, Bs, xs)

    # inter-chunk recurrence over c, a loop over the chunks:
    # S_prev_c = S_prev_{c-1} * decay_{c-1} + S_{c-1}
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])              # (b,c,h)
    state = torch.zeros_like(S[:, 0])
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S[:, c]
    S_prev = torch.stack(prevs, dim=1)                         # (b,c,h,p,n)

    # inter-chunk contribution: y_j += C_j exp(dA_cum_j) . S_prev
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cs, S_prev, torch.exp(dA_cum))
    return (y_intra + y_inter).reshape(bsz, L, H, P), state


def _chunked_on_shards(x, dt, B, C, A, cfg):
    """:func:`_ssd_chunked`; over DTensors, on each rank's sequences and
    heads (as ``x`` splits them). The scan is independent per sequence and
    head, so the result is the one-device one; B and C serve every head of
    their group, so where the heads are split each rank's gradient of them
    is its heads' share. No DTensor operator runs inside: torch 2.11's
    rules refuse some of the scan's views and gradient sums."""
    if not hasattr(x, "device_mesh"):
        return _ssd_chunked(x, dt, B, C, A, cfg)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in x.placements)
    rows = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)
    heads = tuple(Shard(0) if p == Shard(2) else Replicate() for p in pl)
    xl, dtl = (t.redistribute(mesh, pl).to_local(grad_placements=pl) for t in (x, dt))
    Bl, Cl = (t.redistribute(mesh, rows).to_local(
        grad_placements=tuple(Partial() if p == Shard(2) else q for p, q in zip(pl, rows)))
        for t in (B, C))
    Al = A.redistribute(mesh, heads).to_local(
        grad_placements=tuple(Partial() if p == Shard(0) else q for p, q in zip(pl, heads)))
    h, hl = x.shape[2], xl.shape[2]
    if hl != h:  # B and C of this rank's heads, which split major to minor
        block, coord = 0, mesh.get_coordinate()
        for i, p in enumerate(pl):
            if p == Shard(2):
                block = block * mesh.size(i) + coord[i]
        Bl, Cl = (torch.repeat_interleave(t, h // t.shape[2], dim=2)[:, :, block * hl:
                                                                      (block + 1) * hl]
                  for t in (Bl, Cl))
    y, state = _ssd_chunked(xl, dtl, Bl, Cl, Al, cfg)
    return (DTensor.from_local(y, mesh, pl, run_check=False),
            DTensor.from_local(state, mesh, tuple(Shard(1) if p == Shard(2) else p for p in pl),
                               run_check=False))


def apply_ssd(params, u, cfg, *, return_state: bool = False):
    """Full Mamba-2 block (train / prefill). u (B,L,Dm) -> (B,L,Dm)."""
    dt_ = u.dtype
    h, P = _heads(cfg), cfg.ssm_head_dim
    z, xbc, dt_raw = _split_proj(params, u, cfg)
    x, B, C = _split_xbc(_causal_conv(xbc, params, cfg), cfg)
    bsz, L, _ = x.shape
    x = x.reshape(bsz, L, h, P)
    B = B.reshape(bsz, L, cfg.ssm_groups, cfg.ssm_state_dim)
    C = C.reshape(bsz, L, cfg.ssm_groups, cfg.ssm_state_dim)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    # pad L to a chunk multiple; dt = 0 on padding keeps the recurrence exact
    # (decay exp(0) = 1, input contribution dt.x = 0)
    pad = (-L) % min(cfg.ssm_chunk, L) if L else 0
    if pad:
        x, B, C, dt = (_pad_seq(t, pad) for t in (x, B, C, dt))
    y, state = _chunked_on_shards(x.float(), dt, B.float(), C.float(), A, cfg)
    if pad:
        y, x = y[:, :L], x[:, :L]
    y = y + x.float() * params["D"].float()[None, None, :, None]
    y = y.reshape(bsz, L, h * P).to(dt_) * F.silu(z)
    out = _out_proj(params, apply_norm({"scale": params["norm"]}, y, cfg))
    if return_state:
        k = cfg.conv_width
        conv_tail = causal_pad(xbc, k - 1)[:, -(k - 1):, :]
        return out, {"ssm": state, "conv": conv_tail.float()}
    return out


def _step(ssm, x, B, C, dt, A, D):
    """One step of the recurrence for each sequence and head: ssm
    (B,H,P,N), x (B,H,P), B and C (B,H,N), dt (B,H), A and D (H,) ->
    (y (B,H,P), the new ssm)."""
    decay = torch.exp(dt * A[None, :])  # (B,H)
    s = ssm * decay[:, :, None, None] + torch.einsum("bh,bhn,bhp->bhpn", dt, B, x)
    y = torch.einsum("bhn,bhpn->bhp", C, s)
    return y + x * D[None, :, None], s


def _step_on_shards(ssm, x, B, C, dt, A, D):
    """:func:`_step`; over DTensors, on each rank's sequences and heads (as
    the state splits them). The step is independent per sequence and head,
    so the result is the one-device one, and none of its einsums flattens
    a split dimension (which DTensor's view rules refuse in torch 2.11)."""
    if not hasattr(ssm, "device_mesh"):
        return _step(ssm, x, B, C, dt, A, D)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = ssm.device_mesh
    pl = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in ssm.placements)
    heads = tuple(Shard(0) if p == Shard(1) else Replicate() for p in pl)

    def local(t, placements):
        return t.redistribute(mesh, placements).to_local()

    y, s = _step(*(local(t, pl) for t in (ssm, x, B, C, dt)),
                 *(local(t, heads) for t in (A, D)))
    return (DTensor.from_local(y, mesh, pl, run_check=False, shape=x.shape, stride=x.stride()),
            DTensor.from_local(s, mesh, pl, run_check=False, shape=ssm.shape,
                               stride=ssm.stride()))


def ssd_decode(params, u, state, cfg):
    """Single-token recurrence. u (B,1,Dm); state {ssm, conv}, float32,
    updated in place and returned with the output."""
    dt_ = u.dtype
    h, P = _heads(cfg), cfg.ssm_head_dim
    z, xbc, dt_raw = _split_proj(params, u, cfg)  # (B,1,.)
    # rolling conv window
    window = torch.cat([state["conv"].to(dt_), xbc], dim=1)  # (B,k,C)
    conv_out = (torch.einsum("bkc,kc->bc", window, params["conv_w"].to(dt_))
                + params["conv_b"].to(dt_))
    x, B, C = _split_xbc(F.silu(conv_out)[:, None, :], cfg)
    bsz = x.shape[0]
    x = x.reshape(bsz, h, P).float()
    rep = h // cfg.ssm_groups
    B = torch.repeat_interleave(
        B.reshape(bsz, cfg.ssm_groups, cfg.ssm_state_dim).float(), rep, dim=1)
    C = torch.repeat_interleave(
        C.reshape(bsz, cfg.ssm_groups, cfg.ssm_state_dim).float(), rep, dim=1)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"].float())  # (B,H)
    A = -torch.exp(params["A_log"].float())
    y, s = _step_on_shards(state["ssm"].float(), x, B, C, dt, A, params["D"].float())
    y = y.reshape(bsz, 1, h * P).to(dt_) * F.silu(z)
    out = _out_proj(params, apply_norm({"scale": params["norm"]}, y, cfg))
    state["ssm"].copy_(s)
    state["conv"].copy_(window[:, 1:, :])
    return out, state
