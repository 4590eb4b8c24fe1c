"""Mixture-of-Experts with capacity-based grouped dispatch, GShard-style
(counterpart of ``repro.models.moe``).

Tokens are split into groups of about ``moe_group_size``; each expert
takes at most ``capacity`` (token, choice) pairs of a group, and the rest
are dropped. Supports top-k routing, shared (always-on) experts
(DeepSeek-V2) and the Switch load-balancing aux loss.

The reference writes the dispatch and the combine as dense one-hot
einsums over an ``(experts, capacity)`` buffer, so that sharding the
experts axis gives expert parallelism. On one card the same function is
a scatter and a gather: each kept pair's token row is copied into its
``(group, expert, slot)`` row of the buffer, the experts run as one
batched product over that buffer, and each token sums its kept choices'
output rows times their gates. The routing, the capacity, the serial
order of the choices (choice 0 of every token first) and so the dropped
set are the reference's.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.distributed.context import constrain
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.models.layers import _act, apply_mlp, mlp_spec

__all__ = ["moe_spec", "apply_moe", "recording_routes"]


def moe_spec(cfg):
    e, dff, dm = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff, cfg.d_model
    spec = {
        "router": ParamSpec((dm, e), ("embed", "experts"), init="fan_in"),
        "wi": ParamSpec((e, dm, dff), ("experts", "embed", "expert_mlp"), init="fan_in"),
        "wg": ParamSpec((e, dm, dff), ("experts", "embed", "expert_mlp"), init="fan_in"),
        "wo": ParamSpec((e, dff, dm), ("experts", "expert_mlp", "embed"), init="fan_in"),
    }
    if cfg.num_shared_experts:
        spec["shared"] = mlp_spec(cfg, d_ff=cfg.num_shared_experts * (cfg.moe_d_ff or cfg.d_ff))
    return spec


def _group_size(tokens: int, cfg) -> int:
    g = min(getattr(cfg, "moe_group_size", 2048), tokens)
    while tokens % g:
        g -= 1
    return g


def _capacity(group_tokens: int, cfg) -> int:
    cap = int(cfg.num_experts_per_tok * group_tokens * cfg.capacity_factor / cfg.num_experts)
    return max(cap, min(4, group_tokens))


_TLS = threading.local()


@contextlib.contextmanager
def recording_routes():
    """Within the block, every :func:`apply_moe` call of this thread
    appends its routing to the yielded list: a dict of ``expert_idx``
    (G, gs, k), ``kept`` (G, gs, k) bool (not dropped by the capacity) and
    ``capacity``, all on the data's device."""
    prev = getattr(_TLS, "routes", None)
    _TLS.routes = []
    try:
        yield _TLS.routes
    finally:
        _TLS.routes = prev


def _route(params, xt, cfg, cap: int):
    """The reference's router over groups ``xt`` (G, gs, D) -> probs
    (G, gs, E) float32, gates (G, gs, k) float32, expert_idx (G, gs, k),
    the slot of each (token, choice) in its expert's buffer (G, gs, k)
    and whether it is kept (slot < ``cap``)."""
    ng, gs, _ = xt.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = torch.einsum("gtd,de->gte", xt, params["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, -1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    # position of each (token, choice) in its expert's per-group buffer,
    # choices serialised within the group: choice 0 of all tokens first
    onehot = torch.nn.functional.one_hot(expert_idx, e)               # (G, gs, k, E)
    flat = onehot.transpose(1, 2).reshape(ng, k * gs, e)
    before = (flat.cumsum(1) - flat).reshape(ng, k, gs, e).transpose(1, 2)
    pos = torch.gather(before, -1, expert_idx[..., None])[..., 0]     # (G, gs, k)
    return probs, gate_vals, expert_idx, pos, pos < cap


def apply_moe(params, x, cfg):
    """x (B,S,D) -> (out (B,S,D), aux_loss scalar float32)."""
    dt = x.dtype
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = b * s
    gs = _group_size(t, cfg)
    ng = t // gs
    cap = _capacity(gs, cfg)
    xt = x.reshape(ng, gs, d)
    probs, gate_vals, expert_idx, pos, kept = _route(params, xt, cfg, cap)
    routes = getattr(_TLS, "routes", None)
    if routes is not None:
        routes.append({"expert_idx": expert_idx, "kept": kept, "capacity": cap})

    # dispatch: each kept pair's token row into its (group, expert, slot)
    # row; dropped pairs go to one spare row past the buffer
    g_idx = torch.arange(ng, device=x.device)[:, None, None]
    row = (g_idx * e + expert_idx) * cap + pos
    row = torch.where(kept, row, ng * e * cap)
    src = xt[:, :, None, :].expand(ng, gs, k, d).reshape(-1, d)
    buf = x.new_zeros((ng * e * cap + 1, d))
    buf.index_copy_(0, row.reshape(-1), src)
    expert_in = buf[:-1].view(ng, e, cap, d)
    expert_in = constrain(expert_in, ("act_moe_group", "act_experts", None, "act_embed"))
    h = torch.einsum("gecd,edf->gecf", expert_in, params["wi"].to(dt))
    g_ = torch.einsum("gecd,edf->gecf", expert_in, params["wg"].to(dt))
    h = _act(h, cfg.act) * g_
    h = constrain(h, ("act_moe_group", "act_experts", None, "act_expert_mlp"))
    expert_out = torch.einsum("gecf,efd->gecd", h, params["wo"].to(dt))

    # combine: each token sums its kept choices' rows times their gates
    # (the gate rounded to the compute dtype, as the reference's combine
    # tensor is), in float32
    picked = expert_out.reshape(ng * e * cap, d)[row.clamp(max=ng * e * cap - 1)]
    w = torch.where(kept, gate_vals.to(dt), 0).float()
    out = (picked.float() * w[..., None]).sum(2).to(dt).reshape(b, s, d)

    if "shared" in params:
        out = out + apply_mlp(params["shared"], x, cfg)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    density = torch.zeros((ng, gs, e), dtype=torch.float32, device=x.device)
    density.scatter_add_(-1, expert_idx, torch.ones_like(gate_vals))
    aux = (density.mean((0, 1)) * probs.mean((0, 1))).sum() * e * cfg.router_aux_weight
    return out, aux
