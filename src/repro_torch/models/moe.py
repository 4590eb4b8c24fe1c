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
set are the reference's. Over a mesh of several ranks the same runs on
each rank's local tensors (:func:`_apply_moe_on_shards`): its own groups,
its own experts or its slice of their width, and a ``Partial`` combine.
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


def _experts(xt, wi, wg, wo, gates, expert_idx, pos, mine, cap: int, e0: int, cfg):
    """The output of experts ``e0 .. e0 + len(wi)`` for groups ``xt``
    (G, gs, D): each pair in ``mine`` (kept, and routed to one of these
    experts) has its token row copied into its ``(group, expert, slot)``
    row of the buffer, the experts run as one batched product over that
    buffer, and each token sums its pairs' output rows times their
    ``gates`` (the gate rounded to the compute dtype, as the reference's
    combine tensor is), in float32. -> (G, gs, D)."""
    dt = xt.dtype
    ng, gs, d = xt.shape
    k = expert_idx.shape[-1]
    el = wi.shape[0]
    # dispatch: dropped pairs, and pairs of other experts, go to one spare
    # row past the buffer
    g_idx = torch.arange(ng, device=xt.device)[:, None, None]
    row = (g_idx * el + (expert_idx - e0)) * cap + pos
    row = torch.where(mine, row, ng * el * cap)
    src = xt[:, :, None, :].expand(ng, gs, k, d).reshape(-1, d)
    buf = xt.new_zeros((ng * el * cap + 1, d))
    buf.index_copy_(0, row.reshape(-1), src)
    expert_in = buf[:-1].view(ng, el, cap, d)
    expert_in = constrain(expert_in, ("act_moe_group", "act_experts", None, "act_embed"))
    h = torch.einsum("gecd,edf->gecf", expert_in, wi.to(dt))
    g_ = torch.einsum("gecd,edf->gecf", expert_in, wg.to(dt))
    h = _act(h, cfg.act) * g_
    h = constrain(h, ("act_moe_group", "act_experts", None, "act_expert_mlp"))
    expert_out = torch.einsum("gecf,efd->gecd", h, wo.to(dt))

    # combine: each token sums its pairs' rows times their gates
    picked = expert_out.reshape(ng * el * cap, d)[row.clamp(max=ng * el * cap - 1)]
    w = torch.where(mine, gates.to(dt), 0).float()
    return (picked.float() * w[..., None]).sum(2).to(dt)


def _balance(probs, expert_idx):
    """The terms of Switch's load-balance loss ``E * sum_e f_e * p_e``
    over the groups given: each expert's mean choice count ``f_e`` and
    mean router probability ``p_e`` (float32)."""
    ng, gs, e = probs.shape
    density = torch.zeros((ng, gs, e), dtype=torch.float32, device=probs.device)
    density.scatter_add_(-1, expert_idx, torch.ones_like(expert_idx, dtype=torch.float32))
    return density.mean((0, 1)), probs.mean((0, 1))


def apply_moe(params, x, cfg):
    """x (B,S,D) -> (out (B,S,D), aux_loss scalar float32)."""
    if hasattr(x, "device_mesh"):
        return _apply_moe_on_shards(params, x, cfg)
    b, s, d = x.shape
    e = cfg.num_experts
    t = b * s
    gs = _group_size(t, cfg)
    ng = t // gs
    cap = _capacity(gs, cfg)
    xt = x.reshape(ng, gs, d)
    probs, gate_vals, expert_idx, pos, kept = _route(params, xt, cfg, cap)
    routes = getattr(_TLS, "routes", None)
    if routes is not None:
        routes.append({"expert_idx": expert_idx, "kept": kept, "capacity": cap})
    out = _experts(xt, params["wi"], params["wg"], params["wo"], gate_vals, expert_idx, pos,
                   kept, cap, 0, cfg).reshape(b, s, d)
    if "shared" in params:
        out = out + apply_mlp(params["shared"], x, cfg)
    density, router_prob = _balance(probs, expert_idx)
    aux = (density * router_prob).sum() * e * cfg.router_aux_weight
    return out, aux


def _grads_summed(t, mesh, placements, dims):
    """``t`` itself (this rank's local tensor at ``placements``), whose
    gradient is summed over the mesh dimensions ``dims``: where each rank
    of those dimensions computes a share of what ``t`` feeds (its experts,
    or its slice of their hidden width), ``t``'s whole gradient is the sum
    of the shares."""
    if not dims:
        return t
    from torch.distributed.tensor import DTensor, Partial

    grad = tuple(Partial() if i in dims else p for i, p in enumerate(placements))
    return DTensor.from_local(t, mesh, placements, run_check=False).to_local(
        grad_placements=grad)


def _apply_moe_on_shards(params, x, cfg):
    """:func:`apply_moe` over DTensors, each rank on local tensors.

    The groups, the capacity and so the dropped set are the whole batch's,
    as on one device. Where the tokens' batch is split over a mesh
    dimension and the groups divide among its ranks (``act_moe_group``,
    the reference's divisibility fallback otherwise), each rank routes
    and dispatches its own groups; elsewhere every rank routes all of
    them. On the mesh dimensions that split the experts (``experts`` over
    ``model``: expert parallelism) or their hidden width (``expert_mlp``,
    mixtral's rule) each rank runs its own experts or its slice of every
    expert on the pairs routed there, and the combine is a ``Partial`` sum
    over those dimensions. Routing runs alike on each of their ranks with
    the whole router, and the gradients of the gates and of the experts'
    input are summed over them (:func:`_grads_summed`). The aux loss
    averages the densities and router probabilities over all groups.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    b, s, d = x.shape
    e = cfg.num_experts
    t = b * s
    gs = _group_size(t, cfg)
    ng = t // gs
    cap = _capacity(gs, cfg)

    split = [p == Shard(0) for p in x.placements]
    ways = 1
    for i, sp in enumerate(split):
        ways *= mesh.size(i) if sp else 1
    if ng % ways:  # the groups do not divide: every rank routes them all
        split, ways = [False] * mesh.ndim, 1
    roles = []
    for i, p in enumerate(params["wi"].placements):
        role = {Shard(0): "experts", Shard(2): "expert_mlp"}.get(p)
        if role and split[i]:
            raise ValueError(f"the MoE groups and the {role} axis are split over one "
                             f"mesh dimension ({mesh.mesh_dim_names[i]})")
        roles.append(role)
    shares = [i for i, r in enumerate(roles) if r]
    tok = tuple(Shard(0) if sp else Replicate() for sp in split)

    def local(w, mlp_dim):
        pl = tuple(Shard(0) if r == "experts" else Shard(mlp_dim) if r else Replicate()
                   for r in roles)
        grad = tuple(Partial() if sp else p for sp, p in zip(split, pl))
        return w.redistribute(mesh, pl).to_local(grad_placements=grad)

    xl = x.redistribute(mesh, tok).to_local(grad_placements=tok)
    xt = xl.reshape(-1, gs, d)
    router = params["router"].redistribute(mesh, (Replicate(),) * mesh.ndim).to_local(
        grad_placements=tuple(Partial() if sp else Replicate() for sp in split))
    probs, gate_vals, expert_idx, pos, kept = _route({"router": router}, xt, cfg, cap)
    routes = getattr(_TLS, "routes", None)
    if routes is not None:
        routes.append({key: DTensor.from_local(v, mesh, tok, run_check=False)
                       for key, v in (("expert_idx", expert_idx), ("kept", kept))}
                      | {"capacity": cap})

    wi, wg, wo = local(params["wi"], 2), local(params["wg"], 2), local(params["wo"], 1)
    block, coord = 0, mesh.get_coordinate()
    for i, r in enumerate(roles):
        if r == "experts":  # expert blocks major to minor
            block = block * mesh.size(i) + coord[i]
    e0 = block * wi.shape[0]
    mine = kept & (expert_idx >= e0) & (expert_idx < e0 + wi.shape[0])
    out = _experts(_grads_summed(xt, mesh, tok, shares), wi, wg, wo,
                   _grads_summed(gate_vals, mesh, tok, shares), expert_idx, pos, mine, cap,
                   e0, cfg)
    placed = tuple(Partial() if r else p for r, p in zip(roles, tok))
    out = DTensor.from_local(out.reshape(xl.shape), mesh, placed, run_check=False,
                             shape=x.shape, stride=x.stride()).redistribute(mesh, x.placements)
    if "shared" in params:
        out = out + apply_mlp(params["shared"], x, cfg)

    density, router_prob = _balance(probs, expert_idx)
    if ways > 1:  # means over every rank's groups
        part = tuple(Partial() if sp else Replicate() for sp in split)
        density, router_prob = (
            DTensor.from_local(v, mesh, part, run_check=False).full_tensor() / ways
            for v in (density, router_prob))
    aux = (density * router_prob).sum() * e * cfg.router_aux_weight
    # a replicated DTensor: its gradient reaches the local tensors as theirs
    return out, DTensor.from_local(aux, mesh, (Replicate(),) * mesh.ndim, run_check=False)
