"""Shared model building blocks: norms, MLPs, embeddings, RoPE
(counterpart of ``repro.models.layers``).

Each block exposes ``*_spec(cfg) -> ParamSpec tree`` and an apply function
over a dict of tensors. Compute runs in ``cfg.dtype`` (bfloat16 by
default): parameters are float32 masters cast at each use, and norms and
RoPE angles are computed in float32, as in the reference.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.distributed.context import constrain
from repro_torch.distributed.sharding import ParamSpec


def compute_dtype(cfg) -> torch.dtype:
    """``cfg.dtype`` (a string, as in the reference) as a torch dtype."""
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_spec(cfg):
    if cfg.norm_type == "layernorm":
        return {
            "scale": ParamSpec((cfg.d_model,), ("norm",), init="ones"),
            "bias": ParamSpec((cfg.d_model,), ("norm",), init="zeros"),
        }
    return {"scale": ParamSpec((cfg.d_model,), ("norm",), init="ones")}


def apply_norm(params, x, cfg):
    dt = x.dtype
    x32 = x.float()
    if cfg.norm_type == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        var = (x32 ** 2).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"].float()
    return y.to(dt)


# ---------------------------------------------------------------------------
# Dense MLP (gated SiLU/GELU, or plain 2-layer)
# ---------------------------------------------------------------------------


def mlp_spec(cfg, d_ff: int | None = None):
    d_ff = d_ff or cfg.d_ff
    spec = {
        "wi": ParamSpec((cfg.d_model, d_ff), ("embed", "mlp"), init="fan_in"),
        "wo": ParamSpec((d_ff, cfg.d_model), ("mlp", "embed"), init="fan_in"),
    }
    if cfg.gated_mlp:
        spec["wg"] = ParamSpec((cfg.d_model, d_ff), ("embed", "mlp"), init="fan_in")
    return spec


def _act(x, kind: str):
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    return F.silu(x)


def apply_mlp(params, x, cfg):
    dt = x.dtype
    h = torch.einsum("...d,df->...f", x, params["wi"].to(dt))
    if cfg.gated_mlp:
        g = torch.einsum("...d,df->...f", x, params["wg"].to(dt))
        h = _act(h, cfg.act) * g
    else:
        h = _act(h, cfg.act)
    if h.ndim == 3:
        h = constrain(h, ("act_batch", "act_seq", "act_mlp"))
    return torch.einsum("...f,fd->...d", h, params["wo"].to(dt))


def causal_pad(x, n: int):
    """``x`` (B, L, ...) with ``n`` zero steps before it along axis 1, as
    ``F.pad`` pads a causal convolution's input. A concatenation, because
    DTensor's rule for ``pad`` (torch 2.11) fails on a tensor placed over a
    mesh."""
    return torch.cat([x.new_zeros((x.shape[0], n) + tuple(x.shape[2:])), x], dim=1)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_spec(cfg):
    spec = {
        "embedding": ParamSpec(
            (cfg.vocab_size, cfg.d_model), ("vocab", "embed"), scale=1.0, init="fan_in"
        )
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = ParamSpec(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), init="fan_in"
        )
    return spec


def embed_tokens(params, tokens, cfg):
    # gathers the rows first, then casts: the same values as casting the
    # table, without a copy of the whole table in the compute dtype
    return _rows(params["embedding"], tokens).to(compute_dtype(cfg))


class _SumOver(torch.autograd.Function):
    """The sum of ``x`` over the ranks of each group in ``groups``, held
    alike by all of them; its gradient arrives whole on every rank, so the
    backward is the identity."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist

        x = x.clone()
        for group in groups:
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _rows(table, tokens):
    """``table[tokens]``. Over a mesh each rank looks up every token in
    its own block of the table (its vocabulary rows and embedding columns),
    zero where a token's row lies in another rank's block; a sum over the
    mesh dimensions that split the vocabulary (one nonzero term, so
    exact) and a redistribution to the tokens' placements follow. The
    table never moves: each rank's gradient is its block's whole gradient.
    DTensor's own rules for indexing (its backward's ``index_put``) and
    for ``embedding`` (the masked partial sum, with the tokens split over
    the batch) fail on a placed table."""
    if not hasattr(table, "device_mesh"):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = table.device_mesh
    placed = hasattr(tokens, "device_mesh")
    ids = tokens.full_tensor() if placed else tokens
    want = tokens.placements if placed else (Replicate(),) * mesh.ndim
    coord = mesh.get_coordinate()
    lo, n, groups, out = 0, table.shape[0], [], []
    for i, p in enumerate(table.placements):
        if p == Shard(0):  # mesh dimensions split the vocabulary major to minor
            n //= mesh.size(i)
            lo += coord[i] * n
            groups.append(mesh.get_group(i))
            out.append(Replicate())
        elif p == Shard(1):
            out.append(Shard(ids.dim()))
        else:
            out.append(Replicate())
    local = table.to_local(grad_placements=table.placements)
    if local.shape[0] != n:
        raise ValueError(f"embedding rows split unevenly: {local.shape[0]} on a rank, "
                         f"{n} expected")
    idx = ids - lo
    rows = local[idx.clamp(0, n - 1)]
    rows = torch.where(((idx >= 0) & (idx < n))[..., None], rows, rows.new_zeros(()))
    if groups:
        rows = _SumOver.apply(rows, groups)
    return DTensor.from_local(rows, mesh, tuple(out), run_check=False).redistribute(mesh, want)


def unembed(params, x, cfg):
    dt = x.dtype
    if cfg.tie_embeddings:
        return torch.einsum("...d,vd->...v", x, params["embedding"].to(dt))
    return torch.einsum("...d,dv->...v", x, params["unembed"].to(dt))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_angles(positions, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2), in float32."""
    half = dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D) with cos/sin (..., S, D/2) broadcast over heads."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# Positional embedding (learned)
# ---------------------------------------------------------------------------


def learned_pos_spec(n_positions: int, d_model: int):
    return {"pos": ParamSpec((n_positions, d_model), ("seq", "embed"), scale=0.02)}



@contextlib.contextmanager
def full_float32_matmul():
    """float32 products in full float32 inside the block (no TF32 on the
    card), restoring the caller's setting after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
