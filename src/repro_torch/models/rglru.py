"""RG-LRU recurrent block, RecurrentGemma / Griffin (counterpart of
``repro.models.rglru``).

Temporal-mixing block: two linear branches to ``lru_width``; the x-branch
passes a causal conv1d then the Real-Gated LRU; the gate branch multiplies
in with GeLU. Train/prefill runs the recurrence as a log-depth scan;
decode is a single-step recurrence with a constant-size state.

  r_t = sigmoid(W_a x_t + b_a)          recurrence gate
  i_t = sigmoid(W_x x_t + b_x)          input gate
  a_t = exp(-c * softplus(Lambda) * r_t)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t x_t)

The reference scans with ``jax.lax.associative_scan``, whose combine tree
PyTorch has no counterpart of. :func:`_linear_scan` is a Hillis-Steele
scan over the same combine, ceil(log2 L) steps of whole-sequence tensor
ops: another tree, so the float32 states differ from the reference's in
the last bits (``tests/test_torch_mixers.py`` states the tolerance).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.context import constrain
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.models.layers import causal_pad

__all__ = ["rglru_spec", "rglru_state_spec", "apply_rglru", "rglru_decode"]

_C = 8.0  # Griffin's fixed recurrence sharpness


def _width(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def rglru_spec(cfg):
    w = _width(cfg)
    return {
        "w_x_branch": ParamSpec((cfg.d_model, w), ("embed", "mlp"), init="fan_in"),
        "w_gate_branch": ParamSpec((cfg.d_model, w), ("embed", "mlp"), init="fan_in"),
        "conv_w": ParamSpec((cfg.conv_width, w), ("conv", "mlp"), init="fan_in"),
        "conv_b": ParamSpec((w,), ("mlp",), init="zeros"),
        "w_a": ParamSpec((w, w), ("mlp", "mlp"), init="fan_in"),
        "b_a": ParamSpec((w,), ("mlp",), init="zeros"),
        "w_i": ParamSpec((w, w), ("mlp", "mlp"), init="fan_in"),
        "b_i": ParamSpec((w,), ("mlp",), init="zeros"),
        "lambda_": ParamSpec((w,), ("mlp",), init="const", scale=1.0),
        "w_out": ParamSpec((w, cfg.d_model), ("mlp", "embed"), init="fan_in"),
    }


def rglru_state_spec(cfg, batch: int, *, dtype=torch.float32):
    w = _width(cfg)
    return {
        "lru": ParamSpec((batch, w), ("batch", "mlp"), init="zeros", dtype=dtype),
        "conv": ParamSpec((batch, cfg.conv_width - 1, w), ("batch", "conv", "mlp"),
                          init="zeros", dtype=dtype),
    }


def _gates(params, x, x_all=None):
    """x (..., W) float32 -> a (decay), b (the input term). ``x_all``, where
    given, is the gate products' input: every channel of the rank's ``x``,
    a shard of them (:func:`_on_channels`)."""
    x_all = x if x_all is None else x_all
    r = torch.sigmoid(x_all @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(x_all @ params["w_i"].float() + params["b_i"])
    a = torch.exp(-_C * F.softplus(params["lambda_"].float()) * r)
    b = torch.sqrt(torch.clamp(1.0 - a ** 2, min=1e-12)) * (i * x)
    return a, b


def _on_channels(params, xc, step, *states):
    """``step(a, b, *states)`` with ``a, b = _gates(params, xc)``; over
    DTensors, on each rank's sequences and channels (as ``xc`` (..., W)
    splits them, and ``states`` alike). The gates' products read every
    channel, so each rank gathers ``xc`` for them and keeps its own
    columns of ``w_a`` and ``w_i``; the rest is elementwise in the
    channels. No DTensor operator runs inside: torch 2.11 cannot add a
    split bias to a product's partial sums, nor sum some of the
    gradients."""
    if not hasattr(xc, "device_mesh"):
        return step(*_gates(params, xc), *states)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, last = xc.device_mesh, Shard(xc.ndim - 1)
    pl = tuple(p if p in (Shard(0), last) else Replicate() for p in xc.placements)

    def weight(t, placements):
        """This rank's block of a gate weight; each rank of the sequences'
        split holds its sequences' share of the gradient."""
        grad = tuple(Partial() if p == Shard(0) else q for p, q in zip(pl, placements))
        return t.redistribute(mesh, placements).to_local(grad_placements=grad)

    cols = tuple(Shard(1) if p == last else Replicate() for p in pl)
    chans = tuple(Shard(0) if p == last else Replicate() for p in pl)
    mine = {k: weight(params[k], cols) for k in ("w_a", "w_i")}
    mine |= {k: weight(params[k], chans) for k in ("b_a", "b_i", "lambda_")}
    x = xc.redistribute(mesh, pl).to_local(grad_placements=pl)
    x_all = xc.redistribute(mesh, tuple(Replicate() if p == last else p for p in pl)).to_local(
        grad_placements=tuple(Partial() if p == last else p for p in pl))
    out = step(*_gates(mine, x, x_all), *(t.redistribute(mesh, pl).to_local() for t in states))
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _conv(params, x, cfg):
    k = cfg.conv_width
    pad = causal_pad(x, k - 1)
    w = params["conv_w"].to(x.dtype)
    out = sum(pad[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return out + params["conv_b"].to(x.dtype)


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, along axis 1: a Hillis-Steele
    scan of the combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``."""
    n = a.shape[1]
    d = 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def apply_rglru(params, u, cfg, *, return_state: bool = False):
    """u (B,L,Dm) -> (B,L,Dm) [, state]."""
    dt = u.dtype
    xb = torch.einsum("bld,dw->blw", u, params["w_x_branch"].to(dt))
    gb = torch.einsum("bld,dw->blw", u, params["w_gate_branch"].to(dt))
    xb = constrain(xb, ("act_batch", "act_seq", "act_mlp"))
    gb = constrain(gb, ("act_batch", "act_seq", "act_mlp"))
    xc = _conv(params, xb, cfg).float()
    h = _on_channels(params, xc, _linear_scan)
    y = h.to(dt) * F.gelu(gb, approximate="tanh")
    out = torch.einsum("blw,wd->bld", y, params["w_out"].to(dt))
    if return_state:
        k = cfg.conv_width
        tail = causal_pad(xb, k - 1)[:, -(k - 1):, :]
        return out, {"lru": h[:, -1, :], "conv": tail.float()}
    return out


def rglru_decode(params, u, state, cfg):
    """u (B,1,Dm); state {lru (B,W), conv (B,k-1,W)}, float32, updated in
    place and returned with the output."""
    dt = u.dtype
    xb = torch.einsum("bld,dw->blw", u, params["w_x_branch"].to(dt))  # (B,1,W)
    gb = torch.einsum("bld,dw->blw", u, params["w_gate_branch"].to(dt))
    window = torch.cat([state["conv"].to(dt), xb], dim=1)  # (B,k,W)
    xc = (torch.einsum("bkw,kw->bw", window, params["conv_w"].to(dt))
          + params["conv_b"].to(dt)).float()
    h = _on_channels(params, xc, lambda a, b, s: a * s + b, state["lru"].float())
    y = h[:, None, :].to(dt) * F.gelu(gb, approximate="tanh")
    out = torch.einsum("blw,wd->bld", y, params["w_out"].to(dt))
    state["lru"].copy_(h)
    state["conv"].copy_(window[:, 1:, :])
    return out, state
