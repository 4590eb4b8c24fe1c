"""Int8 and top-k compression with error feedback, on tensors (counterpart
of ``repro.optim.compress``).

Two compressors, each with an exact wire format:

* ``int8_compress`` — per-tensor symmetric int8 quantization: 4x fewer
  bytes than float32.
* ``topk_compress`` — magnitude top-k sparsification: k/n of the bytes.

``ef_step`` runs one error-feedback round over a nested structure of
tensors (dicts, lists and tuples): what compression dropped is carried
into the next round (Karimireddy et al., 2019).

The results are bitwise the reference's **jitted** functions (the form
``repro.core.egress`` calls, and a training step runs):

* XLA folds the division of ``amax`` by the constant 127 into a multiply
  by ``f32(1/127)``, while ``x / scale`` stays a true division (here by
  a 0-dim tensor on the data's device);
* ``torch.round`` rounds half to even, as ``jnp.round`` does;
* the top-k breaks ties in magnitude as ``jax.lax.top_k`` does, lower
  index first, through a stable descending sort (``torch.topk`` promises
  no order among ties);
* the int8 residual ``target - q * scale`` is one fused multiply-add
  (``torch.addcmul``), as XLA contracts it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "ef_init",
    "int8_compress",
    "int8_decompress",
    "topk_compress",
    "topk_decompress",
    "ef_step",
    "wire_bytes",
]

#: ``f32(1/127)``: the reciprocal XLA multiplies by for ``amax / 127.0``
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _leaves(tree) -> tuple[list, object]:
    """The tensors of a nested dict/list/tuple, in the reference's flatten
    order (dict keys sorted), and a function that rebuilds the structure."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_leaves(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_leaves(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    flat = [leaf for p in parts for leaf in p[0]]

    def rebuild(leaves):
        out, at = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(leaves[at:at + n]))
            at += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return flat, rebuild


def ef_init(params):
    """Zero float32 error-feedback residual matching the structure."""
    flat, rebuild = _leaves(params)
    return rebuild([torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat])


# ---------------------------------------------------------------------------
# int8 symmetric quantization
# ---------------------------------------------------------------------------


def int8_compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x float32 -> (int8 values, 0-dim float32 scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax, 1e-12) * torch.tensor(_INV_127, dtype=x.dtype, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


# ---------------------------------------------------------------------------
# top-k sparsification
# ---------------------------------------------------------------------------


def topk_compress(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x float32 -> (values (k,), int32 flat indices (k,)), the largest
    magnitudes first, ties lower index first."""
    flat = x.reshape(-1)
    idx = torch.sort(torch.abs(flat), descending=True, stable=True).indices[:k]
    return flat[idx], idx.to(torch.int32)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    flat = torch.zeros(math.prod(shape), dtype=vals.dtype, device=vals.device)
    flat[idx.long()] = vals
    return flat.reshape(shape)


# ---------------------------------------------------------------------------
# one error-feedback round over a nested structure of tensors
# ---------------------------------------------------------------------------


def ef_step(grads, residual, *, kind: str = "int8", k_fraction: float = 0.05):
    """(grads, residual) -> (decompressed values to apply, new residual).

    The returned values are what a receiver decodes from the compressed
    wire; the residual keeps the quantization or sparsity error for the
    next round.
    """

    def one(g, r):
        target = g.to(torch.float32) + r
        if kind == "int8":
            q, scale = int8_compress(target)
            sent = int8_decompress(q, scale)
            # XLA contracts target - q * scale into one fused multiply-add
            return sent, torch.addcmul(target, q.to(torch.float32), scale, value=-1)
        if kind == "topk":
            k = max(1, int(target.numel() * k_fraction))
            vals, idx = topk_compress(target, k)
            sent = topk_decompress(vals, idx, target.shape)
            return sent, target - sent
        raise ValueError(kind)

    flat_g, rebuild = _leaves(grads)
    flat_r, _ = _leaves(residual)
    out = [one(g, r) for g, r in zip(flat_g, flat_r)]
    return rebuild([s for s, _ in out]), rebuild([r for _, r in out])


def wire_bytes(grads, *, kind: str = "int8", k_fraction: float = 0.05) -> int:
    """Bytes on the wire per round under each scheme."""
    total = 0
    for g in _leaves(grads)[0]:
        n = g.numel()
        if kind == "none":
            total += n * 4
        elif kind == "int8":
            total += n * 1 + 4
        elif kind == "topk":
            k = max(1, int(n * k_fraction))
            total += k * 8  # float32 value + int32 index
    return total
