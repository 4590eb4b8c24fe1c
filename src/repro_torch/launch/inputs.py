"""Model input construction (counterpart of ``repro.launch.inputs``).

The random batches are the reference's byte for byte: the same
``np.random.default_rng(seed)`` draws, turned into tensors on the
caller's device (CUDA unless the caller names another). The ``*_spec``
helpers describe a batch as ``meta`` tensors (shape and dtype, no
storage), the counterpart of the reference's ``ShapeDtypeStruct``s.

Modality frontends are stubs, as in the reference: audio gets frame
embeddings ``(B, T_enc, D)`` and vlm patch embeddings ``(B, T_img, D)``,
drawn in float64 and rounded to the compute dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models.layers import compute_dtype

__all__ = [
    "train_batch_spec",
    "decode_batch_spec",
    "batch_logical_axes",
    "make_train_batch",
    "make_decode_batch",
]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _extras_spec(cfg, batch: int, dtype, lead: tuple[int, ...] = ()):
    if cfg.family == "audio":
        return {"frames": _meta(lead + (batch, cfg.encoder_positions, cfg.d_model), dtype)}
    if cfg.family == "vlm":
        return {"image_embeds": _meta(lead + (batch, cfg.num_image_tokens, cfg.d_model),
                                      dtype)}
    return {}


def train_batch_spec(cfg, batch: int, seq: int, microbatches: int = 1):
    """Training batch. With microbatches M > 1 the tensors carry a leading
    microbatch dim (M, B/M, S)."""
    m = max(microbatches, 1)
    if batch % m:
        raise ValueError(f"global batch {batch} not divisible by {m} microbatches")
    lead = (m,) if m > 1 else ()
    b = batch // m
    spec = {"tokens": _meta(lead + (b, seq), torch.int32),
            "labels": _meta(lead + (b, seq), torch.int32)}
    spec.update(_extras_spec(cfg, b, compute_dtype(cfg), lead))
    return spec


def decode_batch_spec(cfg, batch: int):
    spec = {"token": _meta((batch, 1), torch.int32)}
    spec.update(_extras_spec(cfg, batch, compute_dtype(cfg)))
    return spec


def batch_logical_axes(spec_or_batch):
    """Logical axes for each batch entry (leading dims batch, seq)."""

    def axes(name, leaf):
        nd = len(leaf.shape)
        if name in ("frames", "image_embeds"):
            return ("batch", "seq", None)
        return ("batch", "seq")[:nd] if nd <= 2 else ("batch",) + (None,) * (nd - 1)

    return {k: axes(k, v) for k, v in spec_or_batch.items()}


def _tokens(rng, vocab, shape, dev):
    return torch.from_numpy(rng.integers(0, vocab, shape).astype(np.int32)).to(dev)


def _embeds(rng, shape, cfg, dev):
    x = torch.from_numpy(rng.normal(0, 1, shape))
    return x.to(device=dev, dtype=compute_dtype(cfg))


def make_train_batch(cfg, batch: int, seq: int, seed: int = 0, microbatches: int = 1, *,
                     device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    m = max(microbatches, 1)
    lead = (m,) if m > 1 else ()
    b = batch // m
    out = {"tokens": _tokens(rng, cfg.vocab_size, lead + (b, seq), dev),
           "labels": _tokens(rng, cfg.vocab_size, lead + (b, seq), dev)}
    if cfg.family == "audio":
        out["frames"] = _embeds(rng, lead + (b, cfg.encoder_positions, cfg.d_model), cfg, dev)
    if cfg.family == "vlm":
        out["image_embeds"] = _embeds(rng, lead + (b, cfg.num_image_tokens, cfg.d_model),
                                      cfg, dev)
    return out


def make_decode_batch(cfg, batch: int, seed: int = 0, *, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {"token": _tokens(rng, cfg.vocab_size, (batch, 1), dev)}
    if cfg.family == "audio":
        out["frames"] = _embeds(rng, (batch, cfg.encoder_positions, cfg.d_model), cfg, dev)
    if cfg.family == "vlm":
        out["image_embeds"] = _embeds(rng, (batch, cfg.num_image_tokens, cfg.d_model), cfg,
                                      dev)
    return out
