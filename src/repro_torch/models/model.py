"""Uniform model API (counterpart of ``repro.models.model``).

``build_model(cfg)`` returns a :class:`Model` exposing:

  spec()                                   ParamSpec tree (the one source of truth)
  init(generator, device=None)             materialized float32 parameters
  loss(params, batch)                      scalar LM loss
  forward(params, batch)                   logits
  cache_spec(batch, seq)                   decode cache ParamSpec tree
  prefill(params, batch, max_len=None)     (last logits, caches)
  decode_step(params, caches, batch, index)  (logits, caches), in place

Batch dicts:

  LM families:  {tokens (B,S), labels (B,S)}
  audio:        {frames (B,T_enc,D), tokens, labels}   (frontend stub)
  vlm:          {tokens, labels, image_embeds (B,T_img,D)}  (stub)

Decode batches carry ``{token (B,1)}`` plus the modality stubs. Every
family of the reference serves here (decoder-only with attention, MLA,
MoE, RG-LRU and SSD blocks; the vlm and the encoder-decoder).

As in the reference, ``prefill`` of the audio family returns the last
logits of the teacher-forced decoder and ``{"cross": ...}`` alone, no
self-attention caches: a server starts the decoder from token 0 over
caches from ``cache_spec`` instead (``launch/serve.py``).
"""

from __future__ import annotations

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models import vision as V

__all__ = ["build_model", "Model", "cross_entropy"]


def cross_entropy(logits, labels):
    """Mean token cross-entropy in fp32. labels < 0 are masked."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = (labels >= 0).float()
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


class Model:
    def __init__(self, cfg):
        self.cfg = cfg

    # ---- params ----
    def spec(self):
        c = self.cfg
        if c.family == "audio":
            return ED.encdec_spec(c)
        if c.family == "vlm":
            return V.vlm_spec(c)
        return T.model_spec(c)

    def init(self, generator: torch.Generator | None = None, *, device=None):
        """float32 parameters on ``device`` (CUDA unless the caller names
        another; ``RuntimeError`` without CUDA), drawn from ``generator``
        (a generator on that device seeded 0 when ``None``)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return sh.init_params(self.spec(), generator=generator, device=dev)

    def param_count(self) -> int:
        return sh.count_params(self.spec())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        c = self.cfg
        total = self.param_count()
        if not c.num_experts:
            return total
        dff = c.moe_d_ff or c.d_ff
        per_expert = 3 * c.d_model * dff
        moe_layers = c.num_layers - c.first_dense_layers
        return total - moe_layers * (c.num_experts - c.num_experts_per_tok) * per_expert

    # ---- training ----
    def forward(self, params, batch):
        c = self.cfg
        if c.family == "audio":
            return ED.encdec_forward(params, batch["frames"], batch["tokens"], c)
        if c.family == "vlm":
            return V.vlm_forward(params, batch["tokens"], batch["image_embeds"], c)
        logits, _ = T.forward(params, batch["tokens"], c)
        return logits

    def loss(self, params, batch):
        c = self.cfg
        if c.family in ("audio", "vlm"):
            return cross_entropy(self.forward(params, batch), batch["labels"])
        logits, aux = T.forward(params, batch["tokens"], c)
        return cross_entropy(logits, batch["labels"]) + aux

    # ---- serving ----
    def cache_spec(self, batch: int, seq_len: int):
        c = self.cfg
        if c.family == "audio":
            return ED.decoder_cache_spec(c, batch, seq_len)
        if c.family == "vlm":
            return V.vlm_cache_spec(c, batch, seq_len)
        return T.cache_spec_tree(c, batch, seq_len)

    def prefill(self, params, batch, *, max_len=None):
        c = self.cfg
        if c.family == "audio":
            enc = ED.encode(params, batch["frames"], c)
            logits = ED.decoder_forward(params, batch["tokens"], enc, c)
            return logits[:, -1, :], {"cross": ED.precompute_cross_kv(params, enc, c)}
        if c.family == "vlm":
            return V.vlm_prefill(params, batch["tokens"], batch["image_embeds"], c,
                                 max_len=max_len)
        return T.prefill(params, batch["tokens"], c, max_len=max_len)

    def decode_step(self, params, caches, batch, index):
        """One token per sequence at position ``index``; ``caches`` are
        updated in place (consumed) and returned."""
        c = self.cfg
        if c.family == "audio":
            return ED.encdec_decode_step(params, caches, batch["token"], index, c)
        if c.family == "vlm":
            return V.vlm_decode_step(params, caches, batch["token"], batch["image_embeds"],
                                     index, c)
        return T.decode_step(params, caches, batch["token"], index, c)


def build_model(cfg) -> Model:
    return Model(cfg)
