"""Uniform model API (counterpart of ``repro.models.model``).

``build_model(cfg)`` returns a :class:`Model` exposing:

  spec()                                   ParamSpec tree (the one source of truth)
  init(generator, device=None)             materialized float32 parameters
  loss(params, batch)                      scalar LM loss
  forward(params, batch)                   logits
  cache_spec(batch, seq)                   decode cache ParamSpec tree
  prefill(params, batch, max_len=None)     (last logits, caches)
  decode_step(params, caches, batch, index)  (logits, caches), in place

Batches are dicts of tensors: ``{tokens (B,S), labels (B,S)}``, and
``{token (B,1)}`` for a decode step. The audio (encoder-decoder) and vlm
families raise ``NotImplementedError`` (ROADMAP.md queue A item 13(b)).
"""

from __future__ import annotations

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import transformer as T

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

    def _check_family(self):
        if self.cfg.family in ("audio", "vlm"):
            raise NotImplementedError(
                f"the {self.cfg.family} family ({self.cfg.name}) is not ported to "
                "repro_torch yet: ROADMAP.md queue A item 13(b)"
            )

    # ---- params ----
    def spec(self):
        self._check_family()
        return T.model_spec(self.cfg)

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
        self._check_family()
        logits, _ = T.forward(params, batch["tokens"], self.cfg)
        return logits

    def loss(self, params, batch):
        self._check_family()
        logits, aux = T.forward(params, batch["tokens"], self.cfg)
        return cross_entropy(logits, batch["labels"]) + aux

    # ---- serving ----
    def cache_spec(self, batch: int, seq_len: int):
        self._check_family()
        return T.cache_spec_tree(self.cfg, batch, seq_len)

    def prefill(self, params, batch, *, max_len=None):
        self._check_family()
        return T.prefill(params, batch["tokens"], self.cfg, max_len=max_len)

    def decode_step(self, params, caches, batch, index):
        """One token per sequence at position ``index``; ``caches`` are
        updated in place (consumed) and returned."""
        self._check_family()
        return T.decode_step(params, caches, batch["token"], index, self.cfg)


def build_model(cfg) -> Model:
    return Model(cfg)
