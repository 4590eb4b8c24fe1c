"""Deterministic, resumable input pipeline (counterpart of
``repro.data.pipeline``).

Contract (what fault tolerance relies on): batch ``i`` is a pure function
of ``i`` — a restart from step ``k`` replays exactly the stream the failed
run would have seen, with no host-side iterator state to checkpoint. The
default synthetic source is the LM next-token objective over seeded random
tokens, the reference's own numpy draws (``launch.inputs.make_train_batch``)
as tensors on ``device`` (CUDA unless the caller names another); swap
``sample_fn`` for a real tokenized corpus reader.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.launch.inputs import make_train_batch

__all__ = ["DataPipeline"]


@dataclasses.dataclass
class DataPipeline:
    cfg: "object"                 # ArchConfig
    batch: int
    seq: int
    microbatches: int = 1
    cycle: int | None = None      # repeat over N distinct batches (demos)
    sample_fn: Callable | None = None
    device: "str | torch.device | None" = None

    def batch_at(self, step: int):
        seed = step % self.cycle if self.cycle else step
        if self.sample_fn is not None:
            return self.sample_fn(self.cfg, self.batch, self.seq, seed,
                                  self.microbatches)
        b = make_train_batch(
            self.cfg, self.batch, self.seq, seed=seed,
            microbatches=self.microbatches, device=self.device,
        )
        toks = b["tokens"]
        b["labels"] = torch.cat([toks[..., 1:], toks[..., :1]], dim=-1)
        return b

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
