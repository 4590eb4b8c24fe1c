"""Self-contained AdamW (+ global-norm clipping, cosine schedule)
(counterpart of ``repro.optim.adamw``).

The same ``init``/``update`` API over trees of tensors (nested dicts and
lists, walked as ``repro_torch.checkpoint.checkpoint.map_tree`` walks
them), and the reference's rounding: the bias corrections are
``1 - b ** f32(step)``, clipping scales by ``min(1, clip / max(gn,
1e-9))``, and each parameter's update is formed in float32 and cast back
to its dtype.

``update`` writes the moments and the parameters in place under
``torch.no_grad()`` and returns the same tensors: the counterpart of the
reference's donated buffers (``launch/steps.py`` donates both to its
jitted step). ``state["step"]`` is an int32 0-dim tensor, so a checkpoint
holds the reference's leaf kinds.

Leaves may be DTensors over a mesh of several ranks (``launch.steps``):
each moment keeps its parameter's placements, and :func:`global_norm`
reduces over the whole mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.checkpoint.checkpoint import flat_leaves, map_tree

__all__ = ["AdamW", "cosine_schedule", "global_norm"]


def _scalars_replicated(tree):
    """Inside, plain scalar tensors made beside DTensor leaves (the step,
    the learning rate, the bias corrections) count as replicated."""
    if not any(hasattr(x, "device_mesh") for x in flat_leaves(tree)):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares;
    over DTensor leaves a replicated DTensor, reduced over the mesh."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in flat_leaves(tree)))


def cosine_schedule(
    peak_lr: float, warmup_steps: int = 100, total_steps: int = 10000,
    min_ratio: float = 0.1,
) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
        )
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0

    def init(self, params) -> dict[str, Any]:
        """float32 zero moments shaped as ``params``, on their devices, and
        an int32 0-dim ``step`` on the first leaf's device."""
        zeros = lambda t: map_tree(lambda x: torch.zeros_like(x, dtype=torch.float32), t)
        device = flat_leaves(params)[0].device
        return {"mu": zeros(params), "nu": zeros(params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def state_spec(self, param_spec_tree):
        """ParamSpec tree for the optimizer state (mirrors params, fp32)."""
        from repro_torch.distributed.sharding import ParamSpec

        f32 = lambda s: ParamSpec(s.shape, s.axes, init="zeros", dtype=torch.float32)
        return {
            "mu": map_tree(f32, param_spec_tree),
            "nu": map_tree(f32, param_spec_tree),
            "step": ParamSpec((), (), init="zeros", dtype=torch.int32),
        }

    @torch.no_grad()
    def update(self, grads, state, params):
        """One AdamW step -> ``(params, state)``, both updated in place.
        ``grads`` mirrors ``params`` (any float dtype; it is not written;
        DTensor gradients at their parameters' placements)."""
        with _scalars_replicated(params):
            return self._update(grads, state, params)

    def _update(self, grads, state, params):
        step = state["step"] + 1
        if callable(self.learning_rate):
            lr = self.learning_rate(step)
        else:
            lr = torch.tensor(self.learning_rate, dtype=torch.float32, device=step.device)
        scale = None
        if self.clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)

        b1, b2 = self.b1, self.b2
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device),
                             step.float())
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device),
                             step.float())
        # leaf by leaf: one leaf's float32 temporaries at a time
        for p, m, v, g in zip(flat_leaves(params), flat_leaves(state["mu"]),
                              flat_leaves(state["nu"]), flat_leaves(grads)):
            g = g.float() if scale is None else g.float() * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            p32 = p.float()
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps) + self.weight_decay * p32
            p.copy_((p32 - lr * delta).to(p.dtype))
        state["step"] = step
        return params, state
