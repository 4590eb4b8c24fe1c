"""Batched serving: prefill, then a decode loop over KV caches
(counterpart of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --batch 4 --prompt-len 16 --gen 16 [--device cpu]

It runs on the card unless ``--device`` names another device, and raises
``RuntimeError`` when CUDA is asked for and absent. Parameters are drawn
from a seeded generator on the device (not ``jax.random``'s numbers), the
prompt is the reference's (``make_train_batch(..., seed=1)``), and
:func:`generate` is the loop, so a caller can pass other parameters (for
instance the reference's, through ``repro_torch.convert``). Every
``ARCH_ID`` serves, as in the reference's ``main``: each decode batch
carries the prompt batch's ``image_embeds`` or ``frames``, and the audio
family does not prefill: it encodes the frames, starts from caches made
by ``cache_spec`` with the precomputed cross K/V, and decodes from token 0
at position 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models import build_model
from repro_torch.models import encdec as ED
from repro_torch.models.layers import full_float32_matmul

__all__ = ["Generation", "generate", "main"]


@dataclasses.dataclass
class Generation:
    tokens: np.ndarray           # (B, gen): the token each decode step chose
    first: np.ndarray            # (B,): the first token fed to decode: chosen from the
                                 # prefill's logits (audio: the start token 0)
    logits: list                 # each decode step's logits (B, V), on the device
    prefill_s: float             # host seconds, the device synchronised
    decode_s: float              # the whole decode loop, likewise


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pick(logits, temperature: float, generator):
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
    return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)


def _start_audio(model, params, batch, max_len: int):
    """The reference's audio start: encode the frames, caches from
    ``cache_spec`` (zeros, positions -1) with the cross K/V precomputed."""
    cfg = model.cfg
    device = batch["frames"].device
    caches = sh.init_params(model.cache_spec(batch["frames"].shape[0], max_len),
                            generator=torch.Generator(device=device).manual_seed(2),
                            device=device)
    enc = ED.encode(params, batch["frames"], cfg)
    caches["cross"] = ED.precompute_cross_kv(params, enc, cfg)
    return caches


@torch.no_grad()
def generate(model, params, batch, *, prompt_len: int, gen: int, temperature: float = 0.0,
             generator: torch.Generator | None = None) -> Generation:
    """Prefill ``batch["tokens"]`` (B, prompt_len) into caches sized for
    ``prompt_len + gen`` tokens, then take ``gen`` decode steps, each
    feeding the token chosen from the previous logits (greedy: the first
    arg max, as ``jnp.argmax``) with the batch's ``image_embeds`` or
    ``frames``. The caches are updated in place. The audio family encodes
    ``batch["frames"]`` in place of the prefill and decodes from token 0
    at position 0 (its ``prefill_s`` times the encoder and the cross K/V).

    ``temperature > 0`` samples from ``softmax(logits / temperature)``
    with ``generator``; those draws are not ``jax.random.categorical``'s
    and are not comparable with the reference's sampled tokens.
    """
    device = batch["tokens"].device
    extras = {k: batch[k] for k in ("image_embeds", "frames") if k in batch}
    max_len = prompt_len + gen
    with full_float32_matmul():
        _sync(device)
        t0 = time.perf_counter()
        if model.cfg.family == "audio":
            caches = _start_audio(model, params, batch, max_len)
            tok = torch.zeros((batch["frames"].shape[0], 1), dtype=torch.int32, device=device)
            start = 0
        else:
            logits, caches = model.prefill(params, batch, max_len=max_len)
            tok = _pick(logits, temperature, generator)
            start = prompt_len
        first = tok[:, 0]
        _sync(device)
        prefill_s = time.perf_counter() - t0
        steps, chosen = [], []
        t0 = time.perf_counter()
        for i in range(gen):
            logits, caches = model.decode_step(params, caches, {"token": tok, **extras},
                                               start + i)
            tok = _pick(logits, temperature, generator)
            steps.append(logits)
            chosen.append(tok[:, 0])
        _sync(device)
        decode_s = time.perf_counter() - t0
    return Generation(torch.stack(chosen, 1).cpu().numpy(), first.cpu().numpy(), steps,
                      prefill_s, decode_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device=device)
    batch = make_train_batch(cfg, args.batch, args.prompt_len, seed=1, device=device)
    batch.pop("labels")
    out = generate(model, params, batch, prompt_len=args.prompt_len, gen=args.gen,
                   temperature=args.temperature,
                   generator=torch.Generator(device=device).manual_seed(100))

    print(f"[serve] arch={cfg.name} batch={args.batch} device={device}")
    print(f"[serve] prefill {args.prompt_len} tokens: {out.prefill_s * 1e3:.1f} ms")
    print(
        f"[serve] decoded {args.gen} tokens/seq: {out.decode_s * 1e3:.1f} ms "
        f"({args.batch * args.gen / out.decode_s:.1f} tok/s aggregate)"
    )
    print(f"[serve] sample output tokens (seq 0): {out.tokens[0][:12].tolist()}")
    return out.tokens


if __name__ == "__main__":
    main()
