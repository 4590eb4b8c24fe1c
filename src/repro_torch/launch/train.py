"""End-to-end training driver: data -> step -> checkpoint -> fault
tolerance (counterpart of ``repro.launch.train``).

Composes the substrate as the reference does:
  * synthetic token pipeline (deterministic, resumable by step index);
  * the train step (``launch.steps``) with running-sum microbatching;
  * async atomic checkpoints (``CheckpointManager``) in the reference's
    format and leaf order, ``{"params", "opt": {"mu", "nu", "step"}}``:
    either package resumes the other's;
  * straggler detection hooks (per-step wall times);
  * optional error-feedback gradient compression (``--compress int8|topk``)
    of what would cross a pod boundary, applied to the first moment as
    the reference does.

It takes the reference's flags and ``--device``: it runs on the card
unless ``--device cpu`` is given, and raises without CUDA. ``--mesh 2x2``
trains a dense, MoE, SSM or hybrid architecture over a ``(data, model)``
mesh of four ranks: run
it under a process group of that world size (``torchrun --standalone
--nproc-per-node 4``, whose environment starts a gloo group, or a group
the caller started); it raises when the sizes differ. Every rank steps;
rank 0 alone prints and writes checkpoints, which hold full tensors in
the reference's format. Parameters are
drawn from a seeded ``torch.Generator`` on the device (not
``jax.random``'s numbers), so a fresh run starts elsewhere than the
reference's; a run resumed from either package's checkpoint continues it.

Example (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --smoke \\
      --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/ck --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpoint import map_tree, to_host
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim import compress as C
from repro_torch.runtime import StragglerDetector

__all__ = ["Losses", "make_data_stream", "main"]


class Losses(list):
    """The run's losses, one float a step, as the reference's ``main``
    returns them; ``step_s`` holds each step's host seconds (the device
    synchronised by reading the loss) and ``grad_norms`` each step's
    gradient norm."""

    step_s: list[float]
    grad_norms: list[float]


def make_data_stream(cfg, batch, seq, microbatches, *, cycle: int = 4, device=None):
    """Deterministic resumable stream (repro_torch.data.pipeline.DataPipeline)."""
    from repro_torch.data.pipeline import DataPipeline

    return DataPipeline(
        cfg, batch=batch, seq=seq, microbatches=microbatches, cycle=cycle, device=device
    ).batch_at


def main(argv=None) -> Losses:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b",
                    help=f"one of {ARCH_IDS} or an ad-hoc registered config")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--compress", default=None, choices=(None, "int8", "topk"))
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x2 => (data,model) over a process group of 4 ranks")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else (1, 1)
    if (shape[0] * shape[1] > 1 and not torch.distributed.is_initialized()
            and "WORLD_SIZE" in os.environ):
        torch.distributed.init_process_group("gloo")  # torchrun's environment
    mesh = make_mesh(shape, ("data", "model"), device=device)
    rules = steps.resolve_rules(cfg, mesh)
    opt = AdamW(learning_rate=cosine_schedule(args.lr, 5, args.steps))
    lead = mesh.size == 1 or torch.distributed.get_rank() == 0

    train_step, _ = steps.jit_train_step(
        model, opt, mesh, rules,
        microbatches=args.microbatches, batch=args.batch, seq=args.seq,
    )
    params = sh.init_params(model.spec(), generator=torch.Generator(device=device).manual_seed(0),
                            device=device, mesh=mesh, rules=rules)
    opt_state = opt.init(params)
    residual = C.ef_init(params) if args.compress else None

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    state_sh = None
    if mesh.size > 1:
        params_sh, opt_sh = steps.train_state_shardings(model, opt, mesh, rules)
        state_sh = {"params": params_sh, "opt": opt_sh}

    def save(step, blocking=False):
        state = {"params": params, "opt": opt_state}
        if mesh.size > 1:
            state = map_tree(to_host, state)  # every rank gathers; rank 0 writes
        if lead:
            mgr.save(step, state, blocking=blocking)

    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        state, start = mgr.restore(device=device, shardings=state_sh)
        params, opt_state = state["params"], state["opt"]
        start += 1
        if lead:
            print(f"[train] resumed from step {start}")

    data = make_data_stream(cfg, args.batch, args.seq, args.microbatches, device=device)
    straggler = StragglerDetector()
    losses = Losses()
    losses.step_s, losses.grad_norms = [], []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = data(step)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if args.compress:
            # demonstrate the cross-pod path: compress what WOULD cross DCN
            _, residual = C.ef_step(opt_state["mu"], residual, kind=args.compress)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        losses.step_s.append(dt)
        losses.grad_norms.append(float(metrics["grad_norm"]))
        straggler.record("worker0", dt)
        if lead:
            print(f"[train] step {step} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
        if mgr is not None and step % args.ckpt_every == 0:
            save(step)
    if mgr is not None:
        save(args.steps - 1, blocking=True)
    if lead:
        print(
            f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}; "
            f"stragglers={straggler.stragglers()}"
        )
    return losses


if __name__ == "__main__":
    main()
