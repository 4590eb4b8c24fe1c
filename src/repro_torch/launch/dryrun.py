"""Dry run: trace every (arch x shape) cell once on ``meta`` tensors and
record its size, counted work and roofline on one card (counterpart of
``repro.launch.dryrun``).

Per cell this script:
  1. builds the full config and a one-card mesh
     (``make_mesh((1, 1), ("data", "model"), device="meta")``, ``"1x1"``),
  2. takes ``launch.steps.jit_*_step``'s abstract inputs (``meta`` tensors:
     shapes and dtypes, no storage), with the decode position a Python
     ``int``, ``seq_len - 1``: the models read it with ``int(index)``,
     which a ``meta`` tensor cannot answer,
  3. runs the step once under ``roofline.op_costs.analyze`` (counted
     products, operator bytes, the high-water mark of live storage),
  4. records whether arguments (parameters, AdamW state, batch, caches)
     plus the peak beyond them fit the card's HBM, the roofline terms
     against ``launch.mesh.HW`` (one H100 80GB HBM3; the memory term is
     the eager operator traffic), and the step's bound
     (``analysis.step_bound``: products, or the bytes the step must move),
  5. writes one JSON artifact per cell under ``artifacts/dryrun/``.

Nothing is computed, so the card is not needed: the dry run runs on the
host. The reference lowers and compiles each cell for 16 x 16 and
2 x 16 x 16 TPU meshes; the port's one trace replaces both
(``trace_s`` for ``lower_s``/``compile_s``), and meshes over several
cards are ROADMAP.md queue A item 13(d). The reference's
``raw_cost_analysis_flops`` (XLA's count with loop bodies once) has no
counterpart: an eager trace runs every iteration.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
      --shape train_4k [--all] [--out artifacts/dryrun]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, long_context_ok
from repro_torch.launch import steps
from repro_torch.launch.mesh import HW, make_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import op_costs

__all__ = ["cell_overrides", "should_skip", "run_cell", "main"]

MESH_NAME = "1x1"


def cell_overrides(shape_name: str) -> dict:
    if shape_name == "decode_32k":
        # kv head counts are rarely divisible by the 16-way model axis;
        # shard the cache sequence axis over `model` instead.
        return {"cache_seq": "model", "act_cache_seq": "model"}
    if shape_name == "long_500k":
        # batch=1: context parallelism over BOTH axes.
        return {"cache_seq": ("data", "model"),
                "act_cache_seq": ("data", "model")}
    if shape_name == "prefill_32k":
        return {"cache_seq": "model", "act_cache_seq": "model"}
    return {}


def should_skip(arch: str, shape_name: str) -> str | None:
    if shape_name == "long_500k" and not long_context_ok(arch):
        return "skip(full-attn)"
    return None


def _several_cards(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} spans several cards: ROADMAP.md queue A item 13(d); the dry run "
        f"traces each cell on a one-card {MESH_NAME} mesh"
    )


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    rules_extra: dict | None = None,
    microbatches: int | None = None,
    verbose: bool = True,
) -> dict:
    if multi_pod:
        raise _several_cards("the 2 x 16 x 16 mesh")
    shape = SHAPES[shape_name]
    skip = should_skip(arch, shape_name)
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": MESH_NAME,
        "kind": shape.kind,
    }
    if skip:
        record["status"] = skip
        return record

    t0 = time.time()
    cfg = get_config(arch)
    model = build_model(cfg)
    mesh = make_mesh((1, 1), ("data", "model"), device="meta")
    overrides = cell_overrides(shape_name)
    if rules_extra:
        overrides.update(rules_extra)
    rules = steps.resolve_rules(
        cfg, mesh, long_context=(shape_name == "long_500k"), overrides=overrides
    )

    if shape.kind == "train":
        opt = AdamW(learning_rate=3e-4)
        if microbatches is None:
            # per-microbatch batch must stay divisible by the DP size (1 here)
            microbatches = max(1, min(cfg.microbatches, shape.global_batch))
        step, abstract = steps.jit_train_step(
            model, opt, mesh, rules,
            microbatches=microbatches,
            batch=shape.global_batch, seq=shape.seq_len,
        )
    elif shape.kind == "prefill":
        step, abstract = steps.jit_prefill_step(
            model, mesh, rules, batch=shape.global_batch, seq=shape.seq_len
        )
    else:  # decode
        step, abstract = steps.jit_decode_step(
            model, mesh, rules, batch=shape.global_batch, seq=shape.seq_len
        )
        abstract = abstract[:3] + (shape.seq_len - 1,)
    cost = op_costs.analyze(step, *abstract)
    del cost["result"]
    t_trace = time.time() - t0

    terms = ra.roofline_terms(cost)
    bound_s, bound_by = ra.step_bound(cost)
    n_params = model.param_count()
    n_active = model.active_param_count()
    if shape.kind == "train":
        tokens = shape.tokens
        mf = ra.model_flops(n_active, tokens, train=True)
    elif shape.kind == "prefill":
        tokens = shape.tokens
        mf = ra.model_flops(n_active, tokens, train=False)
    else:
        tokens = shape.global_batch  # one new token per sequence
        mf = ra.model_flops(n_active, tokens, train=False)

    arg_b, tmp_b = cost["argument_bytes"], cost["temp_bytes"]
    record.update(
        status="ok",
        trace_s=round(t_trace, 1),
        params=n_params,
        active_params=n_active,
        tokens_per_step=tokens,
        model_flops=mf,
        hlo_flops_per_device=terms.flops,
        useful_flops_ratio=(mf / terms.flops) if terms.flops else 0.0,  # one chip
        memory_analysis={
            "argument_bytes": arg_b,
            "output_bytes": cost["output_bytes"],
            "temp_bytes": tmp_b,
            "alias_bytes": cost["alias_bytes"],
        },
        # arguments stay resident; temp is the peak beyond them
        fits_hbm=bool(arg_b + tmp_b < HW.HBM_BYTES),
        hbm_needed_gib=round((arg_b + tmp_b) / 2**30, 2),
        roofline=terms.asdict(),
        bound={"bound_s": bound_s, "bound_by": bound_by, "io_bytes": cost["io_bytes"]},
        collective_kinds=cost["collectives"],
        collective_wire_bytes=terms.coll_bytes,
        flops_by_op=cost["flops_by_op"],
    )
    if verbose:
        print(
            f"[dryrun] {arch} {shape_name} {MESH_NAME}: trace {t_trace:.0f}s "
            f"hbm {record['hbm_needed_gib']} GiB fits={record['fits_hbm']} "
            f"bound {bound_s * 1e3:.4g} ms by {bound_by}"
        )
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + ("all",))
    ap.add_argument("--shape", default=None, choices=tuple(SHAPES) + ("all",))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="every cell")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes:
        raise _several_cards("the 16 x 16 and 2 x 16 x 16 meshes")

    archs = ARCH_IDS if (args.all or args.arch in (None, "all")) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or args.shape in (None, "all")) else (args.shape,)

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            tag = f"{arch}__{shape_name}__{MESH_NAME}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[dryrun] {tag}: exists, skipping")
                continue
            try:
                rec = run_cell(arch, shape_name)
            except Exception as e:  # a failure here is a fault of the step
                failures += 1
                rec = {
                    "arch": arch, "shape": shape_name, "mesh": MESH_NAME,
                    "status": f"FAIL: {type(e).__name__}: {e}",
                }
                traceback.print_exc()
            with open(path, "w") as f:
                json.dump(rec, f, indent=2, default=str)
    print(f"[dryrun] done, failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
