"""Reckon the memory of ``chip_smoke.py`` phase 15 on the host, before the
card runs it: for each configuration of ``chip_smoke.MESH_RUNS`` (the
published widths at its cut depth, float32), the parameter count, the
float32 train state (parameters, gradients and AdamW's two moments), and
the live peak of one train step and one prefill in one process, counted
by ``roofline.op_costs.analyze`` on ``meta`` tensors. Nothing is
allocated and no card is needed.

Run from the repository root:

    PYTHONPATH=src python scripts/torch_mesh_peaks.py [--only LABEL ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None, help="labels of MESH_RUNS, e.g. 15b")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.roofline import op_costs

    runs = _chip_smoke().MESH_RUNS
    rows = []
    for run in runs:
        if args.only and run["label"] not in args.only:
            continue
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(run["arch"]), dtype="float32",
                                  **({"num_layers": run["layers"]} if run["layers"] else {}))
        model = build_model(cfg)
        n = sh.count_params(model.spec())
        mesh = make_mesh((1, 1), ("data", "model"), device="meta")
        rules = steps.resolve_rules(cfg, mesh)
        train, abstract = steps.jit_train_step(model, AdamW(), mesh, rules, microbatches=1,
                                               batch=run["train_batch"], seq=run["train_seq"])
        train_peak = op_costs.analyze(train, *abstract)["peak_bytes"]
        prefill, abstract = steps.jit_prefill_step(model, mesh, rules, batch=run["batch"],
                                                   seq=run["prompt"])
        prefill_peak = op_costs.analyze(prefill, *abstract)["peak_bytes"]
        row = dict(label=run["label"], arch=run["arch"], layers=cfg.num_layers, params=n,
                   train_state_gb=4 * 4 * n / 1e9, train_peak_gb=train_peak / 1e9,
                   prefill_peak_gb=prefill_peak / 1e9,
                   seconds=time.perf_counter() - t0)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    main()
