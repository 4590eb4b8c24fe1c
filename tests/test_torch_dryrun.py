"""Port parity of the dry run (``repro_torch.launch.dryrun``) against the
reference's, on the CPU.

* ``cell_overrides`` and ``should_skip`` equal the reference's for every
  ``ARCH_IDS`` x ``SHAPES`` cell.
* ``params`` and ``active_params`` equal the reference model's counts for
  every ``ARCH_ID`` at full width (from the specs: nothing is allocated).
* Two full-width cells traced on ``meta`` tensors on the one-card mesh
  (``h2o-danube-1.8b`` ``decode_32k``, ``gemma3-1b`` ``prefill_32k``): the
  record carries the reference's keys and its numbers hang together
  (arguments = parameters + caches + batch; the counted FLOPs against
  2·N·D; the bound from the products and the bytes the step must move).
  No wall-clock limit: a trace takes 1-2 s alone, and ``chip_smoke.py``
  prints phase 14c's trace times.
* ``main`` writes one JSON per cell, records a failed cell as ``FAIL``
  with exit code 1, and refuses the reference's TPU meshes, naming
  item 13(d).
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.checkpoint.checkpoint import flat_leaves
from repro_torch.distributed.sharding import count_params
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HW
from repro_torch.models import build_model

#: the reference record's keys the port keeps (lower_s and compile_s become
#: trace_s; raw_cost_analysis_flops has no eager counterpart)
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "status", "trace_s", "params",
               "active_params", "tokens_per_step", "model_flops", "hlo_flops_per_device",
               "useful_flops_ratio", "memory_analysis", "fits_hbm", "hbm_needed_gib",
               "roofline", "collective_kinds", "collective_wire_bytes"}


def _spec_bytes(spec_tree) -> int:
    return sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()
               for s in flat_leaves(spec_tree))


def _reference_cells() -> dict:
    """The reference's overrides and skips, from a subprocess: importing
    ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices for the
    process and every process it starts."""
    code = textwrap.dedent("""
        import json
        from repro.configs import ARCH_IDS, SHAPES
        from repro.launch import dryrun
        print("CELLS", json.dumps({
            "overrides": {s: dryrun.cell_overrides(s) for s in SHAPES},
            "skips": {f"{a}/{s}": dryrun.should_skip(a, s) for a in ARCH_IDS for s in SHAPES},
        }))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ), timeout=300)
    line = [x for x in out.stdout.splitlines() if x.startswith("CELLS ")]
    assert line, out.stderr[-2000:]
    return json.loads(line[0][len("CELLS "):])


def test_cell_overrides_and_skips_equal_the_reference():
    assert tuple(ARCH_IDS) == tuple(JARCH_IDS) and list(SHAPES) == list(JSHAPES)
    ref = _reference_cells()
    for shape in SHAPES:
        # JSON turns the reference's tuples into lists
        assert json.loads(json.dumps(dryrun.cell_overrides(shape))) == ref["overrides"][shape]
        for arch in ARCH_IDS:
            assert dryrun.should_skip(arch, shape) == ref["skips"][f"{arch}/{shape}"]
    assert sum(dryrun.should_skip(a, s) is not None for a in ARCH_IDS for s in SHAPES) == 5


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_width_parameter_counts_equal_the_reference(arch):
    model, jmodel = build_model(get_config(arch)), jbuild_model(jget_config(arch))
    assert model.param_count() == jmodel.param_count()
    assert model.active_param_count() == jmodel.active_param_count()


@pytest.mark.parametrize("arch,shape", [("h2o-danube-1.8b", "decode_32k"),
                                        ("gemma3-1b", "prefill_32k")])
def test_full_width_cell_traces_on_meta(arch, shape):
    rec = dryrun.run_cell(arch, shape, verbose=False)
    assert set(rec) >= RECORD_KEYS and rec["status"] == "ok" and rec["mesh"] == "1x1"
    cfg, sh = get_config(arch), SHAPES[shape]
    model = build_model(cfg)
    assert rec["params"] == model.param_count()
    mem = rec["memory_analysis"]
    args = _spec_bytes(model.spec()) + 4 * sh.global_batch * (
        1 if sh.kind == "decode" else sh.seq_len)  # int32 tokens
    if sh.kind == "decode":
        caches = _spec_bytes(model.cache_spec(sh.global_batch, sh.seq_len))
        args += caches
        assert mem["alias_bytes"] == caches
        assert rec["tokens_per_step"] == sh.global_batch
    else:
        assert mem["alias_bytes"] == 0 and rec["tokens_per_step"] == sh.tokens
    assert mem["argument_bytes"] == args and mem["temp_bytes"] > 0
    need = mem["argument_bytes"] + mem["temp_bytes"]
    assert rec["fits_hbm"] == (need < HW.HBM_BYTES)
    assert rec["hbm_needed_gib"] == round(need / 2**30, 2)
    assert rec["model_flops"] == 2.0 * model.active_param_count() * rec["tokens_per_step"]
    # the counted products: every parameter's matmul (the embedding's
    # gather is none) and attention's; useful = 2·N·D over them
    assert 0.5 < rec["useful_flops_ratio"] <= 1.05
    assert rec["useful_flops_ratio"] == rec["model_flops"] / rec["hlo_flops_per_device"]
    roof = rec["roofline"]
    assert roof["compute_s"] == rec["hlo_flops_per_device"] / HW.PEAK_BF16_FLOPS
    assert roof["collective_s"] == 0.0 and not any(rec["collective_kinds"].values())
    assert roof["dominant"] in ("compute", "memory")
    # the bound: every input read once, the logits (and prefill's caches)
    # written once, decode's one cache slot a layer written in place
    bound, io_bytes = rec["bound"], rec["bound"]["io_bytes"]
    fresh = io_bytes - mem["argument_bytes"]
    # the last position's logits, in the compute dtype
    logits = getattr(torch, cfg.dtype).itemsize * sh.global_batch * cfg.vocab_size
    if sh.kind == "decode":  # one slot of every cache leaf (a ring of its cache_seq)
        slot = sum(_spec_bytes(s) // s.shape[s.axes.index("cache_seq")]
                   for s in flat_leaves(model.cache_spec(sh.global_batch, sh.seq_len)))
        assert fresh == logits + slot
    else:
        assert fresh == mem["output_bytes"] >= logits
    assert bound["bound_s"] == max(roof["compute_s"], io_bytes / HW.HBM_BW)
    assert bound["bound_s"] < max(roof["compute_s"], roof["memory_s"])
    assert bound["bound_by"] == ("operations" if roof["compute_s"] >= io_bytes / HW.HBM_BW
                                 else "bytes")


def test_skipped_cell_and_the_tpu_meshes():
    rec = dryrun.run_cell("qwen2.5-32b", "long_500k", verbose=False)
    assert rec == {"arch": "qwen2.5-32b", "shape": "long_500k", "mesh": "1x1",
                   "kind": "decode", "status": "skip(full-attn)"}
    with pytest.raises(NotImplementedError, match=r"item 13\(d\)"):
        dryrun.run_cell("h2o-danube-1.8b", "long_500k", multi_pod=True)
    for flag in ("--multi-pod", "--both-meshes"):
        with pytest.raises(NotImplementedError, match=r"item 13\(d\)"):
            dryrun.main(["--arch", "h2o-danube-1.8b", "--shape", "long_500k", flag])


def test_main_writes_a_record_per_cell_and_fails_on_a_failed_cell(tmp_path, monkeypatch):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "h2o-danube-1.8b", "--shape", "long_500k",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    rec = json.loads((tmp_path / "h2o-danube-1.8b__long_500k__1x1.json").read_text())
    assert rec["status"] == "ok" and rec["kind"] == "decode" and rec["tokens_per_step"] == 1
    assert count_params(build_model(get_config("h2o-danube-1.8b")).spec()) == rec["params"]

    def broken(arch, shape_name, **kw):
        raise RuntimeError("a broken step")

    monkeypatch.setattr(dryrun, "run_cell", broken)
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--out", str(tmp_path)])
    assert done.value.code == 1
    rec = json.loads((tmp_path / "gemma3-1b__train_4k__1x1.json").read_text())
    assert rec["status"] == "FAIL: RuntimeError: a broken step"
