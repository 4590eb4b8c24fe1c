"""The port stands alone: it imports neither jax nor the reference, runs
on CUDA unless told otherwise (and refuses to carry on on the CPU when
CUDA is absent), never falls back from a kernel to its plain version,
and can take over or hand back a stream mid-acquisition (``convert``).
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.denoise import DenoiseConfig as JConfig
from repro.core.denoise import StreamingDenoiser as JDenoiser
from repro.data.prism import PrismSource as JSource
from repro_torch import convert
from repro_torch.core import banks, streaming
from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser
from repro_torch.kernels import ops

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
SMALL = dict(num_groups=8, frames_per_group=8, height=8, width=128)


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def test_import_loads_neither_jax_nor_reference():
    mods = _modules()
    for new in ("denoise_median", "denoise_ema", "denoise_spatial", "denoise_tmpframe"):
        assert f"repro_torch.kernels.{new}" in mods
    assert "repro_torch.core.banks" in mods
    for new in ("temporal_median", "ema_variance", "spatial_box"):
        assert f"repro_torch.denoise.{new}" in mods
    assert "repro_torch.tune.budget" in mods and len(mods) > 25
    for new in ("serve", "serve.session", "serve.scheduler", "serve.faults", "serve.retry",
                "obs.slo", "obs.health", "obs.regress", "core.latency_model", "core.egress",
                "optim", "optim.compress", "checkpoint", "checkpoint.checkpoint", "runtime",
                "runtime.fault_tolerance", "runtime.elastic", "serve.recovery", "serve.fleet",
                "serve.autoscale", "serve.loadgen", "tune.autotune", "tune.cache", "tune.plan"):
        assert f"repro_torch.{new}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    src = str(PKG.parent)
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"},
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_no_module_imports_jax_or_reference_statically():
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), f"{path}: {n}"


def test_kernel_modules_have_no_fallback_handlers():
    # a build or launch failure must surface, never reroute to the plain path
    for name in ("denoise_stream.py", "denoise_multibank.py", "denoise_median.py",
                 "denoise_ema.py", "denoise_spatial.py", "denoise_tmpframe.py", "ops.py",
                 "_build.py"):
        tree = ast.parse((PKG / "kernels" / name).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name


def test_bank_executor_handlers_only_record_errors():
    # its handlers end a producer on a closed ring or hand the error to the
    # caller; none runs anything in place of what failed
    tree = ast.parse((PKG / "core" / "banks.py").read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert handlers
    for h in handlers:
        calls = [n for n in ast.walk(h) if isinstance(n, ast.Call)]
        assert all(isinstance(c.func, ast.Attribute) and c.func.attr == "append"
                   for c in calls), ast.unparse(h)


def test_scheduler_handlers_only_record_errors():
    # every handler of the session service records the error on its session
    # (act.error) or executor (self.failed), counts it, re-raises it, or ends
    # a producer or a drain on an exhausted source or a closed ring; none
    # runs anything in place of what failed
    tree = ast.parse((PKG / "serve" / "scheduler.py").read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert len(handlers) >= 8
    for h in handlers:
        for stmt in h.body:
            text = ast.unparse(stmt)
            if isinstance(stmt, ast.Break):
                continue  # ends the loop the handler is in
            if isinstance(stmt, ast.Pass):
                assert "RingClosed" in ast.unparse(h.type), text
            elif isinstance(stmt, ast.Raise):
                assert stmt.exc is None, text  # re-raises the same error
            elif isinstance(stmt, ast.Assign):
                assert all(isinstance(t, ast.Attribute) and t.attr in ("error", "failed")
                           for t in stmt.targets), text
                assert isinstance(stmt.value, ast.Name) and stmt.value.id == h.name, text
            else:  # a counter of errors, nothing else
                assert isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call), text
                assert isinstance(stmt.value.func, ast.Attribute), text
                assert stmt.value.func.attr == "inc", text


def test_build_compiles_every_source_and_raises_on_a_failed_one(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    assert {s.name for s in _build.SOURCES} == {
        "denoise_stream.cu", "denoise_median.cu", "denoise_ema.cu", "denoise_spatial.cu",
        "denoise_tmpframe.cu"}
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"  # fails on the EMA source, succeeds on the others
    fake.write_text(f'#!/bin/sh\necho "$@" >> {log}\n'
                    'case "$*" in *denoise_ema.cu*) echo "ema: error"; exit 2;; esac\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"denoise_ema\.cu \(nvcc exit 2\):\nema: error"):
        _build._build(tmp_path / "build" / "lib.so")
    calls = log.read_text().splitlines()
    assert len(calls) == len(_build.SOURCES)  # every compile ran to its end; no link
    assert all("-c" in c.split() and "sm_90a" in c for c in calls)
    assert not (tmp_path / "build" / "lib.so").exists()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize(
    "entry",
    [
        lambda cfg, src: StreamingDenoiser(cfg),
        lambda cfg, src: streaming.run_pipelined(cfg, src),
        lambda cfg, src: streaming.run_inline(cfg, src),
        lambda cfg, src: streaming.run_inline(cfg, src, prefetch=False),
        lambda cfg, src: streaming.run_buffered(cfg, src),
    ],
    ids=["denoiser", "pipelined", "inline", "inline_serial", "buffered"],
)
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry):
    cfg = DenoiseConfig(**SMALL)
    pulled = []

    def src():
        pulled.append(1)
        yield np.zeros((8, 8, 128), np.uint16)

    with pytest.raises(RuntimeError, match="CUDA"):
        entry(cfg, src())
    assert not pulled  # raised before acquiring anything


@pytest.mark.parametrize("name", ["temporal_median", "ema_variance", "spatial_box"])
def test_every_filter_defaults_to_cuda_and_raises_without_it(no_cuda, name):
    cfg = DenoiseConfig(**SMALL, filter_name=name)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingDenoiser(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        streaming.run_pipelined(cfg, iter([np.zeros((8, 8, 128), np.uint16)]))
    den = StreamingDenoiser(cfg, device="cpu")
    state = den.init()
    leaves = state.values() if isinstance(state, dict) else [state]
    assert all(t.device.type == "cpu" for t in leaves)


def test_bank_entry_points_need_cuda_unless_told_otherwise(no_cuda):
    cfg = DenoiseConfig(**SMALL)
    with pytest.raises(ValueError, match="need 2 devices for 2 banks, have 0"):
        banks.make_bank_mesh(2)
    with pytest.raises(ValueError, match="need 1 devices for 1 banks, have 0"):
        banks.make_bank_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        banks.banked_filter_init(cfg, None, banks=2)
    pulled = []

    def src():
        pulled.append(1)
        yield np.zeros((8, 8, 128), np.uint16)

    with pytest.raises(RuntimeError, match="CUDA"):
        banks.run_pipelined_banked(cfg, [src(), src()], banks.BankMesh(("cuda:0", "cuda:0")))
    assert not pulled
    _, state = banks.banked_filter_init(cfg, banks.BankMesh(("cpu", "cpu")))
    assert [s.device.type for s in state] == ["cpu", "cpu"]


def test_session_scheduler_defaults_to_cuda_and_raises_without_it(no_cuda):
    from repro_torch.serve import SessionScheduler

    with pytest.raises(RuntimeError, match="CUDA"):
        SessionScheduler()
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionScheduler(slots_per_executor=4, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionScheduler(mesh=banks.BankMesh(("cuda:0", "cuda:0")))
    with SessionScheduler(device="cpu") as sched:
        assert sched.device == torch.device("cpu")
    with SessionScheduler(mesh=banks.BankMesh(("cpu", "cpu"))) as sched:
        assert sched.slots_per_executor == 2


#: ``repro.serve.__all__``, listed literally: the port exports every name
REFERENCE_SERVE_NAMES = (
    "AdmissionError", "ArrivalEvent", "AutoscaleDecision", "Autoscaler", "BackoffPolicy",
    "CheckpointMismatch", "Clock", "DEGRADE_LEVELS", "FakeClock", "FaultPlan", "FleetScheduler",
    "InjectedExecutorFailure", "Session", "SessionCheckpointer", "SessionHandle", "SessionReport",
    "SessionScheduler", "TenantProfile", "admission_pressure_slo", "build_trace",
    "diurnal_schedule", "flash_crowd_schedule", "heavy_tail_groups", "poisson_schedule",
    "replay_trace", "retry_with_backoff",
)


def test_unported_serve_names_raise_naming_their_item():
    # every name of the reference's serve package is ported now (queue A
    # item 10(c) was the last): each resolves, and an unknown name is a
    # plain AttributeError
    import repro.serve as jserve
    import repro_torch.serve as serve

    assert set(REFERENCE_SERVE_NAMES) == set(jserve.__all__)
    for name in REFERENCE_SERVE_NAMES:
        assert name in serve.__all__, name
        assert getattr(serve, name) is not None, name
    assert not hasattr(serve, "NOT_PORTED")
    with pytest.raises(AttributeError, match="NoSuchThing"):
        serve.NoSuchThing


def test_autotune_catches_no_launch_failure():
    # a candidate whose launch fails is never dropped for another: the
    # launch model rejects a geometry before any launch, and an error
    # raised while timing propagates (a failed CUDA launch can leave the
    # context unusable)
    tree = ast.parse((PKG / "tune" / "autotune.py").read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert handlers == [], [ast.unparse(h) for h in handlers]


def test_auto_tile_plan_times_on_cuda_by_default(monkeypatch):
    from repro_torch import tune
    from repro_torch.tune import autotune

    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(autotune, "tune_plan",
                        lambda config, device, cache=None: seen.append(device) or
                        tune.Plan(mode="auto"))
    monkeypatch.setattr(tune, "device_kind", lambda device: "card")
    tune.clear_plan_memo()
    try:
        plan = tune.resolve_plan(DenoiseConfig(**SMALL, tile_plan="auto"))
    finally:
        tune.clear_plan_memo()
    assert plan.mode == "auto"
    assert [d.type for d in seen] == ["cuda"]


def test_auto_tile_plan_raises_without_cuda(no_cuda, tmp_path, monkeypatch):
    from repro_torch import tune

    monkeypatch.setenv("REPRO_TUNE_CACHE_PATH", str(tmp_path / "plans.json"))
    tune.clear_plan_memo()
    cfg = DenoiseConfig(**SMALL, tile_plan="auto")
    with pytest.raises(RuntimeError, match="CUDA"):
        tune.resolve_plan(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tune.resolve_plan(cfg, device=None)
    assert not (tmp_path / "plans.json").exists()  # nothing was timed
    assert tune.resolve_plan(cfg, device="cpu").mode == "auto"
    tune.clear_plan_memo()


def test_fleet_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    from repro_torch.checkpoint import restore_tree, save_tree
    from repro_torch.runtime.elastic import available_mesh
    from repro_torch.serve import FleetScheduler, SessionCheckpointer

    with pytest.raises(RuntimeError, match="CUDA"):
        FleetScheduler()
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetScheduler(checkpoint_dir=str(tmp_path / "f"), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetScheduler(mesh=banks.BankMesh(("cuda:0", "cuda:0")))
    with pytest.raises(RuntimeError, match="CUDA"):
        available_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        available_mesh(devices=["cuda:0"])
    assert available_mesh(devices=["cpu", "cpu"]) == banks.BankMesh(("cpu", "cpu"))
    save_tree(str(tmp_path / "ck"), {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_tree(str(tmp_path / "ck"), device="cuda")
    cfg = DenoiseConfig(**SMALL)
    filt, state = banks.banked_filter_init(cfg, None, banks=1, device="cpu")
    ck = SessionCheckpointer(str(tmp_path / "s"))
    ck.save("s", filt, filt.slot_extract(state, 0), steps=0, frames=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ck.restore_latest("s", filt, device="cuda")
    restored, _, _ = ck.restore_latest("s", filt)  # the filter's own device
    assert restored.device == torch.device("cpu")
    with FleetScheduler(checkpoint_dir=str(tmp_path / "f"), device="cpu") as fleet:
        assert fleet.device == torch.device("cpu")


def test_explicit_cuda_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingDenoiser(DenoiseConfig(**SMALL), device="cuda")


@pytest.mark.parametrize(
    "entry",
    [
        lambda: ops.stream_init(8, 8, 128),
        lambda: ops.multibank_stream_init(2, 8, 8, 128),
        lambda: convert.state_from_reference(np.zeros((4, 8, 128), np.float32)),
        lambda: convert.state_from_reference({"ema": np.zeros((4, 8, 128), np.float32)}),
    ],
    ids=["stream_init", "multibank_stream_init", "state_from_reference", "state_dict"],
)
def test_state_constructors_default_to_cuda_and_raise_without_it(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_state_constructors_take_an_explicit_cpu_device(no_cuda):
    assert ops.stream_init(8, 8, 128, device="cpu").device.type == "cpu"
    assert ops.multibank_stream_init(2, 8, 8, 128, device="cpu").shape == (2, 4, 8, 128)
    x = np.ones((4, 8, 128), np.float32)
    assert torch.equal(convert.state_from_reference(x, device="cpu"), torch.ones(4, 8, 128))


def test_config_round_trip_through_convert():
    for kw in (SMALL, dict(SMALL, stream_dtype="p12", algorithm="alg3_v2", num_banks=2)):
        jcfg = JConfig(**kw)
        cfg = convert.config_from_reference(dataclasses.asdict(jcfg))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError, match="lacks"):
        convert.config_from_reference({**dataclasses.asdict(JConfig(**SMALL)), "x": 1})


@pytest.mark.parametrize("algorithm", ["alg3", "alg3_v2"])
@pytest.mark.parametrize("fmt", ["u16", "u8"])
def test_stream_handoff_reference_to_port(fmt, algorithm):
    kw = dict(SMALL, num_groups=6, stream_dtype=fmt, algorithm=algorithm)
    jcfg = JConfig(**kw)
    groups = list(JSource(jcfg, seed=9).groups())
    jden = JDenoiser(jcfg)
    full = jden.run(jnp.asarray(g) for g in groups)
    # the reference folds groups 0..2, the port folds 3..5
    js = jden.init()
    for k in range(3):
        js = jden.ingest(js, jnp.asarray(groups[k]), step=k)
    cfg = convert.config_from_reference(dataclasses.asdict(jcfg))
    den = StreamingDenoiser(cfg, device="cpu")
    st = convert.state_from_reference(np.asarray(js), device="cpu")
    for k in range(3, 6):
        st = den.ingest(st, groups[k], step=k)
    assert np.array_equal(den.finalize(st).numpy(), np.asarray(full))


@pytest.mark.parametrize("algorithm", ["alg3", "alg3_v2"])
def test_stream_handoff_port_to_reference(algorithm):
    kw = dict(SMALL, num_groups=6, algorithm=algorithm)
    jcfg, cfg = JConfig(**kw), DenoiseConfig(**kw)
    groups = list(JSource(jcfg, seed=10).groups())
    full = JDenoiser(jcfg).run(jnp.asarray(g) for g in groups)
    den = StreamingDenoiser(cfg, device="cpu")
    st = den.init()
    for k in range(3):
        st = den.ingest(st, groups[k], step=k)
    jden = JDenoiser(jcfg)
    js = jnp.asarray(convert.state_to_reference(st))
    for k in range(3, 6):
        js = jden.ingest(js, jnp.asarray(groups[k]), step=k)
    assert np.array_equal(np.asarray(jden.finalize(js)), np.asarray(full))


def test_uint16_state_converts_losslessly():
    x = np.array([[[0, 1, 65535]]], np.uint16)
    t = convert.state_from_reference(x, device="cpu")
    assert t.dtype == torch.uint16
    back = convert.state_to_reference(t)
    assert back.dtype == np.uint16 and np.array_equal(back, x)
