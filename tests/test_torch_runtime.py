"""Port parity of the fault-tolerance runtime and the elastic primitives
(``repro_torch.runtime``) against the reference (``repro.runtime``), on
the CPU.

* ``HeartbeatMonitor``, ``StragglerDetector`` and ``Supervisor`` run the
  scripted scenarios of ``tests/test_fault_tolerance.py`` in both
  packages and must give the same ``dead()``, ``workers()``,
  ``last_beats()``, ``stragglers()``, ``ewma`` and history strings (the
  port's runtime is a copy of the reference's; only the checkpoints the
  ``Supervisor`` writes differ, torch tensors against jax arrays).
* ``mesh_shape`` equals the reference's over a range of device counts.
* ``available_mesh`` takes an explicit device list as given and raises
  ``RuntimeError`` without CUDA when none is given (it never yields a CPU
  mesh unasked); ``state_spec_tree`` mirrors a tree's leaves; and
  ``elastic_reshard`` places trees on ``BankMesh(("cpu", "cpu"))``
  bit-exact, whole or split along a ``bank`` axis.

Tolerance: exact (``==`` on floats, ``array_equal`` on arrays).
"""

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.runtime import HeartbeatMonitor as JHeartbeat
from repro.runtime import StragglerDetector as JStraggler
from repro.runtime import Supervisor as JSupervisor
from repro.runtime.elastic import mesh_shape as j_mesh_shape
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.banks import BankMesh
from repro_torch.runtime import HeartbeatMonitor, StragglerDetector, Supervisor
from repro_torch.runtime.elastic import (
    LeafSpec,
    available_mesh,
    elastic_reshard,
    mesh_shape,
    state_spec_tree,
)

CPU = torch.device("cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# HeartbeatMonitor: the same script gives the same answers.
# ---------------------------------------------------------------------------

HEARTBEAT_SCRIPTS = {
    "dead_detection": (10, [("beat", "w0", 0.0), ("beat", "w1", 0.0), ("beat", "w0", 8.0),
                            ("dead", None, 15.0), ("dead", None, 5.0)]),
    "evict": (1, [("beat", "w0", 0.0), ("evict", "w0", None), ("dead", None, 100.0)]),
    "exact_timeout_is_alive": (10, [("beat", "w0", 5.0), ("dead", None, 15.0),
                                    ("dead", None, 15.0 + 1e-9)]),
    "beat_refreshes_deadline": (10, [("beat", "w0", 0.0), ("beat", "w0", 9.0),
                                     ("dead", None, 15.0), ("dead", None, 19.5)]),
    "unknown_worker_never_dead": (1, [("dead", None, 1e9), ("evict", "never-seen", None),
                                      ("dead", None, 1e9)]),
    "evict_is_idempotent": (1, [("beat", "b", 0.0), ("beat", "a", 0.0), ("dead", None, 0.5),
                                ("evict", "a", None), ("evict", "a", None),
                                ("dead", None, 100.0)]),
    "rejoin_after_evict": (10, [("beat", "w0", 0.0), ("beat", "w1", 0.0), ("beat", "w2", 10.0),
                                ("dead", None, 18.0 + 1e-9), ("evict", "w1", None),
                                ("dead", None, 100.0), ("beat", "w1", 95.0),
                                ("dead", None, 105.0)]),
}


@pytest.mark.parametrize("scenario", sorted(HEARTBEAT_SCRIPTS))
def test_heartbeat_monitor_matches_reference(scenario):
    timeout, script = HEARTBEAT_SCRIPTS[scenario]
    mons = [HeartbeatMonitor(timeout_s=timeout), JHeartbeat(timeout_s=timeout)]
    for op, w, t in script:
        outs = []
        for m in mons:
            if op == "beat":
                m.beat(w, now=t)
            elif op == "evict":
                m.evict(w)
            else:
                outs.append((m.dead(now=t), m.workers(), m.last_beats(now=t)))
        assert not outs or outs[0] == outs[1]


# ---------------------------------------------------------------------------
# StragglerDetector: the same samples give the same flags and EWMAs.
# ---------------------------------------------------------------------------

STRAGGLER_SCRIPTS = {
    # (detector kwargs, [(worker, duration) or ("forget", worker)])
    "flags_slow_worker": (dict(threshold=1.5, warmup_steps=3),
                          [(w, 3.0 if w == "slow" else 1.0)
                           for _ in range(5) for w in ("w0", "w1", "w2", "w3", "slow")]),
    "warmup_suppresses_flapping": (dict(threshold=1.5, warmup_steps=3),
                                   [("w0", 1.0), ("w1", 1.0), ("spike", 10.0)]),
    "recovery_unflags": (dict(threshold=1.5, warmup_steps=2, alpha=0.9),
                         [(w, 5.0 if (w == "w2" and k < 4) else 1.0)
                          for k in range(14) for w in ("w0", "w1", "w2")]),
    "threshold_boundary_is_strict": (dict(threshold=2.0, warmup_steps=1, alpha=1.0),
                                     [("a", 1.0), ("b", 1.0), ("c", 1.0), ("edge", 2.0),
                                      ("edge", 2.0 + 1e-9)]),
    "all_zero_durations": (dict(threshold=1.5, warmup_steps=1),
                           [("a", 0.0), ("b", 0.0), ("c", 0.0)]),
    "forget_drops_median_skew": (dict(threshold=1.5, warmup_steps=2, alpha=1.0),
                                 [(w, 10.0 if w == "slow" else 1.0)
                                  for _ in range(3) for w in ("w0", "w1", "slow")]
                                 + [("forget", "slow"), ("slow2", 4.0), ("slow2", 4.0)]),
}


@pytest.mark.parametrize("scenario", sorted(STRAGGLER_SCRIPTS))
def test_straggler_detector_matches_reference(scenario):
    kwargs, script = STRAGGLER_SCRIPTS[scenario]
    dets = [StragglerDetector(**kwargs), JStraggler(**kwargs)]
    seen = []
    for a, b in script:
        for d in dets:
            d.forget(b) if a == "forget" else d.record(a, b)
        if a != "forget" and a not in seen:
            seen.append(a)
        assert dets[0].stragglers() == dets[1].stragglers()
        assert [dets[0].ewma(w) for w in seen] == [dets[1].ewma(w) for w in seen]
        assert dets[0]._median() == dets[1]._median()


def test_straggler_detector_random_samples_match_reference():
    rng = np.random.default_rng(1)
    dets = [StragglerDetector(alpha=0.3, threshold=1.5, warmup_steps=3),
            JStraggler(alpha=0.3, threshold=1.5, warmup_steps=3)]
    workers = ["w0", "w1", "w2", "slow"]
    for step in range(40):
        for w in workers:
            x = float(rng.uniform(0.9, 1.1) * (3.0 if w == "slow" and step < 20 else 1.0))
            for d in dets:
                d.record(w, x)
        if step == 30:
            for d in dets:
                d.forget("w2")
        assert dets[0].stragglers() == dets[1].stragglers()
        assert [dets[0].ewma(w) for w in workers] == [dets[1].ewma(w) for w in workers]
    assert dets[0].stragglers() == []


# ---------------------------------------------------------------------------
# Supervisor: restarts, histories and resumption from checkpoints.
# ---------------------------------------------------------------------------


def _supervise(package, directory, fail_at, *, max_restarts=3, num_steps=8, save_every=2,
               hook=None):
    """One Supervisor run: ``x`` grows by its step index; ``step_fn``
    raises once at each step of ``fail_at``."""
    failed = set()

    def step_fn(state, step):
        if step in fail_at and step not in failed:
            failed.add(step)
            raise RuntimeError(f"scripted failure at {step}")
        return {"x": state["x"] + step}

    if package == "port":
        mgr, sup, x0 = CheckpointManager(directory, keep=2), Supervisor, torch.zeros(3)
    else:
        mgr, sup, x0 = JManager(directory, keep=2), JSupervisor, np.zeros(3, np.float32)
    state, history = sup(manager=mgr, max_restarts=max_restarts, save_every=save_every).run(
        {"x": x0}, step_fn, num_steps=num_steps, on_restart=hook)
    return np.asarray(state["x"]), history


@pytest.mark.parametrize("save_every", [1, 3])
@pytest.mark.parametrize("fail_at", [(), (3,), (0, 5), (1, 4, 7)], ids=str)
def test_supervisor_history_matches_reference(tmp_path, fail_at, save_every):
    x, hist = _supervise("port", str(tmp_path / "p"), set(fail_at), save_every=save_every)
    jx, jhist = _supervise("ref", str(tmp_path / "j"), set(fail_at), save_every=save_every)
    assert hist == jhist
    np.testing.assert_array_equal(x, jx)
    # a second run resumes from the newest checkpoint in both packages
    assert _supervise("port", str(tmp_path / "p"), set())[1] == \
        _supervise("ref", str(tmp_path / "j"), set())[1]


def test_supervisor_restart_budget_matches_reference(tmp_path):
    with pytest.raises(RuntimeError) as port:
        _supervise("port", str(tmp_path / "p"), {1, 2, 3}, max_restarts=2)
    with pytest.raises(RuntimeError) as ref:
        _supervise("ref", str(tmp_path / "j"), {1, 2, 3}, max_restarts=2)
    assert str(port.value) == str(ref.value)
    assert "exceeded 2 restarts" in str(port.value)


def test_supervisor_on_restart_hook_runs_per_restore(tmp_path):
    calls = {"port": [], "ref": []}

    def hook(name):
        def on_restart(state):
            calls[name].append(float(np.asarray(state["x"])[0]))
            return state
        return on_restart

    x, hist = _supervise("port", str(tmp_path / "p"), {5}, hook=hook("port"))
    jx, jhist = _supervise("ref", str(tmp_path / "j"), {5}, hook=hook("ref"))
    assert hist == jhist and calls["port"] == calls["ref"] and len(calls["port"]) == 1
    np.testing.assert_array_equal(x, jx)


# ---------------------------------------------------------------------------
# Elastic primitives.
# ---------------------------------------------------------------------------


def test_mesh_shape_matches_reference():
    for n in range(1, 65):
        for axes in (1, 2):
            assert mesh_shape(n, axes) == j_mesh_shape(n, axes), (n, axes)
    for bad, match in (((0, 1), "num_devices"), ((4, 3), "num_axes")):
        with pytest.raises(ValueError, match=match):
            mesh_shape(*bad)
        with pytest.raises(ValueError, match=match):
            j_mesh_shape(*bad)


@pytest.mark.parametrize("count", [1, 2, 3, 4, 5, 8])
def test_available_mesh_takes_a_device_list_as_given(count):
    mesh = available_mesh(("bank",), devices=["cpu"] * count)
    (n,) = mesh_shape(count, 1)
    assert mesh == BankMesh(("cpu",) * n)
    assert mesh.size == n and mesh.axis_names == ("bank",) and mesh.shape == {"bank": n}


def test_available_mesh_has_only_the_bank_axis_and_needs_cuda_unasked(monkeypatch):
    with pytest.raises(ValueError, match="axis"):
        available_mesh(("data", "model"), devices=["cpu"])
    with pytest.raises(RuntimeError, match="no devices"):
        available_mesh(devices=[])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        available_mesh()


def test_state_spec_tree_mirrors_leaves():
    state = {"ema": torch.zeros(4, 8), "count": np.zeros((), np.int32),
             "nested": [np.ones((3,), np.float64)], "pair": (torch.zeros(2, dtype=torch.uint8),)}
    specs = state_spec_tree(state)
    assert specs["ema"] == LeafSpec(shape=(4, 8), dtype=torch.float32, axes=(None, None))
    assert specs["count"] == LeafSpec(shape=(), dtype=torch.int32, axes=())
    assert specs["nested"][0].dtype == torch.float64  # dtypes kept, no canonicalization
    assert isinstance(specs["pair"], tuple) and specs["pair"][0].dtype == torch.uint8
    assert state_spec_tree({"b": torch.zeros(2, 5)}, axes={0: "bank"})["b"].axes == ("bank", None)


def test_elastic_reshard_round_trip_bit_exact():
    rng = np.random.default_rng(7)
    state = {"ema": rng.standard_normal((4, 8)).astype(np.float32), "step": np.int32(11),
             "sum": torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))}
    mesh = BankMesh(("cpu", "cpu"))
    moved = elastic_reshard(state, state_spec_tree(state), mesh)
    assert all(isinstance(x, torch.Tensor) and x.device == CPU for x in _leaves(moved))
    for k in state:
        got, want = moved[k].numpy(), np.asarray(state[k])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    again = elastic_reshard(moved, state_spec_tree(moved), mesh)  # idempotent
    assert all(torch.equal(again[k], moved[k]) for k in moved)
    # a single-slot state (a bare tensor) lands whole on the first device
    slot = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(elastic_reshard(slot, state_spec_tree(slot), BankMesh(("cpu",))), slot)


def test_elastic_reshard_splits_a_bank_axis_over_the_shards():
    mesh = BankMesh(("cpu", "cpu"))
    banked = {"sum": torch.arange(24.0).reshape(4, 6), "scale": torch.ones(6)}
    specs = {"sum": state_spec_tree(banked["sum"], axes={0: "bank"}),
             "scale": state_spec_tree(banked["scale"])}
    shards = elastic_reshard(banked, specs, mesh)
    assert isinstance(shards, list) and len(shards) == 2
    assert torch.equal(torch.cat([s["sum"] for s in shards]), banked["sum"])
    assert all(torch.equal(s["scale"], banked["scale"]) for s in shards)
    with pytest.raises(ValueError, match="split evenly"):
        elastic_reshard({"b": torch.zeros(3)}, {"b": LeafSpec((3,), torch.float32, ("bank",))},
                        mesh)
