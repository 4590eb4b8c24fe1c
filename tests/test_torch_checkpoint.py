"""Port parity of the checkpoint format (``repro_torch.checkpoint``) and the
per-session checkpointer (``repro_torch.serve.recovery``) against the
reference's (``repro.checkpoint``, ``repro.serve.recovery``), on the CPU:
the counterparts of ``tests/test_checkpoint.py`` (without its JAX-mesh
case) and ``tests/test_slot_checkpoint_properties.py``.

* Trees of tensors or numpy arrays (dict, list, tuple, bare leaf) round
  trip bit-exact with dtype, atomically, with keep-N rotation and an
  async writer; a checkpoint written by either package restores in the
  other bit-exact, and the two manifests are equal except ``time``.
* ``SessionCheckpointer`` round trips every filter's slot state at any
  bank count, slot and phase (a parametrized matrix, and a hypothesis
  sweep), each slot equal to the reference's after the same folds; a
  missing session, a ``stream_key`` mismatch and the cadence/keep
  validation behave as the reference's.
* Across packages: the reference's checkpointer saves a slot mid-stream,
  the port restores it and folds the remaining groups, and the result
  equals the reference's undisturbed run; and the other way round. A
  reference checkpoint also resumes a stalled session in a port
  ``FleetScheduler``.
* bfloat16 slots: the port writes a bfloat16 leaf as the reference does
  (2-byte void, descr ``'<V2'``, member bytes equal), restores either
  package's such checkpoint, and a bfloat16 fleet session recovers,
  resumes and migrates bit for bit; other dtypes keep ``np.savez``'s
  bytes.

Frames come from ``PrismSource`` with a seed, identical numpy arrays for
both packages (``backend="xla"`` in both, as the reference's own
checkpoint tests run). Tolerance: bitwise, except ``spatial_box``
(bilateral by default) outputs, held within
``denoise_spatial.BILATERAL_RTOL`` (ROADMAP queue C: the CPU's plain
bilateral is not bitwise reproducible from call to call). Checkpoints go
to ``tmp_path``; every wait is bounded.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import restore_tree as j_restore_tree
from repro.checkpoint import save_tree as j_save_tree
from repro.core.banks import banked_filter_init as j_banked_filter_init
from repro.core.denoise import DenoiseConfig as JConfig
from repro.core.denoise import StreamingDenoiser as JDenoiser
from repro.serve.recovery import CheckpointMismatch as JMismatch
from repro.serve.recovery import SessionCheckpointer as JCheckpointer
from repro_torch.checkpoint import CheckpointManager, read_manifest, restore_tree, save_tree
from repro_torch.core.banks import banked_filter_init
from repro_torch.core.denoise import DenoiseConfig
from repro_torch.core.streaming import run_pipelined
from repro_torch.data.prism import PrismSource
from repro_torch.kernels import denoise_spatial
from repro_torch.serve import FakeClock, FaultPlan, FleetScheduler, Session
from repro_torch.serve.recovery import CheckpointMismatch, SessionCheckpointer

FILTERS = ["ema_variance", "pair_average", "spatial_box", "temporal_median"]
WAIT = 30
SMALL = dict(num_groups=4, frames_per_group=8, height=8, width=32, backend="xla",
             median_window=3)
CPU = torch.device("cpu")


def _cfg(**kw):
    return DenoiseConfig(**{**SMALL, **kw})


def _jcfg(cfg):
    return JConfig(**dataclasses.asdict(cfg))


def _groups(cfg, seed=5):
    return list(PrismSource(cfg, seed=seed).groups())


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_tree(a, b):
    """Same structure (container kinds), dtypes and bits."""
    assert type(a) is type(b) or not isinstance(a, (dict, list, tuple)), (type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = _host(x), _host(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _close(cfg, got, want):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if cfg.filter_name == "spatial_box" and cfg.spatial_mode == "bilateral":
        np.testing.assert_allclose(got, want, rtol=denoise_spatial.BILATERAL_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def _trees(kind: str, leaf: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    arrays = [
        rng.standard_normal((3, 4)).astype(np.float32),
        rng.integers(0, 65535, (2, 5)).astype(np.uint16),
        np.asarray(7, np.int32),
        rng.standard_normal((6,)).astype(np.float64),
    ]
    if leaf == "tensor":
        arrays = [torch.from_numpy(a) for a in arrays]
    a, b, c, d = arrays
    return {
        "dict": {"w": a, "opt": {"mu": b, "step": c}, "seq": [d, (a, b)]},
        "list": [a, [b, c], {"z": d}],
        "tuple": (a, (b, c), [d]),
        "bare": a,
    }[kind]


# ---------------------------------------------------------------------------
# The tree format: round trips, atomic writes, rotation, async.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leaf", ["tensor", "numpy"])
@pytest.mark.parametrize("kind", ["dict", "list", "tuple", "bare"])
def test_save_restore_round_trip(tmp_path, kind, leaf):
    tree = _trees(kind, leaf)
    save_tree(str(tmp_path / "ck"), tree, step=42, extra={"frames": 3})
    host, step = restore_tree(str(tmp_path / "ck"))
    assert step == 42 and read_manifest(str(tmp_path / "ck"))["extra"] == {"frames": 3}
    assert all(isinstance(x, np.ndarray) for x in _leaves(host))  # a host format
    _same_tree(host, _trees(kind, "numpy"))
    on_cpu, _ = restore_tree(str(tmp_path / "ck"), device="cpu")
    assert all(isinstance(x, torch.Tensor) and x.device == CPU for x in _leaves(on_cpu))
    _same_tree(on_cpu, _trees(kind, "tensor"))


def test_atomic_no_partial_dirs(tmp_path):
    save_tree(str(tmp_path / "ck"), _trees("dict", "tensor"), step=1)
    save_tree(str(tmp_path / "ck"), _trees("dict", "tensor", seed=1), step=2)  # replaces
    assert [p for p in os.listdir(tmp_path) if p.startswith(".tmp")] == []
    tree, step = restore_tree(str(tmp_path / "ck"))
    assert step == 2
    _same_tree(tree, _trees("dict", "numpy", seed=1))


def test_manager_keep_policy(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _trees("dict", "tensor", seed=s), blocking=True)
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4
    tree, step = mgr.restore()
    assert step == 4
    _same_tree(tree, _trees("dict", "numpy", seed=4))


def test_manager_async_overlap_snapshots_before_in_place_writes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = _trees("dict", "tensor")
    mgr.save(1, state)      # async
    state["w"].zero_()      # overwrite in place AFTER save snapshotted it
    mgr.wait()
    restored, step = mgr.restore(1, device="cpu")
    assert step == 1
    _same_tree(restored, _trees("dict", "tensor"))
    assert restored["w"].abs().max() > 0


def test_manager_wait_reraises_the_writers_error(tmp_path, monkeypatch):
    from repro_torch.checkpoint import checkpoint as module

    def disk_full(*args, **kwargs):
        raise OSError("no space left on device")

    monkeypatch.setattr(module, "save_tree", disk_full)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="async checkpoint write failed: no space"):
        mgr.wait()
    mgr.wait()  # the error is raised once
    with pytest.raises(RuntimeError, match="no space"):
        mgr.save(2, {"x": torch.ones(2)}, blocking=True)


def test_restore_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.restore() == (None, None)
    assert mgr.latest_step() is None and mgr.manifest() is None


# ---------------------------------------------------------------------------
# Cross-package: either package restores the other's checkpoints.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dict", "list", "tuple", "bare"])
def test_checkpoints_cross_packages_both_ways(tmp_path, kind):
    tree = _trees(kind, "numpy", seed=3)  # numpy leaves: the reference keeps float64
    j_save_tree(str(tmp_path / "ref"), tree, step=9, extra={"k": "v"})
    save_tree(str(tmp_path / "port"), _trees(kind, "tensor", seed=3), step=9, extra={"k": "v"})
    got, step = restore_tree(str(tmp_path / "ref"), device="cpu")
    assert step == 9
    _same_tree(got, _trees(kind, "tensor", seed=3))
    j_got, j_step = j_restore_tree(str(tmp_path / "port"))
    assert j_step == 9
    _same_tree(j_got, tree)
    manifests = []
    for name in ("ref", "port"):
        with open(tmp_path / name / "manifest.json") as f:
            m = json.load(f)
        m.pop("time")
        manifests.append(m)
    assert manifests[0] == manifests[1]
    with np.load(tmp_path / "port" / "leaves.npz") as data:
        assert sorted(data.files) == sorted(f"leaf_{i}" for i in range(len(_leaves(tree))))


def test_reference_manager_reads_port_manager_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(4):
        mgr.save(s, {"x": torch.full((3,), float(s))}, blocking=True, extra={"s": s})
    jmgr = JManager(str(tmp_path), keep=2)
    assert jmgr.steps() == [2, 3]
    tree, step = jmgr.restore()
    assert step == 3 and jmgr.manifest()["extra"] == {"s": 3}
    np.testing.assert_array_equal(np.asarray(tree["x"]), np.full((3,), 3.0, np.float32))


# ---------------------------------------------------------------------------
# SessionCheckpointer: every filter's slot state.
# ---------------------------------------------------------------------------


def _slot_after(cfg, groups, banks, slot, phase):
    """Fold ``phase`` groups into one slot of a ``banks``-wide port state."""
    filt, state = banked_filter_init(cfg, None, banks=banks, device="cpu")
    for k in range(phase):
        sub = filt.step(filt.slot_extract(state, slot), torch.from_numpy(groups[k]),
                        step_index=k)
        state = filt.slot_insert(state, sub, slot)
    return filt, state


def _j_slot_after(cfg, groups, phase):
    """The reference's single-bank slot after ``phase`` folds."""
    jfilt, jstate = j_banked_filter_init(_jcfg(cfg), None, banks=1)
    for k in range(phase):
        sub = jfilt.step(jfilt.slot_extract(jstate, 0), jnp.asarray(groups[k]), step_index=k)
        jstate = jfilt.slot_insert(jstate, sub, 0)
    return jfilt, jfilt.slot_extract(jstate, 0)


def _round_trip(directory, name, banks, slot, phase, seed):
    """Fold ``phase`` groups into one slot of a ``banks``-wide state,
    checkpoint that slot, restore it, and check the round trip exactly."""
    cfg = _cfg(filter_name=name)
    groups = _groups(cfg, seed=seed)
    filt, state = _slot_after(cfg, groups, banks, slot, phase)
    sub = filt.slot_extract(state, slot)
    ck = SessionCheckpointer(str(directory), every=1, keep=2)
    frames = phase * cfg.frames_per_group
    ck.save("s", filt, sub, steps=phase, frames=frames)
    restored, steps, got_frames = ck.restore_latest("s", filt, device="cpu")
    assert (steps, got_frames) == (phase, frames)
    _same_tree(restored, sub)
    # the slot equals the reference's after the same folds
    _same_tree(filt.slot_to_host(sub), _j_slot_after(cfg, groups, phase)[1])
    # inserting it back leaves the banked state as it was, and seated in
    # a fresh state at another slot it extracts identically (what crash
    # recovery does on the replacement executor)
    before = filt.slot_to_host(state)
    _same_tree(filt.slot_to_host(filt.slot_insert(state, restored, slot)), before)
    filt2, fresh = banked_filter_init(cfg, None, banks=banks, device="cpu")
    other = (slot + 1) % banks
    _same_tree(filt2.slot_extract(filt2.slot_insert(fresh, restored, other), other), sub)


@pytest.mark.parametrize("name", FILTERS)
@pytest.mark.parametrize("banks,slot,phase", [(1, 0, 0), (2, 1, 1), (3, 1, 2), (4, 3, 3)])
def test_slot_checkpoint_round_trip(tmp_path, name, banks, slot, phase):
    _round_trip(tmp_path, name, banks, slot, phase, seed=5)


@settings(max_examples=12, deadline=None)
@given(
    name=st.sampled_from(FILTERS),
    banks=st.integers(1, 4),
    slot_frac=st.floats(0.0, 1.0),
    phase=st.integers(0, 3),
    seed=st.integers(0, 2**31 - 1),
)
def test_slot_checkpoint_round_trip_property(tmp_path_factory, name, banks, slot_frac,
                                            phase, seed):
    slot = min(banks - 1, int(slot_frac * banks))
    _round_trip(tmp_path_factory.mktemp("slot_ckpt"), name, banks, slot, phase, seed)


def test_restore_missing_session_is_empty(tmp_path):
    filt, _ = banked_filter_init(_cfg(), None, banks=1, device="cpu")
    ck = SessionCheckpointer(str(tmp_path))
    assert ck.restore_latest("nope", filt) == (None, 0, 0)
    assert ck.latest_step("nope") is None and ck.sessions() == []


def test_restore_rejects_stream_key_mismatch(tmp_path):
    filt, state = banked_filter_init(_cfg(), None, banks=1, device="cpu")
    ck = SessionCheckpointer(str(tmp_path))
    ck.save("s", filt, filt.slot_extract(state, 0), steps=0, frames=0)
    other, _ = banked_filter_init(_cfg(width=64), None, banks=1, device="cpu")
    with pytest.raises(CheckpointMismatch):
        ck.restore_latest("s", other)
    assert ck.sessions() == ["s"]
    # the fingerprint is the reference's: its checkpointer rejects the
    # port's checkpoint for the other config, and takes it for this one
    jfilt, _ = j_banked_filter_init(_jcfg(_cfg(width=64)), None, banks=1)
    with pytest.raises(JMismatch):
        JCheckpointer(str(tmp_path)).restore_latest("s", jfilt)
    jfilt, _ = j_banked_filter_init(_jcfg(_cfg()), None, banks=1)
    assert JCheckpointer(str(tmp_path)).restore_latest("s", jfilt)[1:] == (0, 0)


def test_checkpointer_validates_cadence_and_keep(tmp_path):
    with pytest.raises(ValueError, match="every"):
        SessionCheckpointer(str(tmp_path), every=0)
    with pytest.raises(ValueError, match="keep"):
        SessionCheckpointer(str(tmp_path), keep=0)
    ck = SessionCheckpointer(str(tmp_path), every=3, keep=1)
    filt, state = banked_filter_init(_cfg(), None, banks=1, device="cpu")
    sub = filt.slot_extract(state, 0)
    assert not ck.maybe_save("s", filt, sub, steps=2, frames=16)
    assert ck.maybe_save("s", filt, sub, steps=3, frames=24)
    assert ck.maybe_save("s", filt, sub, steps=6, frames=48)
    assert ck.latest_step("s") == 6 and ck._manager("s").steps() == [6]


# ---------------------------------------------------------------------------
# Cross-package session round trips.
# ---------------------------------------------------------------------------


def _j_run(cfg, groups):
    """The reference's undisturbed run: its serial filter calls."""
    jden = JDenoiser(_jcfg(cfg))
    state = jden.init()
    for i, g in enumerate(groups):
        state = jden.ingest(state, jnp.asarray(g), step=i)
    return np.asarray(jden.finalize(state))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", FILTERS)
def test_reference_checkpoint_continues_in_the_port(tmp_path, name, k):
    cfg = _cfg(filter_name=name, num_groups=5)
    groups = _groups(cfg, seed=8)
    jfilt, jslot = _j_slot_after(cfg, groups, k)
    JCheckpointer(str(tmp_path)).save("x", jfilt, jslot, steps=k,
                                      frames=k * cfg.frames_per_group)
    filt, _ = banked_filter_init(cfg, None, banks=1, device="cpu")
    state, steps, frames = SessionCheckpointer(str(tmp_path)).restore_latest("x", filt)
    assert (steps, frames) == (k, k * cfg.frames_per_group)
    for i in range(steps, cfg.num_groups):
        state = filt.step(state, torch.from_numpy(groups[i]), step_index=i)
    out = filt.finalize(state)
    _close(cfg, out, _j_run(cfg, groups))
    _close(cfg, out, run_pipelined(cfg, iter(groups), device="cpu")[0])


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", FILTERS)
def test_port_checkpoint_continues_in_the_reference(tmp_path, name, k):
    cfg = _cfg(filter_name=name, num_groups=5)
    groups = _groups(cfg, seed=9)
    filt, state = _slot_after(cfg, groups, 2, 1, k)
    SessionCheckpointer(str(tmp_path)).save("x", filt, filt.slot_extract(state, 1), steps=k,
                                            frames=k * cfg.frames_per_group)
    jfilt, _ = j_banked_filter_init(_jcfg(cfg), None, banks=1)
    jstate, steps, frames = JCheckpointer(str(tmp_path)).restore_latest("x", jfilt)
    assert (steps, frames) == (k, k * cfg.frames_per_group)
    for i in range(steps, cfg.num_groups):
        jstate = jfilt.step(jstate, jnp.asarray(groups[i]), step_index=i)
    out = np.asarray(jfilt.finalize(jstate))
    _close(cfg, out, _j_run(cfg, groups))
    _close(cfg, out, run_pipelined(cfg, iter(groups), device="cpu")[0])


@pytest.mark.parametrize("name", FILTERS)
def test_reference_slot_checkpoint_resumes_in_the_port_fleet(tmp_path, name):
    """The reference folds k groups and checkpoints the slot; a port fleet
    session stalled at group k is evicted, restores that checkpoint (the
    port's own at k was overwritten by the reference's) and finishes."""
    k = 2
    cfg = _cfg(filter_name=name, num_groups=5)
    groups = _groups(cfg, seed=8)
    jfilt, jslot = _j_slot_after(cfg, groups, k)
    plan, clock = FaultPlan().stall("ex0", at_step=k), FakeClock()
    fleet = FleetScheduler(checkpoint_dir=str(tmp_path), faults=plan, clock=clock,
                           slots_per_executor=1, max_executors=2, device="cpu")
    try:
        h = fleet.submit(Session(config=cfg, source=iter(groups), name="x"))
        assert plan.wait_stalled("ex0", timeout=WAIT)
        JCheckpointer(str(tmp_path)).save("x", jfilt, jslot, steps=k,
                                          frames=k * cfg.frames_per_group)
        clock.advance(61.0)
        res = fleet.check_faults(probe=False)
        assert res["recovered"] == ["x"]
        out, rep = h.result(timeout=WAIT)
    finally:
        plan.poison("ex0")
        fleet.shutdown(wait=False)
    _close(cfg, out, _j_run(cfg, groups))
    _close(cfg, out, run_pipelined(cfg, iter(groups), device="cpu")[0])
    assert rep.restarts == 1 and rep.groups == cfg.num_groups
    assert "recover@x->ex1:steps=2+0" in fleet.events


# ---------------------------------------------------------------------------
# bfloat16 slots: the host format is the reference's (2-byte void leaves).
# ---------------------------------------------------------------------------


def _bits(x) -> np.ndarray:
    """The 16-bit patterns of a bfloat16 tensor, a ``V2`` host leaf or a
    reference bfloat16 array."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16, x.dtype
        return x.view(torch.int16).numpy()
    x = np.asarray(x)
    assert x.dtype.itemsize == 2 and x.dtype.kind == "V" or x.dtype.name == "bfloat16", x.dtype
    return x.view(np.int16)


def _same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def _bf16_cfg(name, **kw):
    return _cfg(filter_name=name, accum_dtype="bfloat16", **kw)


def _members(path) -> dict:
    import zipfile

    with zipfile.ZipFile(os.path.join(path, "leaves.npz")) as z:
        return {n: z.read(n) for n in z.namelist()}


def _latest_dir(directory, session):
    mgr = CheckpointManager(os.path.join(directory, session))
    return os.path.join(directory, session, f"step_{mgr.latest_step():010d}")


@pytest.mark.parametrize("name", FILTERS)
def test_bfloat16_slot_checkpoint_has_the_reference_bytes(tmp_path, name):
    """The port's ``leaves.npz`` of a bfloat16 slot holds, member for member,
    the bytes the reference's writes for the same slot after the same folds
    (descr ``'<V2'``); either restores as ``V2`` on the host and as
    bfloat16 on a device, bit for bit."""
    cfg = _bf16_cfg(name)
    groups = _groups(cfg, seed=12)
    filt, state = _slot_after(cfg, groups, 2, 1, 2)
    sub = filt.slot_extract(state, 1)
    jfilt, jslot = _j_slot_after(cfg, groups, 2)
    _same_bits(sub, jslot)
    SessionCheckpointer(str(tmp_path / "port")).save("x", filt, sub, steps=2, frames=16)
    JCheckpointer(str(tmp_path / "ref")).save("x", jfilt, jslot, steps=2, frames=16)
    port, ref = _latest_dir(tmp_path / "port", "x"), _latest_dir(tmp_path / "ref", "x")
    got, want = _members(port), _members(ref)
    assert sorted(got) == sorted(want) and got == want
    assert all(b"'descr': '<V2'" in m for m in got.values())
    manifest, j_manifest = read_manifest(port), read_manifest(ref)
    for m in (manifest, j_manifest):
        m.pop("time")
    assert manifest == j_manifest
    for path in (port, ref):
        host, step = restore_tree(path)
        assert step == 2 and all(a.dtype == np.dtype("V2") for a in _leaves(host))
        _same_bits(host, sub)
        dev, _ = restore_tree(path, device="cpu")
        assert all(t.dtype == torch.bfloat16 for t in _leaves(dev))
        _same_bits(dev, sub)


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.int32, np.uint16])
def test_other_leaves_are_written_as_numpy_savez_writes_them(tmp_path, dtype):
    """float16, float32 and integer leaves keep the bytes ``np.savez`` gave
    them before bfloat16 leaves had a writer of their own."""
    rng = np.random.default_rng(3)
    tree = {"a": (1000 * rng.standard_normal((3, 5))).astype(dtype),
            "b": [torch.from_numpy((50 * rng.standard_normal(7)).astype(dtype)),
                  np.asarray(3, dtype)]}
    save_tree(str(tmp_path / "ck"), tree, step=1)
    host = [_host(x) for x in _leaves(tree)]
    np.savez(tmp_path / "want.npz", **{f"leaf_{i}": a for i, a in enumerate(host)})
    import zipfile

    with zipfile.ZipFile(tmp_path / "want.npz") as z:
        want = {n: z.read(n) for n in z.namelist()}
    assert _members(tmp_path / "ck") == want


@pytest.mark.parametrize("name", FILTERS)
def test_reference_bfloat16_slot_checkpoint_resumes_in_the_port(tmp_path, name):
    k = 2
    cfg = _bf16_cfg(name, num_groups=5)
    groups = _groups(cfg, seed=8)
    jfilt, jslot = _j_slot_after(cfg, groups, k)
    JCheckpointer(str(tmp_path)).save("x", jfilt, jslot, steps=k, frames=k * cfg.frames_per_group)
    filt, _ = banked_filter_init(cfg, None, banks=1, device="cpu")
    state, steps, frames = SessionCheckpointer(str(tmp_path)).restore_latest("x", filt)
    assert (steps, frames) == (k, k * cfg.frames_per_group)
    assert all(t.dtype == torch.bfloat16 for t in _leaves(state))
    for i in range(steps, cfg.num_groups):
        state = filt.step(state, torch.from_numpy(groups[i]), step_index=i)
    out = filt.finalize(state)
    _same_bits(out, run_pipelined(cfg, iter(groups), device="cpu")[0])
    _same_bits(out, _j_run(cfg, groups))


@pytest.mark.parametrize("name", FILTERS)
def test_reference_bfloat16_slot_checkpoint_resumes_in_the_port_fleet(tmp_path, name):
    """As ``test_reference_slot_checkpoint_resumes_in_the_port_fleet``, in
    bfloat16."""
    k = 2
    cfg = _bf16_cfg(name, num_groups=5)
    groups = _groups(cfg, seed=8)
    jfilt, jslot = _j_slot_after(cfg, groups, k)
    plan, clock = FaultPlan().stall("ex0", at_step=k), FakeClock()
    fleet = FleetScheduler(checkpoint_dir=str(tmp_path), faults=plan, clock=clock,
                           slots_per_executor=1, max_executors=2, device="cpu")
    try:
        h = fleet.submit(Session(config=cfg, source=iter(groups), name="x"))
        assert plan.wait_stalled("ex0", timeout=WAIT)
        JCheckpointer(str(tmp_path)).save("x", jfilt, jslot, steps=k,
                                          frames=k * cfg.frames_per_group)
        clock.advance(61.0)
        assert fleet.check_faults(probe=False)["recovered"] == ["x"]
        out, rep = h.result(timeout=WAIT)
    finally:
        plan.poison("ex0")
        fleet.shutdown(wait=False)
    assert out.dtype == torch.bfloat16
    _same_bits(out, run_pipelined(cfg, iter(groups), device="cpu")[0])
    _same_bits(out, _j_run(cfg, groups))
    assert rep.restarts == 1 and rep.groups == cfg.num_groups
    assert "recover@x->ex1:steps=2+0" in fleet.events


@pytest.mark.parametrize("name", FILTERS)
@pytest.mark.parametrize("every", [1, 3])
def test_bfloat16_fleet_session_recovers_from_its_checkpoint(tmp_path, name, every):
    """A bfloat16 session's executor crashes before its 5th group; the
    session restores its own checkpoint (``every=3``: that of fold 3 and a
    replay) on another executor and finishes bit for bit."""
    cfg = _bf16_cfg(name, num_groups=6)
    groups = _groups(cfg, seed=4)
    plan = FaultPlan().crash("ex0", at_step=4)
    with FleetScheduler(checkpoint_dir=str(tmp_path), checkpoint_every=every, faults=plan,
                        slots_per_executor=1, max_executors=2, device="cpu") as fleet:
        out, rep = fleet.submit(Session(config=cfg, source=iter(groups), name="b")).result(
            timeout=WAIT)
    assert plan.crashed("ex0") and rep.restarts == 1 and rep.groups == cfg.num_groups
    assert f"recover@b->ex1:{'steps=4+0' if every == 1 else 'steps=3+1'}" in fleet.events
    host, _ = restore_tree(_latest_dir(tmp_path, "b"))
    assert all(a.dtype == np.dtype("V2") for a in _leaves(host))
    _same_bits(out, run_pipelined(cfg, iter(groups), device="cpu")[0])


@pytest.mark.parametrize("name", FILTERS)
def test_bfloat16_fleet_session_migrates_bit_for_bit(tmp_path, name):
    import threading

    cfg = _bf16_cfg(name, num_groups=5)
    groups = _groups(cfg, seed=6)
    gate, fed = threading.Event(), threading.Event()

    def src():
        yield from groups[:2]
        fed.set()
        assert gate.wait(WAIT)
        yield from groups[2:]

    with FleetScheduler(checkpoint_dir=str(tmp_path), slots_per_executor=2, max_executors=2,
                        device="cpu") as fleet:
        h = fleet.submit(Session(config=cfg, source=src(), name="m"))
        assert fed.wait(WAIT)
        assert fleet.migrate(h, timeout=WAIT) == "ex1"
        gate.set()
        out, rep = h.result(timeout=WAIT)
    assert rep.migrations == 1 and fleet.events == ["migrate@m:ex0->ex1"]
    _same_bits(out, run_pipelined(cfg, iter(groups), device="cpu")[0])


def test_elastic_reshard_places_bfloat16_host_leaves(tmp_path):
    """A restored bfloat16 leaf (``V2`` on the host) goes through
    ``state_spec_tree`` and ``elastic_reshard`` as bfloat16, bit for bit,
    whole or split along its bank axis."""
    from repro_torch.core.banks import BankMesh
    from repro_torch.runtime.elastic import elastic_reshard, state_spec_tree

    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 3, 8)).astype(np.float32))
    tree = {"s": x.to(torch.bfloat16), "n": torch.arange(4, dtype=torch.int32)}
    save_tree(str(tmp_path / "ck"), tree, step=0)
    host, _ = restore_tree(str(tmp_path / "ck"))
    spec = state_spec_tree(host)
    assert spec["s"].dtype == torch.bfloat16 and spec["s"].shape == (4, 3, 8)
    whole = elastic_reshard(host, spec, BankMesh(("cpu",)))
    _same_bits(whole["s"], tree["s"])
    assert torch.equal(whole["n"], tree["n"])
    halves = elastic_reshard(host, state_spec_tree(host, axes={0: "bank"}), BankMesh(("cpu", "cpu")))
    for i, shard in enumerate(halves):
        _same_bits(shard["s"], tree["s"][2 * i:2 * i + 2])
