"""Port parity of the tuning layer (``repro_torch.tune``) against the
reference's (``repro.tune``): the counterparts of ``tests/test_tune.py``.

The port's launch model is Hopper's, not the reference's VMEM model, so
the two pick different candidate geometries; everything that does not
depend on that is held equal: the heuristic (the kernels' default layouts,
the pinned EMA pick), the validation errors, the plan-cache format and its
malformed/stale/missing contract, the resolve-once memo, the ring depth a
plan carries, and the selection rule (the same injected timings pick the
same candidate, by the same 5 % margin). A plan file in the shared format
replays to the same tiles in both packages whichever package wrote it. The
port runs on ``device="cpu"``, where the kernels' plain versions take a
plan's tiles as the CUDA launchers do (and check them the same way); every
output is bitwise equal to the heuristic output and to the reference's,
including a plan file that sets another EMA ``pair_tile`` (the reference's
``pallas`` path in interpret mode for that plan).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tune as jtune
from repro.core.denoise import DenoiseConfig as JConfig
from repro.core.streaming import run_inline as j_run_inline
from repro.kernels.denoise_stream import _pick_pair_tile, _pick_row_tile
from repro.tune import budget as jbudget
from repro.tune.cache import PlanCache as JPlanCache
from repro.tune.plan import exec_key as j_exec_key
from repro.tune.plan import family_key as j_family_key
from repro_torch import tune
from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser
from repro_torch.core.streaming import run_inline, run_pipelined
from repro_torch.kernels import denoise_stream, ops
from repro_torch.tune import autotune, budget
from repro_torch.tune.cache import PlanCache
from repro_torch.tune.plan import SCHEMA_VERSION, exec_key, family_key

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Every test gets its own persistent cache and clean plan memos."""
    monkeypatch.setenv("REPRO_TUNE_CACHE_PATH", str(tmp_path / "plans.json"))
    tune.clear_plan_memo()
    jtune.clear_plan_memo()
    yield
    tune.clear_plan_memo()
    jtune.clear_plan_memo()


def _cfg(**kw):
    return DenoiseConfig(**{**dict(num_groups=4, frames_per_group=20, height=16, width=64,
                                   backend="xla"), **kw})


def _j(cfg):
    return JConfig(**dataclasses.asdict(cfg))


def _groups(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4096, (cfg.frames_per_group, cfg.height, cfg.width))
            .astype(np.uint16) for _ in range(cfg.num_groups)]


def _j_out(cfg, groups):
    return np.asarray(j_run_inline(_j(cfg), iter(groups), prefetch=False)[0])


def _out(cfg, groups):
    return run_inline(cfg, iter(groups), prefetch=False, device="cpu")[0].numpy()


def _fkey(cfg, family="stream", *, backend, ref=False, window=1):
    kw = dict(in_dtype="uint16", acc_dtype="float32", backend=backend, window=window)
    if ref:
        return j_family_key(family, cfg.pairs_per_group, cfg.height, cfg.width, **kw)
    return family_key(family, cfg.pairs_per_group, cfg.height, cfg.width, device=CPU, **kw)


def _ekey(cfg, *, backend, ref=False):
    args = (cfg.filter_name, cfg.num_groups, cfg.frames_per_group, cfg.height, cfg.width)
    return j_exec_key(*args, backend=backend) if ref else exec_key(*args, backend=backend,
                                                                    device=CPU)


def _write(path, entries):
    path.write_text(json.dumps({"version": SCHEMA_VERSION, "entries": entries}))


# ---------------------------------------------------------------------------
# The launch model: divisors, the pinned EMA pick, errors.
# ---------------------------------------------------------------------------


AWKWARD = [(97, 66, 256), (101, 97, 256), (500, 80, 256), (33, 66, 640), (7, 13, 2048),
           (1, 1, 128)]


@pytest.mark.parametrize("family", budget.KERNEL_FAMILIES)
@pytest.mark.parametrize("p,h,w", AWKWARD)
def test_resolve_tiles_and_candidates_divide_and_are_admitted(family, p, h, w):
    th, tp = budget.resolve_tiles(family, p, h, w)
    if family == "ema":  # the reference's pinned pick, whose pair_tile sets the bits
        assert (th, tp) == jbudget.resolve_tiles("ema", p, h, w)
    else:  # every other family keeps its kernel's default layout
        assert (th, tp) == (None, None)
    cands = budget.model_candidates(family, p, h, w)
    assert cands[0] == (th, tp) and len(cands) <= 6
    shapes = set()
    for geom in cands:
        assert budget.reject_reason(family, p, h, w, *geom) is None
        if geom != (None, None):
            assert h % geom[0] == 0 and p % geom[1] == 0
        shapes.add(budget.launch_shape(family, p, h, w, *geom))
    assert len(shapes) == len(cands)  # no two candidates make one launch


def test_resolve_tiles_rejects_non_dividing_overrides():
    for args in [dict(row_tile=7), dict(pair_tile=3)]:
        with pytest.raises(ValueError) as want:
            jbudget.resolve_tiles("stream", 10, 8, 32, **args)
        with pytest.raises(ValueError) as got:
            budget.resolve_tiles("stream", 10, 8, 32, **args)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="kernel family"):
        budget.resolve_tiles("nope", 10, 8, 32)


def test_kernel_rejects_non_dividing_override_end_to_end():
    frames = torch.ones((2, 6, 8, 32), dtype=torch.uint16)
    with pytest.raises(ValueError, match="row_tile 5 must divide H=8"):
        denoise_stream.alg3_subtract_average(frames, row_tile=5)
    with pytest.raises(ValueError, match="pair_tile 2 must divide N/2=3"):
        ops.stream_step(torch.zeros(3, 8, 32), frames[0], num_groups=2, pair_tile=2)


def test_property_candidates_exact_divisors_within_limits():
    pytest.importorskip("hypothesis", reason="dev-only dependency (see requirements-dev.txt)")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=60, deadline=None, derandomize=True)
    @given(
        family=st.sampled_from(budget.KERNEL_FAMILIES),
        p=st.integers(1, 2048),
        h=st.integers(1, 512),
        w=st.sampled_from([24, 128, 256, 640, 2048]),
        fmt=st.sampled_from(["u16", "u8", "p12"]),
    )
    def check(family, p, h, w, fmt):
        limits = budget.DeviceLimits()
        for th, tp in budget.model_candidates(family, p, h, w, stream_dtype=fmt, limits=limits):
            assert th is None or (1 <= th <= h and h % th == 0)
            assert tp is None or (1 <= tp <= p and p % tp == 0)
            spec = budget.family_launch(family, w, stream_dtype=fmt)
            assert spec.threads <= limits.threads_per_block
            assert spec.smem <= limits.smem_per_block_optin
            assert budget.blocks_per_sm(spec, limits) >= spec.min_blocks
            assert budget.launch_blocks(family, p, h, w, th, tp, stream_dtype=fmt) <= 2**31 - 1

    check()


def test_ema_heuristic_pinned_to_legacy_pick():
    for p, h, w in [(96, 80, 256), (56, 80, 256), (500, 80, 256), (10, 16, 64), (3, 8, 32)]:
        th = _pick_row_tile(h, w)
        tp = _pick_pair_tile(p, th, w)
        assert budget.resolve_tiles("ema", p, h, w) == (th, tp)
        assert tune.tile_args(_cfg(frames_per_group=2 * p, height=h, width=w,
                                   filter_name="ema_variance"), "ema") == {
            "row_tile": th, "pair_tile": tp, "placement": None}
    # and the kernel's output is bitwise what the pinned tiles give, and the
    # reference's, at the reference's own shape (a pair_tile of 8)
    rng = np.random.default_rng(13)
    n, h, w = 192, 80, 256
    chunk = rng.integers(0, 4096, (n, h, w)).astype(np.uint16)
    th = _pick_row_tile(h, w)
    tp = _pick_pair_tile(n // 2, th, w)

    def step(row_tile, pair_tile):
        state = [torch.zeros(n // 2, h, w), torch.zeros(h, w), torch.zeros(h, w)]
        return ops.ema_welford_step(*state, torch.from_numpy(chunk), alpha=0.25,
                                    offset=4096.0, backend="pallas", row_tile=row_tile,
                                    pair_tile=pair_tile)

    from repro.kernels import ops as jops

    want = jops.ema_welford_step(
        jnp.zeros((n // 2, h, w)), jnp.zeros((h, w)), jnp.zeros((h, w)), jnp.asarray(chunk),
        alpha=0.25, offset=4096.0, backend="pallas", row_tile=th, pair_tile=tp)
    for a, b, c in zip(step(None, None), step(th, tp), want):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_heuristic_output_bit_identical_to_explicit_tiles():
    rng = np.random.default_rng(11)
    frames = torch.from_numpy(rng.integers(0, 4096, (3, 20, 16, 64)).astype(np.uint16))
    default = denoise_stream.alg3_subtract_average(frames, offset=4096.0)
    for th, tp in [(8, 5), (16, 10), (1, 1), (2, 2)]:
        tiled = denoise_stream.alg3_subtract_average(frames, offset=4096.0, row_tile=th,
                                                     pair_tile=tp)
        assert torch.equal(default, tiled), (th, tp)


# ---------------------------------------------------------------------------
# Plan resolution: modes, precedence, executors.
# ---------------------------------------------------------------------------


def test_heuristic_plan_is_default_and_empty():
    cfg = _cfg()
    assert cfg.tile_plan == "heuristic"
    plan = tune.resolve_plan(cfg)  # the heuristic needs no device
    assert plan is tune.HEURISTIC_PLAN
    assert plan.tile_args("stream") == {"row_tile": None, "pair_tile": None, "placement": None}
    assert plan.num_slots is None
    assert dataclasses.asdict(plan) == dataclasses.asdict(jtune.HEURISTIC_PLAN)


@pytest.mark.parametrize("bad", ["", 123])
def test_config_rejects_bad_tile_plan(bad):
    with pytest.raises(ValueError, match="tile_plan") as got:
        _cfg(tile_plan=bad)
    with pytest.raises(ValueError) as want:
        JConfig(**{**dataclasses.asdict(_cfg()), "tile_plan": bad})
    assert str(got.value) == str(want.value)


def test_explicit_tile_overrides_beat_plan():
    den = StreamingDenoiser(_cfg(row_tile=8, pair_tile=2, tile_plan="auto"), device="cpu")
    assert den.filter.tile_args("stream") == {"row_tile": 8, "pair_tile": 2, "placement": None}


def test_auto_mode_tunes_caches_and_replays(tmp_path):
    cfg = _cfg(tile_plan="auto")
    plan = tune.resolve_plan(cfg, "cpu")
    assert plan.mode == "auto" and plan.source == "tuned"
    assert plan.num_slots in (1, 2, 3) and plan.frames_per_chunk is not None
    cache_file = tmp_path / "plans.json"
    doc = json.loads(cache_file.read_text())
    assert list(doc["entries"]) == [_ekey(cfg, backend="xla")]
    assert tune.resolve_plan(cfg, "cpu") is plan  # the in-process memo
    tune.clear_plan_memo()
    replayed = tune.resolve_plan(cfg, "cpu")  # a fresh process replays the cache
    assert replayed.source == "cache" and replayed.num_slots == plan.num_slots


def test_auto_mode_searches_tiles_where_the_kernels_run(tmp_path):
    cfg = _cfg(tile_plan="auto", backend="pallas", filter_name="temporal_median",
               median_window=3)
    plan = tune.resolve_plan(cfg, "cpu")
    assert [fam for fam, _ in plan.tiles] == ["median_insert", "median_combine"]
    entries = json.loads((tmp_path / "plans.json").read_text())["entries"]
    for fam, window in autotune.filter_families(cfg):
        entry = entries[_fkey(cfg, fam, backend="pallas", window=window)]
        assert entry["placement"] == "compiler" and entry["candidates"]
        args = plan.tile_args(fam)
        assert (entry["row_tile"], entry["pair_tile"]) == (args["row_tile"], args["pair_tile"])
    assert {g.placement for _, g in plan.tiles} == {"compiler"}


def test_cache_hit_performs_no_measurement(monkeypatch):
    cfg = _cfg(tile_plan="auto", backend="pallas")
    tune.resolve_plan(cfg, "cpu")  # populate the persistent cache
    tune.clear_plan_memo()
    calls = []
    monkeypatch.setattr(autotune, "family_timer",
                        lambda *a, **k: calls.append("tiles") or (lambda *t, **kw: 0.0))
    monkeypatch.setattr(autotune, "tune_exec_knobs", lambda *a, **k: calls.append("exec") or {})
    plan = tune.resolve_plan(cfg, "cpu")
    assert plan.source == "cache"
    assert calls == []


def test_plan_resolution_happens_once_per_config(monkeypatch):
    count = [0]
    real = autotune.tune_plan

    def counting(config, device, cache=None):
        count[0] += 1
        return real(config, device, cache)

    monkeypatch.setattr(autotune, "tune_plan", counting)
    cfg = _cfg(tile_plan="auto")
    StreamingDenoiser(cfg, device="cpu")
    StreamingDenoiser(cfg, device="cpu")  # same config: the memo, no re-tune
    StreamingDenoiser(_cfg(tile_plan="auto"), device="cpu")  # equal config: still the memo
    assert count[0] == 1
    den = StreamingDenoiser(cfg, device="cpu")  # a stream never resolves again
    state = den.init()
    for k, g in enumerate(_groups(cfg)):
        state = den.ingest(state, g, step=k)
    den.finalize(state)
    assert count[0] == 1


def test_same_injected_timings_pick_the_same_plan(monkeypatch, tmp_path):
    """The selection rule is the reference's: with the same timing per
    candidate rank, both packages keep their heuristic below the 5 %
    margin, take the same rank above it, and build the same plan fields."""
    from repro.tune import autotune as jautotune

    knobs = {"num_slots": 3, "frames_per_chunk": 10}
    for mod in (autotune, jautotune):
        monkeypatch.setattr(mod, "tune_exec_knobs", lambda *a, **k: dict(knobs))

    def timers(times):
        order = {}

        def make(*a, **k):
            def timer(th, tp, placement=None):
                return times[order.setdefault((th, tp), len(order))]
            return timer
        return make

    # the port on a CUDA device searches (N/2 = 500 pairs of 80 x 256 rows);
    # the reference searches on backend "pallas"
    cfg = DenoiseConfig(num_groups=8, frames_per_group=1000, height=80, width=256,
                        tile_plan="auto", backend="pallas")
    cands = autotune.tile_candidates("stream", 500, 80, 256, vector=True)
    jcands = jautotune.tile_candidates("stream", 500, 80, 256)
    assert len(cands) >= 3 and len(jcands) >= 3
    for times, rank in (([1.0, 0.97, 0.96, 1.1, 1.2, 1.3], 0),
                        ([1.0, 0.97, 0.90, 1.1, 1.2, 1.3], 2)):
        for mod in (autotune, jautotune):
            monkeypatch.setattr(mod, "family_timer", timers(times))
        tune.clear_plan_memo()
        jtune.clear_plan_memo()
        plan = autotune.tune_plan(cfg, CPU, cache=PlanCache(tmp_path / f"{rank}.json"))
        jplan = jtune.autotune.tune_plan(_j(cfg), cache=JPlanCache(tmp_path / f"j{rank}.json"))
        assert plan.tiles[0][1].as_args()["row_tile"] == cands[rank][0]
        assert plan.tiles[0][1].as_args()["pair_tile"] == cands[rank][1]
        assert (jplan.tiles[0][1].row_tile, jplan.tiles[0][1].pair_tile) == jcands[rank]
        for field in ("mode", "num_slots", "frames_per_chunk", "source"):
            assert getattr(plan, field) == getattr(jplan, field), field
        assert len(plan.tiles) == len(jplan.tiles) == 1


def test_pipelined_applies_plan_ring_depth(tmp_path):
    """A pre-built plan file's executor knobs steer run_pipelined; the
    numeric stream is untouched (depth is scheduling-only)."""
    cfg = _cfg()
    path = tmp_path / "prebuilt.json"
    _write(path, {_ekey(cfg, backend="xla"): {"num_slots": 4,
                                                "frames_per_chunk": cfg.frames_per_group}})
    planned = _cfg(tile_plan=str(path))
    groups = _groups(cfg)
    out_ref = _out(cfg, groups)
    out, rep = run_pipelined(planned, iter(groups), device="cpu")
    assert rep.num_slots == 4
    np.testing.assert_array_equal(out.numpy(), out_ref)
    np.testing.assert_array_equal(out.numpy(), _j_out(cfg, groups))
    # the explicit argument still wins over the plan...
    assert run_pipelined(planned, iter(groups), num_slots=2, device="cpu")[1].num_slots == 2
    # ...and so does a non-default config.num_slots
    pinned = _cfg(tile_plan=str(path), num_slots=3)
    assert run_pipelined(pinned, iter(groups), device="cpu")[1].num_slots == 3


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_plan_file_replays_to_the_same_tiles_in_both_packages(tmp_path, writer):
    """One plan file, written by either package's ``PlanCache``, holding the
    same tiles under each package's key: both resolve it to those tiles,
    and every stream is bitwise the heuristic's and the reference's."""
    cfg = _cfg(backend="pallas")
    path = tmp_path / "prebuilt.json"
    cache = (JPlanCache if writer == "reference" else PlanCache)(path)
    cache.put(_fkey(cfg, backend="pallas", ref=True), {"row_tile": 8, "pair_tile": 5})
    cache.put(_fkey(cfg, backend="pallas"), {"row_tile": 8, "pair_tile": 5})
    planned = _cfg(backend="pallas", tile_plan=str(path))
    args = StreamingDenoiser(planned, device="cpu").filter.tile_args("stream")
    assert (args["row_tile"], args["pair_tile"]) == (8, 5)
    jplan = jtune.resolve_plan(_j(planned))
    jargs = jplan.tile_args("stream")
    assert (jargs["row_tile"], jargs["pair_tile"]) == (8, 5)
    # neither package reads the other's entry: drop the port's and it keeps its heuristic
    only_ref = tmp_path / "only-ref.json"
    JPlanCache(only_ref).put(_fkey(cfg, backend="pallas", ref=True),
                             {"row_tile": 8, "pair_tile": 5})
    assert tune.resolve_plan(_cfg(backend="pallas", tile_plan=str(only_ref)), "cpu").tiles == ()
    groups = _groups(cfg)
    out = _out(planned, groups)
    np.testing.assert_array_equal(out, _out(cfg, groups))
    np.testing.assert_array_equal(out, _j_out(_cfg(backend="pallas"), groups))


# ---------------------------------------------------------------------------
# Cache contract: malformed / stale / missing never crash a stream.
# ---------------------------------------------------------------------------


def test_malformed_cache_file_retunes_not_crashes(tmp_path):
    cache_file = tmp_path / "plans.json"
    cache_file.write_text('{"version": 1, "entries": {"truncated"')
    plan = tune.resolve_plan(_cfg(tile_plan="auto"), "cpu")  # re-tunes through the junk
    assert plan.source == "tuned"
    json.loads(cache_file.read_text())  # replaced by a valid store


def test_stale_schema_version_reads_as_empty(tmp_path):
    (tmp_path / "plans.json").write_text(json.dumps({"version": 999, "entries": {"k": {}}}))
    assert tune.resolve_plan(_cfg(tile_plan="auto"), "cpu").source == "tuned"


def test_missing_plan_file_raises_at_resolve_time(tmp_path):
    planned = _cfg(tile_plan=str(tmp_path / "nope.json"))
    with pytest.raises(ValueError, match="does not exist") as got:
        tune.resolve_plan(planned, "cpu")
    with pytest.raises(ValueError) as want:
        jtune.resolve_plan(_j(planned))
    assert str(got.value) == str(want.value)


def test_malformed_plan_file_falls_back_to_heuristic(tmp_path):
    path = tmp_path / "garbage.json"
    path.write_text("not json at all")
    planned = _cfg(tile_plan=str(path))
    with pytest.warns(RuntimeWarning, match="falling back to the heuristic"):
        plan = tune.resolve_plan(planned, "cpu")
    assert plan.tile_args("stream") == {"row_tile": None, "pair_tile": None, "placement": None}
    assert plan.source == "heuristic"
    groups = _groups(_cfg())
    np.testing.assert_array_equal(_out(planned, groups), _out(_cfg(), groups))


def test_corrupt_exec_knobs_degrade_to_config_defaults(tmp_path):
    cfg = _cfg()
    path = tmp_path / "bad-exec.json"
    _write(path, {_ekey(cfg, backend="xla"): {"num_slots": -2, "frames_per_chunk": "400"}})
    planned = _cfg(tile_plan=str(path))
    plan = tune.resolve_plan(planned, "cpu")
    assert plan.num_slots is None and plan.frames_per_chunk is None
    groups = _groups(cfg)
    out, rep = run_pipelined(planned, iter(groups), device="cpu")
    assert rep.num_slots == cfg.num_slots
    np.testing.assert_array_equal(out.numpy(), _out(cfg, groups))


def test_stale_plan_entry_with_non_dividing_tiles_is_skipped(tmp_path):
    cfg = _cfg(backend="pallas")
    path = tmp_path / "stale-shape.json"
    _write(path, {_fkey(cfg, backend="pallas"): {"row_tile": 7, "pair_tile": 3}})
    planned = _cfg(backend="pallas", tile_plan=str(path))
    plan = tune.resolve_plan(planned, "cpu")
    assert plan.tile_args("stream") == {"row_tile": None, "pair_tile": None, "placement": None}
    groups = _groups(cfg)
    np.testing.assert_array_equal(_out(planned, groups), _out(cfg, groups))


# ---------------------------------------------------------------------------
# Output: "auto" and plan files change no bit (B8's pair_tile as the reference's).
# ---------------------------------------------------------------------------


FILTER_NAMES = ["ema_variance", "pair_average", "spatial_box", "temporal_median"]


@pytest.mark.parametrize("name", FILTER_NAMES)
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_auto_pipelined_matches_heuristic_bits_for_every_filter(name, backend):
    cfg_h = _cfg(filter_name=name, backend=backend, spatial_mode="box")
    cfg_a = dataclasses.replace(cfg_h, tile_plan="auto")
    groups = _groups(cfg_h, seed=7)
    out_h = run_pipelined(cfg_h, iter(groups), device="cpu")[0].numpy()
    out_a = run_pipelined(cfg_a, iter(groups), device="cpu")[0].numpy()
    np.testing.assert_array_equal(out_h, out_a, err_msg=name)
    np.testing.assert_array_equal(out_a, _j_out(cfg_h, groups), err_msg=name)


@pytest.mark.parametrize("name", FILTER_NAMES)
def test_plan_file_keeping_the_pinned_ema_tile_changes_no_bit(tmp_path, name):
    cfg = _cfg(filter_name=name, backend="pallas", spatial_mode="box", median_window=3)
    p, h = cfg.pairs_per_group, cfg.height
    pinned = budget.resolve_tiles("ema", p, h, cfg.width)
    entries = {
        _fkey(cfg, "stream", backend="pallas"): {"row_tile": 4, "pair_tile": 2},
        _fkey(cfg, "median_insert", backend="pallas"): {"row_tile": 2, "pair_tile": 5},
        _fkey(cfg, "median_combine", backend="pallas", window=3): {"row_tile": 16,
                                                                   "pair_tile": 10},
        _fkey(cfg, "ema", backend="pallas"): {"row_tile": 8, "pair_tile": pinned[1]},
        _fkey(cfg, "spatial", backend="pallas"): {"row_tile": 8, "pair_tile": 1},
    }
    path = tmp_path / "plan.json"
    _write(path, entries)
    planned = dataclasses.replace(cfg, tile_plan=str(path))
    plan = tune.resolve_plan(planned, "cpu")
    assert len(plan.tiles) == len(autotune.filter_families(cfg))
    groups = _groups(cfg, seed=8)
    np.testing.assert_array_equal(_out(planned, groups), _out(cfg, groups))


def test_plan_file_with_another_ema_pair_tile_matches_the_reference(tmp_path):
    cfg = _cfg(filter_name="ema_variance", backend="pallas")
    p, h, w = cfg.pairs_per_group, cfg.height, cfg.width
    pinned = budget.resolve_tiles("ema", p, h, w)
    assert pinned[1] != 2
    path = tmp_path / "ema.json"
    cache = PlanCache(path)
    for ref in (False, True):
        cache.put(_fkey(cfg, "ema", backend="pallas", ref=ref), {"row_tile": h, "pair_tile": 2})
    planned = dataclasses.replace(cfg, tile_plan=str(path))
    assert tune.tile_args(planned, "ema", device="cpu")["pair_tile"] == 2
    groups = _groups(cfg, seed=9)
    out = _out(planned, groups)
    np.testing.assert_array_equal(out, _j_out(planned, groups))
