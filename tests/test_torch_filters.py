"""Port parity of the other three streaming filters (``temporal_median``,
``ema_variance``, ``spatial_box``) and their kernels' plain versions
(B6-B9) against the JAX reference, on the CPU.

Each kernel's plain version (what ``backend="auto"``/``"pallas"`` runs on
a CPU tensor) is held to the reference's ``backend="pallas"`` (interpret
mode), and the port's ``backend="xla"`` to the reference's ``"xla"``.

Tolerances:

* **bitwise** for B6 (insert), B7 (median combine), B9 box, and B8's
  ``ema``, ``wmean`` and ``wm2`` (the port follows the order in which
  XLA rounds and contracts the reference's Pallas kernel and its XLA
  composite, ``repro_torch.kernels.denoise_ema``); and for every filter
  output built from them;
* **B9 bilateral: rtol** ``denoise_spatial.BILATERAL_RTOL`` (1e-6): the
  weights call ``exp``, and XLA's and PyTorch's ``exp`` differ in the
  last bit for some arguments; the readings behind the limit are in its
  comment.

Note on ``auto``: on the CPU the reference's ``auto`` runs XLA while the
port's runs the kernel's plain version. For B8 those differ in the last
bits (chunked against one-pass merge), so the ``ema_variance`` stream
tests pin ``backend="pallas"`` or ``"xla"`` in both packages.
"""

import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streaming as jstreaming
from repro.core.denoise import DenoiseConfig as JConfig
from repro.core.denoise import StreamingDenoiser as JDenoiser
from repro.data.prism import PrismSource as JSource
from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.tune import budget as jbudget
from repro_torch import convert, obs, tune
from repro_torch.core import streaming
from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser
from repro_torch.data.prism import PrismSource
from repro_torch.kernels import denoise_ema, denoise_median, denoise_spatial, ops

OFFSET = 4096.0
FORMATS = ("u16", "u8", "p12")
N, H, W = 20, 16, 64  # P = 10 pairs per group


def _wire(shape, fmt, seed):
    px = np.random.default_rng(seed).integers(0, 4096, shape + (W,)).astype(np.uint16)
    return jquant.encode(px, fmt)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want), float(np.abs(got.astype(np.float64) - want).max())


# ---------------------------------------------------------------------------
# B6 / B7: temporal-median kernels.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
def test_median_window_insert_b6_bitwise(fmt):
    wire = _wire((4, N, H), fmt, seed=1)
    for backend in ("pallas", "xla"):
        jw = jnp.zeros((3, N // 2, H, W))
        tw = torch.zeros(3, N // 2, H, W)
        for g, slot in enumerate((2, 0, 1, 2)):
            jw = jops.median_window_insert(
                jw, jnp.asarray(wire[g]), slot=slot, offset=OFFSET,
                backend=backend, stream_dtype=fmt,
            )
            out = ops.median_window_insert(
                tw, torch.from_numpy(wire[g]), slot=slot, offset=OFFSET,
                backend=backend, stream_dtype=fmt,
            )
            assert out is tw  # in place, as the reference donates
            _same(tw, jw)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 65])  # 65: above the CUDA network's 64 slots
def test_median_combine_b7_bitwise(k):
    rng = np.random.default_rng(k)
    # integer-valued slots give ties; a fractional part makes (lo + hi) / 2 round
    window = (rng.integers(4000, 4200, (k, 6, H, W)) + rng.random((k, 6, H, W)) * 0.75)
    window = window.astype(np.float32)
    window[:, 0] = np.round(window[:, 0])
    for backend in ("pallas", "xla"):
        want = jops.median_combine(jnp.asarray(window), backend=backend)
        t = torch.from_numpy(window.copy())
        got = ops.median_combine(t, backend=backend)
        _same(got, want)
        got.add_(1.0)  # a fresh tensor, never a view of the window
        assert np.array_equal(t.numpy(), window)


# ---------------------------------------------------------------------------
# B8: EMA + Welford/Chan kernel.
# ---------------------------------------------------------------------------


def _ema_stream(o, x, wire, *, alpha, fmt, backend, **kw):
    p = N // 2
    state = (x(np.zeros((p, H, W), np.float32)), x(np.zeros((H, W), np.float32)),
             x(np.zeros((H, W), np.float32)))
    for g in range(wire.shape[0]):
        state = o.ema_welford_step(
            *state, x(wire[g]), alpha=alpha, offset=OFFSET, prior_count=g * p,
            backend=backend, stream_dtype=fmt, **kw,
        )
    return state


@pytest.mark.parametrize("pair_tile", [None, 1, 2, 5])
@pytest.mark.parametrize("alpha", [0.25, 0.3])
@pytest.mark.parametrize("fmt", FORMATS)
def test_ema_welford_step_b8_pallas_bitwise(fmt, alpha, pair_tile):
    # None: the pinned pick, one chunk of all 10 pairs; 1, 2, 5: 10, 5 and 2 chunks
    wire = _wire((3, N, H), fmt, seed=20)
    kw = dict(alpha=alpha, fmt=fmt, backend="pallas", pair_tile=pair_tile)
    want = _ema_stream(jops, jnp.asarray, wire, **kw)
    got = _ema_stream(ops, torch.from_numpy, wire, **kw)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("alpha", [0.25, 0.3])
@pytest.mark.parametrize("fmt", FORMATS)
def test_ema_welford_step_b8_xla_bitwise(fmt, alpha):
    wire = _wire((3, N, H), fmt, seed=21)
    kw = dict(alpha=alpha, fmt=fmt, backend="xla")
    want = _ema_stream(jops, jnp.asarray, wire, **kw)
    got = _ema_stream(ops, torch.from_numpy, wire, **kw)
    for g, w in zip(got, want):
        _same(g, w)


def test_ema_welford_step_updates_in_place():
    wire = _wire((1, N, H), "u16", seed=22)
    state = (torch.zeros(N // 2, H, W), torch.zeros(H, W), torch.zeros(H, W))
    out = ops.ema_welford_step(*state, torch.from_numpy(wire[0]), alpha=0.25, offset=OFFSET)
    assert all(a is b for a, b in zip(out, state))
    assert state[2].abs().sum() > 0


def test_ema_tiles_follow_the_reference_pick():
    for p, h, w in ((500, 80, 256), (10, 16, 64), (4, 8, 128)):
        assert tune.budget.resolve_tiles("ema", p, h, w) == jbudget.resolve_tiles("ema", p, h, w)
    cfg = DenoiseConfig(filter_name="ema_variance")
    args = tune.tile_args(cfg, "ema")
    assert (args["row_tile"], args["pair_tile"]) == jbudget.resolve_tiles("ema", 500, 80, 256) == (80, 5)
    assert tune.tile_args(cfg, "stream")["pair_tile"] is None  # other families: the kernel's choice
    explicit = DenoiseConfig(filter_name="ema_variance", pair_tile=4, frames_per_group=16)
    assert tune.tile_args(explicit, "ema")["pair_tile"] == 4
    for lib in (tune.budget, jbudget):
        with pytest.raises(ValueError, match="pair_tile 3 must divide N/2=10"):
            lib.resolve_tiles("ema", 10, 16, 64, None, 3)


# ---------------------------------------------------------------------------
# B9: spatial 3x3.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["box", "bilateral"])
def test_spatial_filter_b9(mode):
    rng = np.random.default_rng(30)
    frames = (4096 + 40 * rng.standard_normal((4, H, W))).astype(np.float32)
    frames[:, 3, 5] += 900.0  # a hot pixel, far from its neighbours
    for backend in ("pallas", "xla"):
        want = np.asarray(jops.spatial_filter(
            jnp.asarray(frames), mode=mode, range_sigma=60.0, backend=backend))
        got = ops.spatial_filter(torch.from_numpy(frames), mode=mode, range_sigma=60.0,
                                 backend=backend)
        if mode == "box":
            _same(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=denoise_spatial.BILATERAL_RTOL, atol=0)


@pytest.mark.parametrize(
    "width, in_ptr, out_ptr, want",
    [
        (256, 0x1000, 0x2000, "vector"),   # the paper's rows, allocator-aligned
        (132, 0x1000, 0x2000, "vector"),   # a partial last column tile
        (4, 0x1010, 0x2030, "vector"),
        (130, 0x1000, 0x2000, "scalar"),   # W % 4 != 0: rows start unaligned
        (1, 0x1000, 0x2000, "scalar"),
        (256, 0x1004, 0x2000, "scalar"),   # a view one float in
        (256, 0x1000, 0x2008, "scalar"),
    ],
)
def test_spatial_tile_path_takes_float4_only_where_every_row_allows(width, in_ptr, out_ptr, want):
    assert denoise_spatial.tile_path(width, in_ptr, out_ptr) == want


@pytest.mark.parametrize(
    "width, in_ptr, out_ptr, want",
    [
        (256, 0x1000, 0x2000, "vector"),
        (256, 0x1008, 0x2018, "vector"),   # 8-byte aligned: four half pixels
        (132, 0x1000, 0x2000, "vector"),
        (130, 0x1000, 0x2000, "scalar"),
        (256, 0x1002, 0x2000, "scalar"),   # a view one half pixel in
        (256, 0x1000, 0x2004, "scalar"),
    ],
)
def test_spatial_tile_path_aligns_half_frames_to_four_pixels(width, in_ptr, out_ptr, want):
    assert denoise_spatial.tile_path(width, in_ptr, out_ptr, itemsize=2) == want


ERROR_CALLS = {
    "spatial_mode": lambda o, x: o.spatial_filter(x(np.zeros((1, 4, 8), np.float32)), mode="gauss"),
    "spatial_backend": lambda o, x: o.spatial_filter(x(np.zeros((1, 4, 8), np.float32)), backend="fpga"),
    "median_combine_backend": lambda o, x: o.median_combine(
        x(np.zeros((2, 1, 4, 8), np.float32)), backend="hls"),
    "median_insert_backend": lambda o, x: o.median_window_insert(
        x(np.zeros((2, 1, 4, 8), np.float32)), x(np.zeros((2, 4, 8), np.uint16)), slot=0,
        backend="axi"),
    "ema_backend": lambda o, x: o.ema_welford_step(
        x(np.zeros((1, 4, 8), np.float32)), x(np.zeros((4, 8), np.float32)),
        x(np.zeros((4, 8), np.float32)), x(np.zeros((2, 4, 8), np.uint16)), alpha=0.5,
        backend="verilog"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CALLS))
def test_new_dispatch_errors_match_reference(case):
    call = ERROR_CALLS[case]
    with pytest.raises(ValueError) as want:
        call(jops, jnp.asarray)
    with pytest.raises(ValueError) as got:
        call(ops, torch.from_numpy)
    assert str(got.value) == str(want.value)


def test_cpu_wrappers_count_no_launch():
    counters = [denoise_median.median_window_insert, denoise_median.median_combine,
                denoise_ema.ema_welford_step, denoise_spatial.spatial_filter_3x3]
    before = [f.launches for f in counters]
    wire = torch.from_numpy(_wire((1, N, H), "u16", seed=40)[0])
    window = torch.zeros(2, N // 2, H, W)
    denoise_median.median_window_insert(window, wire, slot=1, offset=OFFSET)
    denoise_median.median_combine(window)
    denoise_ema.ema_welford_step(window[0].clone(), torch.zeros(H, W), torch.zeros(H, W), wire,
                                 alpha=0.25)
    denoise_spatial.spatial_filter_3x3(window[1])
    assert [f.launches for f in counters] == before


# ---------------------------------------------------------------------------
# The filters end to end.
# ---------------------------------------------------------------------------

BASE = dict(num_groups=3, frames_per_group=N, height=H, width=W)
FILTER_CONFIGS = {
    "temporal_median": dict(filter_name="temporal_median", median_window=2),
    "ema_variance": dict(filter_name="ema_variance", backend="pallas", ema_alpha=0.3,
                         pair_tile=2, ema_mask_sigma=1.5),
    "spatial_box": dict(filter_name="spatial_box", spatial_mode="box"),
}


def _pair(name, **extra):
    kw = {**BASE, **FILTER_CONFIGS[name], **extra}
    return DenoiseConfig(**kw), JConfig(**kw)


def _reference_pipelined(jcfg, seed, **kw):
    sink = jstreaming.DownloadConsumer()
    out, _ = jstreaming.run_pipelined(jcfg, JSource(jcfg, seed=seed).groups(), consumer=sink, **kw)
    return np.asarray(out), sink.partials


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(FILTER_CONFIGS))
def test_filter_run_pipelined_and_partials_match(name, depth):
    cfg, jcfg = _pair(name)
    want, want_partials = _reference_pipelined(jcfg, seed=2)
    sink = streaming.DownloadConsumer()
    out, _ = streaming.run_pipelined(cfg, PrismSource(cfg, seed=2).groups(), num_slots=depth,
                                     consumer=sink, device="cpu")
    _same(out, want)
    assert len(sink.partials) == len(want_partials) == cfg.num_groups
    for got, exp in zip(sink.partials, want_partials):
        _same(got, exp)


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("name", sorted(FILTER_CONFIGS))
def test_filter_run_inline_matches(name, prefetch):
    cfg, jcfg = _pair(name)
    want, _ = jstreaming.run_inline(jcfg, JSource(jcfg, seed=3).groups(), prefetch=False)
    out, _ = streaming.run_inline(cfg, PrismSource(cfg, seed=3).groups(), prefetch=prefetch,
                                  device="cpu")
    _same(out, want)


@pytest.mark.parametrize("name", sorted(FILTER_CONFIGS))
def test_filter_drop_oldest_finalize_steps_matches(name):
    cfg, jcfg = _pair(name, num_groups=4)
    groups = list(JSource(jcfg, seed=4).groups())
    den, jden = StreamingDenoiser(cfg, device="cpu"), JDenoiser(jcfg)
    st, jst = den.init(), jden.init()
    for k, g in enumerate(groups[1:]):  # group 0 was dropped
        st = den.ingest(st, g, step=k)
        jst = jden.ingest(jst, jnp.asarray(g), step=k)
    for steps in (1, 2, 3):
        _same(den.finalize(st, steps=steps), jden.finalize(jst, steps=steps))


def _forced_drop(cfg, groups):
    """``run_pipelined`` under ``drop_oldest`` with one stage slot, made to
    drop group 3 of 5 whatever the thread timing: groups 0-2 are handed
    over one at a time, each once the compute stage has ingested the one
    before; a consumer holding step 0 fills its one-slot ring and stops
    the compute stage; then groups 3 and 4 arrive together."""
    reg = obs.MetricsRegistry()
    release = threading.Event()

    def source():
        for k in range(3):
            yield groups[k]
            deadline = time.monotonic() + 60
            while reg.value("stream.frames") < (k + 1) * cfg.frames_per_group:
                assert time.monotonic() < deadline, f"group {k} never ingested"
                time.sleep(1e-3)
        yield groups[3]
        yield groups[4]
        release.set()

    def hold(step, partial):
        if step == 0:
            assert release.wait(60), "the source never delivered its last group"

    return streaming.run_pipelined(cfg, source(), num_slots=1, policy="drop_oldest",
                                   consumer=hold, consumer_slots=1, metrics=reg, device="cpu")


@pytest.mark.parametrize("name", sorted(FILTER_CONFIGS))
def test_filter_forced_drop_oldest_matches_reference_survivors(name):
    cfg, jcfg = _pair(name, num_groups=5)
    groups = list(JSource(jcfg, seed=12).groups())
    out, report = _forced_drop(cfg, groups)
    assert report.drops == 1
    jden = JDenoiser(jcfg)
    jst = jden.init()
    for k, g in enumerate(groups[:3] + groups[4:]):  # group 3 was dropped
        jst = jden.ingest(jst, jnp.asarray(g), step=k)
    _same(out, jden.finalize(jst, steps=4))


@pytest.mark.parametrize("name", sorted(FILTER_CONFIGS))
def test_filter_banked_ingest_many_and_oneshot_replay_match(name):
    cfg, jcfg = _pair(name, num_banks=2)
    frames = np.stack(list(JSource(jcfg, seed=5).banked_groups()), axis=1)  # (B, G, N, H, W)
    den, jden = StreamingDenoiser(cfg, device="cpu"), JDenoiser(jcfg)
    st, jst = den.init(), jden.init()
    for g in range(cfg.num_groups):
        chunk = np.ascontiguousarray(frames[:, g])
        st = den.ingest_many(st, torch.from_numpy(chunk))
        jst = jden.ingest_many(jst, jnp.asarray(chunk))
    want = jden.finalize(jst)
    _same(den.finalize(st), want)
    _same(den(frames), jden(jnp.asarray(frames)))
    _same(den(frames), want)


@pytest.mark.parametrize("name", sorted(FILTER_CONFIGS))
def test_filter_oneshot_replay_matches_stream(name):
    cfg, jcfg = _pair(name)
    frames = JSource(jcfg, seed=6).all_frames()
    den = StreamingDenoiser(cfg, device="cpu")
    want = np.asarray(JDenoiser(jcfg)(jnp.asarray(frames)))
    _same(den(frames), want)
    _same(den.run(iter(frames)), want)


@pytest.mark.parametrize(
    "extra",
    [dict(filter_name="spatial_box", spatial_mode="bilateral", spatial_range_sigma=30.0),
     dict(filter_name="spatial_box", spatial_mode="box", algorithm="alg3_v2", stream_dtype="u8"),
     dict(filter_name="temporal_median", median_window=4, stream_dtype="p12"),
     dict(filter_name="temporal_median", median_window=1, backend="xla"),
     dict(filter_name="ema_variance", backend="xla", stream_dtype="u8"),
     dict(filter_name="ema_variance", backend="pallas", stream_dtype="p12", ema_alpha=0.25)],
    ids=["bilateral", "box_v2_u8", "median4_p12", "median1_xla", "ema_xla_u8", "ema_p12"],
)
def test_filter_variants_match(extra):
    kw = {**BASE, "num_groups": 5, **extra}
    cfg, jcfg = DenoiseConfig(**kw), JConfig(**kw)
    want, want_partials = _reference_pipelined(jcfg, seed=7)
    sink = streaming.DownloadConsumer()
    out, _ = streaming.run_pipelined(cfg, PrismSource(cfg, seed=7).groups(), consumer=sink,
                                     device="cpu")
    if extra.get("spatial_mode") == "bilateral":
        rtol = denoise_spatial.BILATERAL_RTOL
        np.testing.assert_allclose(out.numpy(), want, rtol=rtol, atol=0)
        for got, exp in zip(sink.partials, want_partials):
            np.testing.assert_allclose(got, exp, rtol=rtol, atol=0)
    else:
        _same(out, want)
        for got, exp in zip(sink.partials, want_partials):
            _same(got, exp)


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_ema_variance_finalize_on_converted_states_bitwise(steps):
    cfg, jcfg = _pair("ema_variance", ema_mask_sigma=1.2)
    groups = list(JSource(jcfg, seed=8).groups())
    jden = JDenoiser(jcfg)
    jst = jden.init()
    for k in range(steps):
        jst = jden.ingest(jst, jnp.asarray(groups[k]), step=k)
    st = convert.state_from_reference({k: np.asarray(v) for k, v in jst.items()}, device="cpu")
    den = StreamingDenoiser(cfg, device="cpu")
    want = np.asarray(jden.finalize(jst, steps=steps))
    got = den.finalize(st, steps=steps)
    _same(got, want)
    assert (got.numpy() != np.asarray(jst["ema"]) / np.float32(1 - 0.7**steps)).any()  # masked


def test_ema_variance_finalize_single_sample_returns_the_corrected_ema():
    cfg, jcfg = _pair("ema_variance", frames_per_group=2, pair_tile=None)
    group = next(JSource(jcfg, seed=9).groups())
    jden, den = JDenoiser(jcfg), StreamingDenoiser(cfg, device="cpu")
    jst = jden.ingest(jden.init(), jnp.asarray(group), step=0)
    st = den.ingest(den.init(), group, step=0)
    _same(den.finalize(st, steps=1), jden.finalize(jst, steps=1))


@pytest.mark.parametrize("name", sorted(FILTER_CONFIGS))
def test_filter_stream_handoff_between_packages(name):
    cfg, jcfg = _pair(name, num_groups=4)
    groups = list(JSource(jcfg, seed=10).groups())
    full = np.asarray(JDenoiser(jcfg).run(jnp.asarray(g) for g in groups))
    # reference -> port after two groups
    jden = JDenoiser(jcfg)
    js = jden.init()
    for k in range(2):
        js = jden.ingest(js, jnp.asarray(groups[k]), step=k)
    host = {k: np.asarray(v) for k, v in js.items()} if isinstance(js, dict) else np.asarray(js)
    den = StreamingDenoiser(convert.config_from_reference(dataclasses.asdict(jcfg)), device="cpu")
    st = convert.state_from_reference(host, device="cpu")
    for k in range(2, 4):
        st = den.ingest(st, groups[k], step=k)
    _same(den.finalize(st), full)
    # port -> reference after two groups
    st = den.init()
    for k in range(2):
        st = den.ingest(st, groups[k], step=k)
    back = convert.state_to_reference(st)
    js = ({k: jnp.asarray(v) for k, v in back.items()} if isinstance(back, dict)
          else jnp.asarray(back))
    for k in range(2, 4):
        js = jden.ingest(js, jnp.asarray(groups[k]), step=k)
    _same(jden.finalize(js), full)


def test_filters_at_paper_frame_size_match_reference():
    """PrismSource -> run_pipelined at the paper's 80 x 256 frames (G = 8,
    N = 16): each filter bitwise equal to the reference's serial executor."""
    for name, extra in (("temporal_median", {}), ("ema_variance", dict(backend="pallas")),
                        ("spatial_box", dict(spatial_mode="box"))):
        kw = dict(num_groups=8, frames_per_group=16, height=80, width=256, filter_name=name,
                  **extra)
        cfg, jcfg = DenoiseConfig(**kw), JConfig(**kw)
        want, _ = jstreaming.run_inline(jcfg, JSource(jcfg, seed=11).groups(), prefetch=False)
        out, _ = streaming.run_pipelined(cfg, PrismSource(cfg, seed=11).groups(), device="cpu")
        assert out.shape == (8, 80, 256) and torch.isfinite(out).all()
        _same(out, want)
