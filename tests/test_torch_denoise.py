"""Port parity of ``DenoiseConfig`` / ``StreamingDenoiser``, the filter
registry and the ``pair_average`` filter against ``repro.core.denoise``
(``device="cpu"``; the other filters' streams are in
``test_torch_filters.py``).

Tolerance: bitwise for every comparison (same reason as
``test_torch_kernels.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.denoise import DenoiseConfig as JConfig
from repro.core.denoise import StreamingDenoiser as JDenoiser
from repro.kernels import quant as jquant
from repro_torch.core.denoise import DEFAULT_OFFSET, DenoiseConfig, StreamingDenoiser
from repro.denoise import FILTERS as JFILTERS
from repro_torch.denoise import FILTERS

BASE = dict(num_groups=3, frames_per_group=8, height=8, width=128)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), float(np.abs(got.astype(np.float64) - want).max())


def _groups(cfg, seed, banks=None):
    rng = np.random.default_rng(seed)
    lead = (banks,) if banks else ()
    px = rng.integers(0, 4096, lead + (cfg["num_groups"], cfg["frames_per_group"],
                                       cfg["height"], cfg["width"])).astype(np.uint16)
    return jquant.encode(px, cfg.get("stream_dtype", "u16"))


CONFIGS = [
    {},
    dict(algorithm="alg3_v2"),
    dict(stream_dtype="u8"),
    dict(stream_dtype="p12", algorithm="alg3_v2"),
    dict(num_banks=2, backend="xla", num_slots=3, overflow_policy="drop_oldest"),
    dict(accum_dtype="int32", tile_plan="heuristic", row_tile=4, pair_tile=2),
]


@pytest.mark.parametrize("extra", CONFIGS, ids=str)
def test_config_fields_and_stream_key_match(extra):
    kw = {**BASE, **extra}
    a, b = DenoiseConfig(**kw), JConfig(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    assert a.stream_key() == b.stream_key()
    for prop in ("pairs_per_group", "frame_pixels", "variant", "wire_pixel_bytes",
                 "wire_width", "bytes_per_frame", "input_bytes", "output_frames"):
        assert getattr(a, prop) == getattr(b, prop)


def test_config_defaults_match():
    assert dataclasses.asdict(DenoiseConfig()) == dataclasses.asdict(JConfig())


BAD = [
    dict(frames_per_group=7),
    dict(algorithm="alg7"),
    dict(num_banks=0),
    dict(tile_plan=""),
    dict(num_slots=0),
    dict(stream_dtype="u4"),
    dict(stream_dtype="p12", width=127),
    dict(stream_dtype="u8", accum_dtype="int32"),
    dict(stream_dtype="u8", backend="pallas", algorithm="alg1"),
    dict(overflow_policy="lossy"),
]


@pytest.mark.parametrize("bad", BAD, ids=str)
def test_config_errors_match(bad):
    kw = {**BASE, **bad}
    with pytest.raises(ValueError) as want:
        JConfig(**kw)
    with pytest.raises(ValueError) as got:
        DenoiseConfig(**kw)
    assert str(got.value) == str(want.value)


def test_unknown_filter_lists_registered_filters():
    with pytest.raises(ValueError) as exc:
        DenoiseConfig(**BASE, filter_name="wavelet")
    for name in FILTERS:
        assert name in str(exc.value)


@pytest.mark.parametrize("name", sorted(JFILTERS))
def test_every_reference_filter_builds_the_same_config(name):
    assert sorted(FILTERS) == sorted(JFILTERS)
    kw = {**BASE, "filter_name": name}
    a, b = DenoiseConfig(**kw), JConfig(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.stream_key() == b.stream_key()


BAD_FILTER_PARAMS = [
    dict(filter_name="temporal_median", median_window=0),
    dict(filter_name="temporal_median", accum_dtype="int32"),
    dict(filter_name="ema_variance", ema_alpha=0.0),
    dict(filter_name="ema_variance", ema_alpha=1.5),
    dict(filter_name="ema_variance", ema_mask_sigma=0.0),
    dict(filter_name="ema_variance", accum_dtype="int32"),
    dict(filter_name="spatial_box", spatial_mode="x"),
    dict(filter_name="spatial_box", spatial_range_sigma=0.0),
    dict(filter_name="spatial_box", accum_dtype="int32"),
]


@pytest.mark.parametrize("bad", BAD_FILTER_PARAMS, ids=str)
def test_filter_validate_errors_match_reference(bad):
    kw = {**BASE, **bad}
    with pytest.raises(ValueError) as want:
        JConfig(**kw)
    with pytest.raises(ValueError) as got:
        DenoiseConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(JFILTERS))
def test_phase_invariant_matches_reference(name):
    assert FILTERS[name].phase_invariant is JFILTERS[name].phase_invariant


@pytest.mark.parametrize("plan", ["auto", "plans/denoise.json"])
def test_unported_tile_plans_raise_not_implemented(plan, tmp_path, monkeypatch):
    # both modes are ported now (queue A item 9): "auto" resolves to a
    # measured Plan, and a plan-file path that does not exist raises
    # ValueError at resolve time, as the reference's
    from repro_torch import tune

    monkeypatch.setenv("REPRO_TUNE_CACHE_PATH", str(tmp_path / "plans.json"))
    monkeypatch.chdir(tmp_path)  # "plans/denoise.json" names no file here
    tune.clear_plan_memo()
    cfg = DenoiseConfig(**BASE, tile_plan=plan)
    try:
        if plan == "auto":
            resolved = tune.resolve_plan(cfg, device="cpu")
            assert isinstance(resolved, tune.Plan) and resolved.mode == "auto"
            assert StreamingDenoiser(cfg, device="cpu").plan is resolved
        else:
            with pytest.raises(ValueError, match="does not exist"):
                tune.resolve_plan(cfg, device="cpu")
            with pytest.raises(ValueError, match="does not exist"):
                StreamingDenoiser(cfg, device="cpu")
    finally:
        tune.clear_plan_memo()


@pytest.mark.parametrize(
    "extra",
    [{}, dict(algorithm="alg3_v2"), dict(stream_dtype="u8"),
     dict(stream_dtype="p12", algorithm="alg3_v2"), dict(backend="xla")],
    ids=str,
)
def test_ingest_partial_finalize_and_oneshot_match(extra):
    kw = {**BASE, **extra}
    frames = _groups(kw, seed=1)
    den, jden = StreamingDenoiser(DenoiseConfig(**kw), device="cpu"), JDenoiser(JConfig(**kw))
    st, jst = den.init(), jden.init()
    for g in range(kw["num_groups"]):
        st = den.ingest(st, frames[g])  # numpy chunks are accepted
        jst = jden.ingest(jst, jnp.asarray(frames[g]))
        p, jp = den.partial(st, g), jden.partial(jst, g)
        assert p.data_ptr() != st.data_ptr()  # a fresh tensor, never the sum
        _same(p, jp)
    _same(den.finalize(st), jden.finalize(jst))
    _same(den(torch.from_numpy(frames)), jden(jnp.asarray(frames)))


@pytest.mark.parametrize("algorithm", ["alg3", "alg3_v2"])
def test_banked_ingest_many_and_5d_oneshot_match(algorithm):
    kw = {**BASE, "num_banks": 2, "algorithm": algorithm}
    frames = _groups(kw, seed=2, banks=2)
    den, jden = StreamingDenoiser(DenoiseConfig(**kw), device="cpu"), JDenoiser(JConfig(**kw))
    st, jst = den.init(), jden.init()
    assert tuple(st.shape) == tuple(jst.shape) == (2, 4, 8, 128)
    for g in range(kw["num_groups"]):
        chunk = np.ascontiguousarray(frames[:, g])
        st = den.ingest_many(st, torch.from_numpy(chunk))
        jst = jden.ingest_many(jst, jnp.asarray(chunk))
    _same(den.finalize(st), jden.finalize(jst))
    _same(den(frames), jden(jnp.asarray(frames)))


def test_banked_shape_errors_match():
    kw = {**BASE, "num_banks": 2}
    den, jden = StreamingDenoiser(DenoiseConfig(**kw), device="cpu"), JDenoiser(JConfig(**kw))
    single = _groups(BASE, seed=3)[0]
    for make, d, s in ((torch.from_numpy, den, den.init()), (jnp.asarray, jden, jden.init())):
        with pytest.raises(ValueError, match="num_banks=2"):
            d.ingest(s, make(single))
        with pytest.raises(ValueError, match="does not match"):
            d.ingest_many(s, make(np.stack([single] * 3)))


@pytest.mark.parametrize("variant", ["alg3", "alg3_v2"])
def test_drop_oldest_finalize_steps_matches(variant):
    kw = {**BASE, "algorithm": variant}
    frames = _groups(kw, seed=4)
    den, jden = StreamingDenoiser(DenoiseConfig(**kw), device="cpu"), JDenoiser(JConfig(**kw))
    st, jst = den.init(), jden.init()
    for g in (1, 2):  # group 0 was dropped
        st = den.ingest(st, frames[g], step=g - 1)
        jst = jden.ingest(jst, jnp.asarray(frames[g]), step=g - 1)
    _same(den.finalize(st, steps=2), jden.finalize(jst, steps=2))


@pytest.mark.parametrize("variant", ["divide_last", "divide_first"])
def test_reference_u16_overflow_matches(variant):
    kw = {**BASE, "num_groups": 10}  # divide-last overflows u16 past G = 8
    frames = _groups(kw, seed=5)
    den, jden = StreamingDenoiser(DenoiseConfig(**kw), device="cpu"), JDenoiser(JConfig(**kw))
    got = den.reference_u16(frames, variant=variant)
    assert got.dtype == torch.uint16
    _same(got, jden.reference_u16(jnp.asarray(frames), variant=variant))


def test_integer_accumulator_stream_matches():
    kw = {**BASE, "accum_dtype": "int32", "algorithm": "alg3_v2"}
    frames = _groups(kw, seed=6)
    den, jden = StreamingDenoiser(DenoiseConfig(**kw), device="cpu"), JDenoiser(JConfig(**kw))
    _same(den.run(iter(frames)), jden.run(jnp.asarray(f) for f in frames))
    st, jst = den.init(), jden.init()
    st = den.ingest(st, frames[0])
    jst = jden.ingest(jst, jnp.asarray(frames[0]))
    _same(den.partial(st, 0), jden.partial(jst, 0))


def test_remove_offset_and_run_match():
    frames = _groups(BASE, seed=7)
    den, jden = StreamingDenoiser(DenoiseConfig(**BASE), device="cpu"), JDenoiser(JConfig(**BASE))
    out, jout = den.run(iter(frames)), jden.run(jnp.asarray(f) for f in frames)
    _same(den.remove_offset(out), jden.remove_offset(jout))
    assert DEFAULT_OFFSET == 4096
    with pytest.raises(ValueError, match="expected 3 groups"):
        den.run(iter(frames[:2]))


def _bright_over_dark(kw, seed):
    """u16 groups whose first half of pairs has exc - ctl near 4095, so that
    a uint16 divide-last sum wraps past G = 8 (the paper's u16 container)."""
    frames = _groups(kw, seed=seed)
    half = kw["frames_per_group"] // 2
    frames[:, 0:half:2] //= 4
    frames[:, 1:half:2] = 4095 - frames[:, 1:half:2] // 4
    return frames


@pytest.mark.parametrize("algorithm", ["alg3", "alg3_v2"])
def test_uint16_stream_at_g10_matches_reference(algorithm):
    # backend="auto" in both: the port's kernel plain versions (what its
    # kernels compute on the card) against the reference's own CPU path.
    # (Alg 1/2 have no counterpart here: the reference's XLA composite
    # returns a float32 mean for an integer container, and its Pallas
    # kernels refuse to store that float into one.)
    kw = {**BASE, "num_groups": 10, "accum_dtype": "uint16", "algorithm": algorithm}
    frames = _bright_over_dark(kw, seed=8)
    den, jden = StreamingDenoiser(DenoiseConfig(**kw), device="cpu"), JDenoiser(JConfig(**kw))
    st, jst = den.init(), jden.init()
    for g in range(10):
        st = den.ingest(st, frames[g])
        jst = jden.ingest(jst, jnp.asarray(frames[g]))
        _same(den.partial(st, g), jden.partial(jst, g))
    out = den.finalize(st)
    assert out.dtype == torch.uint16
    _same(out, jden.finalize(jst))
    _same(den(torch.from_numpy(frames)), jden(jnp.asarray(frames)))
    if algorithm == "alg3":  # the sums wrapped: the int32 container reads otherwise
        wide = StreamingDenoiser(DenoiseConfig(**{**kw, "accum_dtype": "int32"}), device="cpu")
        assert not torch.equal(out.to(torch.int32), wide.run(iter(frames)))
