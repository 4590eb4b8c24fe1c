"""Port parity of the acquisition source and the executors:
``repro_torch.data.prism`` / ``repro_torch.core.streaming`` against the
reference, on ``device="cpu"``, plus the slice end to end at the paper's
frame size.

Tolerance: byte-identical frames; bitwise outputs.
"""

import numpy as np
import pytest

from repro.core import streaming as jstreaming
from repro.core.denoise import DenoiseConfig as JConfig
from repro.data.prism import NOISE_REGIMES as J_REGIMES
from repro.data.prism import PrismSource as JSource
from repro.data.prism import snr_db as j_snr_db
from repro_torch.core import streaming
from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser
from repro_torch.data.prism import NOISE_REGIMES, PrismSource, snr_db

SMALL = dict(num_groups=3, frames_per_group=8, height=8, width=128)


def _pair(**kw):
    kw = {**SMALL, **kw}
    return DenoiseConfig(**kw), JConfig(**kw)


@pytest.mark.parametrize("fmt", ["u16", "u8", "p12"])
@pytest.mark.parametrize("regime", NOISE_REGIMES)
def test_prism_source_byte_identical(regime, fmt):
    cfg, jcfg = _pair(stream_dtype=fmt, num_banks=2)
    src = PrismSource(cfg, seed=5, noise_regime=regime)
    jsrc = JSource(jcfg, seed=5, noise_regime=regime)
    for a, b in zip(src.groups(), jsrc.groups(), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(src.banked_groups(), jsrc.banked_groups(), strict=True):
        assert np.array_equal(a, b)
    for a, b in zip(src.bank_source(1), jsrc.bank_source(1), strict=True):
        assert np.array_equal(a, b)
    assert np.array_equal(src.all_frames(), jsrc.all_frames())
    assert np.array_equal(src.true_signal(), jsrc.true_signal())


def test_regimes_and_errors_match():
    assert NOISE_REGIMES == J_REGIMES
    cfg, jcfg = _pair()
    with pytest.raises(ValueError) as a:
        PrismSource(cfg, noise_regime="salt")
    with pytest.raises(ValueError) as b:
        JSource(jcfg, noise_regime="salt")
    assert str(a.value) == str(b.value)


def test_report_header_identical():
    assert streaming.StreamReport.header() == jstreaming.StreamReport.header()
    rep = streaming.StreamReport(1.0, 0.0, 1.0, 8, 16)
    jrep = jstreaming.StreamReport(1.0, 0.0, 1.0, 8, 16)
    assert rep.row("x") == jrep.row("x")


def _reference_stream(jcfg, seed):
    out, _ = jstreaming.run_inline(
        jcfg, JSource(jcfg, seed=seed).groups(), prefetch=False
    )
    return np.asarray(out)


EXECUTOR_CONFIGS = [
    dict(num_groups=8),
    dict(algorithm="alg3_v2"),
    dict(stream_dtype="u8", algorithm="alg3_v2"),
    dict(stream_dtype="p12"),
]


@pytest.mark.parametrize("extra", EXECUTOR_CONFIGS, ids=str)
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_run_pipelined_matches_reference(extra, depth):
    cfg, jcfg = _pair(**extra)
    want = _reference_stream(jcfg, seed=2)
    sink = streaming.DownloadConsumer()
    out, rep = streaming.run_pipelined(
        cfg, PrismSource(cfg, seed=2).groups(), num_slots=depth,
        consumer=sink, device="cpu",
    )
    assert np.array_equal(out.numpy(), want)
    assert len(sink.partials) == cfg.num_groups
    assert np.array_equal(sink.partials[-1], want)
    assert rep.num_slots == depth and rep.frames == cfg.num_groups * cfg.frames_per_group
    assert rep.bytes_in == cfg.input_bytes


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("extra", EXECUTOR_CONFIGS[:2], ids=str)
def test_run_inline_matches_reference(extra, prefetch):
    cfg, jcfg = _pair(**extra)
    out, rep = streaming.run_inline(
        cfg, PrismSource(cfg, seed=3).groups(), prefetch=prefetch, device="cpu"
    )
    assert np.array_equal(out.numpy(), _reference_stream(jcfg, seed=3))
    assert rep.frames == cfg.num_groups * cfg.frames_per_group


@pytest.mark.parametrize("extra", EXECUTOR_CONFIGS, ids=str)
def test_run_buffered_matches_reference(extra):
    cfg, jcfg = _pair(**extra)
    out, rep = streaming.run_buffered(cfg, PrismSource(cfg, seed=4).groups(), device="cpu")
    jout, _ = jstreaming.run_buffered(jcfg, JSource(jcfg, seed=4).groups())
    assert np.array_equal(out.numpy(), np.asarray(jout))
    assert rep.buffering_s > 0 and rep.bytes_in == cfg.input_bytes


def test_drop_oldest_matches_reference_when_nothing_drops():
    cfg, jcfg = _pair(overflow_policy="drop_oldest", num_slots=8)
    out, rep = streaming.run_pipelined(cfg, PrismSource(cfg, seed=6).groups(), device="cpu")
    jout, jrep = jstreaming.run_pipelined(jcfg, JSource(jcfg, seed=6).groups())
    assert rep.drops == jrep.drops == 0
    assert np.array_equal(out.numpy(), np.asarray(jout))


def test_source_error_propagates():
    cfg, _ = _pair()

    def broken():
        yield np.zeros((8, 8, 128), np.uint16)
        raise OSError("camera unplugged")

    with pytest.raises(OSError, match="camera unplugged"):
        streaming.run_pipelined(cfg, broken(), device="cpu")


def test_slice_end_to_end_at_paper_frame_size():
    """PrismSource -> run_pipelined -> pair_average at the paper's
    80 x 256 frames, G = 8, N = 16: bitwise equal to the reference's
    serial executor, and the same SNR against the noise-free signal."""
    kw = dict(num_groups=8, frames_per_group=16, height=80, width=256)
    cfg, jcfg = DenoiseConfig(**kw), JConfig(**kw)
    want = _reference_stream(jcfg, seed=11)
    out, _ = streaming.run_pipelined(cfg, PrismSource(cfg, seed=11).groups(), device="cpu")
    got = out.numpy()
    assert got.shape == (8, 80, 256) and np.isfinite(got).all()
    assert np.array_equal(got, want)
    truth = PrismSource(cfg, seed=11).true_signal()
    assert snr_db(got, truth) == j_snr_db(want, truth)
    assert snr_db(got, truth) > 10.0
    oneshot = StreamingDenoiser(cfg, device="cpu")(PrismSource(cfg, seed=11).all_frames())
    assert np.array_equal(oneshot.numpy(), got)  # G = 8: 1/G is exact


@pytest.mark.parametrize("extra", [dict(), dict(filter_name="ema_variance", pair_tile=2),
                                   dict(filter_name="temporal_median", median_window=2)], ids=str)
def test_download_consumer_takes_a_bfloat16_run(extra):
    """A bfloat16 run's partials land on the host as their float32 widening,
    each equal to the reference's bfloat16 partial widened."""
    cfg, jcfg = _pair(accum_dtype="bfloat16", **extra)
    sink, jsink = streaming.DownloadConsumer(), jstreaming.DownloadConsumer()
    out, _ = streaming.run_pipelined(cfg, PrismSource(cfg, seed=4).groups(), consumer=sink,
                                     device="cpu")
    jout, _ = jstreaming.run_pipelined(jcfg, JSource(jcfg, seed=4).groups(), consumer=jsink)
    assert len(sink.partials) == len(jsink.partials) == cfg.num_groups
    for got, want in zip(sink.partials, jsink.partials):
        assert np.asarray(want).dtype.name == "bfloat16" and got.dtype == np.float32
        assert np.array_equal(got, np.asarray(want).astype(np.float32), equal_nan=True)
    assert np.array_equal(sink.partials[-1], out.float().numpy(), equal_nan=True)
