"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where there is no CUDA device (the CPU
suite holds the plain versions to the JAX reference instead). Run them on
a machine with the card (``--noconftest``: the repo's ``conftest.py``
imports the JAX package, which that machine need not have)::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bitwise (the kernels round as the plain versions do), except
the bilateral mode of the spatial kernel, whose ``expf`` is held to the
plain version's ``torch.exp`` within ``denoise_spatial.BILATERAL_RTOL``.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.core import banks, streaming
from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser
from repro_torch.data.prism import PrismSource
from repro_torch.kernels import (
    denoise_ema,
    denoise_median,
    denoise_multibank,
    denoise_spatial,
    denoise_stream,
    denoise_tmpframe,
    ops,
    quant,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _wire(shape, fmt, seed, width=256):
    px = np.random.default_rng(seed).integers(0, 4096, shape + (width,)).astype(np.uint16)
    return torch.from_numpy(np.ascontiguousarray(quant.encode(px, fmt)))


def _shifted(t, device):
    """``t`` on ``device`` in storage that starts one element into a buffer:
    a contiguous view whose planes are not aligned for vector loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("divide_first", [False, True])
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
@pytest.mark.parametrize("g", [3, 8])
def test_kernels_bitwise_equal_plain(cuda, g, fmt, divide_first):
    kw = dict(offset=4096.0, divide_first=divide_first, stream_dtype=fmt)
    frames = _wire((2, g, 16, 80), fmt, seed=g)
    got = denoise_multibank.multibank_subtract_average(frames.to(cuda), **kw).cpu()
    assert torch.equal(got, denoise_multibank.multibank_subtract_average_plain(frames, **kw))
    got = denoise_stream.alg3_subtract_average(frames[0].to(cuda), **kw).cpu()
    assert torch.equal(got, denoise_stream.alg3_subtract_average_plain(frames[0], **kw))
    s, sc = torch.zeros(2, 8, 80, 256, device=cuda), torch.zeros(2, 8, 80, 256)
    for k in range(g):
        chunk = frames[:, k].contiguous()
        denoise_multibank.multibank_stream_step(chunk.to(cuda), s, num_groups=g, **kw)
        sc = denoise_multibank.multibank_stream_step_plain(chunk, sc, num_groups=g, **kw)
        denoise_stream.alg3_stream_step(chunk[0].to(cuda), s[0], num_groups=g, **kw)
        sc[0] = denoise_stream.alg3_stream_step_plain(chunk[0], sc[0], num_groups=g, **kw)
    assert torch.equal(s.cpu(), sc)


@pytest.mark.parametrize("divide_first", [False, True])
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
@pytest.mark.parametrize(
    "shape, shift, path",
    [((80, 256), False, "vector"), ((8, 136), False, "vector"), ((40, 136), False, "vector"),
     ((80, 256), True, "scalar"), ((7, 130), False, "scalar")],
    ids=["80x256", "8x136", "40x136", "80x256-unaligned-view", "ragged-7x130"],
)
def test_step_kernels_take_the_path_their_planes_allow(cuda, shape, shift, path, fmt,
                                                       divide_first):
    # 8 x 136 is 136 vectors, a partial warp in one partial block; 40 x 136 is
    # 680, a full block and a partial one. p12 has no vector path.
    h, w = shape
    path = "scalar" if fmt == "p12" else path
    g, n = 3, 12
    frames = _wire((2, g, n, h), fmt, seed=h + g, width=w)
    kw = dict(offset=4096.0, divide_first=divide_first, stream_dtype=fmt, num_groups=g)
    b2, b4 = denoise_stream.alg3_stream_step, denoise_multibank.multibank_stream_step
    before = [(f.launches, f.vector_launches, f.scalar_launches) for f in (b2, b4)]
    place = (lambda t: _shifted(t, cuda)) if shift else (lambda t: t.to(cuda))
    s1, s2 = place(torch.zeros(n // 2, h, w)), place(torch.zeros(2, n // 2, h, w))
    c1, c2 = torch.zeros(n // 2, h, w), torch.zeros(2, n // 2, h, w)
    for k in range(g):
        fin = k == g - 1  # the in-kernel final division on the last group
        chunk = frames[:, k].contiguous()
        denoise_stream.alg3_stream_step(place(chunk[0]), s1, final=fin, **kw)
        c1 = denoise_stream.alg3_stream_step_plain(chunk[0], c1, final=fin, **kw)
        denoise_multibank.multibank_stream_step(place(chunk), s2, final=fin, **kw)
        c2 = denoise_multibank.multibank_stream_step_plain(chunk, c2, final=fin, **kw)
    assert torch.equal(s1.cpu(), c1) and torch.equal(s2.cpu(), c2)
    for f, (n0, v0, s0) in zip((b2, b4), before):
        assert f.launches - n0 == g
        assert (f.vector_launches - v0, f.scalar_launches - s0) == (
            (g, 0) if path == "vector" else (0, g))


def test_step_kernel_refuses_a_vector_launch_its_planes_do_not_allow(cuda, monkeypatch):
    # the path is the host's choice; the kernel raises on a wrong one, never reroutes
    monkeypatch.setattr(denoise_stream, "step_path", lambda *a: "vector")
    frames = _wire((12, 7), "u16", seed=3, width=130).to(cuda)
    with pytest.raises(RuntimeError, match="alg3_stream_step: CUDA launch failed"):
        denoise_stream.alg3_stream_step(frames, torch.zeros(6, 7, 130, device=cuda),
                                        num_groups=2)


@pytest.mark.parametrize(
    "pairs, pair_tile, hw, groups",
    [(500, 1, (16, 256), 2), (40, 40, (80, 256), 2), (60, 4, (7, 130), 3)]
    + [(168, t, (16, 256), 2) for t in (2, 3, 6, 7, 8)],
    ids=["500-chunks", "one-chunk", "ragged-7x130"] + [f"pair_tile-{t}" for t in (2, 3, 6, 7, 8)],
)
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
def test_ema_kernel_chunk_rounds_bitwise_equal_plain(cuda, fmt, pairs, pair_tile, hw, groups):
    # 500 chunks: 63 rounds of 8, the last one short; one chunk: longer than
    # the register cap, one round; ragged: a partial last tile of pixels;
    # pair_tile 2-8: every register tile the other cases do not launch
    h, w = hw
    frames = _wire((groups, 2 * pairs, h), fmt, seed=pairs, width=w)
    gpu = [torch.zeros(pairs, h, w, device=cuda), torch.zeros(h, w, device=cuda),
           torch.zeros(h, w, device=cuda)]
    cpu = [t.cpu() for t in gpu]
    before = denoise_ema.ema_welford_step.launches
    for g in range(groups):
        kw = dict(alpha=0.3, offset=4096.0, prior_count=11 + pairs * g, pair_tile=pair_tile,
                  stream_dtype=fmt)
        denoise_ema.ema_welford_step(*gpu, frames[g].to(cuda), **kw)
        cpu = list(denoise_ema.ema_welford_step_plain(*cpu, frames[g], **kw))
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu(), b)
    assert denoise_ema.ema_welford_step.launches - before == groups


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    s = torch.zeros(4, 8, 256, device=cuda)
    with pytest.raises(NotImplementedError, match="float32"):
        denoise_stream.alg3_stream_step(
            torch.zeros(8, 8, 256, dtype=torch.uint16, device=cuda),
            s.to(torch.float64), num_groups=2)
    with pytest.raises(NotImplementedError, match="u8 wire"):  # integer sums take u16 wire
        denoise_stream.alg3_stream_step(
            torch.zeros(8, 8, 256, dtype=torch.uint8, device=cuda),
            s.to(torch.int32), num_groups=2, stream_dtype="u8")
    with pytest.raises(NotImplementedError, match="float32"):  # the median window is float32
        denoise_median.median_window_insert(
            torch.zeros(2, 4, 8, 256, dtype=torch.int32, device=cuda),
            torch.zeros(8, 8, 256, dtype=torch.uint16, device=cuda), slot=0)
    with pytest.raises(TypeError):
        denoise_stream.alg3_stream_step(torch.zeros(8, 8, 256, device=cuda), s, num_groups=2)


@pytest.mark.parametrize("offset", [0.0, 4096.0], ids=["offset0", "offset4096"])
@pytest.mark.parametrize("divide_first", [False, True])
@pytest.mark.parametrize("accum", [torch.int32, torch.uint16], ids=["int32", "uint16"])
def test_integer_sums_bitwise_equal_plain(cuda, accum, divide_first, offset):
    # G = 10: a uint16 divide-last sum wraps past G = 8; offset 0 makes half the
    # differences negative, where a truncating division would differ from //
    g, n, h, w = 10, 12, 9, 132
    frames = _wire((2, g, n, h), "u16", seed=21, width=w)
    kw = dict(offset=offset, divide_first=divide_first, accum_dtype=accum)
    assert torch.equal(
        denoise_multibank.multibank_subtract_average(frames.to(cuda), **kw).cpu(),
        denoise_multibank.multibank_subtract_average_plain(frames, **kw))
    assert torch.equal(denoise_stream.alg3_subtract_average(frames[0].to(cuda), **kw).cpu(),
                       denoise_stream.alg3_subtract_average_plain(frames[0], **kw))
    kw = dict(offset=offset, divide_first=divide_first, num_groups=g)
    s = torch.zeros(2, n // 2, h, w, dtype=accum, device=cuda)
    sc = torch.zeros(2, n // 2, h, w, dtype=accum)
    before = denoise_stream.alg3_stream_step.scalar_launches
    for k in range(g):
        fin = k == g - 1  # the in-kernel final division on the last group
        chunk = frames[:, k].contiguous()
        denoise_multibank.multibank_stream_step(chunk.to(cuda), s, final=fin, **kw)
        sc = denoise_multibank.multibank_stream_step_plain(chunk, sc, final=fin, **kw)
        denoise_stream.alg3_stream_step(chunk[0].to(cuda), s[0], final=fin, **kw)
        sc[0] = denoise_stream.alg3_stream_step_plain(chunk[0], sc[0], final=fin, **kw)
    assert torch.equal(s.cpu(), sc)
    assert denoise_stream.alg3_stream_step.scalar_launches - before == g
    if not divide_first:  # B10: Alg 1 and Alg 2 with the same sums
        want = denoise_tmpframe.alg1_subtract_average_plain(frames[0], offset=offset,
                                                            accum_dtype=accum)
        for fn in (denoise_tmpframe.alg1_subtract_average,
                   denoise_tmpframe.alg2_subtract_average):
            got = fn(frames[0].to(cuda), offset=offset, accum_dtype=accum)
            assert got.dtype == accum and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("algorithm", ["alg3", "alg3_v2", "alg1"])
def test_uint16_pair_average_executors_match_cpu(cuda, algorithm):
    # the paper's u16-container stream on the card: every plain step left on
    # the executors' path (init, finalize's floor division) runs on uint16
    cfg = DenoiseConfig(num_groups=10, frames_per_group=16, height=80, width=256,
                        accum_dtype="uint16", algorithm=algorithm)
    groups = list(PrismSource(cfg, seed=2).groups())
    want = StreamingDenoiser(cfg, device="cpu").run(groups)
    assert want.dtype == torch.uint16
    for depth in (1, 2):
        out, _ = streaming.run_pipelined(cfg, iter(groups), num_slots=depth)
        assert out.dtype == torch.uint16 and torch.equal(out.cpu(), want)
    oneshot = StreamingDenoiser(cfg)(np.stack(groups)).cpu()
    assert torch.equal(oneshot, StreamingDenoiser(cfg, device="cpu")(np.stack(groups)))


@pytest.mark.parametrize("k", [65, 66, 100])
def test_median_combine_above_the_network_window(cuda, k):
    # integer-valued slots give ties; a fractional part makes (lo + hi) / 2 round
    rng = np.random.default_rng(k)
    window = rng.integers(4000, 4040, (k, 3, 7, 130)) + (rng.random((k, 3, 7, 130)) < 0.5) * 0.75
    window = torch.from_numpy(window.astype(np.float32))
    before = denoise_median.median_combine.select_launches
    got = denoise_median.median_combine(window.to(cuda))
    assert torch.equal(got.cpu(), denoise_median.median_combine_plain(window))
    assert denoise_median.median_combine.select_launches - before == 1


def test_spatial_kernel_refuses_a_float4_launch_its_rows_do_not_allow(cuda, monkeypatch):
    # the path is the host's choice; the kernel raises on a wrong one, never reroutes
    monkeypatch.setattr(denoise_spatial, "tile_path", lambda *a: "vector")
    with pytest.raises(RuntimeError, match="spatial_filter_3x3: CUDA launch failed"):
        denoise_spatial.spatial_filter_3x3(torch.zeros(2, 7, 130, device=cuda))


@pytest.mark.parametrize(
    "shape, shift, path",
    [((3, 80, 256), False, "vector"), ((2, 20, 132), False, "vector"),
     ((2, 1, 256), False, "vector"), ((2, 2, 8), False, "vector"),
     ((2, 7, 130), False, "scalar"), ((2, 80, 256), True, "scalar"),
     ((2, 5, 1), False, "scalar"), ((1, 17, 3), False, "scalar")],
    ids=["80x256", "partial-tiles-20x132", "H1", "H2-W8", "ragged-7x130",
         "80x256-unaligned-view", "W1", "17x3"],
)
def test_spatial_tiles_edges_and_paths(cuda, shape, shift, path):
    x = torch.from_numpy(
        (4096 + 40 * np.random.default_rng(sum(shape)).standard_normal(shape)).astype(np.float32))
    x[:, 0, -1] += 900.0  # a hot pixel on the tile edge
    fn = denoise_spatial.spatial_filter_3x3
    before = (fn.vector_launches, fn.scalar_launches)
    xd = _shifted(x, cuda) if shift else x.to(cuda)
    assert torch.equal(fn(xd, mode="box").cpu(), denoise_spatial.spatial_filter_3x3_plain(x))
    kw = dict(mode="bilateral", range_sigma=60.0)
    torch.testing.assert_close(fn(xd, **kw).cpu(), denoise_spatial.spatial_filter_3x3_plain(x, **kw),
                               rtol=denoise_spatial.BILATERAL_RTOL, atol=0)
    assert (fn.vector_launches - before[0], fn.scalar_launches - before[1]) == (
        (2, 0) if path == "vector" else (0, 2))


def test_executors_on_the_card_match_cpu(cuda):
    cfg = DenoiseConfig(num_groups=3, frames_per_group=16, height=80, width=256)
    want = StreamingDenoiser(cfg, device="cpu").run(PrismSource(cfg, seed=1).groups())
    before = denoise_stream.alg3_stream_step.launches
    for depth in (1, 2, 3):
        out, _ = streaming.run_pipelined(cfg, PrismSource(cfg, seed=1).groups(), num_slots=depth)
        assert torch.equal(out.cpu(), want)
    assert denoise_stream.alg3_stream_step.launches - before == 3 * cfg.num_groups


@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
def test_median_kernels_bitwise_equal_plain(cuda, fmt):
    frames = _wire((5, 16, 80), fmt, seed=11)
    w_gpu, w_cpu = torch.zeros(4, 8, 80, 256, device=cuda), torch.zeros(4, 8, 80, 256)
    for g in range(5):
        kw = dict(slot=g % 4, offset=4096.0, stream_dtype=fmt)
        denoise_median.median_window_insert(w_gpu, frames[g].to(cuda), **kw)
        denoise_median.median_window_insert_plain(w_cpu, frames[g], **kw)
        assert torch.equal(w_gpu.cpu(), w_cpu)
    for k in (1, 2, 3, 4):
        got = denoise_median.median_combine(w_gpu[:k])
        assert torch.equal(got.cpu(), denoise_median.median_combine_plain(w_cpu[:k]))
    wide = torch.randn(13, 8, 80, 256)  # a window longer than the unrolled kernels
    got = denoise_median.median_combine(wide.to(cuda))
    assert torch.equal(got.cpu(), denoise_median.median_combine_plain(wide))


@pytest.mark.parametrize("pair_tile", [1, 5, 8])
@pytest.mark.parametrize("fmt", quant.STREAM_DTYPES)
def test_ema_kernel_bitwise_equal_plain(cuda, fmt, pair_tile):
    frames = _wire((3, 80, 80), fmt, seed=12)
    gpu = [torch.zeros(40, 80, 256, device=cuda), torch.zeros(80, 256, device=cuda),
           torch.zeros(80, 256, device=cuda)]
    cpu = [t.cpu() for t in gpu]
    for g in range(3):
        kw = dict(alpha=0.3, offset=4096.0, prior_count=40 * g, pair_tile=pair_tile,
                  stream_dtype=fmt)
        denoise_ema.ema_welford_step(*gpu, frames[g].to(cuda), **kw)
        cpu = list(denoise_ema.ema_welford_step_plain(*cpu, frames[g], **kw))
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu(), b)


def test_spatial_kernel_matches_plain(cuda):
    x = 4096 + 40 * torch.randn(6, 80, 256)
    got = denoise_spatial.spatial_filter_3x3(x.to(cuda), mode="box")
    assert torch.equal(got.cpu(), denoise_spatial.spatial_filter_3x3_plain(x, mode="box"))
    got = denoise_spatial.spatial_filter_3x3(x.to(cuda), mode="bilateral", range_sigma=60.0)
    want = denoise_spatial.spatial_filter_3x3_plain(x, mode="bilateral", range_sigma=60.0)
    torch.testing.assert_close(got.cpu(), want, rtol=denoise_spatial.BILATERAL_RTOL, atol=0)


@pytest.mark.parametrize(
    "extra",
    [dict(filter_name="temporal_median", median_window=2),
     dict(filter_name="ema_variance", ema_mask_sigma=1.5),
     dict(filter_name="spatial_box", spatial_mode="box")],
    ids=["temporal_median", "ema_variance", "spatial_box"],
)
def test_filter_executors_on_the_card_match_cpu(cuda, extra):
    cfg = DenoiseConfig(num_groups=3, frames_per_group=16, height=80, width=256, **extra)
    want = StreamingDenoiser(cfg, device="cpu").run(PrismSource(cfg, seed=1).groups())
    for depth in (1, 2, 3):
        out, _ = streaming.run_pipelined(cfg, PrismSource(cfg, seed=1).groups(), num_slots=depth)
        assert torch.equal(out.cpu(), want)
    frames = torch.from_numpy(PrismSource(cfg, seed=1).all_frames()).to(cuda)
    assert torch.equal(StreamingDenoiser(cfg)(frames).cpu(), want)


@pytest.mark.parametrize("shape", [(5, 16, 80, 256), (5, 6, 7, 130)], ids=["80x256", "ragged"])
def test_tmpframe_kernels_bitwise_equal_plain(cuda, shape):
    # G = 5: a division by G instead of the multiply by f32(1/G) would differ
    frames = torch.from_numpy(
        np.random.default_rng(13).integers(0, 4096, shape).astype(np.uint16))
    want = denoise_tmpframe.alg1_subtract_average_plain(frames, offset=4096.0)
    before = [denoise_tmpframe.alg1_subtract_average.launches,
              denoise_tmpframe.alg2_subtract_average.launches]
    got1 = denoise_tmpframe.alg1_subtract_average(frames.to(cuda), offset=4096.0).cpu()
    got2 = denoise_tmpframe.alg2_subtract_average(frames.to(cuda), offset=4096.0).cpu()
    assert torch.equal(got1, want) and torch.equal(got2, want)
    assert [denoise_tmpframe.alg1_subtract_average.launches,
            denoise_tmpframe.alg2_subtract_average.launches] == [b + 2 for b in before]
    tmp = denoise_tmpframe.subtract_pass(frames.to(cuda), offset=4096.0, burst=True)
    assert torch.equal(tmp.cpu(), denoise_tmpframe.subtract_pass_plain(frames, offset=4096.0))
    with pytest.raises(ValueError, match="'u8' ingest"):
        ops.subtract_average(frames[:, :, :, :128].to(torch.uint8).to(cuda), algorithm="alg1",
                             stream_dtype="u8")
    with pytest.raises(NotImplementedError, match="float32"):
        denoise_tmpframe.alg1_subtract_average(frames.to(cuda), accum_dtype=torch.float64)


@pytest.mark.parametrize(
    "extra",
    [dict(), dict(filter_name="temporal_median", median_window=2),
     dict(filter_name="ema_variance"), dict(filter_name="spatial_box", spatial_mode="box")],
    ids=["pair_average", "temporal_median", "ema_variance", "spatial_box"],
)
def test_two_shard_banked_executor_on_one_card_matches_cpu(cuda, extra):
    cfg = DenoiseConfig(num_groups=3, frames_per_group=16, height=80, width=256,
                        num_banks=2, **extra)
    sources = [list(s) for s in PrismSource(cfg, seed=4).bank_sources(2)]
    want, _ = banks.run_pipelined_banked(cfg, [iter(s) for s in sources],
                                         banks.BankMesh(("cpu", "cpu")))
    got, rep = banks.run_pipelined_banked(cfg, [iter(s) for s in sources],
                                          banks.BankMesh(("cuda:0", "cuda:0")))
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    assert rep.frames == 2 * cfg.num_groups * cfg.frames_per_group


def _gated(groups, gate):
    gate.wait(60)
    yield from groups


@pytest.mark.parametrize(
    "extra",
    [dict(), dict(filter_name="temporal_median", median_window=2),
     dict(filter_name="ema_variance"), dict(filter_name="spatial_box", spatial_mode="box")],
    ids=["pair_average", "temporal_median", "ema_variance", "spatial_box"],
)
def test_one_session_service_on_the_card_equals_run_pipelined(cuda, extra):
    from repro_torch.serve import Session, SessionScheduler

    cfg = DenoiseConfig(num_groups=3, frames_per_group=16, height=80, width=256, **extra)
    groups = list(PrismSource(cfg, seed=2).groups())
    want, _ = streaming.run_pipelined(cfg, iter(groups))
    b2, b4 = denoise_stream.alg3_stream_step, denoise_multibank.multibank_stream_step
    before = (b2.launches, b4.launches)
    with SessionScheduler(slots_per_executor=1, max_executors=1) as sched:
        out, rep = sched.submit(Session(config=cfg, source=iter(groups))).result(timeout=120)
    assert out.device.type == "cuda" and torch.equal(out.cpu(), want.cpu())
    assert rep.groups == cfg.num_groups
    if cfg.filter_name in ("pair_average", "spatial_box"):  # the lone-slot path: B2 only
        assert (b2.launches - before[0], b4.launches - before[1]) == (cfg.num_groups, 0)


def test_four_session_full_cohort_on_the_card_equals_run_pipelined(cuda):
    import threading

    from repro_torch.serve import Session, SessionScheduler

    cfg = DenoiseConfig(num_groups=4, frames_per_group=64, height=80, width=256)
    base = list(PrismSource(cfg, seed=3).groups())
    per_session = [[g + np.uint16(16 * s) for g in base] for s in range(4)]
    wants = [streaming.run_pipelined(cfg, iter(g))[0].cpu() for g in per_session]
    b2, b4 = denoise_stream.alg3_stream_step, denoise_multibank.multibank_stream_step
    before = (b2.launches, b4.launches)
    gate = threading.Event()
    with SessionScheduler(slots_per_executor=4, max_executors=1, coalesce_ms=30_000) as sched:
        hs = [sched.submit(Session(config=cfg, source=_gated(g, gate), name=f"t{s}"))
              for s, g in enumerate(per_session)]
        deadline = time.monotonic() + 60
        while not all(h.status == "active" for h in hs):
            assert time.monotonic() < deadline, "sessions never joined"
            time.sleep(1e-3)
        gate.set()
        outs = [h.result(timeout=120)[0] for h in hs]
    for out, want in zip(outs, wants):
        assert torch.equal(out.cpu(), want)
    # every group one full-cohort step at B = 4, and no lone-slot step
    assert (b2.launches - before[0], b4.launches - before[1]) == (0, cfg.num_groups)


FLEET_FILTERS = pytest.mark.parametrize(
    "extra",
    [dict(), dict(filter_name="temporal_median", median_window=3),
     dict(filter_name="ema_variance"), dict(filter_name="spatial_box")],
    ids=["pair_average", "temporal_median", "ema_variance", "spatial_box"],
)


def _fleet_cfg(**extra):
    return DenoiseConfig(num_groups=5, frames_per_group=16, height=80, width=256, **extra)


@FLEET_FILTERS
@pytest.mark.parametrize("every", [1, 3])
def test_fleet_crash_recovery_on_the_card_equals_run_pipelined(cuda, tmp_path, extra, every):
    """Two sessions in full cohorts on ``ex0``, which crashes before its
    5th cohort; both restore (``every=1``: the checkpoint of fold 4;
    ``every=3``: that of fold 3 and a replay of one group) on ``ex1``."""
    import threading

    from repro_torch.serve import FaultPlan, FleetScheduler, Session

    cfg = _fleet_cfg(**extra)
    sources = [list(PrismSource(cfg, seed=s).groups()) for s in (1, 2)]
    wants = [streaming.run_pipelined(cfg, iter(g))[0].cpu() for g in sources]
    plan, gate = FaultPlan().crash("ex0", at_step=4), threading.Event()
    with FleetScheduler(checkpoint_dir=str(tmp_path), checkpoint_every=every, faults=plan,
                        slots_per_executor=2, max_executors=2, coalesce_ms=30_000) as fleet:
        hs = [fleet.submit(Session(config=cfg, source=_gated(g, gate), name=f"s{i}"))
              for i, g in enumerate(sources)]
        # one beat after ex0's next join pass: both sessions hold a slot
        # before any group exists, so every cohort is a full one
        assert fleet.check_faults(probe_timeout_s=60)["evicted"] == []
        gate.set()
        outs = [h.result(timeout=120) for h in hs]
    assert plan.crashed("ex0")
    for (out, rep), want in zip(outs, wants):
        assert out.device.type == "cuda" and torch.equal(out.cpu(), want)
        assert rep.restarts == 1 and rep.groups == cfg.num_groups
    resumed = "steps=4+0" if every == 1 else "steps=3+1"
    assert sorted(fleet.events) == ["dead@ex0:InjectedExecutorFailure",
                                    f"recover@s0->ex1:{resumed}", f"recover@s1->ex1:{resumed}"]


@FLEET_FILTERS
def test_fleet_migration_on_the_card_lands_on_it_and_equals_run_pipelined(cuda, tmp_path,
                                                                          extra):
    import threading

    from repro_torch.denoise.base import tree_leaves
    from repro_torch.serve import FleetScheduler, Session

    arrived = []

    class Recording(FleetScheduler):
        def _on_migrate(self, ex, act):
            super()._on_migrate(ex, act)
            arrived.extend(t.device for t in tree_leaves(act.resume_state)[0])

    cfg = _fleet_cfg(**extra)
    groups, other = (list(PrismSource(cfg, seed=s).groups()) for s in (4, 5))
    wants = [streaming.run_pipelined(cfg, iter(g))[0].cpu() for g in (groups, other)]
    gate, fed = threading.Event(), threading.Event()

    def src():
        yield from groups[:2]
        fed.set()
        assert gate.wait(60)
        yield from groups[2:]

    with Recording(checkpoint_dir=str(tmp_path), slots_per_executor=2,
                   max_executors=2) as fleet:
        h = fleet.submit(Session(config=cfg, source=src(), name="m0"))
        hb = fleet.submit(Session(config=cfg, source=iter(other), name="m1"))
        assert fed.wait(60)
        assert fleet.migrate(h, timeout=60) == "ex1"
        gate.set()
        outs = [h.result(timeout=120), hb.result(timeout=120)]
    assert arrived and all(d == torch.device("cuda", 0) for d in arrived)
    assert [rep.migrations for _, rep in outs] == [1, 0]
    for (out, _), want in zip(outs, wants):
        assert torch.equal(out.cpu(), want)


@FLEET_FILTERS
def test_fleet_checkpoint_at_fold_k_is_the_state_of_fold_k(cuda, tmp_path, extra):
    """Every checkpoint the fleet takes on its executor thread holds the
    state the step of that fold wrote on the card, bitwise."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.denoise.base import tree_leaves
    from repro_torch.serve import FleetScheduler, Session

    cfg = _fleet_cfg(**extra)
    groups = list(PrismSource(cfg, seed=6).groups())
    with FleetScheduler(checkpoint_dir=str(tmp_path), checkpoint_keep=cfg.num_groups,
                        slots_per_executor=1, max_executors=1) as fleet:
        fleet.submit(Session(config=cfg, source=iter(groups), name="c")).result(timeout=120)
    mgr = CheckpointManager(str(tmp_path / "c"), keep=cfg.num_groups)
    assert mgr.steps() == list(range(1, cfg.num_groups + 1))
    filt, state = banks.banked_filter_init(cfg, None, banks=1)
    sub = filt.slot_extract(state, 0)
    for k, g in enumerate(groups, start=1):
        sub = filt.step(sub, torch.from_numpy(g).to(cuda), step_index=k - 1)
        saved, step = mgr.restore(k, device="cuda")
        assert step == k
        for got, want in zip(tree_leaves(saved)[0], tree_leaves(sub)[0]):
            assert got.device.type == "cuda" and got.dtype == want.dtype
            assert torch.equal(got, want)


def test_elastic_reshard_on_the_card_is_bit_exact(cuda):
    from repro_torch.runtime.elastic import available_mesh, elastic_reshard, state_spec_tree

    rng = np.random.default_rng(9)
    state = {"mean": torch.from_numpy(rng.standard_normal((8, 80, 256)).astype(np.float32))
             .to(cuda), "count": torch.tensor(7, dtype=torch.int32, device=cuda)}
    mesh = available_mesh()
    assert mesh.devices[0] == torch.device("cuda", 0)
    moved = elastic_reshard(state, state_spec_tree(state), banks.BankMesh(("cuda:0",)))
    for k in state:
        assert moved[k].device == torch.device("cuda", 0) and torch.equal(moved[k], state[k])
    banked = torch.arange(4 * 6, dtype=torch.float32, device=cuda).reshape(4, 6)
    shards = elastic_reshard(banked, state_spec_tree(banked, axes={0: "bank"}),
                             banks.BankMesh(("cuda:0", "cuda:0")))
    assert torch.equal(torch.cat(shards), banked)


# ---------------------------------------------------------------------------
# Launch geometry: every tile a plan can give a row-tiled launcher.
# ---------------------------------------------------------------------------

#: kernel path -> (family in the launch model, wire format, vector path)
GEOMETRY_CASES = {
    "B2-vector-u16": ("stream", "u16", True),
    "B2-scalar-p12": ("stream", "p12", False),
    "B2-scalar-unaligned-u8": ("stream", "u8", False),
    "B2-int32": ("stream", "u16", False),
    "B4-vector-u8": ("stream", "u8", True),
    "B3-u16": ("stream", "u16", False),
    "B3-int32": ("stream", "u16", False),
    "B5-p12": ("stream", "p12", False),
    "B6-u16": ("median_insert", "u16", False),
    "B6-p12": ("median_insert", "p12", False),
    "B10-alg1": ("stream", "u16", False),
    "B10-alg2": ("stream", "u16", False),
}


def _geometry_call(case, frames, device, tiles):
    """Run ``case``'s kernel (``device`` = "cpu": its plain version) at
    ``tiles`` on a fresh state; returns the result."""
    kw = dict(offset=4096.0, stream_dtype=GEOMETRY_CASES[case][1], **tiles)
    f = frames.to(device)
    if case.startswith(("B2", "B4")):
        one = f[0, 0] if case.startswith("B2") else f[:, 0].contiguous()
        if case.endswith("unaligned-u8") and device != "cpu":
            one = _shifted(one, device)
        n, h, wp = one.shape[-3:]
        acc = torch.int32 if case.endswith("int32") else torch.float32
        s = torch.zeros(one.shape[:-3] + (n // 2, h, quant.logical_width(wp, kw["stream_dtype"])),
                        dtype=acc, device=device)
        fn = denoise_stream.alg3_stream_step if case.startswith("B2") else \
            denoise_multibank.multibank_stream_step
        return fn(one, s, num_groups=3, final=True, **kw)
    if case.startswith("B3"):
        acc = torch.int32 if case.endswith("int32") else torch.float32
        return denoise_stream.alg3_subtract_average(f[0], accum_dtype=acc, **kw)
    if case.startswith("B5"):
        return denoise_multibank.multibank_subtract_average(f, **kw)
    if case.startswith("B6"):
        one = f[0, 0]
        n, h, wp = one.shape
        window = torch.zeros(2, n // 2, h, quant.logical_width(wp, kw["stream_dtype"]),
                             device=device)
        return denoise_median.median_window_insert(window, one, slot=1, **kw)
    kw.pop("stream_dtype")
    fn = denoise_tmpframe.alg1_subtract_average if case == "B10-alg1" else \
        denoise_tmpframe.alg2_subtract_average
    return fn(f[0], **kw)


@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
@pytest.mark.parametrize("shape", [(1000, 80, 256), (14, 40, 132)], ids=["paper", "partial"])
def test_every_admitted_geometry_bitwise_equal_plain(cuda, case, shape):
    # At the paper's shape every geometry the launch model admits; on 40 x
    # 132 (660 vectors a plane: a share of row_tile x 132 pixels leaves the
    # last block of a plane partial, and 132 columns a partial warp) every
    # pair of exact divisors, as a plan file may name them.
    from repro_torch.tune import budget

    family, fmt, vector = GEOMETRY_CASES[case]
    n, h, w = shape
    px = np.random.default_rng(n + h).integers(0, 4096, (2, 3, n, h, w)).astype(np.uint16)
    frames = torch.from_numpy(np.ascontiguousarray(quant.encode(px, fmt)))
    want = _geometry_call(case, frames, "cpu", {}).to(cuda)
    if shape[0] == 1000:
        geoms = budget.admitted_tiles(family, n // 2, h, w, stream_dtype=fmt, vector=vector,
                                      limits=budget.device_limits(cuda))
    else:
        geoms = [(None, None)] + [(th, tp) for th in range(1, h + 1) if h % th == 0
                                  for tp in range(1, n // 2 + 1) if (n // 2) % tp == 0]
    assert len(geoms) > 1
    b2 = denoise_stream.alg3_stream_step
    paths = (b2.vector_launches, b2.scalar_launches)
    for th, tp in geoms:
        got = _geometry_call(case, frames, cuda, dict(row_tile=th, pair_tile=tp))
        assert torch.equal(got, want), (case, shape, th, tp)
    if case.startswith("B2"):  # every geometry on the path the case names
        taken = (b2.vector_launches - paths[0], b2.scalar_launches - paths[1])
        assert taken == ((len(geoms), 0) if vector else (0, len(geoms)))
