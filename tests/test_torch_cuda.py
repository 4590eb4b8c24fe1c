"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where there is no CUDA device (the CPU
suite holds the plain versions to the JAX reference instead). Run them on
a machine with the card (``--noconftest``: the repo's ``conftest.py``
imports the JAX package, which that machine need not have)::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bitwise (the kernels round as the plain versions do).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import streaming
from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser
from repro_torch.data.prism import PrismSource
from repro_torch.kernels import denoise_multibank, denoise_stream, quant

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _wire(shape, fmt, seed):
    px = np.random.default_rng(seed).integers(0, 4096, shape + (256,)).astype(np.uint16)
    return torch.from_numpy(np.ascontiguousarray(quant.encode(px, fmt)))


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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    s = torch.zeros(4, 8, 256, device=cuda)
    with pytest.raises(NotImplementedError, match="float32"):
        denoise_stream.alg3_stream_step(
            torch.zeros(8, 8, 256, dtype=torch.uint16, device=cuda),
            s.to(torch.int32), num_groups=2)
    with pytest.raises(TypeError):
        denoise_stream.alg3_stream_step(torch.zeros(8, 8, 256, device=cuda), s, num_groups=2)
    with pytest.raises(NotImplementedError, match="B10"):
        from repro_torch.kernels import ops

        ops.subtract_average(torch.zeros(2, 8, 8, 256, dtype=torch.uint16, device=cuda),
                             algorithm="alg1")


def test_executors_on_the_card_match_cpu(cuda):
    cfg = DenoiseConfig(num_groups=3, frames_per_group=16, height=80, width=256)
    want = StreamingDenoiser(cfg, device="cpu").run(PrismSource(cfg, seed=1).groups())
    before = denoise_stream.alg3_stream_step.launches
    for depth in (1, 2, 3):
        out, _ = streaming.run_pipelined(cfg, PrismSource(cfg, seed=1).groups(), num_slots=depth)
        assert torch.equal(out.cpu(), want)
    assert denoise_stream.alg3_stream_step.launches - before == 3 * cfg.num_groups
