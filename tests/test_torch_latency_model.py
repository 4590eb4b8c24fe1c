"""Port parity of the paper §6 analytic latency model
(``repro_torch.core.latency_model``, a copy of ``repro.core.latency_model``):
every public function returns exactly what the reference returns, for the
paper's constants and for other shapes.

Tolerance: equal (``==``), the same floats.
"""

import dataclasses

import pytest

from repro.core import latency_model as jlm
from repro_torch.core import latency_model as lm

ALGORITHMS = ("alg1", "alg2", "alg3")
SHAPES = [
    dict(),  # the paper's: 80 x 256, G = 8, N = 1000, 57 us
    dict(height=16, width=64, groups=3, frames_per_group=20),
    dict(groups=12, frames_per_group=500, inter_frame_us=40.0, clock_ns=4.0),
]


def _constants(kw):
    return lm.PaperConstants(**kw), jlm.PaperConstants(**kw)


def test_same_public_surface():
    assert lm.__all__ == jlm.__all__
    assert [f.name for f in dataclasses.fields(lm.PaperConstants)] == [
        f.name for f in dataclasses.fields(jlm.PaperConstants)
    ]


@pytest.mark.parametrize("kw", SHAPES, ids=["paper", "small", "g12"])
def test_constants_properties_equal(kw):
    c, jc = _constants(kw)
    assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    assert c.packets_per_frame == jc.packets_per_frame
    assert c.us_per_cycle == jc.us_per_cycle


@pytest.mark.parametrize("kw", SHAPES, ids=["paper", "small", "g12"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_frame_latencies_and_total_time_equal(algorithm, kw):
    c, jc = _constants(kw)
    assert lm.frame_latencies_us(algorithm, c) == jlm.frame_latencies_us(algorithm, jc)
    assert lm.total_time_s(algorithm, c) == jlm.total_time_s(algorithm, jc)


@pytest.mark.parametrize("measured", [0.5734, 0.456, 0.6, 2.0])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_effective_initiation_interval_equal(algorithm, measured):
    c, jc = _constants({})
    assert lm.effective_initiation_interval(measured, algorithm, c) == (
        jlm.effective_initiation_interval(measured, algorithm, jc)
    )


@pytest.mark.parametrize(
    "kw",
    [
        dict(sessions=1, slots_per_executor=1),
        dict(sessions=9, slots_per_executor=4),
        dict(sessions=9, slots_per_executor=4, group_rate_hz=5.0),
        dict(sessions=7, slots_per_executor=2, group_rate_hz=40.0, target_headroom=1.5),
        dict(sessions=0, slots_per_executor=3, algorithm="alg1"),
    ],
)
def test_capacity_plan_equal(kw):
    assert lm.capacity_plan(**kw) == jlm.capacity_plan(**kw)


@pytest.mark.parametrize(
    "kw",
    [
        dict(sessions=-1, slots_per_executor=2),
        dict(sessions=2, slots_per_executor=0),
        dict(sessions=2, slots_per_executor=2, target_headroom=0.0),
        dict(sessions=2, slots_per_executor=2, group_rate_hz=-1.0),
    ],
)
def test_capacity_plan_errors_equal(kw):
    with pytest.raises(Exception) as want:
        jlm.capacity_plan(**kw)
    with pytest.raises(want.type) as got:
        lm.capacity_plan(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("in_bytes,accum_bytes", [(2, 4), (1, 4), (2, 2)])
def test_traffic_and_roofline_equal(algorithm, in_bytes, accum_bytes):
    shape = dict(groups=8, frames_per_group=1000, height=80, width=256)
    assert lm.hbm_traffic_bytes(algorithm, in_bytes=in_bytes, accum_bytes=accum_bytes, **shape) == (
        jlm.hbm_traffic_bytes(algorithm, in_bytes=in_bytes, accum_bytes=accum_bytes, **shape)
    )
    assert lm.tpu_denoise_roofline_s(algorithm) == jlm.tpu_denoise_roofline_s(algorithm)
    assert lm.tpu_denoise_roofline_s(algorithm, hbm_gbps=3350.0, groups=3) == (
        jlm.tpu_denoise_roofline_s(algorithm, hbm_gbps=3350.0, groups=3)
    )
