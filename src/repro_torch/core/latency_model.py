"""Paper §6 analytic latency model, reproduced exactly (a copy of the
reference's ``repro.core.latency_model``).

The paper derives per-frame latencies for Algorithms 1-3 from AXI4 protocol
timing (Fig. 6) under these constants:

* FPGA clock: 2 ns;
* 128-bit stream width, mono12-in-u16 pixels -> 8 px/cycle, so a
  256×80 = 20480 px frame is 2560 packets -> 2560 cycles of core compute;
* single-beat AXI: ~8 cycles/read, ~9 cycles/write;
* burst AXI: ~9 cycles per 3 beats read, ~11 cycles per 3 beats written
  (amortized: the address/response handshake is paid once per burst, so a
  long burst costs ≈ 1 cycle/beat + small constants — the paper folds this
  into "+2/+4/+2"-style correction terms);
* camera inter-frame interval: 57 µs (17.5 kFPS).

We reproduce the paper's published numbers (5.12 / 51.2 / 291.84 / 10.256 /
15.388 / 10.252 µs; totals 0.5734 s, 0.456 s; effective II 41 / 13 / 1) and
reuse the same machinery to model our TPU kernels' HBM traffic (the roofline
memory term for the denoise stage).

Tests in ``tests/test_latency_model.py`` assert equality with the paper.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "PaperConstants",
    "capacity_plan",
    "frame_latencies_us",
    "total_time_s",
    "effective_initiation_interval",
    "hbm_traffic_bytes",
    "tpu_denoise_roofline_s",
]


@dataclasses.dataclass(frozen=True)
class PaperConstants:
    clock_ns: float = 2.0
    pixels_per_cycle: int = 8          # 128-bit width / 16-bit containers
    height: int = 80
    width: int = 256
    groups: int = 8                    # G
    frames_per_group: int = 1000       # N
    inter_frame_us: float = 57.0       # camera minimum cycle
    read_single_cycles: int = 8        # Fig. 6a
    write_single_cycles: int = 9       # Fig. 6c

    @property
    def packets_per_frame(self) -> int:
        return self.height * self.width // self.pixels_per_cycle  # 2560

    @property
    def us_per_cycle(self) -> float:
        return self.clock_ns / 1000.0


def frame_latencies_us(algorithm: str, c: PaperConstants = PaperConstants()):
    """Per-frame latency (µs) by phase, exactly as derived in paper §6.

    Returns a dict with keys among:
      odd            — odd (control) frames: no DRAM traffic
      even_body      — even frames in groups 1..G-1 (write phase)
      even_first     — Alg 3: first group (write-only)
      even_middle    — Alg 3: groups 2..G-1 (read+write)
      even_last      — final group (read/average phase)
    """
    p = c.packets_per_frame  # 2560
    odd = p * 2 / 1000.0     # 5.12 us: subtract/avg ops only

    if algorithm == "alg1":
        even_body = odd + p * c.write_single_cycles * 2 / 1000.0      # 51.2
        even_last = p * (c.groups - 1) * c.read_single_cycles * 2 / 1000.0 + odd
        return {"odd": odd, "even_body": even_body, "even_last": even_last}
    if algorithm == "alg2":
        # burst write: ~1 cycle/beat + (2+4+2) handshake correction
        even_body = odd + (p + 2 + 4 + 2) * 2 / 1000.0                # 10.256
        even_last = p * (c.groups - 1) * c.read_single_cycles * 2 / 1000.0 + odd
        return {"odd": odd, "even_body": even_body, "even_last": even_last}
    if algorithm in ("alg3", "alg3_v2"):
        burst_w = (p + 2 + 4 + 2) * 2 / 1000.0   # 5.136
        burst_r = (p + 4 + 2) * 2 / 1000.0       # 5.132
        even_first = odd + burst_w               # 10.256
        even_middle = burst_r + odd + burst_w    # 15.388
        even_last = burst_r + odd                # 10.252
        return {
            "odd": odd,
            "even_first": even_first,
            "even_middle": even_middle,
            "even_last": even_last,
        }
    raise ValueError(algorithm)


def total_time_s(algorithm: str, c: PaperConstants = PaperConstants()) -> float:
    """Paper's t̄ estimate over the whole acquisition (max(compute, camera))."""
    lat = frame_latencies_us(algorithm, c)
    odd_frames = c.groups * c.frames_per_group // 2        # 4000
    evens_per_group = c.frames_per_group // 2              # 500
    cam = c.inter_frame_us

    def gated(x: float) -> float:
        return max(x, cam)

    if algorithm in ("alg1", "alg2"):
        body = evens_per_group * (c.groups - 1)            # 3500
        total_us = (
            gated(lat["odd"]) * odd_frames
            + gated(lat["even_body"]) * body
            + lat["even_last"] * evens_per_group           # paper: NOT cam-gated
        )
    else:
        middle = evens_per_group * (c.groups - 2)          # 3000
        total_us = (
            gated(lat["odd"]) * odd_frames
            + gated(lat["even_first"]) * evens_per_group
            + gated(lat["even_middle"]) * middle
            + gated(lat["even_last"]) * evens_per_group
        )
    return total_us / 1e6


def effective_initiation_interval(
    measured_s: float, algorithm: str, c: PaperConstants = PaperConstants()
) -> float:
    """Paper §6: back out the achieved II from measured wall time.

    II ≈ (t_meas - t̄) · 1e9 / (clock_ns · total_frames · (packets-1))
    """
    gap_s = measured_s - total_time_s(algorithm, c)
    frames = c.groups * c.frames_per_group
    return gap_s * 1e9 / (c.clock_ns * frames * (c.packets_per_frame - 1))


def capacity_plan(
    *,
    sessions: int,
    slots_per_executor: int,
    group_rate_hz: float | None = None,
    algorithm: str = "alg3",
    c: PaperConstants = PaperConstants(),
    target_headroom: float = 1.0,
) -> dict:
    """Executor count needed to serve ``sessions`` camera-paced streams.

    The serve tier's capacity question in the paper's own terms: one
    executor steps ``slots_per_executor`` concurrent streams per banked
    device step, and the analytic model bounds how fast any stream can
    produce groups — the camera-gated per-group floor
    (``total_time_s / groups``, the same reference the health tier's
    headroom column divides by). ``group_rate_hz`` is each tenant's
    offered rate in groups/s; ``None`` means camera-paced (offered =
    sustainable, i.e. every slot fully busy). ``target_headroom`` > 1
    over-provisions by that factor (the autoscaler's safety margin).

    Returns the plan the autoscaler consumes::

        {"executors": E, "group_floor_s": ..., "sustainable_group_hz":
         ..., "demand_group_hz": ..., "per_executor_group_hz": ...,
         "headroom": ...}

    ``headroom`` is capacity/demand at the returned ``executors`` (>= 1
    by construction, except when demand is zero — then it is ``inf``).
    """
    if sessions < 0:
        raise ValueError(f"sessions must be >= 0, got {sessions}")
    if slots_per_executor < 1:
        raise ValueError(
            f"slots_per_executor must be >= 1, got {slots_per_executor}"
        )
    if group_rate_hz is not None and group_rate_hz < 0:
        raise ValueError(f"group_rate_hz must be >= 0, got {group_rate_hz}")
    if target_headroom <= 0:
        raise ValueError(f"target_headroom must be > 0, got {target_headroom}")
    group_floor_s = total_time_s(algorithm, c) / c.groups
    sustainable_hz = 1.0 / group_floor_s
    per_stream_hz = group_rate_hz if group_rate_hz is not None else sustainable_hz
    demand_hz = sessions * per_stream_hz
    per_executor_hz = slots_per_executor * sustainable_hz
    executors = (
        0
        if demand_hz == 0
        else max(1, math.ceil(target_headroom * demand_hz / per_executor_hz))
    )
    capacity_hz = executors * per_executor_hz
    return {
        "executors": executors,
        "group_floor_s": group_floor_s,
        "sustainable_group_hz": sustainable_hz,
        "demand_group_hz": demand_hz,
        "per_executor_group_hz": per_executor_hz,
        "headroom": capacity_hz / demand_hz if demand_hz else float("inf"),
    }


# ---------------------------------------------------------------------------
# TPU-side traffic/roofline model for the same computation.
# ---------------------------------------------------------------------------


def hbm_traffic_bytes(
    algorithm: str,
    *,
    groups: int,
    frames_per_group: int,
    height: int,
    width: int,
    in_bytes: int = 2,
    accum_bytes: int = 4,
) -> dict:
    """Element-exact HBM traffic per algorithm (the paper's DRAM counts).

    Alg 1/2: input read once + tmpFrame written and read once each.
    Alg 3:   input read once + output written once (+ per-group running-sum
             R/W when streaming group-by-group; one-shot fused kernel holds
             the sum in VMEM so those vanish — both reported).
    """
    g, n, h, w = groups, frames_per_group, height, width
    frame = h * w
    inputs = g * n * frame * in_bytes
    tmp = g * (n // 2) * frame * accum_bytes
    out = (n // 2) * frame * accum_bytes
    if algorithm in ("alg1", "alg2"):
        return {
            "read": inputs + tmp,
            "write": tmp + out,
            "total": inputs + 2 * tmp + out,
        }
    fused = {"read": inputs, "write": out, "total": inputs + out}
    streaming_sum_rw = 2 * (g - 1) * (n // 2) * frame * accum_bytes
    fused["streaming_total"] = fused["total"] + streaming_sum_rw
    return fused


def tpu_denoise_roofline_s(
    algorithm: str,
    *,
    groups: int = 8,
    frames_per_group: int = 1000,
    height: int = 80,
    width: int = 256,
    hbm_gbps: float = 819.0,
    flops_per_s: float = 197e12,
) -> dict:
    """Roofline terms for the denoise kernel on one TPU v5e chip."""
    t = hbm_traffic_bytes(
        algorithm,
        groups=groups,
        frames_per_group=frames_per_group,
        height=height,
        width=width,
    )
    flops = 2 * groups * (frames_per_group // 2) * height * width  # sub + add
    mem_s = t["total"] / (hbm_gbps * 1e9)
    comp_s = flops / flops_per_s
    return {
        "memory_s": mem_s,
        "compute_s": comp_s,
        "bound": "memory" if mem_s >= comp_s else "compute",
        "bytes": t["total"],
        "flops": flops,
    }
