"""Synthetic PRISM acquisition source (paper §5 hardware emulation).

A copy of ``repro.data.prism``: the same seed gives byte-identical frames
in both packages, so the port and the reference can be fed one stream.

Emulates the paper's validation rig: a Phantom-style camera imaging a fixed
screen pattern lit by two LEDs — one sine-modulated (the transient
"excitation" signal), one static (ambient noise) — plus shot noise. Frames
alternate control/excitation exactly as PRISM scans do, in mono12-in-u16
containers, streamed group by group.

Beyond the paper's rig, ``noise_regime`` adds sensor-defect models so the
SNR harness of the reference (``benchmarks/table10_filter_zoo.py``) can show where each
streaming filter wins:

* ``"none"``     — the paper's rig exactly (default; byte-identical to the
  pre-regime generator — the regime machinery draws no RNG in this mode).
* ``"hot_pixels"`` — a fixed, seed-deterministic set of stuck-high pixels
  (wrong in *every* frame: only spatial filtering repairs them).
* ``"impulse"``  — per-frame cosmic-ray/salt spikes at random pixels
  (one-group transients: rank filtering rejects them, averaging smears).
* ``"drift"``    — slow sinusoidal sensor-baseline drift across the whole
  acquisition (recency weighting tracks it, the flat mean averages
  against it).

The generator is deterministic given a seed, pure numpy (host-side, like a
frame grabber), and cheap enough to run at benchmark rates. Regime
corruption uses dedicated RNG streams (offset from ``seed``), so the base
frame stream is identical across regimes and per-bank iterators stay
consistent with ``banked_groups`` slices.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.core.denoise import MONO12_MAX, DenoiseConfig
from repro_torch.kernels import quant

__all__ = ["PrismSource", "NOISE_REGIMES", "snr_db"]

NOISE_REGIMES = ("none", "hot_pixels", "impulse", "drift")

# seed offsets for the dedicated regime RNG streams (keeps the base frame
# stream byte-identical across regimes, and bank b's streams disjoint)
_REGIME_SEED = 7_000_003
_HOT_SEED = 9_000_017


@dataclasses.dataclass
class PrismSource:
    config: DenoiseConfig
    seed: int = 0
    signal_amplitude: float = 300.0   # paper Fig. 8: 300 mV drive
    signal_period_frames: float = 50.0  # sine-modulated LED
    ambient_level: float = 400.0      # static LED (background noise source)
    ambient_on: bool = True
    shot_noise_std: float = 25.0
    baseline: float = 800.0
    # -- sensor-defect regimes (see module docstring) -----------------------
    noise_regime: str = "none"
    hot_pixel_fraction: float = 0.002   # share of stuck-high pixels
    hot_pixel_level: float = float(MONO12_MAX)
    impulse_rate: float = 0.002         # spike prob per pixel per frame
    impulse_amplitude: float = 1800.0
    drift_amplitude: float = 150.0      # slow baseline wander (DN)
    drift_period_frames: float = 3000.0

    def __post_init__(self):
        if self.noise_regime not in NOISE_REGIMES:
            raise ValueError(
                f"noise_regime must be one of {NOISE_REGIMES}, got "
                f"{self.noise_regime!r}"
            )

    def _pattern(self) -> np.ndarray:
        """Fixed screen pattern (checkerboard + gradient, like a test chart)."""
        c = self.config
        y = np.linspace(0.0, 1.0, c.height)[:, None]
        x = np.linspace(0.0, 1.0, c.width)[None, :]
        checker = ((np.floor(y * 8) + np.floor(x * 16)) % 2).astype(np.float64)
        return 0.5 + 0.35 * checker + 0.15 * x

    def true_signal(self) -> np.ndarray:
        """Noise-free expected output of the denoiser (for SNR validation).

        Per pair k, the excitation frame adds amplitude·|sin|·pattern; the
        denoiser output is offset + mean over groups of that increment.
        """
        c = self.config
        pat = self._pattern()
        k = np.arange(c.pairs_per_group, dtype=np.float64)
        phase = np.abs(np.sin(2 * np.pi * (2 * k + 1) / self.signal_period_frames))
        return (
            c.offset
            + self.signal_amplitude * phase[:, None, None] * pat[None, :, :]
        )

    def _group(
        self,
        rng: np.random.Generator,
        regime_rng: np.random.Generator | None = None,
        start_frame: int = 0,
        hot_mask: np.ndarray | None = None,
    ) -> np.ndarray:
        """Synthesize one (N, H, W) group, fully vectorized.

        Per-frame luminance is (base + amplitude·|sin|)·pattern — an outer
        product of a per-frame scalar with the fixed pattern — so the whole
        group is one broadcast plus one batched normal draw (f32: the
        mono12 quantization makes f64 noise indistinguishable). The old
        per-frame Python loop cost ~1.2 s/group at paper scale and
        serialized the acquisition path this PR overlaps with compute.

        Regime corruption (``regime_rng``/``start_frame``/``hot_mask``) is
        applied to the float frames before quantization; with the default
        ``noise_regime="none"`` this path is never entered and the output
        is byte-identical to the pre-regime generator.
        """
        c = self.config
        i = np.arange(c.frames_per_group, dtype=np.float32)
        level = np.full(c.frames_per_group, self.baseline, np.float32)
        if self.ambient_on:
            level += self.ambient_level
        phase = np.abs(np.sin(2 * np.pi * i / self.signal_period_frames))
        level += np.where(
            i % 2 == 1, self.signal_amplitude * phase, 0.0
        ).astype(np.float32)
        frames = level[:, None, None] * self._pattern().astype(np.float32)
        frames += rng.standard_normal(frames.shape, np.float32) * self.shot_noise_std
        if self.noise_regime == "impulse":
            spikes = regime_rng.random(frames.shape, dtype=np.float32)
            frames += np.where(
                spikes < self.impulse_rate, self.impulse_amplitude, 0.0
            ).astype(np.float32)
        elif self.noise_regime == "drift":
            t = start_frame + i
            frames += (
                self.drift_amplitude
                * np.sin(2 * np.pi * t / self.drift_period_frames)
            ).astype(np.float32)[:, None, None]
        elif self.noise_regime == "hot_pixels":
            frames[:, hot_mask] = self.hot_pixel_level
        mono12 = np.clip(np.round(frames), 0, MONO12_MAX).astype(np.uint16)
        # wire-format hook: every source path (groups / banked_groups /
        # bank_source / all_frames) funnels through here, so the config's
        # stream_dtype decides the container exactly once. "u16" is a
        # no-copy passthrough — byte-identical to the pre-tier source.
        return quant.encode(mono12, getattr(c, "stream_dtype", "u16"))

    def _regime_state(self, bank: int):
        """Dedicated RNG stream + stuck-pixel mask for one bank's iterator."""
        if self.noise_regime == "none":
            return None, None
        regime_rng = np.random.default_rng(self.seed + bank + _REGIME_SEED)
        hot_mask = None
        if self.noise_regime == "hot_pixels":
            c = self.config
            hot_rng = np.random.default_rng(self.seed + bank + _HOT_SEED)
            hot_mask = hot_rng.random((c.height, c.width)) < self.hot_pixel_fraction
        return regime_rng, hot_mask

    def groups(self) -> Iterator[np.ndarray]:
        """Yield G arrays of (N, H, W) wire-format frames (u16 default)."""
        rng = np.random.default_rng(self.seed)
        regime_rng, hot_mask = self._regime_state(0)
        n = self.config.frames_per_group
        for g in range(self.config.num_groups):
            yield self._group(rng, regime_rng, g * n, hot_mask)

    def banked_groups(self, num_banks: int | None = None) -> Iterator[np.ndarray]:
        """Yield G arrays of (B, N, H, W) u16 frames — one bank per camera.

        Bank b draws from an independent stream seeded ``seed + b`` (the
        paper's banks are disjoint pixel regions of one sensor; independent
        noise per bank is the matching statistical model). Regime streams
        are per bank too, so slices match ``bank_source``.
        """
        c = self.config
        b = num_banks or c.num_banks
        rngs = [np.random.default_rng(self.seed + i) for i in range(b)]
        regimes = [self._regime_state(i) for i in range(b)]
        n = c.frames_per_group
        for g in range(c.num_groups):
            yield np.stack(
                [
                    self._group(r, rr, g * n, hm)
                    for r, (rr, hm) in zip(rngs, regimes)
                ]
            )

    def bank_source(self, bank: int) -> Iterator[np.ndarray]:
        """Yield bank ``bank``'s G groups of (N, H, W) frames, standalone.

        Hook for the ring-pipelined executors: each bank's acquisition
        thread pulls from its own iterator. Per-bank streams are seeded
        ``seed + bank``, so ``bank_source(b)`` yields exactly the ``[b]``
        slice of ``banked_groups`` — one camera pulled independently.
        """
        rng = np.random.default_rng(self.seed + bank)
        regime_rng, hot_mask = self._regime_state(bank)
        n = self.config.frames_per_group
        for g in range(self.config.num_groups):
            yield self._group(rng, regime_rng, g * n, hot_mask)

    def bank_sources(self, num_banks: int | None = None) -> list[Iterator[np.ndarray]]:
        """One independent per-bank iterator per camera (see ``bank_source``).

        Feeds a per-bank executor (the reference's
        ``repro.core.banks.run_pipelined_banked``): one ring per bank,
        one of these iterators per ring.
        """
        b = num_banks or self.config.num_banks
        return [self.bank_source(i) for i in range(b)]

    def all_frames(self) -> np.ndarray:
        """(G, N, H, W) wire containers — the buffered-acquisition view."""
        return np.stack(list(self.groups()))


def snr_db(denoised: np.ndarray, truth: np.ndarray) -> float:
    """SNR of the denoiser output against the noise-free expectation."""
    signal = np.asarray(truth, np.float64) - truth.mean()
    err = np.asarray(denoised, np.float64) - np.asarray(truth, np.float64)
    return 10.0 * np.log10((signal**2).mean() / max((err**2).mean(), 1e-12))
