"""Compressed egress: the device->host half of the bandwidth tier
(counterpart of ``repro.core.egress``).

Ingest moves raw frames host->device; egress moves denoised partial
estimates device->host every group (the paper's frame-grabber readback
path, ``DownloadConsumer``). At the paper's scale that readback is
float32, 2x the raw mono12 wire, so it is the other bandwidth lever.

:class:`CompressedEgress` is a drop-in for any ``consumer(step, partial)``
slot (``run_pipelined``'s consumer stage, a serve ``Session.consumer``
hook). It compresses each partial on the partial's own device with
``repro_torch.optim.compress`` and keeps host numpy copies of what
crossed the wire:

* ``kind="int8"`` — symmetric per-group int8 quantization. One float32
  scale per packet (the group's amax/127), so every group decodes alone;
  the reconstruction error is at most ``scale/2`` a pixel.
* ``kind="topk"`` — magnitude top-k of the centred partial: the estimate
  is ``offset + signal`` with most pixels near the offset, so centring
  first concentrates what the top-k keeps. Kept pixels reconstruct
  exactly; dropped ones decode to ``center``.
* ``kind="none"`` — uncompressed float32 packets (the baseline; byte
  accounting only, the payload round-trips bit-exactly).

``decompress(i)`` exactly inverts the wire format of packet ``i``: it
returns what was *sent*, not the partial before compression.
``wire_bytes``/``raw_bytes``/``reduction`` give the byte accounting.
Packets are bitwise the reference's for the same partials.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.optim.compress import int8_compress, topk_compress, topk_decompress

__all__ = ["EGRESS_KINDS", "EgressPacket", "CompressedEgress"]

EGRESS_KINDS = ("none", "int8", "topk")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class EgressPacket:
    """One compressed per-group partial as it crossed the wire.

    ``payload`` holds host copies of exactly what was transferred:
    ``(q,)`` int8 values for ``"int8"`` (plus the float32 ``scale``
    field), ``(vals, idx)`` for ``"topk"``, the raw float32 array for
    ``"none"``.
    """

    step: int
    kind: str
    shape: tuple
    payload: tuple
    scale: float = 0.0
    center: float = 0.0

    @property
    def raw_bytes(self) -> int:
        """float32 bytes an uncompressed download of this partial would move."""
        return int(np.prod(self.shape)) * 4

    @property
    def wire_bytes(self) -> int:
        if self.kind == "int8":
            return self.payload[0].size + 4  # int8 values + one float32 scale
        if self.kind == "topk":
            return self.payload[0].size * 8  # float32 value + int32 index
        return self.raw_bytes

    def decompress(self) -> np.ndarray:
        """Exact inverse of the wire format: the estimate as sent."""
        if self.kind == "int8":
            q = self.payload[0]
            return (
                q.astype(np.float32) * np.float32(self.scale)
                + np.float32(self.center)
            ).reshape(self.shape)
        if self.kind == "topk":
            vals, idx = self.payload
            dense = topk_decompress(
                torch.from_numpy(vals), torch.from_numpy(idx), (int(np.prod(self.shape)),)
            )
            return _host(dense).reshape(self.shape) + np.float32(self.center)
        return self.payload[0].reshape(self.shape)  # "none": sent uncentred


class CompressedEgress:
    """Compressing ``consumer(step, partial)`` stage (see module docstring).

    ``center`` is subtracted before compression and restored on decode —
    pass the config's ``offset`` so both schemes see a zero-centred
    signal. ``k_fraction`` is the top-k keep ratio (ignored for int8).
    """

    def __init__(
        self,
        kind: str = "int8",
        *,
        center: float = 0.0,
        k_fraction: float = 0.05,
    ):
        if kind not in EGRESS_KINDS:
            raise ValueError(
                f"egress kind must be one of {EGRESS_KINDS}, got {kind!r}"
            )
        if not 0.0 < k_fraction <= 1.0:
            raise ValueError(f"k_fraction must be in (0, 1], got {k_fraction}")
        self.kind = kind
        self.center = float(center)
        self.k_fraction = float(k_fraction)
        self.packets: list[EgressPacket] = []

    def __call__(self, step: int, partial) -> None:
        x = torch.as_tensor(partial).to(torch.float32)
        if self.kind != "none":  # "none" skips centring: bit-exact payload
            x = x - torch.tensor(self.center, dtype=torch.float32, device=x.device)
        shape = tuple(x.shape)
        if self.kind == "int8":
            q, scale = int8_compress(x)
            pkt = EgressPacket(
                step=step,
                kind=self.kind,
                shape=shape,
                payload=(_host(q),),
                scale=float(scale),
                center=self.center,
            )
        elif self.kind == "topk":
            k = max(1, int(x.numel() * self.k_fraction))
            vals, idx = topk_compress(x.reshape(-1), k)
            pkt = EgressPacket(
                step=step,
                kind=self.kind,
                shape=shape,
                payload=(_host(vals), _host(idx)),
                center=self.center,
            )
        else:
            pkt = EgressPacket(
                step=step,
                kind=self.kind,
                shape=shape,
                payload=(_host(x).copy(),),
                center=self.center,
            )
        self.packets.append(pkt)

    def decompress(self, index: int = -1) -> np.ndarray:
        """Decoded estimate of packet ``index`` (default: the latest)."""
        return self.packets[index].decompress()

    @property
    def raw_bytes(self) -> int:
        return sum(p.raw_bytes for p in self.packets)

    @property
    def wire_bytes(self) -> int:
        return sum(p.wire_bytes for p in self.packets)

    @property
    def reduction(self) -> float:
        """Raw/wire byte ratio over everything egressed so far (>= 1)."""
        return self.raw_bytes / self.wire_bytes if self.wire_bytes else 0.0
