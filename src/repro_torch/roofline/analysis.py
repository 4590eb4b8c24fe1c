"""Three-term roofline of one step on the card (counterpart of
``repro.roofline.analysis``).

  compute term    = counted FLOPs / the card's peak bfloat16 FLOP/s
  memory term     = counted bytes / the card's HBM bytes/s
  collective term = 0

The memory term reads the operator traffic of the eager implementation
(``op_costs``' ``bytes``): what this code moves, which falls whenever
operators fuse. So the terms size and compare implementations, and their
maximum is no bound. A step's bound is :func:`step_bound`: its counted
products against the bytes it must move (``io_bytes``: each input read
once, each output written once).

The FLOPs and bytes come from :func:`repro_torch.roofline.op_costs.analyze`
(the operators a step dispatches), read against ``launch.mesh.HW``: one
NVIDIA H100 80GB HBM3 at 700 W, 989 TFLOP/s dense bfloat16 and 3.35 TB/s.
The port runs a step on one card and dispatches no collective, and ``HW``
has no link bandwidth, so the collective term is 0; meshes over several
cards are ROADMAP.md queue A item 13(d).

The reference's ``parse_hlo_bytes`` and ``collective_bytes`` read the
collectives out of XLA's optimized HLO text. The port compiles no HLO
(PyTorch runs the step eagerly), so they have no counterpart here.
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import HW

__all__ = ["RooflineTerms", "roofline_terms", "roofline_terms_corrected", "step_bound",
           "model_flops", "summarize_cell"]


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    coll_bytes: int

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower bound: perfectly-overlapped terms -> max; report max."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def asdict(self):
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.coll_bytes,
        }


def roofline_terms(cost: dict, *, links: float = 1.0) -> RooflineTerms:
    """Terms from ``op_costs.analyze``'s dict. ``links`` is the reference's
    argument; with no collective it scales nothing."""
    return RooflineTerms(
        compute_s=cost["flops"] / HW.PEAK_BF16_FLOPS,
        memory_s=cost["bytes"] / HW.HBM_BW,
        collective_s=0.0,
        flops=cost["flops"],
        bytes_accessed=cost["bytes"],
        coll_bytes=int(sum(cost["collectives"].values())),
    )


def roofline_terms_corrected(corrected: dict, *, links: float = 1.0) -> RooflineTerms:
    """The reference's name for the terms of a loop-aware count; an eager
    count needs no loop correction, so this is :func:`roofline_terms`."""
    return roofline_terms(corrected, links=links)


def step_bound(cost: dict) -> tuple[float, str]:
    """The least time the card could take for ``op_costs.analyze``'s call:
    the larger of its products at the bfloat16 peak and its ``io_bytes``
    at the HBM rate, and which of the two (``"operations"`` or
    ``"bytes"``) sets it."""
    compute_s = cost["flops"] / HW.PEAK_BF16_FLOPS
    io_s = cost["io_bytes"] / HW.HBM_BW
    return max(compute_s, io_s), "operations" if compute_s >= io_s else "bytes"


def model_flops(n_params: int, tokens: int, *, train: bool) -> float:
    """6·N·D for training (fwd 2ND + bwd 4ND), 2·N·D for inference."""
    return (6.0 if train else 2.0) * n_params * tokens


def summarize_cell(record: dict) -> str:
    t = record["roofline"]
    return (
        f"{record['arch']:24s} {record['shape']:12s} {record['mesh']:10s} "
        f"C={t['compute_s']:.3e}s M={t['memory_s']:.3e}s "
        f"X={t['collective_s']:.3e}s dom={t['dominant']:10s} "
        f"useful={record.get('useful_flops_ratio', 0):.2f}"
    )
