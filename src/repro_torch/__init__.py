"""repro_torch — the PyTorch/CUDA port of the PRISM denoising system.

A package beside the JAX reference ``repro`` that mirrors its module paths
and public names, so the counterpart of any module is easy to find. It
imports torch and numpy, never jax and never ``repro``. Entry points run
on a CUDA device unless the caller passes ``device=`` (``"cpu"`` runs the
kernels' plain PyTorch versions), and the hot kernels are hand-written
CUDA for Hopper (``repro_torch/kernels/csrc``), built with nvcc at first
use.

This slice ports the main path: ``PrismSource`` -> ``DenoiseConfig`` /
``StreamingDenoiser`` with the ``pair_average`` filter (Alg 3 and
Alg 3 v2, single-bank and banked) -> ``run_inline`` / ``run_pipelined`` /
``run_buffered``. ``convert`` carries configs and running sums between
the two packages.
"""

import torch as _torch

#: The float functions PyTorch's CPU build hands to MKL's VML
#: (``ATen/cpu/vml.h``), each asked for in high accuracy (``VML_HA``).
_VML_FUNCTIONS = ("acos", "asin", "atan", "cos", "erf", "erfc", "erfinv", "exp", "log",
                  "log10", "log2", "sin", "sqrt", "tan", "tanh", "trunc")


def _settle_vml() -> None:
    """Call each VML function once, on one element, on this thread.

    MKL picks a VML function's kernel at its first call in a process. When
    that first call comes from several threads at once (torch splits a
    large float tensor over its intra-op threads), the threads that arrive
    while the pick is under way compute their chunks with the
    low-accuracy kernel (``VML_EP``: ``torch.cos`` 1.5e-4 off at angles
    near 4200 rad), and every later call is exact. One single-threaded
    call first makes every call the high-accuracy one, so the port's CPU
    results (RoPE's ``cos`` and ``sin``, the bilateral's ``exp``) do not
    depend on which call of the process they are."""
    for dtype in (_torch.float32, _torch.float64):
        x = _torch.full((1,), 0.5, dtype=dtype)
        for name in _VML_FUNCTIONS:
            getattr(_torch, name)(x)


_settle_vml()
