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
