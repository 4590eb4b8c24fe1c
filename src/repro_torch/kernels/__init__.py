"""Hand-written Hopper kernels and their plain PyTorch versions.

``ops`` is the entry point; ``denoise_stream`` / ``denoise_multibank``
wrap the CUDA kernels of ``csrc/denoise_stream.cu``, and
``denoise_median``, ``denoise_ema`` and ``denoise_spatial`` those of the
``csrc`` source of the same name (all built by ``_build`` at first use,
with the shared dequantization prologue in ``csrc/quant.cuh``); ``quant``
and ``ref`` hold the wire formats and the plain oracles.
"""
