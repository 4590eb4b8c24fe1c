"""Hand-written Hopper kernels and their plain PyTorch versions.

``ops`` is the entry point; ``denoise_stream`` / ``denoise_multibank``
wrap the CUDA kernels of ``csrc/denoise_stream.cu`` (built by ``_build``
at first use); ``quant`` and ``ref`` hold the wire formats and the plain
oracles.
"""
