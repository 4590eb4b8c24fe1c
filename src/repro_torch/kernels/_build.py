"""Build and load the port's CUDA kernels (``csrc/denoise_stream.cu``).

The source compiles with one ``nvcc`` call into a shared library with a
plain C interface, loaded with ``ctypes``; nothing includes PyTorch's
headers, so a build takes seconds. The library goes to ``build/`` inside
this package directory (so an installed package builds beside its own
sources), named by a hash of the source and the flags: it is rebuilt only
when either changes, at the first kernel call.

There is deliberately no ``--use_fast_math``: the kernels' division and
FMA rounding is part of their contract with the reference, and they
write it with ``_rn`` intrinsics that no default flag can change.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCE", "BUILD_DIR", "NVCC_FLAGS", "library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "denoise_stream.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float

#: argtypes of every ``extern "C"`` launcher. Every pointer and the stream
#: are ``c_void_p``: ctypes would cut them to 32 bits else.
ARGTYPES = {
    "alg3_stream_step_launch":
        (_P, _P, _I64, _I64, _I64, _I64, _I, _I, _I, _F, _F, _F, _P),
    "multibank_stream_step_launch":
        (_P, _P, _I64, _I64, _I64, _I64, _I64, _I, _I, _I, _F, _F, _F, _P),
    "alg3_subtract_average_launch":
        (_P, _P, _I64, _I64, _I64, _I64, _I64, _I, _I, _F, _F, _F, _P),
    "multibank_subtract_average_launch":
        (_P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I, _F, _F, _F, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build(out: Path) -> None:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the repro_torch "
            "CUDA kernels are built from source on the machine with the card"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(
            f"CUDA kernel build failed: {SOURCE.name} (nvcc exit "
            f"{res.returncode}):\n{res.stdout}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders never see a torn file


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use if it is stale."""
    global _lib
    with _lock:
        if _lib is None:
            h = hashlib.sha256(SOURCE.read_bytes())
            h.update(" ".join(NVCC_FLAGS).encode())
            out = BUILD_DIR / f"{SOURCE.stem}.{h.hexdigest()[:16]}.so"
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            for name, argtypes in ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
