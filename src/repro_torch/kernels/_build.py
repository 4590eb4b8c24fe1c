"""Build and load the port's CUDA kernels (every ``csrc/*.cu``).

Each source compiles with its own ``nvcc -c`` call, all started together,
and one more ``nvcc`` call links the objects into a single shared library
with a plain C interface, loaded with ``ctypes``; nothing includes
PyTorch's headers, so a build takes seconds. The library goes to
``build/`` inside this package directory (so an installed package builds
beside its own sources), named by a hash over every file in ``csrc/``
(headers included) and the flags: it is rebuilt only when one of them
changes, at the first kernel call.

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
import tempfile
import threading
from pathlib import Path

__all__ = ["CSRC", "SOURCES", "BUILD_DIR", "NVCC_FLAGS", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
#: the kernel sources, one object each, linked into one library
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float

#: argtypes of every ``extern "C"`` launcher. Every pointer and the stream
#: are ``c_void_p``: ctypes would cut them to 32 bits else.
ARGTYPES = {
    "alg3_stream_step_launch":
        (_P, _P, _I64, _I64, _I64, _I64, _I, _I, _I, _I, _F, _F, _F, _I, _I64, _I64, _I64, _P),
    "multibank_stream_step_launch":
        (_P, _P, _I64, _I64, _I64, _I64, _I64, _I, _I, _I, _I, _F, _F, _F, _I, _I64, _I64, _I64,
         _P),
    "alg3_subtract_average_launch":
        (_P, _P, _I64, _I64, _I64, _I64, _I64, _I, _I, _F, _F, _F, _I, _I64, _I64, _P),
    "multibank_subtract_average_launch":
        (_P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I, _F, _F, _F, _I, _I64, _I64, _P),
    "median_window_insert_launch":
        (_P, _P, _I64, _I64, _I64, _I64, _I, _F, _F, _I64, _I64, _P),
    "median_combine_launch":
        (_P, _P, _I64, _I64, _P),
    "ema_welford_step_launch":
        (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I, _F, _F, _F, _F, _F, _F, _P),
    "spatial_filter_3x3_launch":
        (_P, _P, _I64, _I64, _I64, _I, _I, _F, _P),
    "tmpframe_subtract_launch":
        (_P, _P, _I64, _I64, _I64, _I, _F, _I, _I64, _I64, _P),
    "tmpframe_reduce_launch":
        (_P, _P, _I64, _I64, _I64, _I64, _F, _I, _I64, _I64, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the repro_torch "
            "CUDA kernels are built from source on the machine with the card"
        )
    return nvcc


def _check(returncode: int, output: str, what: str) -> None:
    if returncode != 0:
        raise RuntimeError(
            f"CUDA kernel build failed: {what} (nvcc exit {returncode}):\n{output}"
        )


def _build(out: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        # wait for every compile before reporting one, so none outlives us
        outputs = [proc.communicate()[0] for proc in procs]
        for src, proc, output in zip(SOURCES, procs, outputs):
            _check(proc.returncode, output, src.name)
        lib = Path(tmp) / out.name
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        _check(res.returncode, res.stdout, "link")
        os.replace(lib, out)  # atomic: concurrent builders never see a torn file


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use if it is stale."""
    global _lib
    with _lock:
        if _lib is None:
            h = hashlib.sha256()
            for path in sorted(CSRC.iterdir()):
                if path.is_file():
                    h.update(path.name.encode())
                    h.update(path.read_bytes())
            h.update(" ".join(NVCC_FLAGS).encode())
            out = BUILD_DIR / f"repro_torch_kernels.{h.hexdigest()[:16]}.so"
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            for name, argtypes in ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
