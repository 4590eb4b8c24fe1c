#!/usr/bin/env python3
"""Times the build of the port's CUDA kernel library two ways.

Run from the root of a checkout on a machine with ``nvcc``::

    python3 scripts/torch_time_kernel_build.py

* ``parallel``: as ``repro_torch.kernels._build`` builds it, one
  ``nvcc -c`` per source in ``csrc/``, all started together, then one
  ``nvcc`` call that links the objects;
* ``one_call``: a single ``nvcc`` call that compiles every source and
  links the library.

Both use the same flags and write into a temporary directory, so the
package's own build cache is untouched. Each is run twice, alternating;
the last line is one JSON object with every time in seconds.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402


def one_call(out: Path) -> None:
    subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
         *map(str, _build.SOURCES)],
        check=True,
    )


def main() -> int:
    times: dict[str, list[float]] = {"parallel": [], "one_call": []}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for rep in range(2):
            for how, build in (("parallel", _build._build), ("one_call", one_call)):
                out = Path(tmp) / f"{how}{rep}.so"
                t0 = time.perf_counter()
                build(out)
                times[how].append(time.perf_counter() - t0)
                print(f"{how:9s} build {rep}: {times[how][-1]:.2f} s "
                      f"({len(_build.SOURCES)} sources)")
    print(json.dumps({"sources": [s.name for s in _build.SOURCES], "seconds": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
