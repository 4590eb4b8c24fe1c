#!/usr/bin/env python3
"""Registers, shared memory and spills of every CUDA kernel of the port, as
``nvcc -Xptxas -v`` reports them for sm_90a.

Run on the machine with nvcc, from the root of a checkout::

    python3 scripts/torch_kernel_regs.py

It compiles each ``src/repro_torch/kernels/csrc/*.cu`` with the port's own
flags (``_build.NVCC_FLAGS``) into a temporary directory and prints one
JSON object: for each kernel instance (its demangled name with its
template arguments), its registers, shared memory bytes and spill bytes
(the most over its compiles). The launch model's register table
(``repro_torch.tune.budget.REGISTERS``) holds these numbers.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402


def main() -> int:
    nvcc = _build._nvcc()
    kernels: dict[str, dict] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in _build.SOURCES:
            res = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                 str(Path(tmp) / f"{src.stem}.o"), str(src)],
                capture_output=True, text=True, timeout=600, check=True,
            )
            name = None
            for line in res.stderr.splitlines():
                fn = re.search(r"Compiling entry function '([^']+)'", line)
                if fn:
                    demangled = subprocess.run(
                        ["c++filt", fn.group(1)], capture_output=True, text=True, check=True
                    ).stdout.strip()
                    plain = demangled.replace("(anonymous namespace)::", "")
                    plain = re.sub(r"^void\s+", "", plain).split("(")[0]
                    name = f"{src.name}:{plain}"
                    continue
                used = re.search(r"Used (\d+) registers", line)
                if name and used:
                    smem = re.search(r"(\d+) bytes smem", line)
                    row = kernels.setdefault(name, {"registers": 0, "smem": 0, "spill": 0,
                                                    "instances": 0})
                    row["registers"] = max(row["registers"], int(used.group(1)))
                    row["smem"] = max(row["smem"], int(smem.group(1)) if smem else 0)
                    row["instances"] += 1
                spill = re.search(r"(\d+) bytes spill stores", line)
                if name and spill:
                    row = kernels.setdefault(name, {"registers": 0, "smem": 0, "spill": 0,
                                                    "instances": 0})
                    row["spill"] = max(row["spill"], int(spill.group(1)))
    print(json.dumps({"flags": list(_build.NVCC_FLAGS), "kernels": kernels}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
