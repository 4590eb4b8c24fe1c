"""The first call of an MKL VML function in a process is exact once
``repro_torch`` is imported (``repro_torch._settle_vml``).

Without it, the first VML call of a process (``torch.cos``,
``torch.exp``, ...) over a tensor that torch splits across its intra-op
threads races MKL's one-time pick of the kernel: in about one process in
twenty, the chunks of the threads that arrive during the pick come from
the low-accuracy kernel, ``cos`` 1.5e-4 off on RoPE's angles (ROADMAP.md
queue C, the cause of ``test_rope_matches``' flake). Each fresh process
here makes its first VML calls on RoPE's angles and an ``exp`` ramp and
must get the bits of the second calls. One race in twenty makes this a
sampling test: its ``PROCESSES`` catch a missing settle four times in
five.
"""

import subprocess
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
PROCESSES, AT_ONCE = 32, 8

_FIRST_CALLS = """
import os, sys
os.nice(10)  # yield the cores to the suite's other workers
sys.path.insert(0, sys.argv[1])
import torch
import repro_torch
freqs = 1.0 / torch.pow(torch.tensor(1e4), torch.arange(0, 40, dtype=torch.float32) / 40)
ang = torch.arange(0, 4200, 7, dtype=torch.float32)[:, None] * freqs
ramp = torch.linspace(-20.0, 5.0, 24000)
first = (torch.cos(ang), torch.sin(ang), torch.exp(ramp))
again = (torch.cos(ang), torch.sin(ang), torch.exp(ramp))
print(sum(int((a != b).sum()) for a, b in zip(first, again)))
"""


def test_the_first_vml_call_of_a_process_is_exact():
    off = []
    for _ in range(PROCESSES // AT_ONCE):
        procs = [subprocess.Popen([sys.executable, "-c", _FIRST_CALLS, SRC],
                                  stdout=subprocess.PIPE, text=True)
                 for _ in range(AT_ONCE)]
        outs = [p.communicate(timeout=120)[0] for p in procs]
        assert all(p.returncode == 0 for p in procs)
        off += [int(o) for o in outs]
    assert off == [0] * PROCESSES
