#!/usr/bin/env python3
"""Which collectives a gloo group of four ranks runs on CUDA tensors that
share one card (chip only; with ``--device cpu`` on the host).

:func:`probe` runs each of ``COLLECTIVES`` once on float32 tensors over
the default group, as the ``torch.distributed`` call or (``functional``)
as the functional op DTensor issues (``torch.ops._c10d_functional.*``
with ``wait_tensor``), and checks its result. ``chip_smoke.py`` phase 15
calls it inside its ranks. Run as a script, each case starts four fresh
ranks (a ``FileStore`` group), since a rank that crashes takes its
process with it and shows as a negative exit code (-11: a segmentation
fault). Prints one line a case and a JSON summary last::

    python3 scripts/torch_gloo_cuda_probe.py [--device cpu]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

RANKS = 4
COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
               "all_to_all_single")


def probe(dev, *, functional: bool = False, names=COLLECTIVES) -> dict:
    """``{collective: "ok", "wrong result" or the error}`` for each of
    ``names`` on ``dev`` over the default group. It records a refusal and
    runs nothing in its place. Over gloo the functional all-gather on CUDA
    tensors crashes the process unless ``launch.mesh.make_mesh`` has
    registered its kernel."""
    import torch
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()
    group = dist.group.WORLD.group_name
    f = torch.ops._c10d_functional
    every = torch.stack([torch.arange(4 * n, dtype=torch.float32, device=dev) + 1000 * k
                         for k in range(n)])
    mine = every[r].clone()
    out = {}
    for name in names:
        try:
            if name == "all_gather_into_tensor":
                want = every.reshape(-1)
                if functional:
                    got = f.wait_tensor(f.all_gather_into_tensor(mine, n, group))
                else:
                    got = torch.empty_like(want)
                    dist.all_gather_into_tensor(got, mine)
            elif name == "reduce_scatter_tensor":
                want = every.sum(0)[4 * r:4 * r + 4]
                if functional:
                    got = f.wait_tensor(f.reduce_scatter_tensor(mine, "sum", n, group))
                else:
                    got = torch.empty_like(want)
                    dist.reduce_scatter_tensor(got, mine)
            elif name == "all_reduce":
                want = every.sum(0)
                if functional:
                    got = f.wait_tensor(f.all_reduce(mine, "sum", group))
                else:
                    got = mine.clone()
                    dist.all_reduce(got)
            else:
                want = every[:, 4 * r:4 * r + 4].reshape(-1)
                if functional:
                    got = f.wait_tensor(f.all_to_all_single(mine, [4] * n, [4] * n, group))
                else:
                    got = torch.empty_like(want)
                    dist.all_to_all_single(got, mine)
            if got.is_cuda:
                torch.cuda.synchronize(got.device)
            out[name] = "ok" if torch.equal(got, want) else "wrong result"
        except Exception as e:  # noqa: BLE001 - the probe records the refusal
            out[name] = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:200]}"
    return out


def rank(r: int, root: str, case: str, device: str) -> None:
    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"), RANKS),
                            rank=r, world_size=RANKS)
    kind, name = case.split(":")
    print("RESULT", probe(torch.device(device), functional=kind == "functional",
                          names=(name,))[name], flush=True)
    dist.destroy_process_group()


def main() -> int:
    device = "cpu" if sys.argv[1:] == ["--device", "cpu"] else "cuda"
    summary = {}
    for case in [f"{kind}:{name}" for kind in ("c10d", "functional") for name in COLLECTIVES]:
        with tempfile.TemporaryDirectory() as root:
            procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), root, case,
                                       device], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for r in range(RANKS)]
            outs = []
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=120)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs.append(p.communicate()[0] + "\nRESULT timeout")
        rcs = [p.returncode for p in procs]
        results = [line.split(" ", 1)[1] for o in outs for line in o.splitlines()
                   if line.startswith("RESULT ")]
        verdict = results[0] if rcs == [0] * RANKS and len(set(results)) == 1 else \
            f"failed: exit codes {rcs}"
        summary[case] = verdict
        print(f"{case} on {device}: {verdict}", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
        sys.exit(0)
    sys.exit(main())
