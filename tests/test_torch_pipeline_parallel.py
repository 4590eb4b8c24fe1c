"""Port parity of the GPipe schedule (``repro_torch.distributed.
pipeline_parallel``) against the reference's, on the CPU.

The reference runs in a subprocess with 4 host devices, as
``tests/test_pipeline_parallel.py`` runs it, on the same seeded numpy
inputs, and hands its outputs back through a numpy file. The port runs
its stages on ``StageMesh(("cpu",) * P)``. Tolerances: within
``REF_ATOL`` 1e-5 of the reference (XLA's and PyTorch's ``tanh(x @ w)``
round differently), bitwise equal to the port's sequential composition
of the stages over each microbatch (the same operators on the same
shapes).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.distributed.pipeline_parallel import bubble_fraction as jbubble_fraction
from repro_torch.distributed.pipeline_parallel import (
    StageMesh,
    bubble_fraction,
    pipeline_forward,
)

REF_ATOL = 1e-5
#: (P stages, M microbatches): the reference test's case, M < P, one stage
CASES = ((4, 8), (4, 2), (1, 3))
MB, D = 2, 16


def _inputs(p: int, m: int):
    rng = np.random.default_rng(100 * p + m)
    ws = (rng.standard_normal((p, D, D)) / np.sqrt(D)).astype(np.float32)
    xs = rng.standard_normal((m, MB, D)).astype(np.float32)
    return ws, xs


def _stage_fn(params, x):
    return torch.tanh(x @ params["w"])


def _sequential(ws: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    outs = []
    for x in xs:
        for s in range(ws.shape[0]):
            x = _stage_fn({"w": ws[s]}, x)
        outs.append(x)
    return torch.stack(outs)


@pytest.fixture(scope="module")
def reference_outputs(tmp_path_factory):
    """The reference's ``pipeline_forward`` on every case, run once."""
    root = tmp_path_factory.mktemp("pipeline")
    for p, m in CASES:
        ws, xs = _inputs(p, m)
        np.save(root / f"ws_{p}_{m}.npy", ws)
        np.save(root / f"xs_{p}_{m}.npy", xs)
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax.numpy as jnp, numpy as np
        from repro.distributed.pipeline_parallel import pipeline_forward
        from repro.jax_compat import make_mesh

        for p, m in {CASES!r}:
            ws = jnp.asarray(np.load(f"{root}/ws_{{p}}_{{m}}.npy"))
            xs = jnp.asarray(np.load(f"{root}/xs_{{p}}_{{m}}.npy"))
            mesh = make_mesh((p,), ("stage",))
            out = pipeline_forward({{"w": ws}}, xs, mesh,
                                   lambda q, x: jnp.tanh(x @ q["w"]))
            np.save(f"{root}/out_{{p}}_{{m}}.npy", np.asarray(out))
        print("PIPELINE_OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ), timeout=600)
    assert "PIPELINE_OK" in out.stdout, out.stderr[-2000:]
    return {(p, m): np.load(root / f"out_{p}_{m}.npy") for p, m in CASES}


@pytest.mark.parametrize("p,m", CASES)
def test_pipeline_matches_reference_and_sequential(reference_outputs, p, m):
    ws, xs = (torch.from_numpy(a) for a in _inputs(p, m))
    mesh = StageMesh(("cpu",) * p)
    out = pipeline_forward({"w": ws}, xs, mesh, _stage_fn)
    assert out.shape == (m, MB, D) and out.device == xs.device
    np.testing.assert_allclose(out.numpy(), reference_outputs[(p, m)], atol=REF_ATOL, rtol=0)
    assert torch.equal(out, _sequential(ws, xs))


def test_bubble_fraction_is_the_reference_s():
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-9
    for p in (1, 2, 4, 8):
        for m in (1, 3, 8, 32):
            assert bubble_fraction(p, m) == jbubble_fraction(p, m)


def test_schedule_runs_each_stage_once_per_microbatch_in_tick_order():
    p, m = 3, 4
    calls = []

    def stage_fn(params, x):
        calls.append((int(params["id"]), int(x[0, 0])))
        return x + 1

    xs = torch.arange(m, dtype=torch.float32).reshape(m, 1, 1) * 10
    out = pipeline_forward({"id": torch.arange(p)}, xs, StageMesh(("cpu",) * p), stage_fn)
    assert torch.equal(out, xs + p)
    # tick t runs (stage s, microbatch t - s), the last stage first
    want = [(s, 10 * (t - s) + s) for t in range(p + m - 1)
            for s in reversed(range(p)) if 0 <= t - s < m]
    assert calls == want


def test_stage_mesh_shape_and_its_checks():
    mesh = StageMesh(("cpu",) * 4)
    assert mesh.shape == {"stage": 4} and mesh.axis_names == ("stage",) and mesh.size == 4
    missing = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(ValueError, match="CUDA devices exist"):
        StageMesh(("cpu", missing))
    ws, xs = (torch.from_numpy(a) for a in _inputs(4, 8))
    with pytest.raises(ValueError, match="4 stages"):
        pipeline_forward({"w": ws[:3]}, xs, mesh, _stage_fn)
