"""Port parity of the float16, bfloat16 and 64-bit accumulators against the
reference, on the CPU: the Alg 1-3 kernels' plain versions (B2-B5, B10),
and how the 64-bit names resolve. The ``pair_average`` filter is in
``test_torch_accumulator_streams.py``, the other filters and their
kernels in ``test_torch_accumulator_filters.py``.

The reference runs with x64 off, so ``"float64"`` and ``"int64"`` resolve
to float32 and int32 in both packages. For the half types the port follows
what XLA's CPU compiler makes of the reference's jitted code
(``repro_torch.kernels.ref`` docstring): float16 keeps the float32 rules
in float16 (reciprocal multiplies, FMAs rounded once), bfloat16 rounds
every operation and divides truly, and ``jnp.sum`` without a dtype sums
either in float32.

Tolerance: **bitwise**, output dtype included, everywhere; the
reference's banked XLA path too, whose group order the port follows
(``ref.XLA_GROUP_LOOPS``).

On the CPU the reference's ``auto`` is its XLA path and the port's
``auto`` the kernels' plain versions; for Alg 1/2 in a half type the
reference's two paths differ (its XLA path sums in float32, its Pallas
baseline in the half type), so those one-shot calls are held on
``pallas`` and ``xla`` in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.denoise import DenoiseConfig as JConfig
from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro_torch.core.denoise import DenoiseConfig, StreamingDenoiser
from repro_torch.kernels import ops, ref

OFFSET = 4096.0
HALF = ("float16", "bfloat16")
FORMATS = ("u16", "u8", "p12")
N, H, W = 8, 8, 128


def _wire(shape, fmt, seed):
    px = np.random.default_rng(seed).integers(0, 4096, shape + (W,)).astype(np.uint16)
    return jquant.encode(px, fmt)


def _np(x):
    """A reference or port array as numpy, bfloat16 as ``"bfloat16"``."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy(), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x, x.dtype.name


def _same(got, want):
    (g, gd), (w, wd) = _np(got), _np(want)
    assert gd == wd and g.shape == w.shape, (gd, wd, g.shape, w.shape)
    assert np.array_equal(g, w, equal_nan=True), float(np.nanmax(np.abs(
        g.astype(np.float64) - w)))


# ---------------------------------------------------------------------------
# Dtype resolution.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "name, want",
    [("float64", torch.float32), ("int64", torch.int32), ("uint64", torch.uint32),
     ("float16", torch.float16), ("bfloat16", torch.bfloat16), (np.float64, torch.float32),
     (np.dtype("int64"), torch.int32), (torch.float64, torch.float64)],
    ids=str,
)
def test_accum_dtypes_resolve_as_the_reference_canonicalizes(name, want):
    assert ref.as_torch_dtype(name) == want
    if not isinstance(name, torch.dtype):
        assert str(jnp.zeros((), name).dtype) == str(want).replace("torch.", "")


@pytest.mark.parametrize("acc", HALF + ("float32",))
def test_host_constants_round_as_jax_converts_them(acc):
    # offsets, the u8 scale, alpha and 1/(2 sigma^2) reach the kernels so rounded
    values = [4096.0, jquant.U8_SCALE, 0.3, 1.0 / 7200.0, 1.0 / 1800.0, 123.456, 1e-5]
    values += list(np.random.default_rng(0).uniform(-1e4, 1e4, 200))
    for v in values:
        want = float(jnp.asarray(v, acc).astype(jnp.float32))
        assert ref.round_const(float(v), getattr(torch, acc)) == want, v


def test_config_keeps_accum_dtype_as_written():
    kw = dict(num_groups=3, frames_per_group=N, height=H, width=W, accum_dtype="float64")
    cfg, jcfg = DenoiseConfig(**kw), JConfig(**kw)
    assert cfg.accum_dtype == "float64" and cfg.stream_key() == jcfg.stream_key()
    assert StreamingDenoiser(cfg, device="cpu").init().dtype == torch.float32


# ---------------------------------------------------------------------------
# B2 / B4 (step), B3 / B5 (one shot), B10 (Alg 1/2) at the kernel level,
# against the reference's Pallas interpret mode and its XLA path.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g", [4, 5, 8])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("acc", HALF)
def test_stream_steps_b2_b4_half(acc, fmt, g):
    wire = _wire((g, 2, N, H), fmt, seed=g)  # two banks
    for variant in ("divide_last", "divide_first"):
        for backend in ("pallas", "xla"):
            js = jops.multibank_stream_init(2, N, H, W, acc)
            ts = ops.multibank_stream_init(2, N, H, W, acc, device="cpu")
            j1, t1 = jops.stream_init(N, H, W, acc), ops.stream_init(N, H, W, acc, device="cpu")
            kw = dict(num_groups=g, offset=OFFSET, variant=variant, backend=backend,
                      stream_dtype=fmt)
            for k in range(g):
                js = jops.multibank_stream_step(js, jnp.asarray(wire[k]), **kw)
                ops.multibank_stream_step(ts, torch.from_numpy(wire[k]), **kw)
                j1 = jops.stream_step(j1, jnp.asarray(wire[k, 0]), **kw)
                ops.stream_step(t1, torch.from_numpy(wire[k, 0]), **kw)
                _same(ts, js)
                _same(t1, j1)
            _same(ops.stream_finalize(t1, g, variant=variant),
                  jops.stream_finalize(j1, g, variant=variant))


@pytest.mark.parametrize("g", [4, 5, 8])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("acc", HALF)
def test_subtract_average_b3_b5_half(acc, fmt, g):
    wire = _wire((2, g, N, H), fmt, seed=10 + g)
    for algorithm in ("alg3", "alg3_v2"):
        for backend in ("pallas", "xla"):
            kw = dict(offset=OFFSET, algorithm=algorithm, backend=backend, accum_dtype=acc,
                      stream_dtype=fmt)
            _same(ops.subtract_average(torch.from_numpy(wire[0]), **kw),
                  jops.subtract_average(jnp.asarray(wire[0]), **kw))
            _same(ops.multibank_subtract_average(torch.from_numpy(wire), **kw),
                  jops.multibank_subtract_average(jnp.asarray(wire), **kw))


@pytest.mark.parametrize("g", [8, 32, 33, 65, 100, 1100])
def test_xla_windows_are_the_reference_compilers(g):
    # the reference's banked XLA one-shot sums over G with jnp.sum; above 32
    # groups XLA's CPU compiler cuts that reduction into padded windows
    # (a reduce-window of 32), which ref.xla_windows reproduces
    import re

    import jax

    x = jnp.zeros((g, 2, 128), jnp.float32)
    hlo = jax.jit(lambda a: a.sum(axis=0)).lower(x).compile().as_text()
    windows = ref.xla_windows(g)
    pads = re.findall(r"reduce-window\(.*window=\{size=(\d+)x\S+ stride=\S+ pad=(\d+)_(\d+)", hlo)
    if g <= ref.XLA_REDUCE_WINDOW:
        assert not pads and windows == [(0, g)]
        return
    size, low, high = map(int, pads[0])
    assert size == ref.XLA_REDUCE_WINDOW
    assert windows[0] == (0, size - low) and windows[-1][1] == g
    assert len(windows) == (g + low + high) // size
    assert all(hi - lo == size for lo, hi in windows[1:-1])
    assert windows[-1][1] - windows[-1][0] == size - high


@pytest.mark.parametrize("g", [5, 9, 12, 16, 17, 24, 28, 31, 32, 33])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("acc", ("float32",) + HALF)
def test_banked_xla_one_shot_sums_in_the_reference_compilers_order(acc, fmt, g):
    # At 9-32 groups XLA's CPU compiler unrolls the banked one-shot's group
    # loop or vectorizes it (strided lanes, an epilogue, the rest in order),
    # by type, format, variant, pixel parity and whether there is an offset
    # (ref.XLA_GROUP_LOOPS); below and above, G = 5 and 33 stay bitwise. A
    # plane of 2 x 4 x 4 x 64 (B, N, H, W); offsets 0 (no offset add),
    # 100.5 (a float add) and 4096 (an integer add, for p12 provably
    # nonnegative: ref.XLA_NONNEG_P12_OFFSETS)
    b, n, h, w = 2, 4, 4, 64
    px = np.random.default_rng(g).integers(0, 4096, (b, g, n, h, w)).astype(np.uint16)
    wire = jquant.encode(px, fmt)
    for offset in (0.0, 100.5, OFFSET):
        for algorithm in ("alg3", "alg3_v2"):
            kw = dict(offset=offset, algorithm=algorithm, backend="xla", accum_dtype=acc,
                      stream_dtype=fmt)
            _same(ops.multibank_subtract_average(torch.from_numpy(wire), **kw),
                  jops.multibank_subtract_average(jnp.asarray(wire), **kw))


@pytest.mark.parametrize("offset", [4094.0, 4095.0, 16383.0, 16384.0])
def test_banked_xla_p12_v2_starts_as_the_reference_compiler_at_the_offset_bounds(offset):
    # float32 p12 Alg 3 v2 with an integer offset of 4095-16383 (the
    # difference provably nonnegative in i16): the sum's first two terms
    # contract the other way round (ref.XLA_NONNEG_P12_OFFSETS), except on
    # the odd pixels at G = 15, a rolled loop (ref.XLA_ROLLED_P12_ODD_G)
    b, n, h, w = 2, 4, 4, 64
    for g in (3, 9, 15, 17):
        px = np.random.default_rng(g).integers(0, 4096, (b, g, n, h, w)).astype(np.uint16)
        wire = jquant.encode(px, "p12")
        kw = dict(offset=offset, algorithm="alg3_v2", backend="xla", stream_dtype="p12")
        _same(ops.multibank_subtract_average(torch.from_numpy(wire), **kw),
              jops.multibank_subtract_average(jnp.asarray(wire), **kw))


#: a script that compiles the reference's banked XLA one-shot for each case of
#: argv[2] (JSON: [accumulator, format, algorithm, G, offset]) with
#: XLA_FLAGS=--xla_dump_to=argv[1] set before JAX starts, and prints, per
#: case, the vector width of its fusion's functions and the widths of the
#: vector reductions in its optimized IR
_IR_PROBE = r"""
import glob, json, re, sys
import numpy as np
import jax.numpy as jnp
from repro.kernels import ops, quant

out = []
for acc, fmt, algorithm, g, offset in json.loads(sys.argv[2]):
    before = set(glob.glob(sys.argv[1] + "/*ir-with-opt.ll"))
    wire = quant.encode(np.zeros((2, g, 4, 4, 64), np.uint16), fmt)
    ops.multibank_subtract_average(jnp.asarray(wire), offset=offset, algorithm=algorithm,
                                   backend="xla", accum_dtype=acc,
                                   stream_dtype=fmt).block_until_ready()
    ir = "".join(open(f).read() for f in set(glob.glob(sys.argv[1] + "/*ir-with-opt.ll")) - before)
    bits = re.findall(r'"prefer-vector-width"="(\d+)"', ir)
    lanes = re.findall(r"vector\.reduce\.fadd\.v(\d+)f", ir)
    out.append(dict(bits=sorted({int(b) for b in bits}), lanes=sorted({int(n) for n in lanes})))
print(json.dumps(out))
"""


def test_xla_vector_width_and_thresholds_are_this_hosts(tmp_path):
    # ref.XLA_GROUP_LOOPS was read off the IR of one host CPU. Its vector
    # width (and so the lane count) and the G at which LLVM starts to
    # vectorize each group loop come from the host's LLVM target, so this
    # test reads them off the IR of the host it runs on, in a subprocess
    # (the dump flag must be set before JAX starts), and says which differs.
    import json
    import os
    import subprocess
    import sys

    cases, want = [], []
    for offset, loops in ((100.0, ref.XLA_GROUP_LOOPS), (0.0, ref.XLA_GROUP_LOOPS_NO_OFFSET)):
        for (acc, fmt, divide_first), rows in loops.items():
            if fmt == "p12":  # its parities start apart: held by the bitwise test above
                continue
            first, lanes = rows[0][0], rows[0][2][0]
            assert lanes == ref.XLA_LANES
            algorithm = "alg3_v2" if divide_first else "alg3"
            cases += [[acc, fmt, algorithm, g, offset] for g in (first - 1, first)]
            want += [[], [lanes]]
    cases.append(["float32", "u16", "alg3", 32, 100.0])  # the pixel loop vectorizes instead
    want.append([])
    env = dict(os.environ, XLA_FLAGS=f"--xla_dump_to={tmp_path}", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    res = subprocess.run([sys.executable, "-c", _IR_PROBE, str(tmp_path), json.dumps(cases)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    widths = {b for row in got for b in row["bits"]}
    assert widths == {ref.XLA_VECTOR_BITS}, (
        f"this host's XLA emits prefer-vector-width {sorted(widths)}, the port's group order "
        f"(ref.XLA_GROUP_LOOPS) was read at {ref.XLA_VECTOR_BITS} bits")
    for case, row, lanes in zip(cases, got, want):
        assert row["lanes"] == lanes, (
            f"{case}: this host's XLA reduces in {row['lanes']} lanes, the port expects "
            f"{lanes} (ref.XLA_GROUP_LOOPS)")


@pytest.mark.parametrize("g", [65, 100])
@pytest.mark.parametrize("acc", HALF)
@pytest.mark.parametrize("kernel", ["b10", "b3_b5-u16", "b3_b5-u8", "b3_b5-p12"])
def test_half_above_64_groups(kernel, acc, g):
    # G > 64, where the card's vector paths divide bfloat16 truly rather than
    # by x * f32(1/G): B10 (Alg 1/2, u16) and B3/B5 (Alg 3 and v2, each wire
    # format) against the reference's Pallas interpret mode and XLA path, on
    # a small plane (N = 2, H = 2) so that the interpret grid stays short
    n, h = 2, 2
    if kernel == "b10":
        wire = _wire((g, n, h), "u16", seed=30 + g)
        for algorithm in ("alg1", "alg2"):
            for backend in ("pallas", "xla"):
                kw = dict(offset=OFFSET, algorithm=algorithm, backend=backend, accum_dtype=acc)
                _same(ops.subtract_average(torch.from_numpy(wire), **kw),
                      jops.subtract_average(jnp.asarray(wire), **kw))
        return
    fmt = kernel.split("-")[1]
    wire = _wire((2, g, n, h), fmt, seed=40 + g)
    for algorithm in ("alg3", "alg3_v2"):
        for backend in ("pallas", "xla"):
            kw = dict(offset=OFFSET, algorithm=algorithm, backend=backend, accum_dtype=acc,
                      stream_dtype=fmt)
            _same(ops.subtract_average(torch.from_numpy(wire[0]), **kw),
                  jops.subtract_average(jnp.asarray(wire[0]), **kw))
            _same(ops.multibank_subtract_average(torch.from_numpy(wire), **kw),
                  jops.multibank_subtract_average(jnp.asarray(wire), **kw))


@pytest.mark.parametrize("g", [4, 5, 8])
@pytest.mark.parametrize("acc", HALF)
def test_alg1_alg2_b10_half(acc, g):
    # pallas: the two-pass kernels sum the tmpFrame in the half type;
    # xla: jnp.sum sums it in float32 (u8/p12 only there, as in the reference)
    for fmt in FORMATS:
        wire = _wire((g, N, H), fmt, seed=20 + g)
        for algorithm in ("alg1", "alg2"):
            for backend in (("pallas", "xla") if fmt == "u16" else ("xla",)):
                kw = dict(offset=OFFSET, algorithm=algorithm, backend=backend,
                          accum_dtype=acc, stream_dtype=fmt)
                _same(ops.subtract_average(torch.from_numpy(wire), **kw),
                      jops.subtract_average(jnp.asarray(wire), **kw))
            banked = np.stack([wire, wire[::-1]])
            kw = dict(offset=OFFSET, algorithm=algorithm, accum_dtype=acc, stream_dtype=fmt)
            _same(ops.multibank_subtract_average(torch.from_numpy(banked), **kw),
                  jops.multibank_subtract_average(jnp.asarray(banked), **kw))
