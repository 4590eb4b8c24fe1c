"""Port parity of the bank executor (``repro_torch.core.banks``) against
the JAX reference (``repro.core.banks``), on the CPU.

The port's meshes here are ``BankMesh(("cpu", "cpu"))``: two bank shards
on the host, each with its own state, ring, producer thread and stager.
The reference runs in-process on a one-device mesh or with ``mesh=None``,
and its results are compared as whole host copies (``np.asarray(out)``):
this JAX raises when a bank-sharded array is indexed.

Tolerance: bitwise, except ``spatial_box`` in bilateral mode, held within
``denoise_spatial.BILATERAL_RTOL`` (its weights call ``exp``, which XLA
and PyTorch round differently). The filter configs pin
``backend="pallas"`` in both packages, as ``tests/test_torch_filters.py``
does: the reference's ``auto`` runs XLA on the CPU, and for
``ema_variance`` that merge differs from the kernel's in the last bits.
The ``pair_average`` one-shot and stream-step tests, and the one-bank
executor test, run ``auto``, whose XLA path the port's plain versions
match bit for bit for those filters.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import banks as jbanks
from repro.core.denoise import DenoiseConfig as JConfig
from repro_torch.core import banks
from repro_torch.core.denoise import DenoiseConfig
from repro_torch.data.prism import PrismSource
from repro_torch.denoise.base import tree_leaves
from repro_torch.kernels import denoise_spatial

SMALL = dict(num_groups=3, frames_per_group=8, height=8, width=128, backend="pallas")
FILTERS = {
    "pair_average": dict(),
    "temporal_median": dict(filter_name="temporal_median", median_window=2),
    "ema_variance": dict(filter_name="ema_variance", ema_mask_sigma=1.5),
    "spatial_box/box": dict(filter_name="spatial_box", spatial_mode="box"),
    "spatial_box/bilateral": dict(filter_name="spatial_box", spatial_mode="bilateral"),
}
CPU2 = banks.BankMesh(("cpu", "cpu"))


def _close(label, got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if label.endswith("bilateral"):
        np.testing.assert_allclose(got, want, rtol=denoise_spatial.BILATERAL_RTOL, atol=0)
    else:
        assert np.array_equal(got, want), float(np.abs(got - want).max())


def _bank_groups(cfg, seed, banks_=2):
    """Per-bank group lists, made once and fed to both packages."""
    return [list(s) for s in PrismSource(cfg, seed=seed).bank_sources(banks_)]


def _reference_banked(kw, per_bank):
    jcfg = JConfig(**kw)
    filt, state = jbanks.banked_filter_init(jcfg, None, banks=len(per_bank))
    for k in range(jcfg.num_groups):
        chunk = jnp.asarray(np.stack([groups[k] for groups in per_bank]))
        state = jbanks.banked_filter_step(state, chunk, None, config=jcfg, step_index=k, filt=filt)
    return np.asarray(filt.finalize(state))


# ---------------------------------------------------------------------------
# The mesh.
# ---------------------------------------------------------------------------


def test_bank_mesh_shape_and_repeated_devices():
    assert CPU2.shape == {"bank": 2}
    assert CPU2.devices == (torch.device("cpu"), torch.device("cpu"))
    with pytest.raises(ValueError, match="at least one device"):
        banks.BankMesh(())
    with pytest.raises(Exception):
        CPU2.devices = ()  # frozen


def test_make_bank_mesh_keeps_the_reference_rule():
    with pytest.raises(ValueError) as want:
        jbanks.make_bank_mesh(3)
    with pytest.raises(ValueError) as got:
        banks.make_bank_mesh(3)  # no CUDA device here
    assert str(want.value).startswith("need 3 devices for 3 banks, have ")
    assert str(got.value) == "need 3 devices for 3 banks, have 0"


# ---------------------------------------------------------------------------
# One-shot and streaming banked pair_average.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("algorithm", ["alg3", "alg3_v2", "alg1"])
def test_banked_subtract_average_matches_reference(algorithm, b):
    kw = dict(SMALL, algorithm=algorithm, backend="auto")
    x = np.random.default_rng(b).integers(0, 4096, (b, 3, 8, 8, 128)).astype(np.uint16)
    want = jbanks.banked_subtract_average(
        jnp.asarray(x), jbanks.make_bank_mesh(1), config=JConfig(**kw))
    got = banks.banked_subtract_average(x, CPU2, config=DenoiseConfig(**kw))
    assert got.device == CPU2.devices[0]
    _close("", got, np.asarray(want))


def test_banked_stream_step_matches_reference():
    kw = dict(SMALL, backend="auto")
    jcfg, cfg = JConfig(**kw), DenoiseConfig(**kw)
    per_bank = _bank_groups(cfg, seed=1)
    js = jnp.zeros((2, 4, 8, 128), jnp.float32)
    sums = [torch.zeros(1, 4, 8, 128) for _ in CPU2.devices]
    for k in range(cfg.num_groups):
        chunk = np.stack([groups[k] for groups in per_bank])
        js = jbanks.banked_stream_step(js, jnp.asarray(chunk), jbanks.make_bank_mesh(1),
                                       config=jcfg)
        assert banks.banked_stream_step(sums, chunk, CPU2, config=cfg) is sums
    _close("", torch.cat(sums), np.asarray(js))


# ---------------------------------------------------------------------------
# Filter-generic banked stepping and the pipelined executor.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", sorted(FILTERS))
def test_pipelined_banked_and_banked_step_match_reference(label):
    kw = dict(SMALL, num_banks=2, **FILTERS[label])
    cfg = DenoiseConfig(**kw)
    per_bank = _bank_groups(cfg, seed=2)
    want = _reference_banked(kw, per_bank)
    out, rep = banks.run_pipelined_banked(cfg, [iter(g) for g in per_bank], CPU2)
    _close(label, out, want)
    assert rep.frames == 2 * cfg.num_groups * cfg.frames_per_group
    assert rep.drops == 0 and rep.num_slots == cfg.num_slots
    filt, state = banks.banked_filter_init(cfg, None, banks=2, device="cpu")
    for k in range(cfg.num_groups):
        chunk = np.stack([groups[k] for groups in per_bank])
        state = banks.banked_filter_step(state, chunk, None, config=cfg, step_index=k)
    _close(label, banks.banked_filter_finalize(filt, state), want)


@pytest.mark.parametrize("label", ["pair_average", "temporal_median"])
def test_one_bank_run_matches_reference_executor(label):
    # the reference's Pallas interpret mode does not run under its shard_map
    # in this JAX, so its executor runs XLA; both filters' XLA composites
    # equal their kernels' plain versions bit for bit
    kw = {**SMALL, **FILTERS[label], "backend": "auto"}
    per_bank = _bank_groups(DenoiseConfig(**kw), seed=3, banks_=1)
    want, jrep = jbanks.run_pipelined_banked(
        JConfig(**kw), [iter(per_bank[0])], jbanks.make_bank_mesh(1))
    got, rep = banks.run_pipelined_banked(
        DenoiseConfig(**kw), [iter(per_bank[0])], banks.BankMesh(("cpu",)))
    _close(label, got, np.asarray(want))
    assert (rep.frames, rep.bytes_in, rep.drops) == (jrep.frames, jrep.bytes_in, jrep.drops)


def test_executor_errors_carry_the_reference_text():
    kw = dict(SMALL)
    cfg, jcfg = DenoiseConfig(**kw), JConfig(**kw)
    per_bank = _bank_groups(cfg, seed=4)
    one = banks.BankMesh(("cpu",))
    cases = [
        (lambda: jbanks.run_pipelined_banked(jcfg, [iter([])] * 2, jbanks.make_bank_mesh(1)),
         lambda: banks.run_pipelined_banked(cfg, [iter([])] * 2, one)),
        (lambda: jbanks.run_pipelined_banked(jcfg, [iter([])], jbanks.make_bank_mesh(1),
                                             policy="drop_oldest"),
         lambda: banks.run_pipelined_banked(cfg, [iter([])], one, policy="drop_oldest")),
    ]
    for ref_call, port_call in cases:
        with pytest.raises(ValueError) as want:
            ref_call()
        with pytest.raises(ValueError) as got:
            port_call()
        assert str(got.value) == str(want.value)
    # unequal chunk counts need two banks, which the reference cannot run on
    # one device: its text is held to the reference's source instead
    with pytest.raises(ValueError) as got:
        banks.run_pipelined_banked(cfg, [iter(per_bank[0]), iter(per_bank[1][:2])], CPU2)
    text = str(got.value)
    assert text.startswith("bank sources yielded unequal chunk counts")
    source = inspect.getsource(jbanks.run_pipelined_banked)
    assert '"bank sources yielded unequal chunk counts: a per-group barrier "' in source
    assert text == ("bank sources yielded unequal chunk counts: a per-group barrier "
                    "needs one chunk per bank per step")


def test_filter_init_errors_match_reference():
    kw = dict(SMALL)
    with pytest.raises(ValueError) as want:
        jbanks.banked_filter_init(JConfig(**kw), None)
    with pytest.raises(ValueError) as got:
        banks.banked_filter_init(DenoiseConfig(**kw), None, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jbanks.banked_filter_init(JConfig(**kw), jbanks.make_bank_mesh(1), banks=2)
    with pytest.raises(ValueError) as got:
        banks.banked_filter_init(DenoiseConfig(**kw), banks.BankMesh(("cpu",)), banks=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("label", ["pair_average", "temporal_median", "ema_variance",
                                   "spatial_box/box"])
def test_each_shard_state_lies_on_its_mesh_device(label):
    cfg = DenoiseConfig(**SMALL, **FILTERS[label])
    mesh = banks.BankMesh(("cpu", "meta"))  # a second device type, no data moved
    filt, state = banks.banked_filter_init(cfg, mesh)
    assert len(state) == 2
    for shard, dev in zip(state, mesh.devices):
        assert filt.is_banked(shard)
        specs = tree_leaves(filt.state_pspec(shard))[0]
        for leaf, spec in zip(tree_leaves(shard)[0], specs):
            assert leaf.device == dev and leaf.shape[spec.index("bank")] == 1
