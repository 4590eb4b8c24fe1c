"""Port parity of the filters' bank layout and slot surgery
(``state_pspec`` and the ``slot_*`` hooks of
``repro_torch.denoise.base.StreamingFilter``) against the JAX reference,
on the CPU.

The same numpy banked state goes to both packages; every hook's result is
held to the reference's bitwise. The port's ``slot_insert`` /
``slot_scatter`` write in place where the reference returns a new array,
so the port's banked state is compared after the call. The extract and
gather copies must share no storage with the banked state: a step on one
updates it in place and must leave every slot of the banked state as it
was.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.denoise import DenoiseConfig as JConfig
from repro.denoise import get_filter as jget_filter
from repro_torch.core.denoise import DenoiseConfig
from repro_torch.data.prism import PrismSource
from repro_torch.denoise import get_filter
from repro_torch.denoise.base import tree_leaves, tree_map

SMALL = dict(num_groups=4, frames_per_group=8, height=8, width=128, backend="pallas")
FILTERS = {
    "pair_average": dict(),
    "temporal_median": dict(filter_name="temporal_median", median_window=3),
    "ema_variance": dict(filter_name="ema_variance", ema_mask_sigma=1.5),
    "spatial_box": dict(filter_name="spatial_box", spatial_mode="box"),
}


def _pair(label, **extra):
    kw = dict(SMALL, **FILTERS[label], **extra)
    cfg = DenoiseConfig(**kw)
    return get_filter(cfg.filter_name)(cfg, device="cpu"), jget_filter(cfg.filter_name)(JConfig(**kw))


def _random_banked(filt, banks, seed):
    """A banked state of ``filt``'s layout filled with random numpy values."""
    rng = np.random.default_rng(seed)
    return tree_map(
        lambda t: (4096 + 50 * rng.standard_normal(tuple(t.shape))).astype(np.float32),
        filt.init(banks=banks),
    )


def _to_torch(state):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), state)


def _to_jax(state):
    return tree_map(jnp.asarray, state)


def _same(got, want) -> None:
    if isinstance(want, dict):  # JAX rebuilds dicts in sorted key order
        assert set(got) == set(want)
        got, want = [got[k] for k in sorted(want)], [want[k] for k in sorted(want)]
    else:
        got, want = [got], [want]
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w)


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


@pytest.mark.parametrize("label", sorted(FILTERS))
def test_state_pspec_matches_reference(label):
    filt, jfilt = _pair(label)
    state, jstate = filt.init(banks=3), jfilt.init(banks=3)
    spec, jspec = filt.state_pspec(state), jfilt.state_pspec(jstate)
    if isinstance(jspec, dict):
        assert set(spec) == set(jspec)
        for key in jspec:
            assert spec[key] == tuple(jspec[key])
    else:
        assert spec == tuple(jspec)


@pytest.mark.parametrize("label", sorted(FILTERS))
def test_slot_hooks_match_reference_bitwise(label):
    filt, jfilt = _pair(label)
    banked = _random_banked(filt, 3, seed=1)
    slot = filt.slot_extract(_to_torch(_random_banked(filt, 1, seed=2)), 0)
    jslot = _to_jax(tree_map(lambda t: t.numpy(), slot))

    # extract
    state = _to_torch(banked)
    _same(filt.slot_extract(state, 1), jfilt.slot_extract(_to_jax(banked), 1))
    # insert, in place; a dict slot pairs by key, not by insertion order
    if isinstance(slot, dict):
        slot = dict(reversed(list(slot.items())))
    want = jfilt.slot_insert(_to_jax(banked), jslot, 2)
    assert filt.slot_insert(state, slot, 2) is state
    _same(state, want)
    # gather
    state = _to_torch(banked)
    sub = filt.slot_gather(state, [2, 0])
    _same(sub, jfilt.slot_gather(_to_jax(banked), [2, 0]))
    for t, s in zip(tree_leaves(state)[0], tree_leaves(sub)[0]):
        assert not _shares_storage(t, s)
    # scatter, in place: slots 0 and 2 take other values
    other = _random_banked(filt, 2, seed=3)
    want = jfilt.slot_scatter(_to_jax(banked), _to_jax(other), [2, 0])
    assert filt.slot_scatter(state, _to_torch(other), [2, 0]) is state
    _same(state, want)


@pytest.mark.parametrize("label", sorted(FILTERS))
def test_stepping_an_extracted_slot_leaves_the_banked_state_unchanged(label):
    filt, _ = _pair(label)
    banked = _random_banked(filt, 3, seed=4)
    state = _to_torch(banked)
    slot = filt.slot_extract(state, 1)
    for t, s in zip(tree_leaves(state)[0], tree_leaves(slot)[0]):
        assert not _shares_storage(t, s) and s.is_contiguous()
    before = tree_map(lambda s: s.clone(), slot)
    group = next(iter(PrismSource(filt.config, seed=5).groups()))
    filt.step(slot, torch.from_numpy(group), step_index=1)
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(slot)[0],
                                                      tree_leaves(before)[0]))
    _same(state, banked)


@pytest.mark.parametrize("label", ["pair_average", "temporal_median", "ema_variance"])
def test_slot_to_host_round_trips_bit_exactly(label):
    filt, jfilt = _pair(label)
    slot = filt.slot_extract(_to_torch(_random_banked(filt, 2, seed=6)), 1)
    host = filt.slot_to_host(slot)
    for a, t in zip(tree_leaves(host)[0], tree_leaves(slot)[0]):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        a += 1.0  # a copy: the device state is untouched
        assert not np.array_equal(a, t.numpy())
    host = filt.slot_to_host(slot)
    _same(filt.slot_from_host(host), slot)
    _same(filt.slot_from_host(host, device="cpu"), jfilt.slot_from_host(
        jfilt.slot_to_host(_to_jax(host))))


def test_slot_to_host_keeps_an_integer_dtype():
    filt, _ = _pair("pair_average", accum_dtype="uint16")
    state = filt.init(banks=2)
    state[1] = 65535
    host = filt.slot_to_host(filt.slot_extract(state, 1))
    assert host.dtype == np.uint16 and (host == 65535).all()
    back = filt.slot_from_host(host)
    assert back.dtype == torch.uint16 and torch.equal(back, state[1])


@pytest.mark.parametrize("label", sorted(FILTERS))
def test_stream_moved_between_slots_finishes_as_if_uninterrupted(label):
    filt, _ = _pair(label)
    cfg = filt.config
    stream = [torch.from_numpy(g) for g in PrismSource(cfg, seed=7).groups()]
    other = [torch.from_numpy(g) for g in PrismSource(cfg, seed=8).groups()]
    want = filt.init()
    for k, g in enumerate(stream):
        want = filt.step(want, g, step_index=k)
    want = filt.finalize(want)

    banked = filt.init(banks=2)
    for k in range(cfg.num_groups):
        if k == 2:  # move the stream from slot 0 to slot 1, start a new one in 0
            moved = filt.slot_extract(banked, 0)
            filt.slot_insert(banked, moved, 1)
            filt.slot_insert(banked, filt.init(), 0)
        lanes = (stream[k], other[k]) if k < 2 else (other[k], stream[k])
        banked = filt.step(banked, torch.stack(lanes), step_index=k)
    got = filt.finalize(filt.slot_extract(banked, 1))
    assert torch.equal(got, want)


@pytest.mark.parametrize("label", sorted(FILTERS))
def test_bfloat16_slot_to_host_round_trips_bit_for_bit(label):
    """A bfloat16 slot goes to the host as its bit patterns (dtype ``V2``,
    the leaves the reference's checkpoint restores) and comes back bit for
    bit, NaN and infinities included; the reference's host copy of the same
    slot holds the same bits."""
    import ml_dtypes

    filt, jfilt = _pair(label, accum_dtype="bfloat16")
    rng = np.random.default_rng(13)

    def fill(t):
        x = (4096 + 50 * rng.standard_normal(tuple(t.shape))).astype(np.float32)
        x.reshape(-1)[:3] = (np.nan, np.inf, -0.0)
        return torch.from_numpy(x).to(t.dtype)

    banked = tree_map(fill, filt.init(banks=2))
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(banked)[0])
    slot = filt.slot_extract(banked, 1)
    host = filt.slot_to_host(slot)
    for a, t in zip(tree_leaves(host)[0], tree_leaves(slot)[0]):
        assert isinstance(a, np.ndarray) and a.dtype == np.dtype("V2")
        assert np.array_equal(a.view(np.int16), t.view(torch.int16).numpy())
        a.view(np.int16)[...] += 1  # a copy: the state is untouched
        assert not np.array_equal(a.view(np.int16), t.view(torch.int16).numpy())
    host = filt.slot_to_host(slot)
    for device in (None, "cpu"):
        back = filt.slot_from_host(host, device=device)
        for b, a, t in zip(tree_leaves(back)[0], tree_leaves(host)[0], tree_leaves(slot)[0]):
            assert b.dtype == torch.bfloat16 and torch.equal(b.view(torch.int16),
                                                             t.view(torch.int16))
            a.view(np.int16)[...] += 1  # the revived tensors share no memory with the snapshot
            assert torch.equal(b.view(torch.int16), t.view(torch.int16))
            a.view(np.int16)[...] -= 1
    jbanked = tree_map(lambda t: jnp.asarray(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)),
                       banked)
    jhost = jfilt.slot_to_host(jfilt.slot_extract(jbanked, 1))
    jleaves = [jhost[k] for k in sorted(jhost)] if isinstance(jhost, dict) else [jhost]
    leaves = [host[k] for k in sorted(host)] if isinstance(host, dict) else [host]
    for a, j in zip(leaves, jleaves):
        assert np.asarray(j).dtype.name == "bfloat16"
        assert np.array_equal(a.view(np.int16), np.asarray(j).view(np.int16))
