"""The four dense architectures (smoke configs) through the port's
``build_model`` against the JAX reference's, on the CPU, with the
reference's parameters carried over (``convert.params_from_reference``)
and the same token batches (``make_train_batch``, the same numpy draws).

Tolerances, as fractions of the reference's largest |logit| (measured in
brackets, over the four archs):

* float32: ``F32_RTOL`` 3e-5 (1.6e-5, gemma3's 12 layers; 2e-6 to 9e-6
  for the others). Each framework multiplies in its own order and
  evaluates ``exp``/``rsqrt`` with its own libm. Loss: relative 1e-6
  (1.5e-7).
* bfloat16: ``BF16_RTOL`` 0.1 (8.7e-2 for gemma3, 3.3e-2 at most for the
  others). XLA fuses each scanned layer and keeps float32 between fused
  ops where eager PyTorch rounds after every op. That is smaller than
  what bfloat16 itself costs: both packages' bfloat16 logits lie 8e-2 to
  4e-1 of max |logit| from their float32 ones, and the test holds the
  port's gap to the reference under the reference's own gap to float32.
  Loss: relative 5e-3 (1.5e-3).
* the port's prefill-then-decode against its own forward: ``TOL`` 2e-3,
  the reference's limit in ``tests/test_decode_consistency.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.launch.inputs import make_train_batch as jmake_train_batch
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models import build_model

DENSE = ("h2o-danube-1.8b", "qwen2.5-32b", "command-r-35b", "gemma3-1b")
F32_RTOL, BF16_RTOL = 3e-5, 0.1
LOSS_RTOL = {"float32": 1e-6, "bfloat16": 5e-3}
TOL = 2e-3
B, S = 2, 10  # S % window != 0 for the ring caches (window 8)


@pytest.fixture(scope="module")
def carried():
    """arch -> the reference's smoke parameters, as numpy leaves."""
    out = {}
    for arch in DENSE:
        params = jbuild_model(jget_config(arch, smoke=True)).init(jax.random.PRNGKey(0))
        out[arch] = jax.tree_util.tree_map(np.asarray, params)
    return out


def _models(arch, dtype):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype=dtype)
    return cfg, build_model(cfg), jcfg, jbuild_model(jcfg)


def _rel(got, want, scale):
    got = got.float().numpy()
    return float(np.abs(got - np.asarray(want, np.float32)).max()) / scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_loss_prefill_decode_match_the_reference(arch, dtype, carried):
    cfg, m, jcfg, jm = _models(arch, dtype)
    jp = carried[arch]
    p = convert.params_from_reference(jp, device="cpu")
    tb = make_train_batch(cfg, B, S + 1, device="cpu")
    jb = jmake_train_batch(jcfg, B, S + 1)
    assert all(np.array_equal(tb[k].numpy(), np.asarray(jb[k])) for k in jb)

    want = np.asarray(jm.forward(jp, jb), np.float32)
    scale = float(np.abs(want).max())
    got = m.forward(p, tb)
    assert got.dtype == getattr(__import__("torch"), dtype)
    err = _rel(got, want, scale)
    if dtype == "float32":
        assert err <= F32_RTOL, err
    else:
        f32 = np.asarray(jbuild_model(dataclasses.replace(jcfg, dtype="float32")).forward(jp, jb))
        assert err <= min(BF16_RTOL, float(np.abs(want - f32).max()) / scale), err
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL

    loss, jloss = float(m.loss(p, tb)), float(jm.loss(jp, jb))
    assert abs(loss - jloss) <= LOSS_RTOL[dtype] * abs(jloss)

    pre = {k: v[:, :S] for k, v in tb.items()}
    jpre = {k: v[:, :S] for k, v in jb.items()}
    logits, caches = m.prefill(p, pre, max_len=S + 4)
    jlogits, jcaches = jm.prefill(jp, jpre, max_len=S + 4)
    assert _rel(logits, jlogits, scale) <= tol
    for seg, jseg in zip(caches, jcaches, strict=True):
        for c, jc in zip(seg, jseg, strict=True):
            assert np.array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
            assert c["k"].shape == jc["k"].shape and c["k"].dtype == logits.dtype

    logits, _ = m.decode_step(p, caches, {"token": tb["tokens"][:, S:S + 1]}, S)
    jlogits, _ = jm.decode_step(jp, jcaches, {"token": jb["tokens"][:, S:S + 1]},
                                jnp.asarray(S, jnp.int32))
    assert _rel(logits, jlogits, scale) <= tol


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_forward(arch, carried):
    cfg, m, _, _ = _models(arch, "float32")
    p = convert.params_from_reference(carried[arch], device="cpu")
    tb = make_train_batch(cfg, B, S + 3, device="cpu")
    full = m.forward(p, tb).numpy()
    logits, caches = m.prefill(p, {"tokens": tb["tokens"][:, :S]}, max_len=S + 4)
    rel = np.abs(logits.numpy() - full[:, S - 1]).max() / np.abs(full[:, S - 1]).max()
    assert rel < TOL, f"prefill mismatch {rel}"
    for i in range(S, S + 3):
        logits, caches = m.decode_step(p, caches, {"token": tb["tokens"][:, i:i + 1]}, i)
        rel = np.abs(logits.numpy() - full[:, i]).max() / np.abs(full[:, i]).max()
        assert rel < TOL, f"decode step {i}: {rel}"


def test_ring_cache_long_decode(carried):
    """Decode far past the window: the ring cache keeps only the last 8."""
    cfg, m, _, _ = _models("h2o-danube-1.8b", "float32")
    p = convert.params_from_reference(carried["h2o-danube-1.8b"], device="cpu")
    n_total = 24  # 3x the window of 8
    tb = make_train_batch(cfg, B, n_total, device="cpu")
    full = m.forward(p, tb).numpy()
    _, caches = m.prefill(p, {"tokens": tb["tokens"][:, :8]})
    assert caches[0][0]["k"].shape[2] == 8
    for i in range(8, n_total):
        logits, caches = m.decode_step(p, caches, {"token": tb["tokens"][:, i:i + 1]}, i)
        rel = np.abs(logits.numpy() - full[:, i]).max() / np.abs(full[:, i]).max()
        assert rel < TOL, f"step {i}: {rel}"
    assert sorted(caches[0][0]["pos"][0].tolist()) == list(range(n_total - 8, n_total))


def test_decode_consumes_the_callers_caches(carried):
    """Caches are updated in place: the reference returns new ones."""
    cfg, m, _, _ = _models("gemma3-1b", "float32")
    p = convert.params_from_reference(carried["gemma3-1b"], device="cpu")
    tb = make_train_batch(cfg, B, S + 1, device="cpu")
    _, caches = m.prefill(p, {"tokens": tb["tokens"][:, :S]}, max_len=S + 4)
    before = caches[0][5]["pos"].clone()  # the global layer's full cache
    _, out = m.decode_step(p, caches, {"token": tb["tokens"][:, S:S + 1]}, S)
    assert out[0][5]["k"] is caches[0][5]["k"]
    assert before[0, S] == -1 and caches[0][5]["pos"][0, S] == S
