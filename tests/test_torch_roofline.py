"""Port parity of the roofline counter (``repro_torch.roofline``) against
the reference's HLO counter (``repro.roofline.hlo_costs``), on the CPU.

* The four single-device cases of ``tests/test_hlo_costs.py``, each scan
  written as the Python loop an eager step runs: FLOPs equal to the
  closed form and within ``FLOPS_RTOL`` 1 % of the reference's
  ``hlo_costs.analyze`` of the jitted scan; the slice-aware bytes inside
  the reference test's bounds.
* ``launch.steps``' train, prefill and decode steps of smoke configs,
  counted on ``meta`` tensors, against ``hlo_costs.analyze`` of the
  reference's jitted step on a 1 x 1 mesh at the same shapes. Dense
  (danube), SSD (mamba2): FLOPs within ``FLOPS_RTOL`` (measured: equal;
  mamba2's train step 0.33 % under). MoE (mixtral, deepseek): the
  reference routes with dense dispatch and combine einsums
  (``repro/models/moe.py:92-114``, ``gtke,gtkc->gtec``,
  ``gtec,gtd->gecd``, ``gtec,gecd->gtd``), which XLA counts as ``dot``s;
  the port routes with a scatter and a gather (``index_copy_`` and an
  indexed read, ``aten.index``: no products). The port's count plus
  those einsums' FLOPs (:func:`_dispatch_flops`: 2 forward products of
  E·C·D and 2 of E·C·k per group of tokens; backward 3 and 1 more) is
  held within ``FLOPS_RTOL`` of the reference's (measured within
  0.001 %).
* The peak tracker: the exact high-water mark of small functions whose
  peak is known, on ``meta`` and on CPU tensors alike, and a backward's
  peak as autograd runs it without a dispatch mode (where the profiler
  shows it summing two gradients in place, and where out of place). With
  checkpointing, a forward recomputed inside backward keeps the forward's
  rules: a smoke train step's counted peak beyond its arguments lies
  within ``PEAK_BAND`` of the one the CPU profiler measures for the bare
  step, remat off and on, and so does a function whose peak is a
  recomputed ``add``.
* Remat's products: a train step with remat counts, beyond the one
  without, each microbatch's forward less the head's product and each
  layer's MLP down projection (``torch.utils.checkpoint`` stops once the
  backward's saved tensors are rebuilt, and the embedding and head lie
  outside the checkpointed layers).
* ``io_bytes``, the bytes a call must move: every input once, every
  fresh output once, and what the call writes into an input.
* ``analysis``: ``summarize_cell`` gives the reference's string on the
  same record, ``model_flops`` the same number, and the terms are the
  counted FLOPs and bytes over ``HW.PEAK_BF16_FLOPS`` and ``HW.HBM_BW``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import steps as JS
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models import build_model as jbuild_model
from repro.optim import AdamW as JAdamW
from repro.roofline import analysis as jra
from repro.roofline import hlo_costs
from repro_torch.configs import get_config
from repro_torch.launch import steps as S
from repro_torch.launch.inputs import make_train_batch
from repro_torch.launch.mesh import HW, make_mesh
from repro_torch.models import build_model
from repro_torch.models.moe import _capacity, _group_size
from repro_torch.optim import AdamW
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import op_costs

FLOPS_RTOL = 0.01
#: the counted peak beyond the arguments over the CPU profiler's measured
#: one: the counter sees every storage but no operator's own scratch
#: (measured 0.986-1.0 on the smoke steps)
PEAK_BAND = (0.95, 1.0)
#: smoke shapes of the step comparison
BATCH, SEQ, MICRO = 4, 32, 2


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads for this file's tests, the caller's count after."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _reference(fn, *shapes) -> dict:
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return hlo_costs.analyze(jax.jit(fn).lower(*specs).compile().as_text())


# ---------------------------------------------------------------------------
# the cases of tests/test_hlo_costs.py
# ---------------------------------------------------------------------------


def test_loop_flops_count_every_iteration():
    def f(a, ws):
        for w in ws:
            a = a @ w
        return a

    def jf(a, ws):
        return jax.lax.scan(lambda x, w: (x @ w, None), a, ws)[0]

    r = op_costs.analyze(f, _meta(128, 128), _meta(12, 128, 128))
    expected = 12 * 2 * 128**3
    assert r["flops"] == expected
    ref = _reference(jf, (128, 128), (12, 128, 128))
    assert abs(r["flops"] - ref["flops"]) / ref["flops"] < FLOPS_RTOL


def test_nested_loops():
    def g(a, ws):
        for w2 in ws:
            for w in w2:
                a = a @ w
        return a

    def jg(a, ws):
        def outer(x, w2):
            return jax.lax.scan(lambda y, w: (y @ w, None), x, w2)[0], None
        return jax.lax.scan(outer, a, ws)[0]

    r = op_costs.analyze(g, _meta(64, 64), _meta(5, 4, 64, 64))
    expected = 20 * 2 * 64**3
    assert r["flops"] == expected
    ref = _reference(jg, (64, 64), (5, 4, 64, 64))
    assert abs(r["flops"] - ref["flops"]) / ref["flops"] < FLOPS_RTOL


def test_einsum_with_batch_dims():
    r = op_costs.analyze(lambda x, w: torch.einsum("bshd,btd->bsht", x, w),
                         _meta(4, 32, 8, 64), _meta(4, 128, 64))
    expected = 2 * 4 * 32 * 8 * 128 * 64
    assert r["flops"] == expected
    ref = _reference(lambda x, w: jnp.einsum("bshd,btd->bsht", x, w),
                     (4, 32, 8, 64), (4, 128, 64))
    assert abs(r["flops"] - ref["flops"]) / ref["flops"] < FLOPS_RTOL


def test_bytes_slice_aware():
    """A loop over a stacked operand charges each step its window, not
    the whole stack."""

    def f(a, ws):
        for w in ws:
            a = torch.tanh(a + w)
        return a

    r = op_costs.analyze(f, _meta(256, 256), _meta(100, 256, 256))
    assert r["bytes"] < 0.5e9, r["bytes"]
    assert r["bytes"] > 100 * 256 * 256 * 4
    # per step: add reads two windows and writes one, tanh reads and writes one
    assert r["bytes"] == 100 * 5 * 256 * 256 * 4
    assert r["flops"] == 0 and set(r["collectives"]) == set(hlo_costs._COLLECTIVES)
    assert not any(r["collectives"].values())


# ---------------------------------------------------------------------------
# the smoke configs' steps against the reference's jitted steps
# ---------------------------------------------------------------------------


def _dispatch_flops(cfg, kind: str) -> float:
    """FLOPs of the reference's MoE dispatch/combine einsums, which the
    port's scatter and gather replace."""
    if not cfg.num_experts:
        return 0.0
    if kind == "train":
        per_call, tokens, calls = (1, 3), BATCH // MICRO * SEQ, MICRO
    elif kind == "prefill":
        per_call, tokens, calls = (0, 0), BATCH * SEQ, 1
    else:
        per_call, tokens, calls = (0, 0), BATCH, 1
    gs = _group_size(tokens, cfg)
    ng, cap, e = tokens // gs, _capacity(gs, cfg), cfg.num_experts
    by_d = 2.0 * ng * gs * e * cap * cfg.d_model        # gtec,gtd->gecd; gtec,gecd->gtd
    by_k = 2.0 * ng * gs * e * cap * cfg.num_experts_per_tok  # the disp/comb one-hots
    backward_k, backward_d = per_call
    per_layer = (2 + backward_d) * by_d + (2 + backward_k) * by_k
    return calls * (cfg.num_layers - cfg.first_dense_layers) * per_layer


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-780m", "mixtral-8x7b",
                                  "deepseek-v2-lite-16b"])
def test_smoke_step_flops_match_the_reference_hlo_count(arch, kind):
    jmodel = jbuild_model(jget_config(arch, smoke=True))
    model = build_model(get_config(arch, smoke=True))
    jmesh = jmake_mesh((1, 1), ("data", "model"))
    mesh = make_mesh((1, 1), ("data", "model"), device="meta")
    jrules, rules = JS.resolve_rules(jmodel.cfg, jmesh), S.resolve_rules(model.cfg, mesh)
    with jmesh:
        if kind == "train":
            jitted, jabstract = JS.jit_train_step(jmodel, JAdamW(), jmesh, jrules,
                                                  microbatches=MICRO, batch=BATCH, seq=SEQ)
            step, abstract = S.jit_train_step(model, AdamW(), mesh, rules,
                                              microbatches=MICRO, batch=BATCH, seq=SEQ)
        elif kind == "prefill":
            jitted, jabstract = JS.jit_prefill_step(jmodel, jmesh, jrules, batch=BATCH, seq=SEQ)
            step, abstract = S.jit_prefill_step(model, mesh, rules, batch=BATCH, seq=SEQ)
        else:
            jitted, jabstract = JS.jit_decode_step(jmodel, jmesh, jrules, batch=BATCH, seq=SEQ)
            step, abstract = S.jit_decode_step(model, mesh, rules, batch=BATCH, seq=SEQ)
            abstract = abstract[:3] + (SEQ - 1,)  # the last position: every cache slot
        ref = hlo_costs.analyze(jitted.lower(*jabstract).compile().as_text())
    got = op_costs.analyze(step, *abstract)
    extra = _dispatch_flops(model.cfg, kind)
    assert (extra > 0) == bool(model.cfg.num_experts)
    assert abs(got["flops"] + extra - ref["flops"]) / ref["flops"] < FLOPS_RTOL, (
        got["flops"], extra, ref["flops"], got["flops_by_op"])
    if extra:
        assert got["flops"] < ref["flops"]
    assert got["bytes"] > 0 and got["peak_bytes"] >= got["argument_bytes"] > 0
    if kind != "prefill":  # train and decode update their state in place
        assert got["alias_bytes"] > 0


# ---------------------------------------------------------------------------
# the peak tracker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_peak_tracker_is_exact(device):
    n = 64 * 64 * 4  # bytes of one (64, 64) float32

    def f(x):
        a = x * 2          # x, a
        b = a + 1          # x, a, b: 3n
        del a              # x, b
        c = b * 3          # x, b, c
        d = c @ x          # x, b, c, d: 4n, the peak
        del b, c
        return d

    r = op_costs.analyze(f, torch.zeros(64, 64, device=device))
    assert (r["argument_bytes"], r["peak_bytes"], r["temp_bytes"]) == (n, 4 * n, 3 * n)
    assert r["output_bytes"] == n and r["alias_bytes"] == 0
    assert r["flops"] == 2 * 64**3

    def g(x, big):
        head = big[:1].clone()      # a copy: big's storage is not the result's
        view = torch.ones(1024, 64, device=x.device)[:2]  # the base stays live
        x.add_(1)                    # in place: no new storage, bytes read and written
        return x, head + view[:1]

    r = op_costs.analyze(g, torch.zeros(64, device=device), torch.zeros(8, 64, device=device))
    args = 64 * 4 + 8 * 64 * 4
    assert r["argument_bytes"] == args
    assert r["peak_bytes"] == args + 64 * 4 + 1024 * 64 * 4 + 64 * 4
    assert r["alias_bytes"] == 64 * 4  # x comes back, updated in place


def _bare_accumulation_is_in_place(fn, *args) -> bool:
    """Whether autograd, run without any dispatch mode, sums the two
    gradients of ``w`` in place: the profiler sees no ``aten::add`` that
    allocates a (V, D) result."""
    n = args[0].numel() * args[0].element_size()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                profile_memory=True) as prof:
        fn(*args)
    return not any(e.name == "aten::add" and e.self_cpu_memory_usage == n
                   for e in prof.events())


def test_peak_counts_the_backward_as_it_runs_without_the_counter():
    """Under a dispatch mode autograd scatters an indexed read's gradient
    into a zero-filled buffer out of place and sums a tensor's two
    gradients out of place; run bare, it writes both in place where the
    running sum is a dense tensor of its own. The counter's peak is the
    bare run's."""
    v, d, b = 1024, 64, 8
    grad = v * d * 4  # bytes of one (V, D) float32 gradient

    def two_uses(w, idx):  # the sum's first operand is a fresh dense tensor
        y = (w[idx] * 2).sum() + (w * 3).sum()
        return torch.autograd.grad(y, [w])[0]

    def tied(w, idx):  # the first operand is a transposed view: summed out of place
        y = (w[idx] @ w.t()).sum()
        return torch.autograd.grad(y, [w])[0]

    w, idx = torch.randn(v, d, requires_grad=True), torch.randint(0, v, (b,))
    assert _bare_accumulation_is_in_place(two_uses, w, idx)
    assert not _bare_accumulation_is_in_place(tied, w, idx)
    for device in ("cpu", "meta"):
        args = (w.detach().to(device).requires_grad_(), idx.to(device))
        # bare: the (w * 3) gradient and the zero-filled buffer, then both
        # written in place; small: the (B, D) gradients and scalars
        temp = op_costs.analyze(two_uses, *args)["temp_bytes"]
        assert 2 * grad <= temp < 2 * grad + 4 * b * d * 4, temp
        # bare: the transposed gradient, the scattered one and their sum
        temp = op_costs.analyze(tied, *args)["temp_bytes"]
        assert 3 * grad <= temp < 3 * grad + 4 * b * v * 4, temp


def _measured_temp_peak(fn, *args) -> int:
    """The high-water mark of the CPU allocator's bytes while ``fn`` runs
    bare, beyond what was allocated before: the profiler's running total
    at each allocation and free."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                profile_memory=True) as prof:
        fn(*args)
    totals = []

    def walk(node):
        if type(node.extra_fields).__name__ == "_ExtraFields_Allocation":
            totals.append(node.extra_fields.total_allocated)
        for child in node.children:
            walk(child)

    for root in prof.profiler.kineto_results.experimental_event_tree():
        walk(root)
    assert totals, "the profiler recorded no allocation"
    return max(totals)


def _in_band(counted: int, measured: int) -> bool:
    return PEAK_BAND[0] <= counted / measured <= PEAK_BAND[1]


def test_peak_counts_a_forward_recomputed_inside_backward():
    """Non-reentrant checkpointing reruns a forward inside backward, while
    an autograd node is current. Its ``add``, whose first operand dies
    right after it, is no gradient sum of the engine: held to the bare
    run's bytes, the peak (the recomputed ``h @ w`` and its sum beside the
    gradient of ``p``) would read one (N, 8D) tensor low."""
    n, d = 1024, 64
    unit = n * 8 * d * 4

    def layer(h, w, b):
        return torch.relu((h @ w + b)[:, :1])

    def f(x, w, b, p):
        h = torch.utils.checkpoint.checkpoint(layer, x, w, b, use_reentrant=False)
        y = h.sum() + (p * 3).sum()
        return torch.autograd.grad(y, [w, p])

    gen = torch.Generator().manual_seed(0)
    x, w, b, p = (torch.randn(s, generator=gen) for s in ((n, d), (d, 8 * d), (8 * d,),
                                                            (n, 8 * d)))
    measured = _measured_temp_peak(f, x, w.requires_grad_(), b, p.requires_grad_())
    assert 3 * unit <= measured < 3 * unit + unit // 8, measured
    for device in ("cpu", "meta"):
        args = (x.to(device), w.detach().to(device).requires_grad_(), b.to(device),
                p.detach().to(device).requires_grad_())
        temp = op_costs.analyze(f, *args)["temp_bytes"]
        assert _in_band(temp, measured), (device, temp, measured)


@pytest.mark.parametrize("remat,policy", [(False, "minimal"), (True, "minimal"),
                                          (True, "dots")])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma3-1b"])
def test_smoke_train_step_peak_matches_the_bare_cpu_run(arch, remat, policy):
    """The counter's peak of a train step traced on ``meta`` against the
    peak the CPU profiler measures for the same step run bare (gemma3 ties
    its embedding: the indexed read's scattered gradient and a gradient
    sum)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat, remat_policy=policy)
    model = build_model(cfg)
    meta_mesh = make_mesh((1, 1), ("data", "model"), device="meta")
    step, abstract = S.jit_train_step(model, AdamW(), meta_mesh,
                                      S.resolve_rules(cfg, meta_mesh), microbatches=MICRO,
                                      batch=BATCH, seq=SEQ)
    counted = op_costs.analyze(step, *abstract)
    cpu_mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    step, _ = S.jit_train_step(model, AdamW(), cpu_mesh, S.resolve_rules(cfg, cpu_mesh),
                               microbatches=MICRO, batch=BATCH, seq=SEQ)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt_state = AdamW().init(params)
    data = make_train_batch(cfg, BATCH, SEQ, microbatches=MICRO, device="cpu")
    measured = _measured_temp_peak(step, params, opt_state, data)
    assert _in_band(counted["temp_bytes"], measured), (counted["temp_bytes"], measured)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma3-1b"])
def test_remat_recomputes_each_layer_but_its_down_projection(arch):
    off = dataclasses.replace(get_config(arch, smoke=True), remat=False)
    on = dataclasses.replace(off, remat=True, remat_policy="minimal")
    mesh = make_mesh((1, 1), ("data", "model"), device="meta")
    flops = {}
    for name, cfg in (("off", off), ("on", on)):
        step, abstract = S.jit_train_step(build_model(cfg), AdamW(), mesh,
                                          S.resolve_rules(cfg, mesh), microbatches=MICRO,
                                          batch=BATCH, seq=SEQ)
        flops[name] = op_costs.analyze(step, *abstract)["flops"]
    params, _, batch = abstract
    forward = op_costs.analyze(build_model(off).loss, params,
                               {k: v[0] for k, v in batch.items()})["flops"]
    tokens = BATCH // MICRO * SEQ
    head = 2 * tokens * off.d_model * off.vocab_size
    down = 2 * tokens * off.d_ff * off.d_model * off.num_layers
    assert flops["on"] - flops["off"] == MICRO * (forward - head - down) > 0


def test_io_bytes_read_every_input_and_write_what_the_call_writes():
    def f(x, cache, rows, idx):
        cache[:, 3] = x[:, 0]                 # a (4,) window written
        rows.index_copy_(0, idx, x[:2])       # two rows written
        return x * 2, cache, rows             # a fresh (4, 8): written once

    x, cache = _meta(4, 8), _meta(4, 16)
    rows, idx = _meta(32, 8), torch.empty(2, dtype=torch.int64, device="meta")
    r = op_costs.analyze(f, x, cache, rows, idx)
    reads = (4 * 8 + 4 * 16 + 32 * 8) * 4 + 2 * 8
    assert r["argument_bytes"] == reads
    assert r["io_bytes"] == reads + 4 * 4 + 2 * 8 * 4 + 4 * 8 * 4

    def g(p, m):  # AdamW-like: three passes over m, one over p
        m.mul_(0.9)
        m.add_(p, alpha=0.1)
        m.copy_(m.sqrt())
        p.sub_(m)
        return p, m

    p, m = _meta(64), _meta(64)
    r = op_costs.analyze(g, p, m)
    assert r["io_bytes"] == 2 * (64 * 4) + 2 * (64 * 4)  # each read once, written once
    assert r["bytes"] > r["io_bytes"]


def test_views_and_detach_are_free_and_in_place_ops_count():
    def f(x):
        y = x.view(4, 16).t().detach()[1:]
        y.mul_(2)
        return y

    r = op_costs.analyze(f, torch.zeros(64, device="meta"))
    # mul_ reads its (15, 4) window and writes it back (operand + result)
    assert r["bytes"] == 2 * 15 * 4 * 4
    assert r["temp_bytes"] == 0 and r["alias_bytes"] == 64 * 4


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------


def test_analysis_matches_the_reference_formulas():
    for n, tokens, train in ((999_812_736, 1024, True), (1_831_201_280, 128, False)):
        assert ra.model_flops(n, tokens, train=train) == jra.model_flops(n, tokens, train=train)
    cost = op_costs.analyze(lambda a, b: torch.tanh(a @ b), _meta(512, 256), _meta(256, 128))
    del cost["result"]
    terms = ra.roofline_terms(cost)
    assert terms.compute_s == cost["flops"] / HW.PEAK_BF16_FLOPS
    assert terms.memory_s == cost["bytes"] / HW.HBM_BW
    bound_s, bound_by = ra.step_bound(cost)
    io_s = cost["io_bytes"] / HW.HBM_BW
    assert bound_s == max(terms.compute_s, io_s) and bound_s <= terms.step_time_s
    assert bound_by == ("operations" if terms.compute_s >= io_s else "bytes")
    assert terms.collective_s == 0.0 and terms.coll_bytes == 0
    assert terms.dominant == ("compute" if terms.compute_s > terms.memory_s else "memory")
    assert terms.step_time_s == max(terms.compute_s, terms.memory_s)
    assert ra.roofline_terms_corrected(cost) == terms
    ref_terms = jra.RooflineTerms(**{f: getattr(terms, f) for f in
                                     ("compute_s", "memory_s", "collective_s", "flops",
                                      "bytes_accessed", "coll_bytes")})
    assert terms.asdict() == ref_terms.asdict()
    record = {"arch": "gemma3-1b", "shape": "train_4k", "mesh": "1x1",
              "roofline": terms.asdict(), "useful_flops_ratio": 0.7875}
    assert ra.summarize_cell(record) == jra.summarize_cell(record)
    assert math.isclose(cost["flops"], 2 * 512 * 256 * 128)
