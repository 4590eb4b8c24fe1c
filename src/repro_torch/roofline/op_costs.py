"""Operator-level cost counter of one eager call (counterpart of
``repro.roofline.hlo_costs``).

The reference walks the optimized HLO of a compiled step and multiplies
loop bodies by their trip counts. The port has no HLO: PyTorch runs a step
eagerly, operator by operator, and every iteration of a Python loop
dispatches its own operators, so counting what is dispatched needs no
trip-count correction. :func:`analyze` runs ``fn`` once under
``torch.utils.flop_counter.FlopCounterMode`` and one
``TorchDispatchMode`` of its own, on ``meta`` tensors (shapes and dtypes,
no storage: nothing is computed) or on real ones alike.

Counting rules, the reference's as far as they carry over:

* ``flops``: products only, as the reference counts ``dot``s: the matrix
  products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``_scaled_mm``) and
  the fused attention products, at 2 FLOPs a multiply-add, from
  ``FlopCounterMode``'s formulas. Backward products count like forward ones.
* ``bytes``: each operator's tensor operands and results, numel times
  element size. In eager mode every operator is a kernel, so its operands
  and results are its HBM traffic: the counterpart of "a fusion boundary
  is the HBM traffic boundary". An operand that is a view counts its
  window, not its base (the reference's slice-aware rule). Free: views
  (every result shares an operand's storage and nothing is written),
  ``detach``, and the factories that allocate without writing (``empty``
  and its kin). This is what the eager implementation moves, not what the
  function must move: it falls whenever operators fuse, so it bounds
  nothing.
* ``io_bytes``: the bytes the function must move, each input read once
  and each output written once: every argument's storage, every storage
  the result holds that no argument held, and of an argument's storage
  what the call writes into it (in place or ``out=``; a scatter writes its
  source's bytes), at most the storage's size. With the products this
  gives the call's bound (``analysis.step_bound``).
* ``peak_bytes``: the high-water mark of live storage bytes, the
  arguments' storages included (``argument_bytes``); ``temp_bytes`` is
  the peak beyond them. A storage is live from the operator that returns
  it until its last tensor dies (tracked by a weak reference, so the
  counter keeps nothing alive). Workspaces an operator allocates inside
  itself (cuBLAS's, a sort's scratch) are invisible here. While any
  dispatch mode is active, autograd takes out-of-place variants where it
  otherwise writes in place: the backward of an indexed read (``index``,
  ``gather``) scatters into a fresh zero-filled buffer (``index_put``,
  ``scatter_add``), and the engine sums two gradients of one tensor with
  ``add`` (in place only with grad mode off: ``InputBuffer::accumulate``).
  Inside the backward proper (an autograd node is current and grad mode
  is off; a forward that checkpointing recomputes there runs with grad
  mode on, and keeps its own rules), the counter holds such a scatter's
  result to the buffer's bytes, and an ``add`` whose first operand (the
  engine's running sum: dense, no view, the result's size) dies right
  after it to that operand's bytes, so the peak is the step's as it runs
  without the counter.
* ``alias_bytes``: the arguments' storages that the result hands back,
  the leaves a step updates in place (the reference's donated buffers).
* ``collectives``: the reference's five kinds, all 0. The port runs every
  step on one device and dispatches no collective; a mesh over several
  cards is ROADMAP.md queue A item 13(d).
"""

from __future__ import annotations

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["analyze", "COLLECTIVES", "PRODUCT_OPS"]

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_aten = torch.ops.aten
#: the operators whose FLOPs count: matrix products and fused attention
PRODUCT_OPS = frozenset(
    getattr(_aten, name) for name in (
        "mm", "addmm", "bmm", "baddbmm", "_scaled_mm",
        "_scaled_dot_product_efficient_attention",
        "_scaled_dot_product_flash_attention",
        "_scaled_dot_product_cudnn_attention",
        "_scaled_dot_product_efficient_attention_backward",
        "_scaled_dot_product_flash_attention_backward",
        "_scaled_dot_product_cudnn_attention_backward",
        "_flash_attention_forward", "_efficient_attention_forward",
        "_flash_attention_backward", "_efficient_attention_backward",
    ) if hasattr(_aten, name)
)
#: factories that allocate without writing: no traffic
_ALLOCATE_ONLY = frozenset((
    _aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
    _aten.new_empty_strided,
))
#: zero-filled buffers, and the out-of-place scatters that a backward
#: formula applies to such a buffer when a dispatch mode is active
_ZERO_FILLS = frozenset((_aten.zeros, _aten.new_zeros, _aten.zeros_like))
_SCATTERS = frozenset((
    _aten.index_put, _aten.scatter_add, _aten.scatter, _aten.index_add,
    _aten.index_copy, _aten.masked_scatter, _aten.slice_scatter, _aten.select_scatter,
))
#: in-place scatters: they write their source's bytes, not their target's
_IN_PLACE_SCATTERS = frozenset((
    _aten.index_put_, _aten._index_put_impl_, _aten.index_copy_, _aten.index_add_,
    _aten.scatter_, _aten.scatter_add_, _aten.masked_scatter_,
))
_SOURCES = ("values", "source", "src")


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _operator_tensors(args, kwargs, out) -> tuple[list, list]:
    """An operator's tensor operands and results: aten schemas nest
    tensors at most one list deep (``cat``'s ``Tensor[]``)."""
    def flat(items):
        got = []
        for x in items:
            if isinstance(x, torch.Tensor):
                got.append(x)
            elif isinstance(x, (list, tuple)):
                got.extend(y for y in x if isinstance(y, torch.Tensor))
        return got

    ins = flat(args) + (flat(kwargs.values()) if kwargs else [])
    outs = [out] if isinstance(out, torch.Tensor) else flat(out if isinstance(out, (list, tuple))
                                                            else ())
    return ins, outs


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t`` covers its storage without gaps or overlaps in some
    order of its dims (autograd accumulates into such a tensor in place)."""
    expected = 1
    for stride, size in sorted((st, sz) for st, sz in zip(t.stride(), t.shape) if sz != 1):
        if stride != expected:
            return False
        expected *= size
    return True


_WRITES: dict = {}


def _writes(func) -> bool:
    """Whether the operator writes one of its operands (in place, ``out=``)."""
    got = _WRITES.get(func)
    if got is None:
        got = _WRITES[func] = any(a.alias_info is not None and a.alias_info.is_write
                                  for a in func._schema.arguments)
    return got


def _written(func, args, kwargs) -> list[tuple[torch.Tensor, int]]:
    """The operands an operator writes, each with the bytes written into it."""
    kwargs = kwargs or {}
    named = {}
    for i, a in enumerate(func._schema.arguments):
        named[a.name] = args[i] if i < len(args) and not a.kwarg_only else kwargs.get(a.name)
    source = None
    if func.overloadpacket in _IN_PLACE_SCATTERS:
        source = next((named[n] for n in _SOURCES if isinstance(named.get(n), torch.Tensor)),
                      None)
    got = []
    for a in func._schema.arguments:
        if a.alias_info is not None and a.alias_info.is_write:
            value = named[a.name]
            for t in value if isinstance(value, (list, tuple)) else (value,):
                if isinstance(t, torch.Tensor):
                    got.append((t, _nbytes(source if source is not None else t)))
    return got


def _in_backward() -> bool:
    """Whether an operator runs in a backward formula or the engine's own
    work: an autograd node is current and grad mode is off. A forward that
    non-reentrant checkpointing recomputes inside backward runs with grad
    mode on."""
    return torch._C._current_autograd_node() is not None and not torch.is_grad_enabled()


class _Traffic(TorchDispatchMode):
    """Operand and result bytes of every operator, and live storage bytes."""

    def __init__(self, arguments: list[torch.Tensor]):
        super().__init__()
        self.bytes = 0
        self._live: dict[int, tuple[StorageWeakRef, int]] = {}
        self._tracked = 0  # bytes of every tracked storage, some maybe dead
        for t in arguments:
            self._track(t.untyped_storage())
        self.argument_bytes = self._tracked
        self._arguments = set(self._live)
        self.written: dict[int, int] = {}  # bytes written into each argument's storage
        self.peak = self._tracked
        self._fresh = None  # the zero-filled buffer the last operator made
        self._pending = None  # a gradient sum's peak, until its operands' fate is known

    def _track(self, storage) -> None:
        key = storage._cdata
        if key not in self._live:
            n = storage.nbytes()
            self._live[key] = (StorageWeakRef(storage), n)
            self._tracked += n

    def _sweep(self) -> None:
        """Drop the storages that died; ``_tracked`` becomes exact."""
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._tracked -= self._live.pop(k)[1]

    def settle(self) -> None:
        """Settle a backward ``add``'s peak: its out-of-place result stands
        for the engine's in-place sum when its first operand, a dense
        tensor of the result's size and no view, died right after it."""
        if self._pending is not None:
            live, old, n = self._pending
            self._pending = None
            self.peak = max(self.peak, live - n if old.expired() else live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.settle()
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet is _aten.detach or packet in _ALLOCATE_ONLY:
            return out
        ins, outs = _operator_tensors(args, kwargs, out)
        in_storages = {t.untyped_storage()._cdata for t in ins}
        writes = _writes(func)
        if writes or any(t.untyped_storage()._cdata not in in_storages for t in outs):
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if writes:
            for t, n in _written(func, args, kwargs):
                key = t.untyped_storage()._cdata
                if key in self._arguments:
                    self.written[key] = self.written.get(key, 0) + n
        backward = _in_backward()
        fresh, self._fresh = self._fresh, None
        if (backward and packet in _SCATTERS and ins
                and ins[0].untyped_storage()._cdata == fresh):
            # in place without a mode: the result takes the buffer's place
            self._tracked -= self._live.pop(fresh)[1]
        for t in outs:
            self._track(t.untyped_storage())
        if backward and packet in _ZERO_FILLS:
            self._fresh = outs[0].untyped_storage()._cdata
        # the live total only needs to be exact when it could be a new peak
        if self._tracked > self.peak:
            self._sweep()
            if self._tracked > self.peak:
                if packet is _aten.add and backward and _engine_sum(ins[0], outs):
                    n = ins[0].untyped_storage().nbytes()
                    self._pending = (self._tracked, StorageWeakRef(ins[0].untyped_storage()), n)
                else:
                    self.peak = self._tracked
        return out


def _engine_sum(old: torch.Tensor, outs: list) -> bool:
    """Whether a backward ``add`` may be the autograd engine summing two
    gradients into ``old``, its running sum, which the engine writes in
    place without a dispatch mode: a dense tensor of the result's size that
    is no view."""
    return (len(outs) == 1 and not old._is_view() and _dense(old)
            and old.untyped_storage().nbytes() == outs[0].untyped_storage().nbytes())


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its products, bytes and
    live memory. Returns the reference's keys (``flops``, ``bytes``,
    ``collectives``) and ``io_bytes``, ``peak_bytes``, ``argument_bytes``,
    ``temp_bytes``, ``output_bytes`` (the result's storages),
    ``alias_bytes``, ``flops_by_op`` (the products per operator) and
    ``result`` (what ``fn`` returned)."""
    arguments = _tensors((args, kwargs))
    counter = FlopCounterMode(display=False)
    traffic = _Traffic(arguments)
    with counter, traffic:
        result = fn(*args, **kwargs)
    traffic.settle()
    counts = counter.get_flop_counts().get("Global", {})
    by_op = {str(op): int(n) for op, n in counts.items() if op in PRODUCT_OPS}
    arg_keys = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in arguments}
    returned = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _tensors(result)}
    written = sum(min(n, traffic.written.get(k, 0)) for k, n in arg_keys.items())
    return {
        "flops": float(sum(by_op.values())),
        "bytes": float(traffic.bytes),
        "collectives": {k: 0 for k in COLLECTIVES},
        "io_bytes": (traffic.argument_bytes + written
                     + sum(n for k, n in returned.items() if k not in arg_keys)),
        "peak_bytes": traffic.peak,
        "argument_bytes": traffic.argument_bytes,
        "temp_bytes": traffic.peak - traffic.argument_bytes,
        "output_bytes": sum(returned.values()),
        "alias_bytes": sum(n for k, n in arg_keys.items() if k in returned),
        "flops_by_op": by_op,
        "result": result,
    }
