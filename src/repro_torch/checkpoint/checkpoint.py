"""Fault-tolerant checkpointing: atomic, async, device-agnostic
(counterpart of ``repro.checkpoint.checkpoint``).

Design:
  * ATOMIC: write to ``<dir>/.tmp.<name>.<pid>``, fsync the manifest, then
    rename to the final directory — a crash mid-write never corrupts the
    latest checkpoint.
  * ASYNC: ``CheckpointManager.save`` snapshots tensors to host (a copy,
    blocking) and writes in a background thread, so the caller keeps
    stepping and may overwrite its tensors in place meanwhile.
  * DEVICE-AGNOSTIC: leaves are stored as full numpy arrays plus the
    tree's key paths, so a restore can land them on any device — what
    the fleet's session recovery and ``repro_torch.runtime.elastic`` use.

Format, file for file the reference's: one ``leaves.npz`` holding
``leaf_{i}`` and a ``manifest.json`` with ``paths``, ``kinds``,
``num_leaves``, ``step``, ``time`` and ``extra``. Either package reads
the other's checkpoints. A tree is a dict, list or tuple of trees, or a
leaf (a ``torch.Tensor``, a numpy array or scalar); ``None`` holds no
leaf. Leaves are flattened as JAX flattens them: dict keys in sorted
order, sequences by index.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile

import numpy as np
import torch

from repro_torch.kernels import ops

__all__ = [
    "save_tree", "restore_tree", "read_manifest", "CheckpointManager", "to_host", "from_host",
]


def _flatten(tree, path=()):
    """``(path, leaf)`` pairs in JAX's flatten order; a path is a list of
    ``["d", key]`` (dict) and ``["s", index]`` (list/tuple) steps."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (["d", str(k)],))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (["s", i],))
    elif tree is not None:
        yield list(path), tree


def _paths(tree) -> tuple[list[list], list]:
    """Flatten with JSON-able key paths (see :func:`_flatten`)."""
    flat = list(_flatten(tree))
    return [p for p, _ in flat], [leaf for _, leaf in flat]


def flat_leaves(tree) -> list:
    """The leaves of ``tree``, in JAX's flatten order."""
    return [leaf for _, leaf in _flatten(tree)]


def map_tree(fn, tree, *rest):
    """``fn`` over every leaf of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), in ``tree``'s structure:
    dicts, lists and tuples rebuilt as they were, ``None`` kept."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, *args) for args in zip(tree, *rest))
    return None if tree is None else fn(tree, *rest)


def _container_kinds(tree):
    """Record list-vs-tuple kinds along every path so restore is exact."""
    kinds = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            kinds[prefix] = "dict"
            for k, v in node.items():
                walk(v, prefix + f"/d:{k}")
        elif isinstance(node, tuple):
            kinds[prefix] = "tuple"
            for i, v in enumerate(node):
                walk(v, prefix + f"/s:{i}")
        elif isinstance(node, list):
            kinds[prefix] = "list"
            for i, v in enumerate(node):
                walk(v, prefix + f"/s:{i}")

    walk(tree, "")
    return kinds


def _rebuild(paths, leaves, kinds):
    if len(paths) == 1 and not paths[0]:
        # bare-leaf tree (e.g. a filter slot state that is one tensor):
        # the root has no container, the tree IS the leaf
        return leaves[0]
    root: dict = {}

    def insert(container, path, value):
        key = path[0]
        k = key[1]
        if len(path) == 1:
            container[k] = value
        else:
            container.setdefault(k, {})
            insert(container[k], path[1:], value)

    for p, leaf in zip(paths, leaves):
        insert(root, p, leaf)

    def finalize(node, prefix):
        if not isinstance(node, dict):
            return node
        kind = kinds.get(prefix, "dict")
        if kind in ("list", "tuple"):
            items = [
                finalize(node[i], prefix + f"/s:{i}")
                for i in sorted(node, key=int)
            ]
            return tuple(items) if kind == "tuple" else items
        return {k: finalize(v, prefix + f"/d:{k}") for k, v in node.items()}

    return finalize(root, "")


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of tensor ``t`` (a CPU tensor is copied too, so the
    caller may overwrite it in place), dtype kept: the checkpoint and
    migration format. numpy has no bfloat16 without ``ml_dtypes``, so a
    bfloat16 tensor becomes its 2-byte bit patterns as dtype ``V2``, which
    is what the reference's ``restore_tree`` gives back for the bfloat16
    leaf its ``save_tree`` wrote (:func:`from_host` reads them back). A
    DTensor gives its full tensor, whatever the mesh: a collective, which
    every rank of the mesh calls."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _bfloat16_bits(a: np.ndarray) -> bool:
    return a.dtype.kind == "V" and a.dtype.itemsize == 2 and a.dtype.names is None


def from_host(leaf) -> torch.Tensor:
    """The tensor of a host leaf, sharing its memory where ``torch.as_tensor``
    would (a tensor passes through): a 2-byte void array holds bfloat16 bit
    patterns (:func:`to_host`, or a reference checkpoint's bfloat16 leaf)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.asarray(leaf)
    if _bfloat16_bits(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def _host(leaf) -> np.ndarray:
    """A host numpy copy of a leaf: a tensor by :func:`to_host`; anything
    else goes through ``np.asarray`` as in the reference."""
    if isinstance(leaf, torch.Tensor):
        return to_host(leaf)
    return np.asarray(leaf)


def _write_npz(file: str, host: list) -> None:
    """``np.savez(file, leaf_0=..., ...)``, member for member, except that a
    2-byte void leaf (bfloat16 bits) is written under the descr ``'<V2'``:
    the header the reference's ``ml_dtypes`` bfloat16 leaf gets, where
    numpy alone would write ``'|V2'``. Both load as ``V2``."""
    with zipfile.ZipFile(file, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, a in enumerate(host):
            a = np.asanyarray(a)
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as fid:
                if _bfloat16_bits(a):
                    a = np.ascontiguousarray(a)
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
                    fid.write(a.tobytes())
                else:
                    np.lib.format.write_array(fid, a)


def save_tree(
    path: str, tree, *, step: int | None = None, extra: dict | None = None
) -> None:
    """Atomic synchronous save of a tree to ``path`` (a directory).

    ``extra`` is an optional JSON-able dict stored verbatim in the
    manifest — callers (e.g. the fleet's session recovery) use it for
    sidecar metadata like frame counters or a config fingerprint, read
    back via :func:`read_manifest` without loading the arrays.
    """
    paths, leaves = _paths(tree)
    host = [_host(x) for x in leaves]
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp.{os.path.basename(path)}.{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    _write_npz(os.path.join(tmp, "leaves.npz"), host)
    manifest = {
        "paths": paths,
        "kinds": _container_kinds(tree),
        "num_leaves": len(host),
        "step": step,
        "time": time.time(),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def restore_tree(path: str, *, device=None, shardings=None):
    """Restore a tree; returns ``(tree, step)``.

    With ``device=None`` the leaves are host numpy arrays, as the
    reference's without shardings: a checkpoint is a host format (a
    bfloat16 leaf is ``V2``, as the reference's). With a device
    (``"cuda"``, ``"cuda:1"``, ``"cpu"``) they are tensors there, dtype
    kept, bfloat16 too (:func:`from_host`; ``RuntimeError`` for CUDA
    without a card). ``shardings``, a tree of
    ``distributed.sharding.NamedSharding`` matching the checkpoint's,
    places the leaves over its mesh, on the mesh's device (every rank
    reads the file). A bank mesh's placement is
    :func:`repro_torch.runtime.elastic.elastic_reshard`'s.
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "leaves.npz")) as data:
        leaves = [data[f"leaf_{i}"] for i in range(manifest["num_leaves"])]
    tree = _rebuild(manifest["paths"], leaves, manifest["kinds"])
    if device is not None:
        dev = ops.resolve_device(device)
        tree = map_tree(lambda a: from_host(a).to(dev), tree)
    if shardings is not None:
        from repro_torch.distributed.sharding import place

        tree = place(map_tree(from_host, tree), shardings)
    return tree, manifest.get("step")


def read_manifest(path: str) -> dict:
    """The checkpoint's manifest (step, time, extra, leaf count) without
    touching the array payload — cheap existence/metadata probing."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


class CheckpointManager:
    """Keep-N rotating checkpoints with an async writer thread."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ---- paths ----
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    # ---- save ----
    def save(
        self, step: int, tree, *, blocking: bool = False, extra: dict | None = None
    ) -> None:
        self.wait()  # one in-flight write at a time
        # snapshot to host NOW (so the caller may overwrite its tensors)
        host = map_tree(_host, tree)

        def write():
            try:
                save_tree(self._step_dir(step), host, step=step, extra=extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err}") from err

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---- restore ----
    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, *, device=None, shardings=None):
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return restore_tree(self._step_dir(step), device=device, shardings=shardings)

    def manifest(self, step: int | None = None) -> dict | None:
        """Manifest of ``step`` (default latest) or None if no checkpoint."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return read_manifest(self._step_dir(step))
