"""Persistent JSON plan cache with crash-safe writes and stale fallback
(counterpart of ``repro.tune.cache``, copied, not imported: the same file
format, schema check, atomic write and ``REPRO_TUNE_CACHE_PATH``, so both
packages read and write one file; the port's keys name the card and the
torch build, so neither package reads the other's entries).

Layout (one file, a flat key -> entry map)::

    {
      "version": 1,
      "entries": {
        "v1/stream/p500h80w256k1/uint16->float32/pallas/NVIDIA_H100_80GB_HBM3/torch2.11.0+cu128":
            {"row_tile": 20, "pair_tile": 1, "measured_s": ..., ...},
        "v1/exec/pair_average/g8n1000h80w256/pallas/NVIDIA_H100_80GB_HBM3/torch2.11.0+cu128":
            {"num_slots": 3, "frames_per_chunk": 1000, ...}
      }
    }

Contract (exercised by ``tests/test_torch_tune.py``, as the reference's):

* **Malformed or stale never crashes.** A file that fails to parse, has
  the wrong top-level shape, or carries a different ``version`` reads as
  *empty*: ``"auto"`` mode re-tunes, explicit-path mode falls back to the
  heuristic. The broken file is left in place (diagnosable) until the
  next successful ``put`` atomically replaces it.
* **Atomic writes.** Same temp-file + ``os.replace`` discipline as
  ``bench_record``: a writer dying mid-put can never leave truncated JSON.
* **Location.** ``REPRO_TUNE_CACHE_PATH`` env var, else
  ``~/.cache/repro-denoise/plans.json`` — never inside the repo.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile

from repro_torch.tune.plan import SCHEMA_VERSION

__all__ = ["PlanCache", "default_cache_path"]

_ENV_VAR = "REPRO_TUNE_CACHE_PATH"


def default_cache_path() -> pathlib.Path:
    env = os.environ.get(_ENV_VAR)
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "repro-denoise" / "plans.json"


class PlanCache:
    """File-backed key -> dict store; loads lazily, tolerates anything."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = pathlib.Path(path) if path is not None else default_cache_path()
        self._entries: dict[str, dict] | None = None
        self.stale = False  # last load found a malformed/old-version file

    # -- read ---------------------------------------------------------------
    def _load(self) -> dict[str, dict]:
        if self._entries is not None:
            return self._entries
        self._entries = {}
        self.stale = False
        if self.path.exists():
            try:
                doc = json.loads(self.path.read_text())
            except (json.JSONDecodeError, OSError):
                doc = None
            if (
                isinstance(doc, dict)
                and doc.get("version") == SCHEMA_VERSION
                and isinstance(doc.get("entries"), dict)
            ):
                self._entries = {
                    k: v for k, v in doc["entries"].items()
                    if isinstance(v, dict)
                }
            else:
                self.stale = True  # present but unusable -> treat as empty
        return self._entries

    def get(self, key: str) -> dict | None:
        return self._load().get(key)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    # -- write --------------------------------------------------------------
    def put(self, key: str, entry: dict) -> None:
        entries = dict(self._load())
        entries[key] = entry
        self.path.parent.mkdir(parents=True, exist_ok=True)
        doc = {"version": SCHEMA_VERSION, "entries": entries}
        fd, tmp = tempfile.mkstemp(
            dir=self.path.parent, prefix=f".{self.path.name}.", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(doc, indent=2, sort_keys=True) + "\n")
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._entries = entries
        self.stale = False
