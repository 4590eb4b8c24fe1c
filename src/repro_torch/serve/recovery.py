"""Per-session filter-state checkpoint/restore for the fleet layer
(counterpart of ``repro.serve.recovery``).

A session's recovery unit is its *slot* — the single-bank filter state the
``slot_extract``/``slot_insert`` hooks move around. :class:`SessionCheckpointer`
persists that slot state through ``repro_torch.checkpoint`` (atomic
rename, keep-N rotation, full numpy leaves), one ``CheckpointManager``
directory per session::

    <dir>/<session>/step_0000000003/{leaves.npz, manifest.json}

The manifest's ``extra`` carries the scheduler-side counters the fleet
needs to resume bookkeeping exactly (frames folded, the config's
``stream_key`` fingerprint for mismatch detection). Restores are
validated against the session's current config: a checkpoint written
under a different stream key raises instead of silently resuming a
stream with the wrong filter/shape. The format and the fingerprint are
the reference's (``DenoiseConfig.stream_key()`` has the same ``repr`` in
both packages), so either package resumes the other's sessions.

Serialization is dtype-preserving numpy (``slot_to_host``), so a
save → restore → ``slot_insert`` round trip is **bit-identical**. Saves
are synchronous (``blocking=True``): the fleet checkpoints from the
executor thread at group boundaries, after the step it snapshots has
finished on the device, and a torn async write racing an executor crash
is exactly the failure mode this layer exists to rule out.
"""

from __future__ import annotations

import os
import threading

from repro_torch.checkpoint import CheckpointManager

__all__ = ["CheckpointMismatch", "SessionCheckpointer"]


class CheckpointMismatch(RuntimeError):
    """A session checkpoint exists but was written under a different
    config ``stream_key`` — resuming it would run the wrong stream."""


class SessionCheckpointer:
    """Keep-N rotating per-session slot-state checkpoints.

    ``every`` is the cadence in *groups folded*: the fleet calls
    :meth:`maybe_save` after every fold and the checkpointer persists on
    multiples of ``every`` (1 = every group — the default, which makes
    recovery replay-free). ``keep`` rotates old checkpoints per session.
    """

    def __init__(self, directory: str, *, every: int = 1, keep: int = 2):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.every = every
        self.keep = keep
        self._lock = threading.Lock()
        self._managers: dict[str, CheckpointManager] = {}

    def _manager(self, session: str) -> CheckpointManager:
        with self._lock:
            mgr = self._managers.get(session)
            if mgr is None:
                mgr = CheckpointManager(
                    os.path.join(self.directory, session), keep=self.keep
                )
                self._managers[session] = mgr
            return mgr

    # -- save ---------------------------------------------------------------
    def maybe_save(
        self, session: str, filt, slot_state, *, steps: int, frames: int
    ) -> bool:
        """Persist if ``steps`` is on the cadence; True when written.

        ``steps`` is the number of groups already folded into
        ``slot_state`` (i.e. the state is the post-fold state of group
        ``steps - 1``); the next fold after a restore uses
        ``step_index=steps``.
        """
        if steps % self.every != 0:
            return False
        self.save(session, filt, slot_state, steps=steps, frames=frames)
        return True

    def save(
        self, session: str, filt, slot_state, *, steps: int, frames: int
    ) -> None:
        """Copy ``slot_state`` to the host (on the calling thread's
        stream, so after the work it queued there) and write it."""
        self._manager(session).save(
            steps,
            filt.slot_to_host(slot_state),
            blocking=True,
            extra={
                "frames": frames,
                "stream_key": repr(filt.config.stream_key()),
            },
        )

    # -- restore ------------------------------------------------------------
    def restore_latest(self, session: str, filt, *, device=None):
        """``(slot_state, steps, frames)`` of the newest checkpoint, as
        tensors on ``device`` ready for ``slot_insert`` — the device of
        the executor that takes the session over; the filter's own device
        when ``None`` — or ``(None, 0, 0)`` if the session was never
        checkpointed. Raises :class:`CheckpointMismatch` on a stream-key
        mismatch."""
        mgr = self._manager(session)
        host, steps = mgr.restore()
        if host is None:
            return None, 0, 0
        manifest = mgr.manifest(steps) or {}
        extra = manifest.get("extra") or {}
        want = repr(filt.config.stream_key())
        got = extra.get("stream_key")
        if got is not None and got != want:
            raise CheckpointMismatch(
                f"session {session!r}: checkpoint stream_key {got} does not "
                f"match the session config's {want}"
            )
        return (
            filt.slot_from_host(host, device),
            int(steps or 0),
            int(extra.get("frames", 0)),
        )

    def latest_step(self, session: str) -> int | None:
        return self._manager(session).latest_step()

    def sessions(self) -> list[str]:
        """Session names with at least one on-disk checkpoint (merely
        *probing* a session creates its directory; that doesn't count)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(
            name
            for name in os.listdir(self.directory)
            if os.path.isdir(os.path.join(self.directory, name))
            and any(
                step.startswith("step_")
                for step in os.listdir(os.path.join(self.directory, name))
            )
        )
