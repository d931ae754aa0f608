"""Structured trials checkpointing in orbax's JSON-step layout.

``fmin(trials_save_file=...)`` pickles the whole ``Trials`` object every
iteration (the reference's ``hyperopt/fmin.py`` mechanism, kept through
:func:`atomic_pickle_dump`).  A path ending in ``.orbax`` saves through
:class:`TrialsCheckpointer` instead: **versioned, atomic, retained**
steps —

- a crash mid-write never loses the run: a step is written under a
  temporary name and published by one rename, so the previous step
  always survives;
- steps are retained (``max_to_keep``) so a corrupted objective that
  poisons recent trials can be rolled back, and a torn newest step
  falls back to the one before;
- trial docs are stored as JSON (the ``$datetime``/``$bytes`` sentinel
  codec of the FileTrials queue), so checkpoints are inspectable and not
  tied to pickle or Python versions.

The on-disk form is what ``orbax.checkpoint.CheckpointManager`` writes
for a ``JsonSave`` item, written here without orbax (which imports
JAX)::

    <directory>/<step>/_CHECKPOINT_METADATA   # the step's orbax metadata
    <directory>/<step>/default/metadata        # json.dumps of the payload

so the JAX package's ``TrialsCheckpointer`` restores a directory this
one wrote, and this one restores a directory orbax wrote.  Reference:
``hyperopt_tpu/checkpoint.py``.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
import time

from .base import SONify, Trials, trials_from_docs
from .parallel.file_trials import (
    _atomic_write,
    _json_default,
    _json_object_hook,
)

logger = logging.getLogger(__name__)

# orbax's names for one JSON item of a step
_ITEM = "default"
_PAYLOAD = "metadata"
_STEP_METADATA = "_CHECKPOINT_METADATA"
_JSON_HANDLER = ("orbax.checkpoint._src.handlers.json_checkpoint_handler."
                 "JsonCheckpointHandler")
# orbax's marker of a step still being written; never listed as a step
_TMP_MARK = ".orbax-checkpoint-tmp-"


def is_orbax_path(path) -> bool:
    """fmin's dispatch rule for ``trials_save_file``."""
    return bool(path) and str(path).endswith(".orbax")


def atomic_pickle_dump(obj, path, protocol=-1):
    """Crash-safe pickle for the plain ``trials_save_file`` path:
    temp file → flush → fsync → atomic rename (the queue's
    ``_atomic_write`` primitive).  A crash mid-save leaves the previous
    checkpoint intact instead of a torn pickle that loses the run."""
    _atomic_write(path, pickle.dumps(obj, protocol=protocol))


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class TrialsCheckpointer:
    """Save/restore a ``Trials`` history as orbax-layout JSON steps."""

    def __init__(self, directory, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        steps = self.steps()
        self._last_step = steps[-1] if steps else None
        self._last_fingerprint = None

    # -- encoding ------------------------------------------------------
    @staticmethod
    def _encode(docs):
        # SONify first (numpy scalars/arrays -> plain python), then the
        # sentinel codec for datetimes/bytes; round-trip through json so
        # the stored payload is guaranteed plain-JSON
        return json.loads(
            json.dumps(SONify(docs), default=_json_default, sort_keys=True)
        )

    @staticmethod
    def _decode(payload):
        return json.loads(
            json.dumps(payload), object_hook=_json_object_hook
        )

    @staticmethod
    def _fingerprint(trials):
        """Cheap change detector: doc count per state.  Async backends
        mutate existing docs in place (NEW → DONE with results) without
        growing the list, so a pure length check would stop saving once
        the last doc is enqueued and lose the final batch's losses."""
        counts = {}
        for doc in trials.trials:
            counts[doc["state"]] = counts.get(doc["state"], 0) + 1
        return (len(trials.trials), tuple(sorted(counts.items())))

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _write_step(self, step: int, payload) -> None:
        """One step, as orbax lays it out: both files written atomically
        under a temporary step directory, then the directory published
        by one rename (the commit point) and the parent fsynced."""
        init_ns = time.time_ns()
        tmp = os.path.join(self.directory, f"{step}{_TMP_MARK}{init_ns}")
        os.makedirs(os.path.join(tmp, _ITEM))
        _atomic_write(os.path.join(tmp, _ITEM, _PAYLOAD),
                      json.dumps(payload).encode())
        meta = {
            "item_handlers": {_ITEM: _JSON_HANDLER},
            "metrics": {},
            "performance_metrics": {},
            "init_timestamp_nsecs": init_ns,
            "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {},
        }
        _atomic_write(os.path.join(tmp, _STEP_METADATA), json.dumps(meta).encode())
        _fsync_dir(os.path.join(tmp, _ITEM))
        _fsync_dir(tmp)
        os.rename(tmp, self._step_dir(step))
        _fsync_dir(self.directory)

    # -- API -----------------------------------------------------------
    def save(self, trials: Trials) -> bool:
        """Checkpoint the current history as the next step; returns
        False (no-op) if nothing changed since the last save."""
        fp = self._fingerprint(trials)
        if fp == self._last_fingerprint:
            return False
        step = (self._last_step or 0) + 1
        self._write_step(step, {"format": 1, "docs": self._encode(trials.trials)})
        self._last_step = step
        self._last_fingerprint = fp
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return True

    def _restore_step(self, step: int):
        """One step's decoded docs; raises on a corrupted/torn step."""
        path = os.path.join(self._step_dir(step), _ITEM, _PAYLOAD)
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
        if not isinstance(payload, dict) or "docs" not in payload:
            raise ValueError(
                f"step {step}: malformed checkpoint payload "
                f"({type(payload).__name__}, no 'docs')"
            )
        return self._decode(payload["docs"])

    def restore(self, step: int | None = None, into: Trials | None = None):
        """Latest (or given) step; None if the directory has no steps.

        When no explicit ``step`` is requested and the latest step turns
        out to be corrupted or torn (a crash mid-finalization, a
        truncated filesystem, a poisoned payload), restore falls back to
        the previous retained steps in descending order instead of
        raising — losing one save interval beats losing the run.  An
        explicitly requested ``step`` still raises on corruption (the
        caller asked for that step, not "the newest readable one").

        ``into``: an EMPTY ``Trials`` (sub)instance to refill — preserves
        the caller's trials subclass and attachments, which a fresh
        ``trials_from_docs`` cannot (fmin's resume path uses this when
        the user passed their own trials object)."""
        if step is not None:
            docs = self._restore_step(int(step))
        else:
            steps = sorted(self.steps(), reverse=True)
            if not steps:
                return None
            docs = None
            last_err = None
            for s in steps:
                try:
                    docs = self._restore_step(s)
                except (OSError, ValueError) as e:
                    last_err = e
                    logger.warning(
                        "orbax restore: step %d unreadable (%s); falling "
                        "back to the previous retained step", s, e,
                    )
                else:
                    step = s
                    if s != steps[0]:
                        logger.warning(
                            "orbax restore: recovered from retained step "
                            "%d (latest step %d was corrupted)",
                            s, steps[0],
                        )
                    break
            if docs is None:
                raise last_err
        if into is not None:
            if len(into.trials):
                logger.warning(
                    "orbax restore: passed trials object is non-empty; "
                    "keeping it as-is (not refilling from step %d)", step,
                )
                return into
            into._insert_trial_docs(docs)
            into.refresh()
            return into
        return trials_from_docs(docs)

    def steps(self):
        """The published steps, ascending (a step directory is named by
        its number; orbax's temporary directories are never listed)."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(
            int(n) for n in names
            if n.isdigit() and os.path.isdir(os.path.join(self.directory, n))
        )

    def close(self):
        """Nothing to release (no background threads); kept for the
        reference's interface."""
