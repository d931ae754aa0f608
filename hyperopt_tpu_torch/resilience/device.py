"""Device-failure recovery for the suggest plane on the card.

Reference parity: ``hyperopt_tpu/resilience/device.py``, with the CUDA
error families in place of the XLA runtime's:

- :func:`is_device_error` / :func:`mark_device_error` — which exceptions
  are device-plane failures (out of memory, a failed kernel launch, a
  fault reported at the readback's wait, a chaos stand-in);
- :class:`DeviceRecovery` — **bounded re-initialization**: on a device
  error it drops every piece of device-resident suggest state
  (:func:`hyperopt_tpu_torch.algos.tpe_device.reset_device_state`: the
  ``DeviceHistory`` mirrors, the suggest streams, the caching
  allocator's free blocks) and retries; the next suggest re-uploads the
  history from the host's ``_TrialsHistory``.

The reference's second step, pinning suggests to the CPU backend once
``max_reinits`` consecutive errors are spent, has no counterpart: on the
card that is a fallback that hides the device.  When the budget is spent
the error propagates; ``cpu_fallback_active`` is always False and the
``cpu_fallback`` counter stays 0.

What re-initialization can cure: an out-of-memory error (another tenant,
a transient peak) leaves the CUDA context usable, so freeing the cached
buffers and retrying recovers in the process.  A *sticky* error (an
illegal address, a faulting kernel) poisons the context: every later
CUDA call raises, the reset's own calls included (caught and logged
here), each retry fails again and counts against the budget, and the
budget's end raises.  Such a process cannot recover; a restart can.

Used by ``FMinIter`` (synchronous suggest calls) and the pipelined engine
(its synchronous recomputes, and the failed launches and readbacks it
absorbs).  Every event is counted in
:class:`~hyperopt_tpu_torch.observability.FaultStats` (``device_error`` /
``device_reinit``).
"""

from __future__ import annotations

import logging
import threading
import time

import torch

from .. import tracing

logger = logging.getLogger(__name__)


class SyntheticDeviceError(RuntimeError):
    """A chaos-injected device failure (stands in for a CUDA error)."""


# ``torch.AcceleratorError`` (raised for CUDA launch and runtime errors)
# exists in recent torch builds only
_CUDA_ERROR_TYPES = tuple(
    t
    for t in (
        getattr(torch.cuda, "OutOfMemoryError", None),
        getattr(torch, "AcceleratorError", None),
    )
    if t is not None
)


def is_device_error(exc) -> bool:
    """Is ``exc`` a CUDA runtime failure (or a chaos stand-in)?

    Recognized: :class:`SyntheticDeviceError`, an exception tagged by
    :func:`mark_device_error`, ``torch.cuda.OutOfMemoryError``,
    ``torch.AcceleratorError`` where this torch has it, and a
    ``RuntimeError`` whose message starts with ``CUDA error`` (what the
    CUDA caching allocator and kernel launch checks raise)."""
    if isinstance(exc, SyntheticDeviceError):
        return True
    if getattr(exc, "_hyperopt_device_error", False):
        return True
    if _CUDA_ERROR_TYPES and isinstance(exc, _CUDA_ERROR_TYPES):
        return True
    return isinstance(exc, RuntimeError) and str(exc).startswith("CUDA error")


def mark_device_error(exc):
    """Tag ``exc`` so :func:`is_device_error` recognizes it regardless of
    type — used by dispatch sites that positively know the failure came
    from the device plane (e.g. a kernel wrapper's launch status)."""
    try:
        exc._hyperopt_device_error = True
    except Exception:  # extension-type exceptions may reject attributes
        pass
    return exc


def _reset_device_state():
    """Drop device-resident suggest state so a retried dispatch rebuilds
    from host truth.  Best-effort: under a sticky CUDA error the reset's
    own CUDA calls raise too; that is logged, and the retry's failure is
    what the budget counts."""
    try:
        from ..algos import tpe_device

        tpe_device.reset_device_state()
    except Exception:
        logger.warning("device state reset failed", exc_info=True)


class DeviceRecovery:
    """Run device-dispatching callables with bounded re-initialization.

    One instance per driver run (``FMinIter`` owns it and shares it with
    the speculative engine).  Thread-safe: the engine and the driver
    thread may both hit device errors.

    ``max_reinits``: CONSECUTIVE device errors absorbed by
    re-initialization; a successful dispatch refills the budget
    (scattered transient faults over a long run each recover; only a
    persistently failing device escalates).  One more device error after
    the budget is spent propagates: the port never moves a suggest to the
    CPU.
    """

    # lock-order: _state_lock
    def __init__(self, max_reinits: int = 2, stats=None):
        self.max_reinits = int(max_reinits)
        self.stats = stats
        self._state_lock = threading.Lock()
        self._n_reinits = 0  # guarded-by: _state_lock
        # seconds each re-initialization took, in order
        self.reinit_seconds = []  # guarded-by: _state_lock

    @property
    def cpu_fallback_active(self) -> bool:
        """Always False: the port has no CPU fallback (module docstring)."""
        return False

    @property
    def n_reinits(self) -> int:
        with self._state_lock:
            return self._n_reinits

    def note_success(self):
        """A dispatch went through: refill the consecutive-failure
        budget."""
        with self._state_lock:
            self._n_reinits = 0

    def _record(self, event):
        if self.stats is not None:
            self.stats.record(event)

    def absorb(self, exc):
        """Process one observed device error WITHOUT retrying — for
        callers that have their own degrade path (the speculative engine
        drops a failed launch and recomputes synchronously, but the device
        state still needs the reset first).

        Returns None when ``exc`` is not a device error (caller should
        re-raise), True when a re-initialization was done (a retry is
        sensible), False when the budget is exhausted (caller must
        propagate)."""
        if not is_device_error(exc):
            return None
        self._record("device_error")
        with self._state_lock:
            if self._n_reinits >= self.max_reinits:
                return False
            self._n_reinits += 1
            n = self._n_reinits
        # visible in the request trace that absorbed the failure (no-op
        # outside a traced request)
        tracing.add_event("device.recovery", action="reinit", error=type(exc).__name__)
        self._record("device_reinit")
        logger.warning(
            "device error during suggest dispatch (re-initializing, %d/%d): %s",
            n, self.max_reinits, exc,
        )
        t0 = time.perf_counter()
        with tracing.span("device.reinit", action="reinit"):
            _reset_device_state()
        with self._state_lock:
            self.reinit_seconds.append(time.perf_counter() - t0)
        return True

    def run(self, fn):
        """``fn()`` with recovery.  Non-device exceptions propagate
        untouched; device errors trigger re-initialization (bounded), then
        propagate."""
        while True:
            try:
                out = fn()
            except Exception as e:
                if not self.absorb(e):  # None (not device) or False
                    raise
            else:
                self.note_success()
                return out
