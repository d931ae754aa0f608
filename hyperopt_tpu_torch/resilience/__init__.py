"""Fault-tolerant trial execution.

Reference parity: the parts of ``hyperopt_tpu/resilience`` that the
FileTrials path imports:

- :mod:`.retry` — per-trial retry policy: exponential backoff with
  deterministic jitter, per-trial objective timeouts (watchdog thread,
  distinct from ``fmin``'s global ``timeout``), and poison-trial
  quarantine (after ``max_attempts`` a trial lands in
  ``JOB_STATE_ERROR`` and is excluded from the TPE fit).
- :mod:`.leases` — FileTrials reservations are renewable heartbeat
  leases; a driver-side :class:`~.leases.LeaseReaper` reclaims expired
  leases with attempt counters.
- :mod:`.device` — the device-error taxonomy over the CUDA error
  families, and :class:`~.device.DeviceRecovery`: bounded
  re-initialization of the device state around a suggest dispatch, then
  the error propagates (no CPU fallback).
- :mod:`.chaos` — deterministic, seed-reproducible fault injection
  (worker kills, torn locks, delayed/duplicated results, objective
  exceptions/NaNs/hangs, synthetic device errors, and the service-plane
  sites).

- :mod:`.fsck` — offline detect-and-repair for a FileTrials queue
  directory (torn docs and segments, orphan leases and locks, duplicate
  tids, tmp droppings, a broken id allocator) and for a service root
  (every study's queue, its config, seed cursor and response journal);
  ``python -m hyperopt_tpu_torch.resilience.fsck``.  Its names load at
  first use, so ``python -m`` runs the module once.

The service client's :class:`~.retry.CircuitBreaker` lives in
:mod:`.retry` too.  All recovery events flow into :class:`hyperopt_tpu_torch.observability.FaultStats` counters.
"""

from .device import (
    DeviceRecovery,
    SyntheticDeviceError,
    is_device_error,
    mark_device_error,
)
from .leases import LeaseHeartbeat, LeaseReaper
from .retry import (
    CircuitBreaker,
    CircuitOpenError,
    RetryPolicy,
    TrialQuarantined,
    TrialTimeout,
    backoff_delay,
    execute_with_retry,
    run_with_timeout,
)

_FSCK_NAMES = ("FsckReport", "fsck_path", "fsck_queue", "fsck_service_root")


def __getattr__(name):
    if name in _FSCK_NAMES:
        from . import fsck

        return getattr(fsck, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "DeviceRecovery",
    "FsckReport",
    "LeaseHeartbeat",
    "LeaseReaper",
    "RetryPolicy",
    "SyntheticDeviceError",
    "TrialQuarantined",
    "TrialTimeout",
    "backoff_delay",
    "execute_with_retry",
    "fsck_path",
    "fsck_queue",
    "fsck_service_root",
    "is_device_error",
    "mark_device_error",
    "run_with_timeout",
]
