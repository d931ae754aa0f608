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
  families (``DeviceRecovery`` is not ported yet).
- :mod:`.chaos` — deterministic, seed-reproducible fault injection
  (worker kills, torn locks, delayed/duplicated results, objective
  exceptions/NaNs/hangs, synthetic device errors, and the service-plane
  sites).

Not ported yet (ROADMAP.md, queue A): ``DeviceRecovery``, ``fsck`` and
the service client's circuit breaker.  All recovery events flow into
:class:`hyperopt_tpu_torch.observability.FaultStats` counters.
"""

from .device import SyntheticDeviceError, is_device_error, mark_device_error
from .leases import LeaseHeartbeat, LeaseReaper
from .retry import (
    RetryPolicy,
    TrialQuarantined,
    TrialTimeout,
    backoff_delay,
    execute_with_retry,
    run_with_timeout,
)

__all__ = [
    "LeaseHeartbeat",
    "LeaseReaper",
    "RetryPolicy",
    "SyntheticDeviceError",
    "TrialQuarantined",
    "TrialTimeout",
    "backoff_delay",
    "execute_with_retry",
    "is_device_error",
    "mark_device_error",
    "run_with_timeout",
]
