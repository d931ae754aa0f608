"""The device-error taxonomy of the suggest plane.

Reference parity: the error half of ``hyperopt_tpu/resilience/device.py``
(``SyntheticDeviceError``, ``is_device_error``, ``mark_device_error``),
with the CUDA error families in place of the XLA runtime's.  The
reference's ``DeviceRecovery`` (bounded re-initialization, then a CPU
backend fallback) is not ported: on the card, how a dead context should
recover is an open design question (ROADMAP.md, queue A).  Until it is
settled, a device error takes the port's existing path: the speculative
engine discards a failed speculation and recomputes it once
synchronously, and a second failure raises.
"""

from __future__ import annotations

import torch


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
