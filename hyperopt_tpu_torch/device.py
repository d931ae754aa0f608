"""Where the port's tensors live, and the stream its suggests run on.

Every entry point that touches tensors takes ``device=None``, which means
the CUDA card.  The CPU is used only when the caller names it
(``device="cpu"``), as the tests do; without a card and without that
request the entry point raises instead of carrying on quietly on the CPU.

Every read and write of a device history and every suggest launch goes on
one CUDA stream per card (:func:`suggest_stream`), never the default
stream.  The history is updated in place, so stream order is what keeps an
in-flight suggest reading the buffers as they were when it was launched;
an objective that uses the card from another thread keeps its own
stream.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_streams = {}  # card index -> the suggest stream of that card


def resolve_device(device=None) -> torch.device:
    """``device`` (None, a string or a ``torch.device``) as a
    ``torch.device``; None means ``cuda``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hyperopt_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def suggest_stream(device):
    """The port's own CUDA stream on ``device`` (made at first use, one per
    card for the life of the process), or None for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = torch.cuda.current_device() if dev.index is None else dev.index
    stream = _streams.get(index)
    if stream is None:
        stream = _streams.setdefault(index, torch.cuda.Stream(device=index))
    return stream


def on_suggest_stream(device):
    """A context that makes :func:`suggest_stream` the calling thread's
    current stream (nothing for the CPU)."""
    stream = suggest_stream(device)
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def upload(arr, device) -> torch.Tensor:
    """A host array as a new tensor on ``device``.

    For the card the array is staged in pinned memory and copied without
    blocking, on the current stream: a copy from pageable memory would
    hold the calling thread until that stream drains.  PyTorch's pinned
    allocator records an event after the copy and reuses the staging
    buffer only once it has passed."""
    a = np.asarray(arr)
    if device.type != "cuda":
        return torch.tensor(a, device=device)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    return torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
