"""Where the port's tensors live.

Every entry point that touches tensors takes ``device=None``, which means
the CUDA card.  The CPU is used only when the caller names it
(``device="cpu"``), as the tests do; without a card and without that
request the entry point raises instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


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
