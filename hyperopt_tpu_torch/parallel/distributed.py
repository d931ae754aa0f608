"""Several processes, one mesh: ``torch.distributed`` for the numeric plane.

Reference parity: ``hyperopt_tpu/parallel/distributed.py``.  The reference
joins every host to one JAX runtime and lets XLA's collectives cross it.
Here each process joins one ``torch.distributed`` process group (NCCL for
CUDA tensors, gloo for CPU ones); the sharded scorers
(:mod:`.sharding`) combine a ``dp`` row whose ``sp`` shards lie on several
ranks with all-reduces over that row's group.  The control plane for
black-box objectives stays on the host (:mod:`.file_trials`, a durable
queue on a shared filesystem).

One controller: rank 0 runs ``fmin``; the other ranks run
workers against the shared queue, or take part as mesh slots in a sharded
suggest, calling it with the same inputs as rank 0 (the SPMD contract).
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger(__name__)


def initialize(coordinator_address=None, num_processes=None, process_id=None, **kwargs):
    """Join the process group (a no-op returning False for one process with
    no coordinator address).

    ``coordinator_address``: ``host:port`` (or a full ``tcp://`` URL) of
    rank 0; ``num_processes`` the world size, ``process_id`` this rank.
    The backend is NCCL when there is a card, else gloo, unless ``kwargs``
    name ``backend=``; ``kwargs`` go to
    ``torch.distributed.init_process_group``.  Returns True once joined.
    Every argument comes from the caller: nothing is read from the
    environment."""
    address = coordinator_address
    if address is None:
        if num_processes in (None, 1):
            logger.info("distributed.initialize: one process, skipping")
            return False
        raise ValueError(f"{num_processes} processes need a coordinator address")
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    init_method = address if "://" in address else f"tcp://{address}"
    torch.distributed.init_process_group(
        init_method=init_method, world_size=int(num_processes or 1),
        rank=int(process_id or 0), **kwargs)
    logger.info("distributed.initialize: process %d/%d ready (%s)",
                torch.distributed.get_rank(), torch.distributed.get_world_size(),
                kwargs["backend"])
    return True


def is_coordinator() -> bool:
    """Rank 0, or the only process."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def global_mesh(axis_names=("dp", "sp"), shape=None, local=None):
    """A mesh over every rank's devices (every rank calls this with the
    same arguments, the SPMD contract).

    ``local``: this process's devices (default: its CUDA devices).  The
    slots are ordered process-major, so with the default ``(dp, sp)`` axes
    the ``sp`` axis, whose shards are combined by all-reduces, stays within
    one process's devices where it can, and ``dp``, which needs no
    communication, spans processes.  Without a process group it is the
    local mesh."""
    from .sharding import DeviceMesh, default_shape, local_devices

    if tuple(axis_names) != ("dp", "sp"):
        raise ValueError(f"mesh axes are ('dp', 'sp'), got {axis_names!r}")
    mine = [str(d) for d in (local_devices() if local is None else local)]
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
    else:
        every = [mine]
    devices = [d for devs in every for d in devs]
    ranks = [r for r, devs in enumerate(every) for _ in devs]
    shape = default_shape(len(devices)) if shape is None else shape
    return DeviceMesh(devices=devices, shape=shape, ranks=ranks)
