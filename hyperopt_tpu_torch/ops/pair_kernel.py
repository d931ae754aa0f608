"""The pair-score kernel: ``csrc/pair_score.cu`` bound with ctypes.

Replaces ``hyperopt_tpu/ops/pallas_gmm.py``'s ``_kernel_batched`` (the
TPU kernel launched by ``_pair_score_pallas_batched``): for each label l
and candidate z, ``LSE_{j<Kb}(F·P[:,j]) − LSE_{j≥Kb}(F·P[:,j])`` with
``F = [z², z, 1]``, never materializing the ``[C, K]`` matrix.  The
source says what bounds the kernel on the card and what its design does
about it.

:func:`pair_score_batched` (``[L, C]``) and :func:`pair_score_single`
(``[C]``, the counterpart of ``pallas_gmm.py``'s single-label ``_kernel``)
launch the kernel for CUDA tensors and run the plain version
(``ops.score.pair_score``) for CPU tensors; nothing else selects between
them.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_build
from .score import effective_scorer, pair_score

_MAX_GRID_Y = 65535


def bind(lib):
    """``lib``'s ``pair_score_batched_launch`` with the ctypes signature of
    ``csrc/pair_score.cu``'s C interface (``lib``: that source built, or
    another build of it)."""
    fn = lib.pair_score_batched_launch  # ctypes caches this object per library
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def _lib():
    return bind(kernel_build.load("pair_score"))


def _check(z, params, k_below):
    if not isinstance(z, torch.Tensor) or not isinstance(params, torch.Tensor):
        raise TypeError("z and params must be torch tensors")
    if z.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError(f"z and params must be float32, got {z.dtype} and {params.dtype}")
    if z.device != params.device:
        raise ValueError(f"z is on {z.device} but params on {params.device}")
    if z.dim() != 2 or params.dim() != 3:
        raise ValueError(f"need z [L, C] and params [L, 3, K], got {tuple(z.shape)} "
                         f"and {tuple(params.shape)}")
    L, C = z.shape
    if params.shape[0] != L or params.shape[1] != 3:
        raise ValueError(f"params {tuple(params.shape)} does not match z {tuple(z.shape)}")
    K = params.shape[2]
    if not 1 <= k_below < K:
        raise ValueError(f"k_below={k_below} must split K={K} into two non-empty regions")
    if not z.is_contiguous() or not params.is_contiguous():
        raise ValueError("z and params must be contiguous")
    if L > _MAX_GRID_Y or max(L * C, L * 3 * K) >= 2**31:
        raise ValueError(f"shape L={L}, C={C}, K={K} is beyond the kernel's int indexing")


def _launch(z, params, k_below, fn=None):
    """Scores ``[L, C]`` from the kernel on the current stream (no
    synchronise; a refused launch raises).  Inputs already checked.
    ``fn``: another build's launch function (:func:`bind`)."""
    L, C = z.shape
    out = torch.empty_like(z)
    if C == 0:
        return out
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = (fn or _lib())(z.data_ptr(), params.data_ptr(), out.data_ptr(),
                             L, C, params.shape[2], k_below, stream)
    if err != 0:
        raise RuntimeError(f"pair_score kernel launch failed: CUDA error {err}")
    return out


def pair_score_batched(z, params, k_below: int):
    """Scores ``[L, C]`` for candidates ``z`` ([L, C], f32) against
    ``params`` ([L, 3, Kb+Ka], f32, from ``ops.score.pair_params``) with
    ``k_below`` = Kb.

    A CUDA tensor launches the kernel on the current stream (no
    synchronise; a refused launch raises).  A CPU tensor runs the plain
    version.  ``pair_score_batched.launches`` counts kernel launches."""
    k_below = int(k_below)
    _check(z, params, k_below)
    if effective_scorer(z) == "plain":
        return pair_score(z, params, k_below)
    out = _launch(z, params, k_below)
    pair_score_batched.launches += 1
    return out


pair_score_batched.launches = 0


def pair_score_single(z, params, k_below: int):
    """Scores ``[C]`` of one label: candidates ``z`` ([C], f32) against
    ``params`` ([3, Kb+Ka], f32).

    The counterpart of ``hyperopt_tpu/ops/pallas_gmm.py``'s
    ``pair_score_pallas`` (its TPU kernel ``_kernel``): the same arithmetic
    as the batched kernel, so it is the L=1 launch of that kernel, with
    its own count, ``pair_score_single.launches``.  A CPU tensor runs the
    plain version."""
    k_below = int(k_below)
    if not isinstance(z, torch.Tensor) or not isinstance(params, torch.Tensor):
        raise TypeError("z and params must be torch tensors")
    if z.dim() != 1 or params.dim() != 2:
        raise ValueError(f"need z [C] and params [3, K], got {tuple(z.shape)} "
                         f"and {tuple(params.shape)}")
    z2, p3 = z[None], params[None]
    _check(z2, p3, k_below)
    if effective_scorer(z) == "plain":
        return pair_score(z2, p3, k_below)[0]
    out = _launch(z2, p3, k_below)
    pair_score_single.launches += 1
    return out[0]


pair_score_single.launches = 0
