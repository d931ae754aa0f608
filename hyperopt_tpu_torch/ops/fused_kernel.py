"""The fused suggest kernel: ``csrc/fused_suggest.cu`` bound with ctypes.

Replaces ``hyperopt_tpu/ops/pallas_fused.py``'s ``_fused_kernel`` (the TPU
kernel launched by ``_fused_suggest_pallas``): per label and suggestion it
draws the candidates (optionally), scores them with the pair-score loop of
``csrc/pair_score.cu``, and keeps only the winner and the EI partials, so
the ``[L, C]`` candidate and score vectors never reach device memory.  The
source says what bounds the kernel on the card and what its design does
about it.

:func:`fused_suggest` launches the kernel for CUDA tensors and runs
:func:`fused_suggest_plain` for CPU tensors; nothing else selects between
them.  :func:`ei_from_partials` combines the partials into the
``tpe_device._ei_diag`` reductions.  Whether a suggest takes this tier, and
whether the kernel draws, is decided in ``ops.score`` alone
(``HYPEROPT_TPU_SCORER=fused``, ``HYPEROPT_TPU_FUSED_DRAW=1``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..resilience.device import mark_device_error
from . import kernel_build
from .gmm import draw_from_rows, draw_param_rows  # noqa: F401  (draw_param_rows: API)
from .score import effective_scorer, pair_score, resolve_scorer

EPS = 1e-12
MAX_TOP = 128  # the reference's accumulator row
# candidates per block of the tile kernel at its smallest (pair_lse.cuh
# WARPS x 4 candidates per warp): the scratch holds that many tiles
MIN_TILE = 64
_MAX_GRID_YZ = 65535


def bind(lib):
    """``lib``'s ``fused_suggest_launch`` with the ctypes signature of
    ``csrc/fused_suggest.cu``'s C interface (``lib``: that source built, or
    another build of it)."""
    fn = lib.fused_suggest_launch  # ctypes caches this object per library
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return fn


def _lib():
    return bind(kernel_build.load("fused_suggest"))


def _check(u_comp, u_val, draw_params, params, k_below, k, n_top, draw_in_kernel):
    """Raise on what the kernel does not take; returns ``n_top`` capped at
    the candidate count."""
    tensors = [u_comp, params] + ([u_val, draw_params] if draw_in_kernel else [])
    if not all(isinstance(a, torch.Tensor) for a in tensors):
        raise TypeError("u_comp, params (and u_val, draw_params when drawing) must be "
                        "torch tensors")
    for a in tensors:
        if a.dtype != torch.float32:
            raise TypeError(f"inputs must be float32, got {a.dtype}")
        if a.device != u_comp.device:
            raise ValueError(f"inputs on {a.device} and {u_comp.device}")
        if not a.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if u_comp.dim() != 2 or params.dim() != 3:
        raise ValueError(f"need u_comp [L, C] and params [L, 3, K], got "
                         f"{tuple(u_comp.shape)} and {tuple(params.shape)}")
    L, C = u_comp.shape
    K = params.shape[2]
    if params.shape[:2] != (L, 3):
        raise ValueError(f"params {tuple(params.shape)} does not match u_comp {(L, C)}")
    if not 1 <= k_below < K:
        raise ValueError(f"k_below={k_below} must split K={K} into two non-empty regions")
    if k < 1 or C % k or C == 0:
        raise ValueError(f"candidate count {C} not a positive multiple of k={k}")
    n_top = min(n_top, C)
    if not 1 <= n_top <= MAX_TOP:
        raise ValueError(f"n_top={n_top} outside 1..{MAX_TOP}")
    if draw_in_kernel:
        if u_val.shape != u_comp.shape:
            raise ValueError(f"u_val {tuple(u_val.shape)} != u_comp {(L, C)}")
        if draw_params.shape != (L, 7, k_below):
            raise ValueError(f"draw_params {tuple(draw_params.shape)} != {(L, 7, k_below)}")
    tiles = -(-(C // k) // MIN_TILE)
    if (L > _MAX_GRID_YZ or k > _MAX_GRID_YZ
            or max(L * C, L * 3 * K, L * k * tiles * (4 + n_top)) >= 2**31):
        raise ValueError(f"shape L={L}, C={C}, K={K}, k={k} is beyond the kernel's "
                         "int indexing")
    return n_top


def _launch(u_comp, u_val, draw_params, params, k_below, k, n_top, log_scale,
            draw_in_kernel, fn=None):
    """Both kernels of ``csrc/fused_suggest.cu`` on the current stream (no
    synchronise; a refused launch raises).  Inputs already checked.
    ``fn``: another build's launch function (:func:`bind`)."""
    L, C = u_comp.shape
    n_cand = C // k
    tiles = -(-n_cand // MIN_TILE)
    dev = u_comp.device
    part = torch.empty(L * k * tiles * (4 + n_top), dtype=torch.float32, device=dev)
    arg = torch.empty(L * k * tiles, dtype=torch.int32, device=dev)
    win = torch.empty((L, k), dtype=torch.float32, device=dev)
    best_idx = torch.empty((L, k), dtype=torch.int32, device=dev)
    seg_m = torch.empty((L, k), dtype=torch.float32, device=dev)
    seg_s = torch.empty((L, k), dtype=torch.float32, device=dev)
    seg_top = torch.empty((L, k, n_top), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = (fn or _lib())(
            u_comp.data_ptr(), u_val.data_ptr() if draw_in_kernel else None,
            draw_params.data_ptr() if draw_in_kernel else None, params.data_ptr(),
            part.data_ptr(), arg.data_ptr(), win.data_ptr(), best_idx.data_ptr(),
            seg_m.data_ptr(), seg_s.data_ptr(), seg_top.data_ptr(),
            L, k, n_cand, params.shape[2], k_below, n_top, int(log_scale),
            int(draw_in_kernel), stream)
    if err != 0:
        # a device-plane failure whatever its type: the recovery layer
        # (resilience.device) must see the card's own kernel failures
        raise mark_device_error(
            RuntimeError(f"fused_suggest kernel launch failed: CUDA error {err}"))
    return win, best_idx, seg_m, seg_s, seg_top


def fused_suggest(u_comp, u_val, draw_params, params, k_below: int, k: int,
                  n_top: int = 16, log_scale: bool = False, draw_in_kernel: bool = False):
    """The fused suggest inner loop, the counterpart of the reference's
    ``fused_suggest_pallas`` (``pallas_fused.py:268``).

    ``draw_in_kernel=False``: ``u_comp`` ([L, k·n_cand]) holds the
    candidates ``gmm_sample`` drew; ``u_val`` and ``draw_params`` are not
    read (None will do).  ``draw_in_kernel=True``: ``u_comp``/``u_val`` are
    the component-pick and value uniforms and ``draw_params`` the
    ``[L, 7, Kb]`` table of :func:`draw_param_rows` for the below mixture;
    the candidates are drawn in the kernel.  ``params``: ``[L, 3, Kb+Ka]``
    from ``ops.score.pair_params``, ``k_below`` = Kb.

    Returns ``(win, best_idx, seg_m, seg_s, seg_top)``: the winning values
    ``[L, k]`` (raw space), their index in the segment ``[L, k]`` (int32),
    the per-segment (max, sum-exp) of the sanitized scores ``[L, k]`` each,
    and the per-segment top ``n_top`` sanitized scores ``[L, k, n_top]``
    (−inf padded).  ``n_top`` is capped at the candidate count.

    A CUDA tensor launches the kernel on the current stream (no
    synchronise; a refused launch raises) and adds one to
    ``fused_suggest.launches``.  A CPU tensor runs the plain version."""
    k_below, k = int(k_below), int(k)
    n_top = _check(u_comp, u_val, draw_params, params, k_below, k, int(n_top),
                   draw_in_kernel)
    if effective_scorer(u_comp) == "plain":
        return fused_suggest_plain(u_comp, u_val, draw_params, params, k_below, k, n_top,
                                   log_scale, draw_in_kernel)
    out = _launch(u_comp, u_val, draw_params, params, k_below, k, n_top, log_scale,
                  draw_in_kernel)
    fused_suggest.launches += 1
    return out


fused_suggest.launches = 0


def sanitize_scores(score):
    """Scores as the EI reductions read them: NaN → −1e30, ±inf → ±1e30."""
    return torch.nan_to_num(score, nan=-1e30, posinf=1e30, neginf=-1e30).clamp(-1e30, 1e30)


def fused_suggest_plain(u_comp, u_val, draw_params, params, k_below: int, k: int,
                        n_top: int = 16, log_scale: bool = False,
                        draw_in_kernel: bool = False):
    """:func:`fused_suggest` in plain PyTorch: the draw by ``gmm_sample``'s
    op chain (:func:`~hyperopt_tpu_torch.ops.gmm.draw_from_rows`), the
    plain ``pair_score``, a first-index argmax per segment, and the
    per-segment (max, sum-exp) and top ``n_top`` of the sanitized scores."""
    L, C = u_comp.shape
    n_cand = C // k
    n_top = min(int(n_top), C)
    x = draw_from_rows(u_comp, u_val, draw_params, log_scale) if draw_in_kernel else u_comp
    z = torch.log(x.clamp(min=EPS)) if log_scale else x
    score = pair_score(z, params, int(k_below)).reshape(L, k, n_cand)
    best_idx = torch.argmax(score, dim=2)
    win = x.reshape(L, k, n_cand).gather(2, best_idx[:, :, None])[:, :, 0]
    sd = sanitize_scores(score)
    seg_m = sd.amax(dim=2)
    seg_s = torch.exp(sd - seg_m[:, :, None]).sum(dim=2)
    top = torch.topk(sd, min(n_top, n_cand), dim=2).values
    seg_top = torch.full((L, k, n_top), float("-inf"), dtype=sd.dtype, device=sd.device)
    seg_top[:, :, :top.shape[2]] = top
    return win, best_idx.to(torch.int32), seg_m, seg_s, seg_top


def ei_from_partials(seg_m, seg_s, seg_top, n_cand_total: int, n_top: int):
    """The per-label EI reductions of ``tpe_device._ei_diag`` — ``(max,
    log-mean-exp, top-k softmax mass)``, each ``[L]`` — from the per-segment
    partials: the max-rebased merge of the (max, sum-exp) states, and the
    top ``n_top`` of the segments' top sets, which hold the global top set.
    Reference: ``pallas_fused.py:394-415``."""
    m_star = seg_m.amax(dim=1)
    s_tot = (seg_s * torch.exp(seg_m - m_star[:, None])).sum(dim=1)
    lse = m_star + torch.log(s_tot.clamp(min=1e-300))
    lme = lse - math.log(n_cand_total)
    flat = seg_top.reshape(seg_top.shape[0], -1)
    kk = min(int(n_top), int(n_cand_total), flat.shape[1])
    topk = torch.topk(flat, kk, dim=1).values
    mass = torch.exp(topk - lse[:, None]).sum(dim=1)
    return m_star, lme, mass


def probe_result():
    """The tier in use as the benchmark's line reads it: ``{"fused": True}``
    under ``fused``, ``{"fused": False}`` under ``pallas``, None under
    ``xla`` or ``exact``, where no kernel scores.  No timing probe runs:
    the tier is ``ops.score.resolve_scorer``'s, so a process left unpinned
    always reports the pair-score kernel.  ``portbench/run.py`` reads it
    twice; a ``benchmark`` change retires those reads and this function
    (ROADMAP §E3)."""
    tier = resolve_scorer()
    return {"fused": tier == "fused"} if tier in ("fused", "pallas") else None
