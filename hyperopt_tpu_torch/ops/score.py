"""The pair score ``log l(x) − log g(x)`` in its quadratic form.

The TPE score for candidate x is ``log l(x) − log g(x)`` where each term is
a logsumexp over mixture components of
``−½((z−μ)/σ)² + log w − log(σ√2π)``.  The quadratic expands to

    comp_ll = z²·(−½inv²) + z·(μ·inv²) + (logcoef − ½μ²·inv²)

i.e. features ``F = [z², z, 1]`` ([C, 3]) against a parameter block ``P``
([3, K]).  Both mixtures are concatenated into one ``[3, Kb+Ka]`` block
(the below mixture is capped at ``linear_forgetting`` components while the
above one grows with history, so the boundary ``k_below`` is carried
explicitly).

The additive constants the suggest path may drop (global ``p_accept``
normalizers, the lognormal ``−log x`` Jacobian which cancels in l−g) do
not affect the argmax; ``ops.gmm.gmm_lpdf`` remains the exact normalized
density.

Two implementations with one contract: :func:`pair_score` here, the plain
PyTorch version (chunked over candidates, the ``[L, chunk, K]`` matrix
materialized), and the hand-written CUDA kernel behind
:func:`hyperopt_tpu_torch.ops.pair_kernel.pair_score_batched`, which never
materializes it.  :func:`effective_scorer` picks between them by where the
tensors lie.

Scorer tiers (:func:`resolve_scorer`, the reference's names and
``HYPEROPT_TPU_SCORER`` values; this module reads every tier switch):

- ``pallas``: the pair-score kernel (``pair_score_batched``), the default
  whenever no tier is pinned;
- ``xla``: the plain :func:`pair_score`, on whatever device the tensors
  lie;
- ``fused``: the fused suggest kernel (``ops.fused_kernel``): score,
  winner and EI partials in one launch; ``HYPEROPT_TPU_FUSED_DRAW=1``
  (:func:`resolve_fused_draw`) also draws the candidates in the kernel;
- ``exact``: the normalized ``gmm_lpdf`` difference.

Every tier's kernel wrapper runs its plain version for CPU tensors.
"""

from __future__ import annotations

import os

import torch

_LOG_SQRT_2PI = 0.9189385332046727
NEG_BIG = -1e30


def prepare_mixture(w, mu, sigma, eps=1e-12):
    """Mixtures ``[..., K]`` → the 3-row parameter blocks ``[..., 3, K]``.

    Zero-weight (padding) components get logcoef = NEG_BIG (−1e30, finite)
    so they contribute exactly 0 mass against any real component; their
    mu/inv entries are finite so no NaNs arise.
    """
    sigma = sigma.clamp(min=eps)
    inv = 1.0 / sigma
    inv2 = inv * inv
    logcoef = torch.where(
        w > 0, torch.log(w.clamp(min=eps)) - torch.log(sigma) - _LOG_SQRT_2PI, NEG_BIG
    )
    # rows: coefficient of z², coefficient of z, constant
    return torch.stack([-0.5 * inv2, mu * inv2, logcoef - 0.5 * mu * mu * inv2],
                       dim=-2)


def pair_params(wb, mb, sb, wa, ma, sa):
    """Both mixtures stacked into one ``[..., 3, Kb+Ka]`` block.

    The boundary is ``wb.shape[-1]`` — pass it to the scorers as
    ``k_below``.
    """
    return torch.cat([prepare_mixture(wb, mb, sb), prepare_mixture(wa, ma, sa)],
                     dim=-1)


def effective_scorer(z) -> str:
    """``"kernel"`` for a CUDA tensor, ``"plain"`` for a CPU one.

    No size crossover: the card's has not been measured yet."""
    return "kernel" if z.is_cuda else "plain"


SCORERS = ("pallas", "xla", "fused", "exact")


def pair_score_cost(n_cand: int, k_total: int, scorer: str) -> dict:
    """{flops, mxu_flops, bytes} model of one pair-scorer invocation at C
    candidates x K total mixture components, per scorer tier (the
    reference's model, ``hyperopt_tpu/ops/score.py:105``):

    - every tier: the rank-3 product is 2·3·C·K FLOPs (``mxu_flops``, the
      subset the reference's MFU is defined against; the port runs it as
      FMAs on CUDA cores) and the two logsumexps add ~4 FLOPs per cell;
    - ``xla`` (the plain :func:`pair_score`) materializes the ``[C, K]``
      component matrix, so its traffic charges a write and a read of it;
    - ``pallas`` (the pair-score kernel, ``ops.pair_kernel``) accumulates
      the logsumexp on chip and never materializes it: traffic is the
      candidates, the parameter block and the output;
    - ``fused`` (``ops.fused_kernel``) also keeps candidates and scores on
      chip: traffic is the two uniform streams, the parameter block and
      the per-id winners, plus ~40 FLOPs per candidate of draw and
      selection.

    The one difference from the reference: it demotes ``pallas`` and
    ``fused`` to ``xla`` below a TPU-measured K crossover when no tier is
    forced; the port has no crossover, so the tier is taken as given.
    ``hyperopt_tpu_torch.profiling`` builds its analytical cost on this.
    """
    C, K = float(n_cand), float(k_total)
    mxu = 2.0 * 3.0 * C * K
    flops = mxu + 4.0 * C * K
    if scorer == "fused":
        flops += 40.0 * C
        nbytes = 4.0 * (2.0 * C + 3.0 * K)
        return {"flops": flops, "mxu_flops": mxu, "bytes": nbytes}
    # z read + features + output, params [3, K]
    nbytes = 4.0 * (3.0 * C + 3.0 * K)
    if scorer != "pallas":
        nbytes += 2.0 * C * K * 4.0  # comp matrix write + read
    return {"flops": flops, "mxu_flops": mxu, "bytes": nbytes}


def resolve_scorer() -> str:
    """The scorer tier of one suggest: ``HYPEROPT_TPU_SCORER`` (one of
    :data:`SCORERS`) when it is set, else ``pallas``, on every device."""
    forced = os.environ.get("HYPEROPT_TPU_SCORER")
    if forced:
        if forced not in SCORERS:
            raise ValueError(f"HYPEROPT_TPU_SCORER={forced!r}: expected one of {SCORERS}")
        return forced
    return "pallas"


def resolve_fused_draw() -> bool:
    """Should the fused kernel also draw the candidates
    (``HYPEROPT_TPU_FUSED_DRAW=1``)?  Default off: the in-kernel draw can
    differ from ``gmm_sample``'s values in the last ulp or two, while the
    default streams ``gmm_sample``'s own candidates through the kernel.
    ``1``, ``true``, ``yes`` and ``on`` are true."""
    value = os.environ.get("HYPEROPT_TPU_FUSED_DRAW", "")
    return value.strip().lower() in ("1", "true", "yes", "on")


def _logsumexp_rows(comp):
    m = comp.amax(dim=-1)
    m_safe = m.clamp(min=NEG_BIG)
    s = torch.exp(comp - m_safe[..., None]).sum(dim=-1)
    return m_safe + torch.log(s.clamp(min=1e-300))


# candidates per chunk of the plain pair score: one [L, chunk, K] product
PAIR_CHUNK = 4096


def pair_score(z, params, k_below: int, chunk: int = PAIR_CHUNK):
    """``log l − log g`` (up to an additive constant) for candidates ``z``.

    ``z``: ``[L, C]``; ``params``: ``[L, 3, Kb+Ka]`` from
    :func:`pair_params`; ``k_below`` is the Kb boundary.  Chunked over
    candidates so the ``[L, chunk, Kb+Ka]`` intermediate stays bounded at
    10k+ histories.

    The rank-3 product must be true f32: TF32 keeps ~3 decimal digits,
    which at 10k components randomizes the EI argmax.  On the card this
    therefore refuses to run while
    ``torch.backends.cuda.matmul.allow_tf32`` is True.
    """
    if z.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "pair_score needs IEEE f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    out = []
    for c0 in range(0, z.shape[1], chunk):
        zb = z[:, c0:c0 + chunk]
        feats = torch.stack([zb * zb, zb, torch.ones_like(zb)], dim=-1)
        comp = torch.matmul(feats, params)  # [L, chunk, Kb+Ka]
        out.append(_logsumexp_rows(comp[..., :k_below])
                   - _logsumexp_rows(comp[..., k_below:]))
    return torch.cat(out, dim=1)


def pair_lse_partials(z, params, k_below: int, chunk: int = PAIR_CHUNK):
    """Each region's logsumexp ``[2, L, C]``: ``LSE_{j<Kb}`` then
    ``LSE_{j>=Kb}`` of ``F·P`` for candidates ``z`` ([L, C]) against
    ``params`` ([L, 3, K]), the terms whose difference :func:`pair_score`
    returns.  The plain version of the partials launch
    (``ops.pair_kernel.pair_lse_partials``), one mesh shard's step
    (``parallel.sharding``): a region of only padding columns (logcoef
    NEG_BIG) gives a partial near NEG_BIG, which adds exactly 0 when the
    shards are combined.  Chunked over candidates like :func:`pair_score`,
    and for the same reason refuses TF32 on the card."""
    if z.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "pair_lse_partials needs IEEE f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    out = z.new_empty((2,) + tuple(z.shape))
    for c0 in range(0, z.shape[1], chunk):
        zb = z[:, c0:c0 + chunk]
        feats = torch.stack([zb * zb, zb, torch.ones_like(zb)], dim=-1)
        comp = torch.matmul(feats, params)  # [L, chunk, Kb+Ka]
        out[0, :, c0:c0 + chunk] = _logsumexp_rows(comp[..., :k_below])
        out[1, :, c0:c0 + chunk] = _logsumexp_rows(comp[..., k_below:])
    return out
