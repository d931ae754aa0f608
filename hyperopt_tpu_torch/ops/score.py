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
``HYPEROPT_TPU_SCORER`` values):

- ``pallas``: the pair-score kernel (``pair_score_batched``), the default;
- ``xla``: the plain :func:`pair_score`, on whatever device the tensors
  lie;
- ``fused``: the fused suggest kernel (``ops.fused_kernel``): score,
  winner and EI partials in one launch;
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


def env_bool(name: str):
    """Tri-state env flag: True/False when set (``1/true/yes/on`` are
    true), None when unset."""
    v = os.environ.get(name)
    if v is None:
        return None
    return v.strip().lower() in ("1", "true", "yes", "on")


def resolve_scorer(device=None) -> str:
    """The scorer tier of one suggest on ``device``.

    ``HYPEROPT_TPU_SCORER`` (one of :data:`SCORERS`) is honoured verbatim.
    Without it, a suggest on a CUDA device first runs the fused kernel's
    timing probe (once per process; ``fused_kernel.maybe_probe_fused``),
    and the tier is ``fused`` when
    :func:`~hyperopt_tpu_torch.ops.fused_kernel.resolve_fused` says so,
    else ``pallas``.  ``device`` None probes nothing.  No TPU verdict
    carries over."""
    forced = os.environ.get("HYPEROPT_TPU_SCORER")
    if forced:
        if forced not in SCORERS:
            raise ValueError(f"HYPEROPT_TPU_SCORER={forced!r}: expected one of {SCORERS}")
        return forced
    from .fused_kernel import maybe_probe_fused, resolve_fused  # imports this module

    maybe_probe_fused(device)
    return "fused" if resolve_fused() else "pallas"


def _logsumexp_rows(comp):
    m = comp.amax(dim=-1)
    m_safe = m.clamp(min=NEG_BIG)
    s = torch.exp(comp - m_safe[..., None]).sum(dim=-1)
    return m_safe + torch.log(s.clamp(min=1e-300))


def pair_score(z, params, k_below: int, chunk: int = 4096):
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
