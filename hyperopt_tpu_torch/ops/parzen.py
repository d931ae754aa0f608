"""Adaptive-Parzen estimator fit over padded, label-stacked buffers.

Reference parity (SURVEY.md §2 #11): ``hyperopt/tpe.py`` —
``adaptive_parzen_normal`` / ``linear_forgetting_weights`` (~L40-200): the
per-observation sigma heuristic (max of neighbor gaps in sorted order),
prior-as-extra-component insertion at the sorted position, sigma clamping to
``[prior_sigma/min(100, 1+K), prior_sigma]``, the one-observation special
case (``sigma = prior_sigma/2``), and linear-forgetting ramp weights over
chronological order.

The fit runs over ``[L, PAD]`` observation buffers (``PAD`` a power-of-two
bucket, ``n_obs`` per label); invalid slots carry weight 0.  The label
axis is written out as the leading batch dimension.
"""

from __future__ import annotations

import torch

_F32 = torch.float32


def bucket(n: int, minimum: int = 8) -> int:
    """Power-of-two padding bucket: buffer shapes change O(log history) times."""
    n = max(int(n), 1)
    return max(minimum, 1 << (n - 1).bit_length())


def linear_forgetting_weights_padded(n_obs, lf: int, pad: int):
    """Chronological observation weights ``[L, pad]`` for counts ``n_obs`` ([L]).

    Oldest ``n_obs - lf`` observations get a linear ramp from ``1/n_obs`` to
    1; the newest ``lf`` get weight 1.  ``lf <= 0`` disables forgetting.
    """
    i = torch.arange(pad, dtype=_F32, device=n_obs.device)
    nn = n_obs[:, None]
    n = nn.clamp(min=1).to(_F32)
    ramp_len = nn - lf
    denom = (ramp_len - 1).clamp(min=1).to(_F32)
    ramp = 1.0 / n + (1.0 - 1.0 / n) * i / denom
    w = torch.where(i < ramp_len, ramp, 1.0)
    use_ramp = (lf > 0) & (nn > lf)
    w = torch.where(use_ramp, w, 1.0)
    return torch.where(i < nn, w, 0.0)


def adaptive_parzen_normal_padded(obs, n_obs, prior_weight, prior_mu, prior_sigma,
                                  lf: int):
    """Fit the adaptive Parzen mixture on padded observation buffers.

    Args:
      obs: ``[L, PAD]`` observation values in *chronological* order; only
        the first ``n_obs[l]`` entries of row ``l`` are valid.
      n_obs: ``[L]`` integer counts of valid observations.
      prior_weight: the prior component's weight (a float).
      prior_mu / prior_sigma: ``[L]`` prior components.
      lf: linear-forgetting horizon (0 disables).

    Returns:
      ``(weights, mus, sigmas)`` each ``[L, PAD+1]`` — the mixtures in
      sorted-mu order with the prior inserted at its sorted position; the
      first ``n_obs + 1`` entries are valid, the rest have weight exactly 0.
    """
    L, pad = obs.shape
    K = pad + 1
    dev = obs.device
    obs = obs.to(_F32)
    i_pad = torch.arange(pad, device=dev)
    i_out = torch.arange(K, device=dev)
    nn = n_obs.to(torch.int64)[:, None]
    valid = i_pad < nn
    pm = prior_mu.to(_F32)[:, None]
    ps = prior_sigma.to(_F32)[:, None]

    big = torch.where(valid, obs, float("inf"))
    srtd, order = torch.sort(big, dim=1, stable=True)  # valid obs to the front

    # searchsorted-left position of the prior among valid observations
    prior_pos = (valid & (obs < pm)).sum(dim=1, keepdim=True)

    # scatter sorted obs around the prior slot
    out_pos = i_pad + (i_pad >= prior_pos)
    srtd_mus = (
        torch.zeros(L, K, dtype=_F32, device=dev)
        .scatter(1, out_pos, torch.where(valid, srtd, 0.0))
        .scatter(1, prior_pos, pm)
    )

    n_tot = nn + 1
    prev = srtd_mus[:, (i_out - 1).clamp(min=0)]
    nxt = srtd_mus[:, (i_out + 1).clamp(max=K - 1)]
    left_gap = srtd_mus - prev
    right_gap = nxt - srtd_mus
    sigma = torch.maximum(left_gap, right_gap)
    sigma = torch.where(i_out == 0, right_gap, sigma)
    sigma = torch.where(i_out == n_tot - 1, left_gap, sigma)
    # one observation: the non-prior component gets prior_sigma/2
    sigma = torch.where((nn == 1) & (i_out != prior_pos), 0.5 * ps, sigma)

    maxsigma = ps
    minsigma = ps / (1.0 + n_tot.to(_F32)).clamp(max=100.0)
    sigma = torch.minimum(torch.maximum(sigma, minsigma), maxsigma)
    sigma = sigma.scatter(1, prior_pos, ps)

    # chronological forgetting weights -> sorted order -> prior inserted
    w_chrono = linear_forgetting_weights_padded(nn[:, 0], lf, pad)
    w_sorted = w_chrono.gather(1, order)
    pw = torch.full((L, 1), float(prior_weight), dtype=_F32, device=dev)
    srtd_w = (
        torch.zeros(L, K, dtype=_F32, device=dev)
        .scatter(1, out_pos, torch.where(valid, w_sorted, 0.0))
        .scatter(1, prior_pos, pw)
    )
    srtd_w = torch.where(i_out < n_tot, srtd_w, 0.0)
    srtd_w = srtd_w / srtd_w.sum(dim=1, keepdim=True)

    return srtd_w, srtd_mus, sigma
