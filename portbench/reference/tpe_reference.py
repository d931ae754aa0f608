"""The plain reference of a TPE suggest: hyperopt's ``tpe.suggest`` in
float64, written from its published description.

It imports neither JAX nor the program under test.  From a flat space
(``portbench.core.spaces`` records) and a history (values as recorded,
losses), it rebuilds what each suggest derived: the γ split
(``n_below = min(ceil(γ·√N), linear_forgetting)``, a stable rank by loss),
the adaptive Parzen fits of l(x) (below) and g(x) (above) with linear
forgetting weights and the prior as one more component, each label's
candidate distribution (l truncated to the bounds, quantized values
rounded, categories drawn from the below posterior) and the score
``log l − log g``.

A suggest is the argmax of that score over ``C = n_EI_candidates`` draws
from l.  Without the program's candidates, the reference judges a winner
``W`` by where it falls in the distribution of the best of ``C`` draws:
``U = F(W)^C`` with ``F`` the distribution function of the score of one
draw (randomized over ties, so that ``U`` is uniform when ``W`` is the
best of ``C`` draws), and the winner's *deficit* is ``-log U``: an
exponential variable of mean 1 for a sound suggest, of mean ``m`` for the
best of ``C/m`` draws, and unbounded for a value that no argmax picked.

:func:`reference_suggest` is the same suggest done by the reference
itself (its own draws, exact scores, argmax): the control of the check,
with fewer candidates than the configuration states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import spaces

F64 = torch.float64
LEVELS = (1 << 14, 64, 64)  # a continuous label's grid, then each unsure cell's split
SPAN_SIGMAS = 10.0      # an unbounded label's grid covers l's components ± this
BUCKET_SIGMAS = 6.0     # quantized values are enumerated over ± this (mass < 1e-9 beyond)
MAX_BUCKETS = 1 << 20   # quantized values enumerated per label
_CHUNK = 1 << 23        # elements of one [points, components] block


def forgetting_weights(n: int, lf: int) -> np.ndarray:
    """Linear forgetting: the oldest ``n − lf`` observations ramp from
    ``1/n`` to 1, the newest ``lf`` weigh 1."""
    if n == 0:
        return np.zeros(0)
    if not lf or n < lf:
        return np.ones(n)
    return np.concatenate([np.linspace(1.0 / n, 1.0, n - lf), np.ones(lf)])


def below_mask(losses: np.ndarray, gamma: float, lf) -> np.ndarray:
    """The γ split of a history in chronological order: True for the
    ``n_below`` best losses (a stable rank, so an earlier trial wins a tie)."""
    n = len(losses)
    n_below = int(math.ceil(gamma * math.sqrt(n)))
    if lf is not None:
        n_below = min(n_below, int(lf))
    order = np.argsort(np.asarray(losses, np.float64), kind="stable")
    mask = np.zeros(n, bool)
    mask[order[:n_below]] = True
    return mask


def adaptive_parzen(obs, prior_weight, prior_mu, prior_sigma, lf):
    """hyperopt's ``adaptive_parzen_normal``: ``(weights, mus, sigmas)``
    sorted by mu, the prior inserted at its sorted place."""
    obs = np.asarray(obs, np.float64)
    n = len(obs)
    order = np.argsort(obs, kind="stable")
    srt = obs[order]
    pos = int(np.searchsorted(srt, prior_mu, side="left"))
    mus = np.insert(srt, pos, prior_mu)
    if n == 0:
        sig = np.array([prior_sigma])
    elif n == 1:
        sig = np.full(2, 0.5 * prior_sigma)
    else:
        sig = np.empty(n + 1)
        sig[1:-1] = np.maximum(mus[1:-1] - mus[:-2], mus[2:] - mus[1:-1])
        sig[0] = mus[1] - mus[0]
        sig[-1] = mus[-1] - mus[-2]
    minsigma = prior_sigma / min(100.0, 1.0 + len(mus))
    sig = np.clip(sig, minsigma, prior_sigma)
    sig[pos] = prior_sigma
    w = np.insert(forgetting_weights(n, lf)[order], pos, prior_weight)
    return w / w.sum(), mus, sig


def _prior(lab):
    """``(mu, sigma, low, high)`` of a continuous label in fit space."""
    d = lab["dist"]
    if d in spaces.BOUNDED:
        lo, hi = float(lab["low"]), float(lab["high"])
        return 0.5 * (lo + hi), hi - lo, lo, hi
    return float(lab["mu"]), float(lab["sigma"]), -math.inf, math.inf


def _ndtr_diff(a, b):
    """Φ(b) − Φ(a) for a ≤ b, exact in both tails."""
    upper = a > 0
    return torch.where(upper, torch.special.ndtr(-a) - torch.special.ndtr(-b),
                       torch.special.ndtr(b) - torch.special.ndtr(a))


class _Mixture:
    """One truncated 1-D Gaussian mixture in fit space, on ``device``."""

    def __init__(self, w, mu, sigma, lo, hi, device):
        self.w = torch.as_tensor(w, dtype=F64, device=device)
        self.mu = torch.as_tensor(mu, dtype=F64, device=device)
        self.sigma = torch.as_tensor(sigma, dtype=F64, device=device)
        self.lo, self.hi = lo, hi
        self.logw = torch.where(self.w > 0, torch.log(self.w), -math.inf)
        self.logc = self.logw - torch.log(self.sigma) - 0.5 * math.log(2 * math.pi)
        lo_t = torch.tensor(lo, dtype=F64, device=device)
        hi_t = torch.tensor(hi, dtype=F64, device=device)
        self.mass = _ndtr_diff((lo_t - self.mu) / self.sigma, (hi_t - self.mu) / self.sigma)

    def log_density(self, z, dtype=F64):
        """log Σ wᵢ N(z; μᵢ, σᵢ) (the truncation's constant left out),
        computed in ``dtype``."""
        out = torch.empty(z.shape, dtype=dtype, device=z.device)
        logc, mu, sigma = (t.to(dtype) for t in (self.logc, self.mu, self.sigma))
        rows = max(1, _CHUNK // max(1, len(self.mu)))
        for r0 in range(0, len(z), rows):
            zz = z[r0:r0 + rows, None].to(dtype)
            out[r0:r0 + rows] = torch.logsumexp(logc - 0.5 * ((zz - mu) / sigma) ** 2, dim=1)
        return out

    def bucket_mass(self, edges):
        """The mass between consecutive fit-space ``edges`` (ascending),
        normalized by the in-bounds mass: each bucket from the mixture's
        CDF below its median and from its survival function above, so
        neither tail cancels."""
        cdf = torch.empty_like(edges)
        sf = torch.empty_like(edges)
        rows = max(1, _CHUNK // max(1, len(self.mu)))
        for r0 in range(0, len(edges), rows):
            a = (edges[r0:r0 + rows, None] - self.mu) / self.sigma
            cdf[r0:r0 + rows] = (self.w * torch.special.ndtr(a)).sum(dim=1)
            sf[r0:r0 + rows] = (self.w * torch.special.ndtr(-a)).sum(dim=1)
        lower = cdf[1:] < sf[1:]
        mass = torch.where(lower, cdf[1:] - cdf[:-1], sf[:-1] - sf[1:]).clamp(min=0.0)
        return mass / (self.w * self.mass).sum()

    def span(self, sigmas=SPAN_SIGMAS):
        """A fit-space interval that holds all but a negligible part of
        the mixture's in-bounds mass."""
        lo = float((self.mu - sigmas * self.sigma).min())
        hi = float((self.mu + sigmas * self.sigma).max())
        return max(lo, self.lo), min(hi, self.hi)

    def sample(self, n, gen):
        """``n`` exact draws from the truncated mixture."""
        dev = self.w.device
        p = self.w * self.mass
        comp = torch.multinomial(p / p.sum(), n, replacement=True, generator=gen)
        mu, s = self.mu[comp], self.sigma[comp]
        lo_t = torch.full_like(mu, self.lo)
        hi_t = torch.full_like(mu, self.hi)
        a = torch.special.ndtr((lo_t - mu) / s)
        b = torch.special.ndtr((hi_t - mu) / s)
        u = torch.rand(n, dtype=F64, device=dev, generator=gen)
        x = mu + s * torch.special.ndtri(a + u * (b - a))
        return torch.minimum(torch.maximum(x, lo_t), hi_t)


class LabelModel:
    """One label's posterior at one suggest: the candidate distribution
    and the score, with the deficit of a winner."""

    def __init__(self, lab, values, below, algo, device):
        self.lab = lab
        self.dist = d = lab["dist"]
        self.device = device
        pw = float(algo.get("prior_weight", 1.0))
        lf = algo.get("linear_forgetting", 25)
        values = np.asarray(values, np.float64)
        if d in spaces.INDEX:
            self.kind = "index"
            p = spaces.prior_p(lab)
            obs = (values - spaces.index_offset(lab)).astype(np.int64)

            def posterior(o):
                counts = np.bincount(o, weights=forgetting_weights(len(o), lf),
                                     minlength=len(p))[:len(p)]
                pseudo = counts + len(p) * pw * p  # hyperopt: p.size pseudocounts
                return pseudo / pseudo.sum()

            self.pb, self.pa = posterior(obs[below]), posterior(obs[~below])
            return
        mu0, s0, lo, hi = _prior(lab)
        fit = np.log(np.maximum(values, 1e-300)) if d in spaces.LOG else values
        self.log = d in spaces.LOG
        self.l = _Mixture(*adaptive_parzen(fit[below], pw, mu0, s0, lf), lo, hi, device)
        self.g = _Mixture(*adaptive_parzen(fit[~below], pw, mu0, s0, lf), lo, hi, device)
        self.kind = "quantized" if d in spaces.QUANTIZED else "continuous"

    # -- candidate values and their scores ---------------------------
    def _buckets(self):
        """Quantized values ``v`` with non-negligible l mass: ``(v, Pl, Pg)``."""
        q = float(self.lab["q"])
        zlo, zhi = self.l.span(BUCKET_SIGMAS)
        raw_lo, raw_hi = (math.exp(zlo), math.exp(zhi)) if self.log else (zlo, zhi)
        j0 = math.floor(raw_lo / q) - 1
        j1 = min(math.ceil(raw_hi / q) + 1, j0 + MAX_BUCKETS)
        v = q * torch.arange(j0, j1 + 1, dtype=F64, device=self.device)
        # bucket v holds the draws that round to it: [v - q/2, v + q/2]
        # within the bounds (raw space; a log label's edges go to log space)
        edges = torch.cat([v - q / 2, v[-1:] + q / 2])
        lo, hi = self.l.lo, self.l.hi
        if self.log:
            blo = math.exp(lo) if math.isfinite(lo) else 0.0
            bhi = math.exp(hi) if math.isfinite(hi) else math.inf
            edges = edges.clamp(min=blo, max=bhi)
            edges = torch.where(edges > 0, torch.log(edges.clamp(min=1e-300)), -math.inf)
        else:
            edges = edges.clamp(min=lo, max=hi)
        pl = self.l.bucket_mass(edges)
        pg = self.g.bucket_mass(edges)
        keep = pl > 0
        return v[keep], pl[keep], pg[keep]

    def _discrete(self):
        """``(values, P_l, score)`` of the discrete kinds."""
        if self.kind == "index":
            k = np.arange(len(self.pb)) + spaces.index_offset(self.lab)
            with np.errstate(divide="ignore"):
                s = np.log(self.pb) - np.log(self.pa)
            return (torch.as_tensor(k, dtype=F64), torch.as_tensor(self.pb),
                    torch.as_tensor(s))
        v, pl, pg = self._buckets()
        return v, pl, torch.log(pl) - torch.log(pg)

    def score_fit(self, z):
        """The continuous score at fit-space points ``z``."""
        return self.l.log_density(z) - self.g.log_density(z)

    def deficit(self, winner, n_cand, u):
        """``-log U`` of a recorded winner under the best of ``n_cand``
        draws; ``u`` in (0, 1) randomizes ties."""
        if self.kind != "continuous":
            vals, pl, s = (t.to(self.device) for t in self._discrete())
            hit = torch.isclose(vals, torch.tensor(float(winner), dtype=F64,
                                                   device=self.device),
                                rtol=spaces.F32_REL, atol=0.0)
            if not bool(hit.any()):
                return math.inf
            t = s[hit][0]
            p_gt = float(pl[s > t].sum())
            p_eq = float(pl[(s == t)].sum())
        else:
            if self.log and winner <= 0:
                return math.inf
            z = math.log(winner) if self.log else float(winner)
            # a float32 value may lie a rounding step outside a bound
            room = spaces.F32_REL * max(1.0, abs(z))
            if not (self.l.lo - room <= z <= self.l.hi + room) or not math.isfinite(z):
                return math.inf
            z = min(max(z, self.l.lo), self.l.hi)
            p_gt = self._continuous_tail(z)
            p_eq = 0.0
        log_f = math.log1p(-min(p_gt, 1.0)) if p_gt < 1.0 else -math.inf
        log_fm = math.log1p(-min(p_gt + p_eq, 1.0)) if p_gt + p_eq < 1.0 else -math.inf
        hi_u = math.exp(n_cand * log_f)
        lo_u = math.exp(n_cand * log_fm)
        big_u = lo_u + u * (hi_u - lo_u)
        return -math.log(big_u) if big_u > 0 else math.inf

    def _continuous_tail(self, z_star):
        """P_l[score > score(z*)] by adaptive quadrature over the candidate
        domain: a grid of LEVELS[0] points, then each cell in which the
        score may cross the winner's (its end values, widened by twice the
        largest second difference around it, straddle the winner's score)
        split again, LEVELS[1:] times; a cell wholly above counts whole, a
        last-level cell the part above its linearly interpolated crossing,
        l interpolated linearly throughout."""
        lo, hi = self.l.span()
        lo, hi = min(lo, z_star), max(hi, z_star)
        dev = self.device
        t = self.score_fit(torch.tensor([z_star], dtype=F64, device=dev))[0]
        top = None
        p = 0.0
        cells = torch.tensor([[lo, hi]], dtype=F64, device=dev)
        for level, n in enumerate(LEVELS):
            frac = torch.linspace(0.0, 1.0, n + 1, dtype=F64, device=dev)
            z = cells[:, :1] + (cells[:, 1:] - cells[:, :1]) * frac      # [cells, n+1]
            ll = self.l.log_density(z.reshape(-1)).reshape(z.shape)
            sc = ll - self.g.log_density(z.reshape(-1)).reshape(z.shape)
            if top is None:
                top = ll.max()
            dens = torch.exp(ll - top)
            h = (z[:, 1:] - z[:, :-1])
            if level == 0:
                total = float((0.5 * (dens[:, 1:] + dens[:, :-1]) * h).sum())
            d2 = torch.zeros_like(sc)
            d2[:, 1:-1] = (sc[:, 2:] - 2 * sc[:, 1:-1] + sc[:, :-2]).abs()
            d2[:, 0], d2[:, -1] = d2[:, 1], d2[:, -2]
            slack = 2.0 * torch.maximum(d2[:, 1:], d2[:, :-1])
            s0, s1 = sc[:, :-1], sc[:, 1:]
            l0, l1 = dens[:, :-1], dens[:, 1:]
            above = torch.minimum(s0, s1) - slack > t
            unsure = ~above & (torch.maximum(s0, s1) + slack > t)
            p += float((0.5 * (l0 + l1) * h)[above].sum())
            if level == len(LEVELS) - 1 or not bool(unsure.any()):
                a, b = (s0 - t)[unsure], (s1 - t)[unsure]
                la, lb, hh = l0[unsure], l1[unsure], h[unsure]
                theta = torch.where(a != b, a / (a - b), torch.zeros_like(a)).clamp(0.0, 1.0)
                start = torch.where(a > 0, torch.zeros_like(a), theta)
                stop = torch.where(b > 0, torch.ones_like(a), torch.where(a > 0, theta, start))
                part = (stop - start) * la + 0.5 * (lb - la) * (stop ** 2 - start ** 2)
                p += float((part * hh).sum())
                break
            cells = torch.stack([z[:, :-1][unsure], z[:, 1:][unsure]], dim=1)
        return p / total

    # -- the reference's own suggest ---------------------------------
    def suggest(self, n_cand, gen, dtype=F64):
        """The best of ``n_cand`` draws from l (drawn in float64), scored
        in ``dtype``: the recorded form (raw value, category index with its
        offset).  ``dtype=torch.bfloat16`` is the check's control."""
        return self.suggest_many(n_cand, 1, gen, dtype)[0]

    def suggest_many(self, n_cand, n_new, gen, dtype=F64):
        """``n_new`` suggests from this one posterior, each the best of
        its own ``n_cand`` draws: a NumPy array of recorded values."""
        if self.kind == "index":
            p = torch.as_tensor(self.pb, dtype=F64, device=self.device)
            cand = torch.multinomial(p, n_new * n_cand, replacement=True,
                                     generator=gen).view(n_new, n_cand)
            pb = torch.as_tensor(self.pb, device=self.device).to(dtype)
            pa = torch.as_tensor(self.pa, device=self.device).to(dtype)
            s = (torch.log(pb) - torch.log(pa))[cand]
            best = cand.gather(1, torch.argmax(s, dim=1, keepdim=True))[:, 0]
            return best.cpu().numpy() + spaces.index_offset(self.lab)
        z = self.l.sample(n_new * n_cand, gen)
        if self.kind == "continuous":
            s = self.l.log_density(z, dtype) - self.g.log_density(z, dtype)
            z = z.view(n_new, n_cand)
            best = z.gather(1, torch.argmax(s.view(n_new, n_cand), dim=1, keepdim=True))[:, 0]
            return (torch.exp(best) if self.log else best).cpu().numpy()
        q = float(self.lab["q"])
        x = torch.exp(z) if self.log else z
        v = (torch.round(x / q) * q).view(n_new, n_cand)
        vals, pl, pg = self._buckets()
        s = torch.log(pl.to(dtype)) - torch.log(pg.to(dtype))
        idx = torch.searchsorted(vals, v.reshape(-1)).clamp(max=len(vals) - 1)
        at = torch.argmax(s[idx].view(n_new, n_cand), dim=1, keepdim=True)
        return v.gather(1, at)[:, 0].cpu().numpy()


def label_models(labels, hist_vals, hist_losses, algo, device):
    """Every label's model at a history (chronological arrays)."""
    below = below_mask(hist_losses, float(algo.get("gamma", 0.25)),
                       algo.get("linear_forgetting", 25))
    return [LabelModel(lab, hist_vals[lab["label"]], below, algo, device) for lab in labels]


def reference_suggest(labels, hist_vals, hist_losses, algo, n_cand, gen, device,
                      dtype=F64):
    """One suggest made by the reference: ``{label: value}`` as recorded."""
    models = label_models(labels, hist_vals, hist_losses, algo, device)
    return {m.lab["label"]: m.suggest(n_cand, gen, dtype) for m in models}


def reference_round(labels, hist_vals, hist_losses, algo, n_cand, n_new, gen, device):
    """``n_new`` suggests made by the reference from one history, as a
    study's workers make them in a round: ``{label: array}`` as recorded."""
    models = label_models(labels, hist_vals, hist_losses, algo, device)
    return {m.lab["label"]: m.suggest_many(n_cand, n_new, gen) for m in models}
