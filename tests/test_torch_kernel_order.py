"""The reduction order of the card's pair-score loop (``csrc/pair_lse.cuh``),
emulated in torch on the CPU, against ``pair_score`` and the JAX package's
Pallas kernel in interpret mode.

The CUDA loop cannot run here, so this emulation repeats its order step for
step: each region cut into chunks of 32·G components padded with
(0, 0, −inf) columns; lane l owning components 4l + 128h + {0..3} of a
chunk; per lane and chunk the max of the chunk's quadratics (NaN-ignoring,
as ``fmaxf``), a pairwise sum of ``exp2((c − m)·log2 e)`` and one rescale
of the running sum; then the lanes merged by an xor-butterfly max, one
rescale, and an xor-butterfly sum.  Tolerance: atol 1e-4, rtol 1e-5, as
the other pair-score parity tests (the summation order of a long
logsumexp differs between the kernel, the Pallas tiles and the chunked
matmul).
"""

import math

import numpy as np
import pytest
import torch

from hyperopt_tpu.ops.pallas_gmm import pair_score_pallas_batched
from hyperopt_tpu.ops.score import pair_params as j_pair_params
from hyperopt_tpu_torch.ops.score import NEG_BIG, pair_score

G = 8             # pair_lse.cuh: components per lane per chunk
CHUNK = 32 * G    # components per warp per chunk
LOG2E = np.float32(1.4426950408889634)
TOL = dict(atol=1e-4, rtol=1e-5)


def fma(a, b, c):
    """f32 fused multiply-add, through f64 (the product is exact there)."""
    return (a.double() * b.double() + c.double()).float()


def pairwise(x, op):
    """pair_lse.cuh's pairwise tree over the last axis (length G)."""
    x = list(x.unbind(-1))
    w = 1
    while w < len(x):
        for g in range(0, len(x), 2 * w):
            x[g] = op(x[g], x[g + w])
        w *= 2
    return x[0]


def butterfly(x, op):
    """The xor butterfly over the lane axis (last, 32): every lane's result."""
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = op(x, x[..., lane ^ off])
    return x


def region_lse(z, p, per_lane=False):
    """Logsumexp over the region ``p`` ([L, 3, n]) of candidates ``z``
    ([L, C]) in the kernel's order: ``[L, C]``, or ``[L, C, 32]`` with every
    lane's merged value when ``per_lane``."""
    L, C = z.shape
    n = p.shape[2]
    nq = -(-n // CHUNK)
    pad = torch.zeros((L, 3, nq * CHUNK - n), dtype=torch.float32)
    pad[:, 2] = -math.inf
    cols = torch.cat([p, pad], dim=2)
    # [L, 3, chunk, group, lane, 4] -> [L, 3, lane, chunk, G]
    cols = cols.reshape(L, 3, nq, G // 4, 32, 4).permute(0, 1, 4, 2, 3, 5)
    cols = cols.reshape(L, 3, 1, 32, nq, G)
    f0 = (z * z)[:, :, None, None, None]
    f1 = z[:, :, None, None, None]
    c = fma(f0, cols[:, 0], fma(f1, cols[:, 1], cols[:, 2]))  # [L, C, 32, nq, G]
    m = torch.full((L, C, 32), NEG_BIG, dtype=torch.float32)
    s = torch.zeros((L, C, 32), dtype=torch.float32)
    for q in range(nq):
        v = c[..., q, :]
        mx = torch.fmax(pairwise(v, torch.fmax), m)
        t = pairwise(torch.exp2((v - mx[..., None]) * LOG2E), torch.add)
        s = fma(s, torch.exp2((m - mx) * LOG2E), t)
        m = mx
    M = butterfly(m, torch.fmax)
    S = butterfly(s * torch.exp2((m - M) * LOG2E), torch.add)
    lse = M + torch.log(S)
    return lse if per_lane else lse[..., 0]


def kernel_order_scores(z, params, k_below):
    return region_lse(z, params[:, :, :k_below]) - region_lse(z, params[:, :, k_below:])


def batched_case(L, C, kb, ka, seed, pad_b=0, pad_a=0):
    """numpy mixtures through the JAX package's pair_params: [L, C], [L, 3, K]."""
    rng = np.random.default_rng(seed)
    zs, ps = [], []
    for _ in range(L):
        wb = rng.uniform(0.1, 1, kb).astype(np.float32)
        wa = rng.uniform(0.1, 1, ka).astype(np.float32)
        if pad_b:
            wb[-pad_b:] = 0.0
        if pad_a:
            wa[-pad_a:] = 0.0
        wb /= max(wb.sum(), 1e-12)
        wa /= max(wa.sum(), 1e-12)
        below = [rng.normal(0, 2, kb).astype(np.float32),
                 rng.uniform(0.05, 2, kb).astype(np.float32)]
        above = [rng.normal(0, 2, ka).astype(np.float32),
                 rng.uniform(0.05, 2, ka).astype(np.float32)]
        ps.append(np.asarray(j_pair_params(wb, *below, wa, *above)))
        zs.append(rng.uniform(-4, 4, C).astype(np.float32))
    return np.stack(zs), np.stack(ps)


# the edge grids of tests/test_torch_ops.py, a region of several chunks and
# ragged C and K
CASES = {
    "kb1": dict(L=2, C=70, kb=1, ka=40),
    "ragged_k": dict(L=2, C=130, kb=33, ka=257),
    "padded_regions": dict(L=2, C=64, kb=9, ka=137, pad_b=4, pad_a=10),
    "l3": dict(L=3, C=200, kb=17, ka=50, pad_a=3),
    "several_chunks": dict(L=1, C=33, kb=300, ka=1100, pad_a=7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_order_matches_plain_and_pallas_interpret(case):
    z, P = batched_case(seed=len(case), **CASES[case])
    kb = CASES[case]["kb"]
    got = kernel_order_scores(torch.tensor(z), torch.tensor(P), kb).numpy()
    plain = pair_score(torch.tensor(z), torch.tensor(P), kb, chunk=48).numpy()
    np.testing.assert_allclose(got, plain, **TOL)
    ref = np.asarray(pair_score_pallas_batched(z, P, kb, tc=64, tk=128, interpret=True,
                                               fma=True))
    np.testing.assert_allclose(got, ref, **TOL)


def test_kernel_order_all_padding_region():
    """A below region of NEG_BIG (padding) columns only: the kernel's order
    gives the plain version's NEG_BIG + log(n) - LSE_above, and padding
    appended to a region adds no mass."""
    z, P = batched_case(L=2, C=50, kb=8, ka=30, seed=9)
    P = torch.tensor(P)
    dead = P.clone()
    dead[:, 0, :8] = 0.0
    dead[:, 1, :8] = 0.0
    dead[:, 2, :8] = NEG_BIG
    z = torch.tensor(z)
    got = kernel_order_scores(z, dead, 8)
    np.testing.assert_allclose(got.numpy(), pair_score(z, dead, 8).numpy(), **TOL)
    pad = torch.zeros((2, 3, 300))
    pad[:, 2] = NEG_BIG
    padded = torch.cat([P, pad], dim=2)
    np.testing.assert_allclose(kernel_order_scores(z, padded, 8).numpy(),
                               kernel_order_scores(z, P, 8).numpy(), **TOL)


def test_kernel_order_nan_candidates_score_nan():
    """A NaN candidate scores NaN, as in the plain version, and leaves its
    neighbours' scores alone."""
    z, P = batched_case(L=1, C=40, kb=5, ka=60, seed=3)
    z = torch.tensor(z)
    z[0, [0, 17]] = math.nan
    got = kernel_order_scores(z, torch.tensor(P), 5)
    plain = pair_score(z, torch.tensor(P), 5)
    assert torch.isnan(got[0, [0, 17]]).all() and torch.isnan(plain[0, [0, 17]]).all()
    keep = ~torch.isnan(z)
    np.testing.assert_allclose(got[keep].numpy(), plain[keep].numpy(), **TOL)


@pytest.mark.parametrize("ka", [1, 255, 256, 257, 1023, 1025])
def test_kernel_order_ragged_regions(ka):
    """Region sizes on both sides of the chunk and tile edges."""
    z, P = batched_case(L=1, C=37, kb=3, ka=ka, seed=ka)
    got = kernel_order_scores(torch.tensor(z), torch.tensor(P), 3)
    plain = pair_score(torch.tensor(z), torch.tensor(P), 3)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_kernel_order_every_lane_ends_with_the_same_bits():
    """The merge leaves one value in all 32 lanes (max first, then a sum
    whose every pairing is commutative), so which lane writes a score, and
    so which CPW the launch picked, cannot change its bits."""
    z, P = batched_case(L=2, C=25, kb=9, ka=700, seed=5)
    lanes = region_lse(torch.tensor(z), torch.tensor(P)[:, :, 9:], per_lane=True)
    bits = lanes.view(torch.int32)
    assert torch.equal(bits, bits[..., :1].expand_as(bits))
