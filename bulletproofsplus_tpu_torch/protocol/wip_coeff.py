"""The coefficient-form prover: the known-challenge fold with no generator fold.

Port of bulletproofsplus_tpu/protocol/wip_coeff.py (:49-170), over K-batched
tensors. Each folded generator is a linear combination of the key's
original generators whose coefficients are products of challenge factors:
G^(r)_i = Σ_{j ≡ i mod n_r} wG_j·G_j with wG_j = Π_{t<r} (β_t(j) ? ŷ_t⁻¹·e_t
: e_t⁻¹), β_t(j) bit log2(n) − 1 − t of j, and wH_j with e_t⁻¹ / e_t. So
every round's L and R is an MSM over the original (G, H, g, h), n + 2 lanes
whose index sets are static bit patterns, and the whole prover is a field
program that packs every round's scalar row, then one (K, 2·log2 n)-row MSM
over the key's generators (shared by the K proofs: the points are one
(2·log2 n, n + 2) tensor, expanded over K), one A row of 2n + 2 lanes and
the 2-lane B. Its proofs equal the fold prover's byte for byte (the same
scalars, and points equal as affine points).

The row MSMs take the Pippenger bucket MSM (msm/pippenger.py) when
BPP_PIPPENGER is on and a proof's lanes reach BPP_PIPPENGER_MIN, counted
as the JAX package's vmap sees them (`_rows_msm`, :49-63): at n·m = 1,024
the L/R rows are 20·1,026 lanes and the A row 2,050, so with the default
minimum of 4,096 the rows take the buckets and A the joint ladder (K2 and
K3). B is always the ladder.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.profiler import record_function

from ..msm.engine import msm
from ..msm.pippenger import msm_pippenger, pippenger_enabled, pippenger_min_lanes
from .wip import final_responses


def rows_msm(curve, scalars_plain, points, nbits: int):
    """Σ over axis -3 for K proofs' rows: scalars (K, ..., W, S) plain form,
    points (..., W, C, L) shared by the K proofs. The buckets when they are
    on and a proof's lanes reach the minimum, else the joint ladder."""
    if pippenger_enabled() and points[..., 0, 0].numel() >= pippenger_min_lanes():
        return msm_pippenger(curve, scalars_plain, points, nbits)
    return msm(curve, scalars_plain, points.expand(*scalars_plain.shape[:-1],
                                                   *points.shape[-2:]), nbits)


@functools.lru_cache(maxsize=None)
def _patterns(n: int, device_key: str):
    """The static bit patterns of each round r (wip_coeff.py:77-85): β_r(j)
    (n,) bool, idx_hi / idx_lo the j with β_r(j) = 1 / 0, and low_hi /
    low_lo those j mod n_(r+1), as tensors on the device."""
    device = torch.device(device_key)
    logn = n.bit_length() - 1
    j = np.arange(n)
    out = []
    for r in range(logn):
        half = n >> (r + 1)
        beta = ((j >> (logn - 1 - r)) & 1).astype(bool)
        idx_hi, idx_lo = np.nonzero(beta)[0], np.nonzero(~beta)[0]
        out.append(tuple(torch.from_numpy(x).to(device)
                         for x in (beta, idx_hi, idx_lo, idx_hi % half, idx_lo % half)))
    return out


def wip_prove_coeff_batched(curve, a, b, power_of_y, alpha, G, H, g, h,
                            es_m, dLs_m, dRs_m, r_m, s_m, delta_m, eta_m, ef_m):
    """The fold of K proofs whose challenges and blinds are known ahead, in
    coefficient form; arguments and result as wip.wip_prove_known_batched's:
    a, b, power_of_y (K, n, 8) and α (K, 8) Montgomery, G, H (n, C, L) and
    g, h (C, L) the key's generators, es, dLs, dRs (K, log2 n, 8), r, s, δ,
    η, e_final (K, 8); returns (L_vec, R_vec (K, log2 n, C, L), A, B
    (K, C, L), r', s', δ' (K, 8))."""
    fn = curve.fn
    K, n = a.shape[:2]
    logn = n.bit_length() - 1
    nbits = fn.order_bits
    dev = a.device
    pats = _patterns(n, str(dev))
    with record_function("bpp::coeff_rows"):
        ynhats = power_of_y[:, [(n >> (r + 1)) - 1 for r in range(logn)]]   # (K, logn, 8)
        # one Fermat chain inverts the round challenges and the ŷ together
        _, invs = fn.batch_invert(torch.cat([es_m, ynhats], dim=1), axis=1)
        es_inv, ynhat_invs = invs[:, :logn], invs[:, logn:]
        es_sqr = fn.mul(es_m, es_m)
        es_inv_sqr = fn.mul(es_inv, es_inv)
        wG = wH = fn.one(dev).expand(K, n, fn.L)
        rows, points = [], []
        for r in range(logn):
            beta, idx_hi, idx_lo, low_hi, low_lo = pats[r]
            half = n >> (r + 1)
            e_m, e_inv = es_m[:, r, None], es_inv[:, r, None]
            ynhat, ynhat_inv = ynhats[:, r, None], ynhat_invs[:, r, None]
            a1, a2 = a[:, :half], a[:, half:]
            b1, b2 = b[:, :half], b[:, half:]
            y1 = power_of_y[:, :half]
            c_L = fn.sum(fn.mul(fn.mul(a1, b2), y1), axis=1)
            c_R = fn.sum(fn.mul(fn.mul(a2, b1), fn.mul(y1, ynhat)), axis=1)
            # the packed rows: wip:98-125 over the original bases
            sGL = fn.mul(fn.mul(a1[:, low_hi], ynhat_inv), wG[:, idx_hi])
            sHL = fn.mul(b2[:, low_lo], wH[:, idx_lo])
            sGR = fn.mul(fn.mul(a2[:, low_lo], ynhat), wG[:, idx_lo])
            sHR = fn.mul(b1[:, low_hi], wH[:, idx_hi])
            rows += [torch.cat([sGL, sHL, c_L[:, None], dLs_m[:, r, None]], dim=1),
                     torch.cat([sGR, sHR, c_R[:, None], dRs_m[:, r, None]], dim=1)]
            points += [torch.cat([G[idx_hi], H[idx_lo], g[None], h[None]]),
                       torch.cat([G[idx_lo], H[idx_hi], g[None], h[None]])]
            # the weights move after round r's rows (L and R use w^(r)):
            # G's factor is e⁻¹ where β = 0 and ŷ⁻¹e where β = 1, H's e and e⁻¹
            wG = fn.mul(wG, fn.select(beta, fn.mul(ynhat_inv, e_m), e_inv))
            wH = fn.mul(wH, fn.select(beta, e_inv, e_m))
            # the compact field folds (wip:147-158)
            a = fn.add(fn.mul(a1, e_m), fn.mul(a2, fn.mul(ynhat, e_inv)))
            b = fn.add(fn.mul(b1, e_inv), fn.mul(b2, e_m))
            alpha = fn.add(alpha, fn.add(fn.mul(es_sqr[:, r], dLs_m[:, r]),
                                         fn.mul(es_inv_sqr[:, r], dRs_m[:, r])))
        # A (wip:189-208): G^(log2 n)_0 = Σ_j wG_j·G_j, one row of 2n + 2 lanes
        y0 = power_of_y[:, 0]
        a0, b0 = a[:, 0], b[:, 0]
        rcbsca = fn.add(fn.mul(fn.mul(r_m, y0), b0), fn.mul(fn.mul(s_m, y0), a0))
        rcs = fn.mul(fn.mul(r_m, y0), s_m)
        sA = torch.cat([fn.mul(wG, r_m[:, None]), fn.mul(wH, s_m[:, None]), rcbsca[:, None],
                        delta_m[:, None]], dim=1)
        S = fn.from_mont(torch.stack(rows, dim=1))                 # (K, 2·logn, n + 2, 8)
        P = torch.stack(points)                                    # (2·logn, n + 2, C, L)
    with record_function("bpp::rows_msm"):
        LR = rows_msm(curve, S, P, nbits)                          # (K, 2·logn, C, L)
    with record_function("bpp::final_ab"):
        A = rows_msm(curve, fn.from_mont(sA), torch.cat([G, H, g[None], h[None]]), nbits)
        B = msm(curve, fn.from_mont(torch.stack([rcs, eta_m], dim=1)),
                torch.stack([g, h]).expand(K, 2, *g.shape), nbits)
        responses = final_responses(fn, a0, b0, alpha, r_m, s_m, delta_m, eta_m, ef_m)
    return (LR[:, 0::2], LR[:, 1::2], A, B, *responses)
