"""The weighted-inner-product proof container and its K-batched prover.

Port of bulletproofsplus_tpu/protocol/wip.py: the reference struct
(:29-44, wip:24-33), `_joint_rows_msm` (:233-269) and the known-challenge
fold of K proofs `_wip_prove_known_kbatched_prog` (:928-1066). Its
verification scalars are computed inside the batched exponent programs of
protocol/range.py.

The fold is one function (`fold`) over a round body (`round_lr`, then
`round_fold`) and the final part (`final_ab`, `final_responses`), and takes
its challenges from two callbacks: `wip_prove_known_batched` reads them from
tensors known ahead, protocol/fs256.py::wip_prove_fs256_batched derives them
from each round's L and R on the card. Nothing else differs between them.

Every round's tensors carry the leading K axis, so each kernel sees one
launch per round for the whole batch: L and R of every proof are one
(K, 2, W) MSM (K2 at J = 4, then K3), and the generator folds are K2 at
J = 2 over (K, 2·half) pairs. `power_of_y` is not folded, as in the
reference; G and H stay an `expand` of the key's generators until the first
fold.
"""
from __future__ import annotations

import dataclasses
import os

import torch
from torch.profiler import record_function

from ..curves.cuda_curve import joint_ladder_msm_grouped, sum_points_grouped


@dataclasses.dataclass
class WipProof:
    """2·log2(n) points + A, B and three Montgomery-form scalars."""

    L_vec: torch.Tensor    # (rounds, C, L), C = curve.COORDS, L = curve.fp.L
    R_vec: torch.Tensor    # (rounds, C, L)
    A: torch.Tensor        # (C, L)
    B: torch.Tensor        # (C, L)
    r_prime: torch.Tensor  # (8,)
    s_prime: torch.Tensor  # (8,)
    d_prime: torch.Tensor  # (8,)

    @property
    def rounds(self) -> int:
        return self.L_vec.shape[0]


def joint_rows_msm(curve, scalars_plain, points, nbits: int):
    """Σ over axis -3 of (..., W) pairs by the J-way joint ladder (K2) and
    the grouped sum (K3): J = 4 if W % 4 == 0 or W ≥ 8, else 2; W pads to a
    multiple of J with zero scalars and identity points."""
    lead = points.shape[:-3]
    W = points.shape[-3]
    J = 4 if W % 4 == 0 or W >= 8 else 2
    Wp = -(-W // J) * J
    if Wp != W:
        scalars_plain = torch.cat(
            [scalars_plain, scalars_plain.new_zeros(*lead, Wp - W, scalars_plain.shape[-1])],
            dim=-2)
        points = torch.cat(
            [points, curve.identity_like((*lead, Wp - W), points.device)], dim=-3)
    return sum_points_grouped(
        curve, joint_ladder_msm_grouped(curve, scalars_plain, points, nbits, J))


def round_lr(curve, a, b, power_of_y, Gk, Hk, gk, hk, ynhat, ynhat_inv, dL, dR):
    """L and R of one round of K proofs (wip:98-125), (K, 2, C, L):
    L = Σ (ŷ⁻¹a1)ᵢ·G2ᵢ + Σ b2ᵢ·H1ᵢ + c_L·g + d_L·h and
    R = Σ (ŷ·a2)ᵢ·G1ᵢ + Σ b1ᵢ·H2ᵢ + c_R·g + d_R·h, one (K, 2, W) MSM."""
    fn = curve.fn
    half = a.shape[1] // 2
    a1, a2 = a[:, :half], a[:, half:]
    b1, b2 = b[:, :half], b[:, half:]
    y1 = power_of_y[:, :half]
    c_L = fn.sum(fn.mul(fn.mul(a1, b2), y1), axis=1)
    c_R = fn.sum(fn.mul(fn.mul(a2, b1), fn.mul(y1, ynhat[:, None])), axis=1)
    S = torch.stack([
        torch.cat([fn.mul(a1, ynhat_inv[:, None]), b2, c_L[:, None], dL[:, None]], dim=1),
        torch.cat([fn.mul(a2, ynhat[:, None]), b1, c_R[:, None], dR[:, None]], dim=1),
    ], dim=1)                                                  # (K, 2, W, 8)
    P = torch.stack([
        torch.cat([Gk[:, half:], Hk[:, :half], gk[:, None], hk[:, None]], dim=1),
        torch.cat([Gk[:, :half], Hk[:, half:], gk[:, None], hk[:, None]], dim=1),
    ], dim=1)                                                  # (K, 2, W, C, L)
    return joint_rows_msm(curve, fn.from_mont(S), P, fn.order_bits)


def round_fold(curve, a, b, Gk, Hk, ynhat, ynhat_inv, e_m, e_inv):
    """The folds of one round (wip:147-171): a, b, and G' = e⁻¹·G1 + ŷ⁻¹e·G2,
    H' = e·H1 + e⁻¹·H2, each (G1ᵢ, G2ᵢ) / (H1ᵢ, H2ᵢ) pair one J = 2 group."""
    fn = curve.fn
    K, half = a.shape[0], a.shape[1] // 2
    a = fn.add(fn.mul(a[:, :half], e_m[:, None]),
               fn.mul(a[:, half:], fn.mul(ynhat, e_inv)[:, None]))
    b = fn.add(fn.mul(b[:, :half], e_inv[:, None]), fn.mul(b[:, half:], e_m[:, None]))
    fold4 = fn.from_mont(torch.stack(
        [e_inv, fn.mul(ynhat_inv, e_m), e_m, e_inv], dim=1))   # (K, 4, 8)
    pair_p = torch.cat([torch.stack([Gk[:, :half], Gk[:, half:]], dim=2),
                        torch.stack([Hk[:, :half], Hk[:, half:]], dim=2)], dim=1)
    pair_s = torch.cat([fold4[:, None, :2].expand(K, half, 2, fn.L),
                        fold4[:, None, 2:].expand(K, half, 2, fn.L)], dim=1)
    out = joint_ladder_msm_grouped(curve, pair_s.reshape(K, 4 * half, fn.L),
                                   pair_p.reshape(K, 4 * half, *Gk.shape[-2:]),
                                   fn.order_bits, 2)
    return a, b, out[:, :half], out[:, half:]


def final_ab(curve, a0, b0, y0, G0, H0, gk, hk, r_m, s_m, delta_m, eta_m):
    """A = r·G0 + s·H0 + (r·y·b0 + s·y·a0)·g + δ·h and B = (r·y·s)·g + η·h
    (wip:181-208), (K, 2, C, L)."""
    fn = curve.fn
    rcbsca = fn.add(fn.mul(fn.mul(r_m, y0), b0), fn.mul(fn.mul(s_m, y0), a0))
    rcs = fn.mul(fn.mul(r_m, y0), s_m)
    zero = torch.zeros_like(r_m)
    ident = curve.identity_like(r_m.shape[:1], r_m.device)
    AB_s = torch.stack([torch.stack([r_m, s_m, rcbsca, delta_m], dim=1),
                        torch.stack([rcs, eta_m, zero, zero], dim=1)], dim=1)
    AB_p = torch.stack([torch.stack([G0, H0, gk, hk], dim=1),
                        torch.stack([gk, hk, ident, ident], dim=1)], dim=1)
    return joint_rows_msm(curve, fn.from_mont(AB_s), AB_p, fn.order_bits)


def final_responses(fn, a0, b0, alpha, r_m, s_m, delta_m, eta_m, ef_m):
    """r' = r + a0·e, s' = s + b0·e, δ' = η + δ·e + α·e² (wip:211-216)."""
    r_prime = fn.add(r_m, fn.mul(a0, ef_m))
    s_prime = fn.add(s_m, fn.mul(b0, ef_m))
    d_prime = fn.add(eta_m, fn.add(fn.mul(delta_m, ef_m),
                                   fn.mul(alpha, fn.mul(ef_m, ef_m))))
    return r_prime, s_prime, d_prime


def fold(curve, a, b, power_of_y, alpha, G, H, g, h, dLs_m, dRs_m, r_m, s_m,
         delta_m, eta_m, ynhat_invs, round_challenge, final_challenge):
    """The whole fold of K proofs (wip:36-227). a, b, power_of_y (K, n, 8)
    and α (K, 8) Montgomery; G, H (n, C, L), g, h (C, L) the key's
    generators; dLs/dRs (K, log2 n, 8); r, s, δ, η (K, 8); ynhat_invs
    (K, log2 n, 8) the inverses of round r's ŷ = power_of_y[:, n/2^(r+1) − 1].
    round_challenge(r, LR) gives round r's (e, e⁻¹, e², e⁻²), each (K, 8),
    from its (K, 2, C, L) L and R; final_challenge(AB) the final e from A
    and B. Returns (L_vec, R_vec (K, log2 n, C, L), A, B (K, C, L), r', s',
    δ' (K, 8))."""
    fn = curve.fn
    K, n = a.shape[:2]
    logn = n.bit_length() - 1
    Gk, Hk = G.expand(K, *G.shape), H.expand(K, *H.shape)
    gk, hk = g.expand(K, *g.shape), h.expand(K, *h.shape)
    Ls, Rs = [], []
    for r in range(logn):
        with record_function("bpp::fold_round"):
            ynhat, ynhat_inv = power_of_y[:, (n >> (r + 1)) - 1], ynhat_invs[:, r]
            LR = round_lr(curve, a, b, power_of_y, Gk, Hk, gk, hk, ynhat, ynhat_inv,
                          dLs_m[:, r], dRs_m[:, r])
            Ls.append(LR[:, 0])
            Rs.append(LR[:, 1])
            e_m, e_inv, e_sqr, e_inv_sqr = round_challenge(r, LR)
            a, b, Gk, Hk = round_fold(curve, a, b, Gk, Hk, ynhat, ynhat_inv, e_m, e_inv)
            alpha = fn.add(alpha, fn.add(fn.mul(e_sqr, dLs_m[:, r]),
                                         fn.mul(e_inv_sqr, dRs_m[:, r])))
    with record_function("bpp::final_ab"):
        a0, b0 = a[:, 0], b[:, 0]
        AB = final_ab(curve, a0, b0, power_of_y[:, 0], Gk[:, 0], Hk[:, 0], gk, hk,
                      r_m, s_m, delta_m, eta_m)
        ef_m = final_challenge(AB)
        responses = final_responses(fn, a0, b0, alpha, r_m, s_m, delta_m, eta_m, ef_m)
    return (torch.stack(Ls, dim=1), torch.stack(Rs, dim=1), AB[:, 0], AB[:, 1], *responses)


def prover_variant() -> str:
    """Which program proves a batch whose challenges and blinds are known
    ahead (wip.py:629-650): "coeff", the coefficient-form prover
    (protocol/wip_coeff.py), when BPP_PROVER=coeff, else "fold", this
    module's fold. BPP_PROVER=scan|unrolled (and the legacy BPP_PROVER_SCAN)
    choose between two XLA programs of the one fold, whose scan body exists
    only to bound TPU compiles, so both mean "fold" here. Read at call time;
    the fold is the default, as in the JAX package."""
    return "coeff" if os.environ.get("BPP_PROVER") == "coeff" else "fold"


def wip_prove_known_batched(curve, a, b, power_of_y, alpha, G, H, g, h,
                            es_m, dLs_m, dRs_m, r_m, s_m, delta_m, eta_m, ef_m):
    """The fold of K proofs whose challenges and blinds are known ahead:
    es (K, log2 n, 8) and e_final (K, 8), other arguments and the result as
    `fold`'s."""
    fn = curve.fn
    n = a.shape[1]
    logn = n.bit_length() - 1
    ynhats = power_of_y[:, [(n >> (r + 1)) - 1 for r in range(logn)]]   # (K, logn, 8)
    # one Fermat chain inverts the round challenges and the ŷ together
    _, invs = fn.batch_invert(torch.cat([es_m, ynhats], dim=1), axis=1)
    es_inv = invs[:, :logn]
    es_sqr = fn.mul(es_m, es_m)
    es_inv_sqr = fn.mul(es_inv, es_inv)
    return fold(curve, a, b, power_of_y, alpha, G, H, g, h, dLs_m, dRs_m, r_m, s_m,
                delta_m, eta_m, invs[:, logn:],
                lambda r, LR: (es_m[:, r], es_inv[:, r], es_sqr[:, r], es_inv_sqr[:, r]),
                lambda AB: ef_m)
