"""One proof's WIP fold with its mn axis split over a mesh axis.

Port of bulletproofsplus_tpu/parallel/sharded_prover.py. The fold halves
its vectors log2(mn) times (weighted_inner_product_proof.rs:79-172), and
every round reads both halves of each vector. Layout (:1-40 there):
element i of a, b, the powers of y, G and H lives on shard i mod P, in
slot i div P. With n and P powers of two, (i + n/2) mod P = i mod P while
n/2 ≥ P, so both halves of a pair sit on one shard and every fold is local
(`_n_sharded_rounds`). Per round:

- each shard runs `wip.round_lr` at K = 1 on its slice: its c_L and c_R
  partial sums and its partial L and R, one (2, W) MSM (K2, then K3);
- the P partial (L, R) pairs are copied to the first device and summed by
  one K3. L and R are linear in the slices, and c_L, c_R are sums over
  them, so the sum is the round's L and R. The blinds d_L·h and d_R·h go to
  shard 0 alone (zero on the others); the JAX package weights every
  device's g and h lanes by P⁻¹ instead (:26-28), because its SPMD program
  has no device-0 branch. A single controller needs no such weight;
- e comes from the summed (L, R): known ahead, or one launch of the fs256
  chain's round step (protocol/fs256.py::round_step) on the first device;
- each shard folds its slice with `wip.round_fold` (K2 at J = 2).

Once a half would fall below P, the shards' slices are gathered in global
order on the first device, and `wip.fold` runs the remaining rounds and the
final A, B and responses there. The statement (bit commitment, y and z,
setup) runs as in batch_prove, at K = 1 (`batchprove.prove_statements`).
Blinds are drawn in the JAX package's order: α, every round's (d_L, d_R),
then the final four (:346, :366-368).

The proof's bytes equal `prove`'s under the same transcript and rng: the
challenges and scalars are the same field elements, and points are compared
affine (the sums' projective representatives differ).
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..protocol.batchprove import draw_blinds, prove_statements
from ..protocol.fs256 import absorb_and_draw, final_step, round_step
from ..protocol.range import RangeProof, validate
from ..protocol.wip import WipProof, fold, round_fold, round_lr
from ..transcript import Fs256Transcript, SystemRng
from .sharded_msm import gather_sum


def _n_sharded_rounds(n: int, ndev: int) -> int:
    """Rounds whose fold stays local under the cyclic layout: half ≥ ndev."""
    cnt, half = 0, n // 2
    while half >= ndev:
        cnt += 1
        half //= 2
    return cnt


def _interleave(parts, device):
    """The shards' cyclic slices (each (1, S, ...)) → (1, S·P, ...) in
    global order (element i from shard i mod P, slot i div P) on `device`."""
    st = torch.stack([x.to(device, non_blocking=True) for x in parts], dim=2)
    return st.reshape(1, -1, *parts[0].shape[2:])


def sharded_prove(curve, pk, n: int, prover, mesh, transcript=None, rng=None,
                  axis: str = "tp") -> RangeProof:
    """Prove one range statement with the mn axis split over mesh[axis].

    transcript: Fs256Transcript (the default; unused) or
    DeterministicTranscript; rng: SystemRng by default. mn and the axis size
    P must be powers of two with mn ≥ P. The statement runs on pk's device,
    the rounds on the axis's devices, the tail and the result on its first
    device. Returns the RangeProof that `prove` gives under the same
    transcript and rng; an fs256 transcript ends in its host twin's state."""
    fn = curve.fn
    m = len(prover.v_vec)
    validate(pk, n, m)
    mn = n * m
    devs = mesh.axis_devices(axis)
    P = len(devs)
    if mn < P or mn & (mn - 1) or P & (P - 1):
        raise ValueError("mn and mesh axis must be powers of two, mn >= P")
    transcript = transcript if transcript is not None else Fs256Transcript(m)
    rng = rng if rng is not None else SystemRng(fn.p)
    fs256 = bool(getattr(transcript, "device_graph", False))
    known = getattr(transcript, "challenges_known_ahead", False)
    if not (fs256 or known):
        raise ValueError(
            "sharded_prove needs an fs256 or known-challenge transcript "
            "(interactive host-hash transcripts serialize the mesh)")
    if fs256 and transcript._counter != 0:
        raise ValueError("fs256 sharded_prove needs a FRESH transcript")

    pk = pk.prefix(mn)
    logn = mn.bit_length() - 1
    alphas, dLs, dRs, finals = draw_blinds([rng], logn, True)
    A, (a, b, power_of_y, alpha), state, _ = prove_statements(
        curve, pk, n, m, [prover], [transcript], alphas, "fs256" if fs256 else "known")

    dev = devs[0]

    def row(vals):
        return fn.encode(vals, dev).reshape(1, -1, fn.L)

    dLs_m, dRs_m, blinds = row(dLs), row(dRs), row(finals[0])
    ynhats = power_of_y[:, [(mn >> (r + 1)) - 1 for r in range(logn)]].to(dev)
    if known:
        es_m = row([transcript.round_challenge(curve, None, None) for _ in range(logn)])
        ef_m = row([transcript.final_challenge(curve, None, None)])[:, 0]
        _, invs = fn.batch_invert(torch.cat([es_m, ynhats], dim=1), axis=1)
        es_inv, ynhat_invs = invs[:, :logn], invs[:, logn:]
    else:
        _, ynhat_invs = fn.batch_invert(ynhats, axis=1)
        state = state.to(dev)

    def challenge(r, LR):
        """Round r's (e, e⁻¹, e², e⁻²), each (1, 8), from its (1, 2, C, L)."""
        nonlocal state
        if known:
            e_m, e_inv = es_m[:, r], es_inv[:, r]
        else:
            with record_function("bpp::fs256_challenge"):
                ch, state = absorb_and_draw(curve, state, None, round_step(r), LR)
                e_m = ch[:, 0]
                e_inv = fn.inv(e_m)
        return e_m, e_inv, fn.mul(e_m, e_m), fn.mul(e_inv, e_inv)

    def final_challenge(AB):
        nonlocal state
        if known:
            return ef_m
        with record_function("bpp::fs256_challenge"):
            ch, state = absorb_and_draw(curve, state, None, final_step(logn), AB)
            return ch[:, 0]

    ns = min(_n_sharded_rounds(mn, P), logn - 1)   # P = 1 would leave the tail no round
    Ls, Rs = [], []
    G, H = pk.G_vec[None], pk.H_vec[None]
    alpha = alpha.to(dev)
    if ns:
        zero = torch.zeros_like(dLs_m[:, 0])
        gh = [(pk.g[None].to(d), pk.h[None].to(d)) for d in devs]
        sl = [[x[:, j::P].to(d) for x in (a, b, power_of_y, G, H)]
              for j, d in enumerate(devs)]
        for r in range(ns):
            with record_function("bpp::fold_round"):
                ynhat, ynhat_inv = ynhats[:, r], ynhat_invs[:, r]
                dL, dR = dLs_m[:, r], dRs_m[:, r]
                with record_function("bpp::sharded_msm"):
                    parts = [round_lr(curve, a_j, b_j, y_j, G_j, H_j, *gh[j],
                                      ynhat.to(d), ynhat_inv.to(d),
                                      (dL if j == 0 else zero).to(d),
                                      (dR if j == 0 else zero).to(d))
                             for j, (d, (a_j, b_j, y_j, G_j, H_j)) in enumerate(zip(devs, sl))]
                LR = gather_sum(curve, parts, dev)                       # (1, 2, C, L)
                Ls.append(LR[:, 0])
                Rs.append(LR[:, 1])
                e_m, e_inv, e_sqr, e_inv_sqr = challenge(r, LR)
                for j, d in enumerate(devs):
                    a_j, b_j, y_j, G_j, H_j = sl[j]
                    a_j, b_j, G_j, H_j = round_fold(curve, a_j, b_j, G_j, H_j, ynhat.to(d),
                                                    ynhat_inv.to(d), e_m.to(d), e_inv.to(d))
                    sl[j] = [a_j, b_j, y_j[:, :a_j.shape[1]], G_j, H_j]
                alpha = fn.add(alpha, fn.add(fn.mul(e_sqr, dL), fn.mul(e_inv_sqr, dR)))
        with record_function("bpp::shard_gather"):
            a, b, power_of_y, G, H = (_interleave([s[k] for s in sl], dev) for k in range(5))
    else:
        a, b, power_of_y, G, H = (x.to(dev) for x in (a, b, power_of_y, G, H))

    L_t, R_t, A_wip, B, r_p, s_p, d_p = fold(
        curve, a, b, power_of_y, alpha, G[0], H[0], pk.g.to(dev), pk.h.to(dev),
        dLs_m[:, ns:], dRs_m[:, ns:], blinds[:, 0], blinds[:, 1], blinds[:, 2], blinds[:, 3],
        ynhat_invs[:, ns:], lambda r, LR: challenge(ns + r, LR), final_challenge)
    if fs256:
        transcript.set_state_words(state.cpu().numpy()[0], logn + 3)
    L_vec = torch.cat([*(x[:, None] for x in Ls), L_t], dim=1)
    R_vec = torch.cat([*(x[:, None] for x in Rs), R_t], dim=1)
    return RangeProof(A=A[0].to(dev), proof=WipProof(
        L_vec=L_vec[0], R_vec=R_vec[0], A=A_wip[0], B=B[0],
        r_prime=r_p[0], s_prime=s_p[0], d_prime=d_p[0]))
