"""Batch proving: K range proofs over one pk as one pass of batched programs.

Port of bulletproofsplus_tpu/protocol/batchprove.py::batch_prove (:124-485):
the known-ahead branch (:275-327), the fs256 branch (:329-375) and the
interactive branch (:377-485, with the host y and z of :225-238). A
homogeneous batch (same n, same m) gains a leading K axis on every tensor:
the bit commitment (K5 + K3), the setup programs, then the whole fold of
protocol/wip.py, so every kernel launch serves all K proofs at once.

Challenges come from one of three sources, all through wip.py's one `fold`:

- DeterministicTranscript: known ahead, uploaded before the fold. With
  every rng's blinds known ahead too and BPP_PROVER=coeff, the
  coefficient-form prover (protocol/wip_coeff.py) runs in place of the
  fold, as the JAX package's does (wip.py:659-702, :271-316): the same
  bytes, every round's L and R an MSM over the key's original generators.
- Fs256Transcript, the default: its chain runs on the card. y and z come
  from A and the commitments (the JAX package draws these two on the host,
  :225-241, which here would be a Python decode of K·m points; the bytes
  are the same), then every round's and the final challenge inside the
  fold (protocol/fs256.py), each step one launch of the fs256 chain kernel.
- Any other transcript (ShaTranscript, merlin.MerlinBppTranscript, or a
  batch mixing kinds): the interactive path. Its hashes run on the host, so
  each round is one round trip for the whole batch: one device-to-host copy
  of the round's (K, 2) L and R, one batched decode (one host inversion),
  K host hashes, one upload of the K challenges and one Fermat inversion of
  them on the card. Fs256 transcripts in a mixed batch hash on their host
  twin.

Blinds never depend on a challenge, so they are drawn ahead from any rng,
in the order the JAX package draws them for the same batch: every α first,
then either per proof its (d_L, d_R) per round and its four final blinds
(the JAX whole-fold branches: every transcript known ahead with every rng's
blinds known ahead, or every transcript an unused fs256 one) or round by
round a (d_L, d_R) for each proof and then each proof's four final blinds
(the JAX interactive branch, :403-407, :430). With a shared, stateful rng
the bytes therefore equal the JAX package's.

The JAX package's K-chunking (:179-212) bounds TPU compile time and memory
and its CPU gate (:171-177) is XLA machinery; neither is carried over: the
port proves the whole batch in one pass.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..hashers_device import words_tensor
from ..transcript import Fs256Transcript, SystemRng
from .fs256 import absorb_and_draw, statement_step, wip_prove_fs256_batched
from .range import (
    ProofBatch,
    bit_commitment_batched,
    bit_decompose,
    prove,
    prove_setup_multiple_batched,
    prove_setup_single_batched,
    validate,
)
from .wip import fold, prover_variant, wip_prove_known_batched
from .wip_coeff import wip_prove_coeff_batched


def draw_blinds(rngs, logn: int, per_proof: bool):
    """(α per proof, d_L and d_R (K·logn, proof-major), the four final
    blinds per proof), drawn per proof or round by round (module docstring)."""
    K = len(rngs)
    alphas = [r.alpha() for r in rngs]
    rounds = [[None] * logn for _ in range(K)]
    if per_proof:
        finals = []
        for k, r in enumerate(rngs):
            rounds[k] = [r.round_blinds() for _ in range(logn)]
            finals.append(r.final_blinds())
    else:
        for j in range(logn):
            for k, r in enumerate(rngs):
                rounds[k][j] = r.round_blinds()
        finals = [r.final_blinds() for r in rngs]
    pairs = [d for row in rounds for d in row]
    return alphas, [d for d, _ in pairs], [d for _, d in pairs], finals


def host_challenges(curve, pts, draw):
    """K challenges from (K, 2, C, L) points by host transcripts: one copy
    off the device (which waits for the points) and one batched decode,
    `draw(k, P0, P1)` for each proof on the affine pairs, then one upload of
    the K values (Montgomery)."""
    fn = curve.fn
    with record_function("bpp::host_fetch"):
        host = pts.cpu()
    with record_function("bpp::host_decode"):
        aff = curve.decode_points(host)
    with record_function("bpp::host_hash"):
        vals = [draw(k, aff[2 * k], aff[2 * k + 1]) % fn.p for k in range(pts.shape[0])]
    with record_function("bpp::host_upload"):
        return fn.encode(vals, pts.device)


def wip_prove_interactive_batched(curve, transcripts, a, b, power_of_y, alpha, G, H,
                                  g, h, dLs_m, dRs_m, r_m, s_m, delta_m, eta_m):
    """The fold of K proofs whose challenges come from host transcripts
    (batchprove.py:377-485): protocol/wip.py's fold, each round's e from
    `round_challenge` on the round's affine L and R, the final e from
    `final_challenge` on A and B (host_challenges). ŷ is inverted once up
    front, each round's K challenges by one Fermat inversion on the card.
    Arguments and result as wip_prove_known_batched's, less the challenges."""
    fn = curve.fn
    n = a.shape[1]
    logn = n.bit_length() - 1
    _, ynhat_invs = fn.batch_invert(power_of_y[:, [(n >> (r + 1)) - 1 for r in range(logn)]],
                                    axis=1)

    def round_challenge(r, LR):
        with record_function("bpp::host_challenge"):
            e_m = host_challenges(
                curve, LR, lambda k, L, R: transcripts[k].round_challenge(curve, L, R))
            e_inv = fn.inv(e_m)
            return e_m, e_inv, fn.mul(e_m, e_m), fn.mul(e_inv, e_inv)

    def final_challenge(AB):
        with record_function("bpp::host_challenge"):
            return host_challenges(
                curve, AB, lambda k, A, B: transcripts[k].final_challenge(curve, A, B))

    return fold(curve, a, b, power_of_y, alpha, G, H, g, h, dLs_m, dRs_m, r_m, s_m,
                delta_m, eta_m, ynhat_invs, round_challenge, final_challenge)


def prove_statements(curve, pk, n: int, m: int, provers, transcripts, alphas, mode: str):
    """What K statements over pk need before the fold, on pk's device: the
    bit commitments A (K, C, L) (K5, then K3), y and z, and the setup
    programs. y and z are known ahead (mode "known"), drawn by the fs256
    chain on the card ("fs256") or by host transcripts ("host"). Returns
    (A, (a_vec, b_vec, power_of_y, alpha_hat), state, base): the fs256
    chain's (K, 8) state after y and z and the (K,) int32 counters before
    them (None for 0), both None unless the mode is "fs256"."""
    fn = curve.fn
    K, dev = len(provers), pk.device
    state = base = None
    with record_function("bpp::bit_commitment"):
        bits = torch.from_numpy(
            np.stack([bit_decompose(p.v_vec, n, m) for p in provers])).to(dev)
        A = bit_commitment_batched(curve, fn.encode_plain(alphas, dev), bits,
                                   pk.G_vec, pk.H_vec, pk.h)
    if mode == "known":
        yz = [t.challenge_yz(curve, None, None) for t in transcripts]
        y_m, z_m = fn.encode([y for y, _ in yz], dev), fn.encode([z for _, z in yz], dev)
    elif mode == "fs256":
        with record_function("bpp::fs256_statement"):
            counts = [t._counter for t in transcripts]
            base = (None if not any(counts) else
                    torch.tensor(counts, dtype=torch.int32, device=dev))
            state = words_tensor(Fs256Transcript.stacked_state_words(transcripts), dev)
            # one stack of all K·m commitments (a copy launch per 128, not
            # per proof)
            V_all = torch.stack([v for p in provers for v in p.commitment_vec]).reshape(
                K, m, *A.shape[1:])
            yz, state = absorb_and_draw(curve, state, base, statement_step(m),
                                        torch.cat([V_all, A[:, None]], dim=1))
            y_m, z_m = yz[:, 0], yz[:, 1]
    else:
        with record_function("bpp::host_statement"):
            A_aff = curve.decode_points(A)
            V_aff = curve.decode_points(
                torch.stack([v for p in provers for v in p.commitment_vec]))
            yz = [t.challenge_yz(curve, V_aff[k * m:(k + 1) * m], A_aff[k])
                  for k, t in enumerate(transcripts)]
            y_m = fn.encode([y % fn.p for y, _ in yz], dev)
            z_m = fn.encode([z % fn.p for _, z in yz], dev)
    with record_function("bpp::prove_setup"):
        alpha_m = fn.encode(alphas, dev)
        if m == 1:
            gamma = fn.encode([p.gamma_vec[0] for p in provers], dev)
            setup = prove_setup_single_batched(fn, n, y_m, z_m, bits, gamma, alpha_m)
        else:
            gamma = fn.encode([g for p in provers for g in p.gamma_vec], dev).reshape(
                K, m, fn.L)
            setup = prove_setup_multiple_batched(fn, n, m, y_m, z_m, bits, gamma,
                                                 alpha_m)
    return A, setup, state, base


def batch_prove(curve, pk, n: int, provers: Sequence,
                transcripts: Optional[Sequence] = None,
                rngs: Optional[Sequence] = None):
    """Prove K range statements (RangeProvers over the shared pk) on the
    key's device. Returns a ProofBatch, whose index k is the RangeProof
    that `prove` gives for prover k with the same transcript and rng; a
    batch mixing aggregation sizes proves each statement alone and returns
    a list of RangeProof.

    transcripts: K transcripts, by default Fs256Transcript(m) each; any mix
    of DeterministicTranscript, Fs256Transcript, ShaTranscript and
    merlin.MerlinBppTranscript (module docstring). Each fs256 transcript
    ends in the state and counter of the host twin that proved its
    statement, each host transcript in the state its statement left. rngs:
    K blinding sources, by default SystemRng."""
    K = len(provers)
    if K == 0:
        return []
    m = len(provers[0].v_vec)
    if any(len(p.v_vec) != m for p in provers):
        return [prove(curve, pk, n, p,
                      transcripts[i] if transcripts else None,
                      rngs[i] if rngs else None)
                for i, p in enumerate(provers)]
    validate(pk, n, m)
    transcripts = (list(transcripts) if transcripts is not None
                   else [Fs256Transcript(m) for _ in range(K)])
    if len(transcripts) != K or (rngs is not None and len(rngs) != K):
        raise ValueError("need one transcript (and one rng) per prover")
    known = all(getattr(t, "challenges_known_ahead", False) for t in transcripts)
    on_card = not known and all(getattr(t, "device_graph", False) for t in transcripts)
    fn = curve.fn
    rngs = list(rngs) if rngs else [SystemRng(fn.p) for _ in range(K)]
    pk = pk.prefix(n * m)
    dev = pk.device
    logn = (n * m).bit_length() - 1

    per_proof = ((known and all(getattr(r, "blinds_known_ahead", False) for r in rngs))
                 or (on_card and all(t._counter == 0 for t in transcripts)))
    alphas, dLs, dRs, finals = draw_blinds(rngs, logn, per_proof)

    def rows(vals):
        return fn.encode(vals, dev).reshape(K, -1, fn.L)

    A, setup, state, base = prove_statements(
        curve, pk, n, m, provers, transcripts, alphas,
        "known" if known else "fs256" if on_card else "host")
    with record_function("bpp::prove_setup"):
        blinds = rows([x for f in finals for x in f])          # (K, 4, 8)
        fold_in = (*setup, pk.G_vec, pk.H_vec, pk.g, pk.h)
        fold_blinds = (rows(dLs), rows(dRs), blinds[:, 0], blinds[:, 1], blinds[:, 2],
                       blinds[:, 3])
    if known:
        es, efs = [], []
        for t in transcripts:
            es += [t.round_challenge(curve, None, None) for _ in range(logn)]
            efs.append(t.final_challenge(curve, None, None))
        # the JAX package's whole-fold branch (:275-327): every transcript
        # and every rng known ahead, BPP_FUSE_PROVER not 0; only there does
        # BPP_PROVER=coeff take the coefficient-form prover
        whole = (per_proof and logn > 0 and os.environ.get("BPP_FUSE_PROVER") != "0")
        prog = (wip_prove_coeff_batched if whole and prover_variant() == "coeff"
                else wip_prove_known_batched)
        L_vec, R_vec, A_wip, B, r_p, s_p, d_p = prog(
            curve, *fold_in, rows(es), *fold_blinds, fn.encode(efs, dev))
    elif on_card:
        L_vec, R_vec, A_wip, B, r_p, s_p, d_p, state = wip_prove_fs256_batched(
            curve, *fold_in, state, *fold_blinds, base=base)
        words = state.cpu().numpy()
        for t, w in zip(transcripts, words):
            t.set_state_words(w, logn + 3)
    else:
        L_vec, R_vec, A_wip, B, r_p, s_p, d_p = wip_prove_interactive_batched(
            curve, transcripts, *fold_in, *fold_blinds)
    return ProofBatch(A=A, L_vec=L_vec, R_vec=R_vec, A_wip=A_wip, B=B,
                      r_prime=r_p, s_prime=s_p, d_prime=d_p)
