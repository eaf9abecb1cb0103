"""Batch verification: K proofs → one random-linear-combination MSM.

Port of bulletproofsplus_tpu/protocol/batch.py, homogeneous path
(`_batch_verify_fused_jit` :34-87, `_batch_verify_fused` :147-194,
`batch_verify` :197-257). Every proof's verification is "MSM == identity";
weighting proof k by a random 128-bit w_k and summing keeps one MSM whose
identity implies every term's, with overwhelming probability. The proofs
share the pk generators, so their G/H/g/h exponents merge by field adds:
the 2mn generator lanes run on fixed-base tables (K4) and only the
K·(2·log2(mn)+m+3)+2 proof-specific lanes run the joint ladder (K2); one
K3 launch sums the ladder's group outputs and K4's partial points together,
so no point add runs between the two MSMs. When no table fits
BPP_FIXED_BASE_MAX_BYTES (PublicKey.fixed_tables gives None), the generator
lanes join the ladder's lanes, as in the JAX package (batch.py:187-192).

The challenges come from the fs256 branch of `_batch_verify_fused`
(batch.py:157-172) when every transcript is an unused Fs256Transcript (the
default): protocol/fs256.py::fs256_replay derives them on the card, with no
host decode or hash. Otherwise the host replays them (range.py::replay_batch).
`batch_verify_identify` (batch.py:389-433) names the proofs that fail by
bisecting a failed batch into sub-batches.
"""
from __future__ import annotations

import secrets
from typing import List

import torch
from torch.profiler import record_function

from ..errors import VerificationError
from ..hashers_device import words_tensor
from ..msm import msm_partials, tree_sum
from ..msm.fixed import fixed_msm_partials
from ..transcript import Fs256Transcript
from .fs256 import fs256_replay
from .range import (
    ProofBatch,
    replay_batch,
    stack_commitments,
    vinputs_multiple_batched,
    vinputs_single_batched,
)


def replay_challenges(curve, n: int, m: int, batch: ProofBatch, V_all, transcripts):
    """The K proofs' challenges as Montgomery tensors (y, z (K, 8), es
    (K, logn, 8), e_final (K, 8)): replayed on the card when every
    transcript is an unused fs256 one, each from its own start state (its
    label's), else on the host and encoded."""
    if all(getattr(t, "device_graph", False) and getattr(t, "_counter", None) == 0
           for t in transcripts):
        with record_function("bpp::fs256_replay"):
            state = words_tensor(Fs256Transcript.stacked_state_words(transcripts),
                                 batch.A.device)
            return fs256_replay(curve, m, V_all, batch.A, batch.L_vec, batch.R_vec,
                                batch.A_wip, batch.B, state)
    fn, dev = curve.fn, batch.A.device
    ys, zs, ess, efs = replay_batch(curve, n, m, transcripts, batch, V_all)
    return (fn.encode(ys, dev), fn.encode(zs, dev),
            fn.encode([e for es in ess for e in es], dev).reshape(len(ys), -1, fn.L),
            fn.encode(efs, dev))


def verify_stacked(curve, pk, n: int, m: int, batch: ProofBatch, V_all,
                   challenges, W) -> bool:
    """Whether Σ_k w_k·(proof k's verification MSM) is the identity.

    batch: K proofs on pk's device; V_all (K, m, C, L); challenges the
    Montgomery (y, z, es, e_final) of replay_challenges; W (K, 8)
    Montgomery weights."""
    fn = curve.fn
    mn = n * m
    with record_function("bpp::exponents"):
        args = (*challenges, batch.r_prime, batch.s_prime, batch.d_prime)
        if m == 1:
            uniq_s, G_exp, H_exp, g_exp, h_exp = vinputs_single_batched(fn, n, *args)
            head = [batch.B, batch.A_wip, batch.A]   # pairs [1, e, e²]
        else:
            uniq_s, G_exp, H_exp, g_exp, h_exp = vinputs_multiple_batched(fn, n, m, *args)
            head = [batch.A, batch.A_wip, batch.B]   # pairs [1, e⁻¹, e⁻²]
    with record_function("bpp::rlc_merge"):
        Wg = W[:, None, :]
        gen_s = fn.from_mont(torch.cat([fn.sum(fn.mul(G_exp, Wg), axis=0),
                                        fn.sum(fn.mul(H_exp, Wg), axis=0)]))
        var_s = fn.from_mont(torch.cat([fn.mul(uniq_s, Wg).reshape(-1, fn.L),
                                        fn.sum(fn.mul(g_exp, W), axis=0)[None],
                                        fn.sum(fn.mul(h_exp, W), axis=0)[None]]))
        uniq_p = torch.cat([h[:, None] for h in head]
                           + [batch.L_vec, batch.R_vec, V_all], dim=1)
        var_p = torch.cat([uniq_p.reshape(-1, *pk.g.shape), pk.g[None], pk.h[None]])
        tables = pk.fixed_tables(mn)
        if tables is None:   # no table fits the budget: the generators join the ladder
            var_s = torch.cat([var_s, gen_s])
            var_p = torch.cat([var_p, pk.G_vec[:mn], pk.H_vec[:mn]])
    with record_function("bpp::variable_msm"):
        parts = msm_partials(curve, var_s, var_p)
    if tables is not None:
        with record_function("bpp::fixed_msm"):
            parts = torch.cat([parts, fixed_msm_partials(curve, gen_s, tables)])
    with record_function("bpp::msm_sum"):
        total = tree_sum(curve, parts)
    with record_function("bpp::identity_check"):
        return bool(curve.is_identity(total))


def batch_verify(curve, pk, n: int, proofs, commitment_lists,
                 transcripts=None, rng=None) -> None:
    """Verify K proofs over one pk in a single MSM; raises VerificationError.

    proofs: a ProofBatch or a sequence of RangeProof; commitment_lists: a
    (K, m, C, L) tensor or K equal-length lists of (C, L) points, all on
    pk's device. transcripts: K fresh transcripts, by default
    Fs256Transcript(m) each, or of the kinds that proved the proofs
    (DeterministicTranscript, ShaTranscript, MerlinBppTranscript, or a mix).
    rng: callable returning the 128-bit
    RLC weights; the default draws them from `secrets`, and must stay
    unpredictable to the prover."""
    if len(proofs) != len(commitment_lists):
        raise VerificationError("proof/commitment count mismatch")
    K = len(proofs)
    if K == 0:
        return
    draw = rng or (lambda: secrets.randbits(128))
    batch = proofs if isinstance(proofs, ProofBatch) else ProofBatch.from_proofs(proofs)
    V_all = stack_commitments(commitment_lists)
    m = V_all.shape[1]
    if transcripts is None:
        transcripts = [Fs256Transcript(m) for _ in range(K)]
    if len(transcripts) != K:
        raise ValueError("need one transcript per proof")
    if n * m != 1 << batch.rounds or pk.length < n * m:
        raise VerificationError()
    challenges = replay_challenges(curve, n, m, batch, V_all, transcripts)
    W = curve.fn.encode([draw() for _ in range(K)], pk.device)
    if not verify_stacked(curve, pk.prefix(n * m), n, m, batch, V_all,
                          challenges, W):
        raise VerificationError("batch verification failed")


def batch_verify_identify(curve, pk, n: int, proofs, commitment_lists,
                          transcript_factory=None, rng=None) -> List[int]:
    """Verify K proofs in one batch and, if it fails, bisect: each half is
    verified as a batch of its own until the failing proofs are isolated.
    Returns the sorted indices of the proofs that fail ([] when the batch
    verifies); a failed batch costs O(bad · log K) sub-batch verifies.

    transcript_factory: index → a FRESH transcript for that proof, called
    for every dispatch (transcripts are stateful and each dispatch replays
    them); None gives fresh default transcripts (Fs256Transcript) each
    time. rng: as batch_verify's."""
    batch = proofs if isinstance(proofs, ProofBatch) else ProofBatch.from_proofs(proofs)
    V_all = stack_commitments(commitment_lists)
    if len(batch) != V_all.shape[0]:
        raise VerificationError("proof/commitment count mismatch")

    def rec(lo: int, hi: int) -> List[int]:
        trs = (None if transcript_factory is None
               else [transcript_factory(i) for i in range(lo, hi)])
        try:
            batch_verify(curve, pk, n, batch.take(slice(lo, hi)), V_all[lo:hi],
                         transcripts=trs, rng=rng)
            return []
        except VerificationError:
            if hi - lo == 1:
                return [lo]
            mid = (lo + hi) // 2
            return rec(lo, mid) + rec(mid, hi)

    return rec(0, len(batch))
